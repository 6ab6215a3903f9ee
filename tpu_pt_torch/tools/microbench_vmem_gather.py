"""Row fetch from a small bf16 table, widened to f32, on the card: the
counterpart of the JAX package's ``tools/microbench_vmem_gather.py`` (the
fused-descent probe, ``docs/r5-descent-kernel.md``).

    python -m tpu_pt_torch.tools.microbench_vmem_gather
    python -m tpu_pt_torch.tools.microbench_vmem_gather --device cpu \\
        --rays 64 --scene-subdiv 2      # the checks only, at a small size

At the JAX tool's shapes, P = Q x 34 rows from an (N = 233, 64) table and
P = Q x 59 from N = 1,864 (Q = 4,096 rays, P rounded down to a multiple of
512, int32 indices, a standard normal table rounded to bf16, seeded with
numpy), the kernel ``fetch_rows`` runs against torch's gather + cast,
``table[idx].float()``.  Then at the port's real descent: the child fetch of
each level of one traversal sub-batch (Q = 1,024 rays, sub-batch 0 of the
first camera wave of big-1m at 1024², key (0, 3)), with the int64
candidates where the descent holds them and clamped as it clamps them,
against what the descent ran before the kernel,
``table[clamp(cand)].float()``.  Each
case is checked bit for bit against the plain version and prints one JSON
line: the two times (a CUDA graph of 30 calls, best of three replays) and
their rates over the bytes the fetch must move.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_pt_torch.kernels.fetch import fetch_rows, fetch_rows_ref
from tpu_pt_torch.tools import _probe

B = 512                 # the JAX kernel's rows per grid step
SHAPES = (("L1", 34, 233), ("L2", 59, 1864))   # (case, rows a ray, N)


def descent_fetches(cb, ro, rd, t_max):
    """(level, table, cand) of every child fetch that the cluster descent
    makes for these rays (t_max (Q, 1)), with ``cand`` as the descent holds
    it: caught in its row form (``fetch="rows"``); the default form,
    ``fetch_fields``, fetches from the same operands."""
    from tpu_pt_torch.bvh import cluster

    got = []
    real = cluster.fetch_rows

    def spy(table, idx, *, clamp=False):
        got.append((len(got) + 1, table, idx))
        return real(table, idx, clamp=clamp)

    cluster.fetch_rows = spy
    try:
        with torch.no_grad():
            cluster._descend_compact(
                cb, ro, 1.0 / rd, torch.zeros_like(t_max), t_max,
                fetch="rows")
    finally:
        cluster.fetch_rows = real
    return got


def first_wave_batch(subdiv: int, device):
    """The cluster BVH of ``meshes.big_scene(subdiv)`` on ``device`` and the
    rays of the closest-hit sub-batch 0 of its first camera wave (1024²,
    spp 1, queue 4,096, key (0, 3)), t_max as the wavefront sets it."""
    from tpu_pt_torch.bvh import cluster
    from tpu_pt_torch.config import RenderConfig
    from tpu_pt_torch.render import wavefront
    from tpu_pt_torch.scene import meshes

    cb = cluster.build_cluster_bvh(meshes.big_scene(subdiv=subdiv)).to(device)
    cfg = RenderConfig(width=1024, height=1024, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam = meshes.big_camera(1024, 1024).to(device)
    st = wavefront.init_queue(4096, cfg.n_pixels, device)
    st = wavefront._respawn(cam, cfg, (0, 3), st, 0, cfg.n_pixels, 0, cfg.spp)
    k = cluster._split_batches(4096, cluster.SPLIT_CLOSEST)
    t_max = torch.where(st.alive, 1e30, -1.0).to(torch.float32)
    return (cb, st.ro[0::k].contiguous(), st.rd[0::k].contiguous(),
            t_max[0::k].contiguous())


def run_case(device, case, table, idx, clamp, torch_fn):
    N, W = table.shape
    out = fetch_rows(table, idx, clamp=clamp)
    exact = _probe.bitwise_equal(out, fetch_rows_ref(table, idx, clamp=clamp))
    line = {"tool": "microbench_vmem_gather", "case": case,
            "device": _probe.device_name(device), "P": idx.numel(), "N": N,
            "W": W, "idx_dtype": str(idx.dtype).replace("torch.", ""),
            "idx_contiguous": idx.is_contiguous(), "clamp": clamp,
            "exact": exact,
            **_probe.times(device, lambda: fetch_rows(table, idx, clamp=clamp),
                           torch_fn, _probe.fetch_bytes(idx, N, W))}
    _probe.emit(line)
    assert exact, f"fetch_rows {case}: kernel and plain version differ"
    return line


def main(argv=None, descent=None):
    """Runs every case; returns their lines.  ``descent``: (cb, ro, rd,
    t_max) of a real traversal sub-batch to take the descent case from, in
    place of big-1m's first camera wave."""
    ap = _probe.parser(__doc__)
    ap.add_argument("--rays", type=int, default=4096,
                    help="Q of the synthetic shapes (P = Q x rows a ray)")
    ap.add_argument("--scene-subdiv", type=int, default=8,
                    help="subdivision of the big scene of the descent case "
                         "(8: big-1m)")
    args = ap.parse_args(argv)
    device = _probe.device_of(args)
    lines = []
    for case, per_ray, N in SHAPES:
        rs = np.random.RandomState(args.seed)
        P = max(B, args.rays * per_ray // B * B)
        table = _probe.bf16_table(rs, N, 64, device)
        idx = _probe.index(rs, N, (P,), device)
        lines.append(run_case(device, case, table, idx, False,
                              lambda: table[idx].float()))
    cb, ro, rd, t_max = descent if descent is not None else \
        first_wave_batch(args.scene_subdiv, device)
    for level, table, cand in descent_fetches(cb, ro, rd, t_max):
        N = table.shape[0]
        lines.append(run_case(
            device, f"descent_L{level}", table, cand, True,
            lambda: table[torch.clamp(cand, 0, N - 1)].float()))
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
