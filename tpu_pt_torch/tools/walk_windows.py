"""How many windows of node rows the packed walk's window design loads per
ray, beside the node steps and leaves of its walk, on the headline's real
batches: counted, not timed.

    python -m tpu_pt_torch.tools.walk_windows --device cpu
    python -m tpu_pt_torch.tools.walk_windows --device cpu --warm 10 \\
        --scene-subdiv 4 --size 128          # a small, quick count
    python -m tpu_pt_torch.tools.walk_windows --device cpu \\
        --window 32 64 128                    # other window sizes too

Builds big-1m (``meshes.big_scene(subdiv=8)``) and its packed and cluster
BVHs on the host, runs ``--warm`` steps of the wavefront renderer (1024²,
spp 1, depth 4, queue 4,096, key (0, 3)) on ``--device``, and walks the
whole queue's closest-hit batch and the last step's shadow batch through
the plain walk (``kernels.packed_walk.packed_walk_ref``), whose statistics
give each ray's node steps, leaves entered and windows (``--window`` rows
a window, ``WINDOW`` = 32 in the kernel: one where the walk starts, one
each time the cursor leaves the last).  ``chip_smoke.py`` times the walk on the same two batches.  Prints
one JSON line a batch.
"""

from __future__ import annotations

import json
import sys

import torch

from tpu_pt_torch.kernels.packed_walk import WINDOW, packed_walk_ref
from tpu_pt_torch.tools import _probe


def queue_batches(scene, cam, cb, cfg, key, queue, n_warm):
    """The whole queue's closest-hit batch after ``n_warm`` wavefront steps
    (t_max 1e30 where a lane is alive, else -1) and the shadow batch of the
    last of those steps: (ro, rd, t_max (R,)) each."""
    from tpu_pt_torch.render import wavefront
    from tpu_pt_torch.render.driver import _intersectors_counted

    isect, occl_counted = _intersectors_counted("cluster", cb)
    shadow = []

    def occl(scene, ro, rd, t_max, narrow=False):
        shadow[:] = [ro, rd, t_max.reshape(-1)]
        return occl_counted(scene, ro, rd, t_max, narrow=narrow)

    st = wavefront.init_queue(queue, cfg.n_pixels, cam.origin.device)
    with torch.no_grad():
        for i in range(n_warm):
            st, _ = wavefront._step(scene, cam, cfg, key, isect, occl, st, 0,
                                    cfg.n_pixels, 0, cfg.spp,
                                    shadow_narrow=i >= 2)
        st = wavefront._respawn(cam, cfg, key, st, 0, cfg.n_pixels, 0,
                                cfg.spp)
    t_max = torch.where(st.alive, 1e30, -1.0).to(torch.float32).reshape(-1)
    return {"queue_closest": (st.ro, st.rd, t_max),
            "queue_shadow": tuple(shadow)}


def summary(x) -> dict:
    """Max, mean and quantiles of a per-ray count."""
    x = x.double()
    q = torch.quantile(x, torch.tensor([0.5, 0.9, 0.99], dtype=x.dtype,
                                       device=x.device))
    return {"max": int(x.max()), "mean": round(float(x.mean()), 3),
            "p50": float(q[0]), "p90": float(q[1]), "p99": float(q[2])}


def count(pk, ro, rd, t_max, any_hit: bool, window: int = WINDOW) -> dict:
    """The plain walk's per-ray counts on one batch."""
    stats = {}
    with torch.no_grad():
        packed_walk_ref(pk.table, pk.prim_gid, ro.contiguous(),
                        rd.contiguous(), torch.zeros_like(t_max),
                        t_max.contiguous(), pk.n_nodes, pk.n_tables,
                        pk.max_leaf, any_hit=any_hit, stats=stats,
                        window=window)
    walking = t_max >= 0
    steps, windows, leaves = (stats[k][walking] for k in
                              ("steps", "windows", "leaves"))
    longest = int(torch.argmax(stats["steps"]))
    return {"rays": int(t_max.shape[0]), "walking_rays": int(walking.sum()),
            "any_hit": any_hit, "window_rows": window,
            "steps": summary(steps), "windows": summary(windows),
            "leaves": summary(leaves),
            "windows_over_steps": round(float(windows.sum() / steps.sum()),
                                        4),
            "longest_ray": {k: int(stats[k][longest]) for k in
                            ("steps", "windows", "leaves")},
            "max_windows_plus_leaves": int((stats["windows"]
                                            + stats["leaves"]).max())}


def main(argv=None):
    from tpu_pt_torch.bvh import cluster, native
    from tpu_pt_torch.config import RenderConfig
    from tpu_pt_torch.scene import meshes

    ap = _probe.parser(__doc__)
    ap.add_argument("--warm", type=int, default=150,
                    help="wavefront steps before the batches are taken")
    ap.add_argument("--scene-subdiv", type=int, default=8,
                    help="subdivision of the big scene (8: big-1m)")
    ap.add_argument("--size", type=int, default=1024, help="image width")
    ap.add_argument("--window", type=int, nargs="+", default=[WINDOW],
                    help="node rows a window (the kernel's: 32)")
    args = ap.parse_args(argv)
    device = _probe.device_of(args)
    scene_h = meshes.big_scene(subdiv=args.scene_subdiv)
    pk = native.build_packed_any(scene_h).to(device)
    cb = cluster.build_cluster_bvh(scene_h).to(device)
    cfg = RenderConfig(width=args.size, height=args.size, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    cam = meshes.big_camera(args.size, args.size).to(device)
    batches = queue_batches(scene_h.to(device), cam, cb, cfg, (0, 3), 4096,
                            args.warm)
    lines = []
    for window in args.window:
        for name, (ro, rd, t_max) in batches.items():
            line = {"tool": "walk_windows", "batch": name,
                    "device": _probe.device_name(device),
                    "scene_subdiv": args.scene_subdiv, "size": args.size,
                    "warm_steps": args.warm,
                    **count(pk, ro, rd, t_max, name == "queue_shadow",
                            window)}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
