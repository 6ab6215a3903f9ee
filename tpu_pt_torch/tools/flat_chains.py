"""How long the flat walk's chains of dependent loads are on the oracle
render's walk batches, in its two designs: counted, not timed.

    python -m tpu_pt_torch.tools.flat_chains --device cpu            # chunk 0
    python -m tpu_pt_torch.tools.flat_chains --device cpu --chunk 12
    python -m tpu_pt_torch.tools.flat_chains --device cpu --size 64 --spp 4
                                                        # a small, quick count

Renders chunk ``--chunk`` of ``cornell("mesh", mesh_subdiv=4)`` (or
``--mesh-subdiv``) at
``--size``², ``--spp`` samples, depth 4, key (0, 0) (the command line's
oracle defaults; a chunk is ``(1 << 17) // spp`` whole pixels, as
``driver.render`` takes them) through backend ``"bvh"``, catching every walk
batch on its way in (per depth: the closest-hit batch, then the shadow
batch), and walks each again through ``kernels.flat_walk.flat_walk_counts``
(the plain walk's statistics on the CPU, the row walk's STATS form on the
card).  Per batch: node steps a ray; the lane efficiency (sum of the steps
over the sum, over warps of 32 consecutive rays, of the warp's most steps
times 32: the share of a warp's lanes busy in a step); leaves entered and
primitives tested a ray; and the longest chain of dependent round trips of
a ray, ``steps + 3 x primitives`` for the thread walk (a node; a
primitive's id, its indices, its vertices) and ``steps + leaves`` for the
row walk (a node row; a leaf's rows together).  Prints one JSON line a
batch.
"""

from __future__ import annotations

import json
import sys

import torch

from tpu_pt_torch.bvh.sah import MAX_LEAF
from tpu_pt_torch.tools import _probe
from tpu_pt_torch.tools.walk_windows import summary

WARP = 32


def lane_efficiency(steps) -> float:
    """Sum of the steps over the sum of each warp's most steps x 32 (rays
    in launch order, 32 a warp; a last partial warp counts 32 lanes)."""
    pad = (-steps.shape[0]) % WARP
    s = torch.cat([steps, steps.new_zeros(pad)]).reshape(-1, WARP)
    return float(steps.sum()) / float(s.max(dim=1).values.sum() * WARP)


def chunk_batches(scene, cam, cfg, key, bvh, chunk: int) -> list:
    """Every walk batch of chunk ``chunk`` of the oracle render, in the
    order the integrator hands them over: (name, ro, rd, t_min (R,),
    t_max (R,), any_hit)."""
    from tpu_pt_torch.bvh import flat
    from tpu_pt_torch.core.intersect import as_col
    from tpu_pt_torch.render.integrator import render_chunk

    isect, occl = flat.intersectors(bvh)
    got = []

    def isect_spy(scene, ro, rd, t_min, t_max):
        R = ro.shape[0]
        got.append((f"closest_{sum(not b[5] for b in got)}", ro, rd,
                    as_col(t_min, R, ro.device).reshape(-1),
                    as_col(t_max, R, ro.device).reshape(-1), False))
        return isect(scene, ro, rd, t_min, t_max)

    def occl_spy(scene, ro, rd, t_max):
        R = ro.shape[0]
        got.append((f"shadow_{sum(b[5] for b in got)}", ro, rd,
                    torch.zeros((R,), device=ro.device),
                    as_col(t_max, R, ro.device).reshape(-1), True))
        return occl(scene, ro, rd, t_max)

    pix_chunk = min((1 << 17) // cfg.spp, cfg.n_pixels)
    dev = scene.vertices.device
    ids = torch.arange(chunk * pix_chunk, (chunk + 1) * pix_chunk,
                       device=dev).clamp_max(cfg.n_pixels - 1)
    with torch.no_grad():
        render_chunk(scene, cam, cfg, key, ids.repeat_interleave(cfg.spp),
                     torch.arange(cfg.spp, device=dev).repeat(pix_chunk),
                     isect_spy, occl_spy)
    return got


def count(bvh, scene, rows, ro, rd, t_min, t_max, any_hit: bool) -> dict:
    """One batch's counts (``flat_walk_counts``) and chains."""
    from tpu_pt_torch.kernels.flat_walk import flat_walk_counts

    with torch.no_grad():
        st = flat_walk_counts(
            bvh.node_min, bvh.node_max, bvh.skip, bvh.prim_start,
            bvh.prim_count, bvh.prim_ids, scene.tri_idx, scene.vertices,
            scene.sph_center, scene.sph_radius, ro.contiguous(),
            rd.contiguous(), t_min.contiguous(), t_max.contiguous(),
            MAX_LEAF, any_hit=any_hit, rows=rows)
    steps, leaves, prims = st["steps"], st["leaves"], st["prims"]
    thread, rows_chain = steps + 3 * prims, steps + leaves
    return {"rays": int(ro.shape[0]),
            "walking_rays": int((t_max >= t_min).sum()), "any_hit": any_hit,
            "steps": summary(steps),
            "lane_efficiency": round(lane_efficiency(steps), 4),
            "leaves": summary(leaves), "prims": summary(prims),
            "chain_thread": summary(thread), "chain_rows": summary(rows_chain),
            "prims_tri": st["prims_tri"], "prims_sph": st["prims_sph"]}


def main(argv=None):
    from tpu_pt_torch.bvh import flat, sah
    from tpu_pt_torch.config import RenderConfig
    from tpu_pt_torch.scene import cornell

    ap = _probe.parser(__doc__)
    ap.add_argument("--chunk", type=int, default=0,
                    help="which chunk of the render (0: its first)")
    ap.add_argument("--size", type=int, default=512, help="image width")
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--mesh-subdiv", type=int, default=4,
                    help="subdivision of the Cornell box's mesh (4: the "
                         "oracle's cornell_mesh_4)")
    args = ap.parse_args(argv)
    device = _probe.device_of(args)
    scene_h = cornell.cornell("mesh", mesh_subdiv=args.mesh_subdiv)
    bvh = sah.build_bvh(scene_h).to(device)
    scene = scene_h.to(device)
    rows = flat.row_tables(bvh, scene)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_depth=4)
    cam = cornell.camera(args.size, args.size).to(device)
    lines = []
    for name, ro, rd, t_min, t_max, any_hit in chunk_batches(
            scene, cam, cfg, (0, 0), bvh, args.chunk):
        line = {"tool": "flat_chains", "batch": name, "chunk": args.chunk,
                "device": _probe.device_name(device), "size": args.size,
                "spp": args.spp, "mesh_subdiv": args.mesh_subdiv,
                "n_nodes": bvh.n_nodes,
                **count(bvh, scene, rows, ro, rd, t_min, t_max, any_hit)}
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
