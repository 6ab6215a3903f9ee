"""One rank of the two-process distribution test (tests/test_torch_dist.py),
the port's counterpart of tools/mp_worker.py: N processes join one gloo
group on the CPU and run the port's sharded gradient step over a mesh of 8
shards (8 / N local shards each).

    python tests/torch_dist_worker.py <port> <rank> <world>

Prints one JSON line: whether a mesh of world + 1 shards was refused; for
the inputs of tests/test_multiprocess.py
(``mp``) the loss and the gradients; for a case whose shards run unequal
numbers of chunks (``chunks``) the same, the chunk counts of each local
shard, the reduces started in backward, and the gradients of one tail
reduce of the summed (unreduced) gradients.
"""

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

CASES = {
    # tests/test_multiprocess.py:64-74
    "mp": dict(variant="empty", queue=64, key=(0, 2),
               cfg=dict(width=8, height=8, spp=2, max_depth=1, rr_start=9)),
    # Shards 3 and 7 run 14 and 12 steps: 4 chunks against 3.
    "chunks": dict(variant="spheres", queue=32, key=(0, 3),
                   cfg=dict(width=16, height=16, spp=4, max_depth=3)),
}


def setup(case):
    """(params, scene, camera, config, key, target, packed BVH) of a case,
    on the CPU; the same in every process."""
    from tpu_pt_torch.bvh.native import build_packed_any
    from tpu_pt_torch.config import RenderConfig
    from tpu_pt_torch.diff.params import split
    from tpu_pt_torch.scene import cornell

    c = CASES[case]
    scene = cornell.cornell(c["variant"])
    cfg = RenderConfig(**c["cfg"])
    cam = cornell.camera(cfg.width, cfg.height)
    target = np.zeros((cfg.n_pixels, 3), np.float32)
    return (split(scene)[0], scene, cam, cfg, c["key"], target,
            build_packed_any(scene))


def tail_reduced(params, scene, cam, cfg, key, target, bvh, mesh, queue):
    """The sharded step's gradients with no chunk reduce: each local shard's
    backward into the leaves, then one all_reduce of each gradient."""
    from tpu_pt_torch.diff.adjoint import _leaves
    from tpu_pt_torch.diff.params import merge
    from tpu_pt_torch.render.wavefront import wavefront_accum

    leaves = _leaves(params, "cpu")
    sc = merge(leaves, scene.to("cpu"))
    block = cfg.n_pixels // mesh.size
    tgt = torch.from_numpy(target)
    for s in mesh.local_shards:
        accum = wavefront_accum(sc, cam.to("cpu"), cfg, key, bvh.to("cpu"),
                                queue, "packed", s * block, block,
                                differentiable=True)
        img = accum / cfg.spp
        loss = torch.sum((img - tgt[s * block:(s + 1) * block]) ** 2) / (
            cfg.n_pixels * 3)
        loss.backward()
    out = {}
    for k, x in leaves.items():
        g = x.grad if x.grad is not None else torch.zeros_like(x)
        dist.all_reduce(g)
        out[k] = g.tolist()
    return out


def main():
    port, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from tpu_pt_torch.dist.sharding import (loss_and_grad_sharded,
                                                make_mesh)

        mesh = make_mesh(8, device="cpu")
        out = {"rank": rank, "local_shards": list(mesh.local_shards)}
        try:
            make_mesh(world + 1, device="cpu")
            out["uneven_mesh_refused"] = False
        except ValueError:
            out["uneven_mesh_refused"] = True
        for case in CASES:
            params, scene, cam, cfg, key, target, bvh = setup(case)
            queue = CASES[case]["queue"]
            loss, grads, stats = loss_and_grad_sharded(
                params, scene, cam, cfg, key, target, bvh, mesh, queue=queue,
                backend="packed", with_stats=True)
            out[case] = dict(
                loss=float(loss), grads={k: g.tolist() for k, g in
                                         grads.items()},
                chunks=stats["chunks"], allreduces_bwd=stats["allreduces_bwd"],
                steps_run=stats["steps_run"])
            if case == "chunks":
                out[case]["tail_grads"] = tail_reduced(
                    params, scene, cam, cfg, key, target, bvh, mesh, queue)
        print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
