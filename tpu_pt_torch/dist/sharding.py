"""Tile sharding over a mesh of ranks: the sharded render and the sharded
gradient step.

The JAX package shards with ``shard_map`` over a device mesh and lets XLA
insert the collectives.  Here a :class:`Mesh` is ``size`` shards spread
evenly over the ranks of a ``torch.distributed`` process group; each rank
renders its ``size / world`` local shards in turn on its own device, with
the scene and the BVH replicated, and the ranks meet in three collectives:

  - ``all_gather`` of the shards' radiance sums (the image every rank
    returns);
  - ``all_reduce`` of the loss;
  - the gradient, reduced chunk by chunk while backward runs
    (``render/wavefront.py::ChunkReduce``: async ``all_reduce`` per chunk,
    paired across ranks by an agreed count), with no tail reduce on top.

Without a process group one process holds every shard: the counterpart of
the JAX package's 8 virtual CPU devices, and what the CPU tests use.  Two
ranks on one card (``cuda:0`` each) must use gloo: NCCL refuses them.

Shard s of n renders pixels {s, s+n, s+2n, ...} (``interleave=True``, the
default: every shard sees the same mix of the image) or the contiguous
block [s*block, (s+1)*block).  Ray ids, and so random numbers, are global
and the accumulate is order-fixed, so either layout gives the
one-device image bit for bit wherever the traversal is exact.

Under ``torchrun`` call :func:`init_distributed` first; everything else is
the same.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from tpu_pt_torch.config import RenderConfig, resolve_device
from tpu_pt_torch.diff.adjoint import _f32, _leaves
from tpu_pt_torch.diff.params import merge
from tpu_pt_torch.render.driver import _on_device
from tpu_pt_torch.render.wavefront import ChunkReduce, wavefront_accum
from tpu_pt_torch.scene.types import Scene

DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def init_distributed(backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     **kw) -> None:
    """Join the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` in the environment): backend ``"nccl"``
    where CUDA is available, else ``"gloo"``.  Does nothing when a group is
    already up or in a plain single process.  A backend that cannot start
    raises."""
    if dist.is_initialized() or not all(
            k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl" and torch.cuda.is_available():
        torch.cuda.set_device(_local_device_index())
    dist.init_process_group(backend, timeout=timeout, **kw)


def _local_device_index() -> int:
    return int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count()


class Mesh(NamedTuple):
    """``size`` shards over the ``world`` ranks of ``group`` (None: one
    process holds them all); this rank holds :attr:`local_shards` and
    renders them on ``device``."""

    size: int
    group: object
    rank: int
    world: int
    device: torch.device

    @property
    def local_shards(self) -> range:
        per = self.size // self.world
        return range(self.rank * per, (self.rank + 1) * per)


def make_mesh(n_devices: Optional[int] = None, device="cuda",
              group=None) -> Mesh:
    """A mesh of ``n_devices`` shards (default: one a rank) over ``group``
    (default: the default process group if one is up, else this process
    alone).  ``n_devices`` must be a multiple of the world size.  The
    device is ``cuda:{LOCAL_RANK % device_count}`` for ``"cuda"`` (two ranks
    on one card share ``cuda:0``), or as given; ``"cuda"`` without a card
    raises."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _local_device_index())
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    size = n_devices or world
    if size % world:
        raise ValueError(f"make_mesh: {size} shards do not divide evenly "
                         f"over {world} ranks")
    return Mesh(size, group, rank, world, device)


def _pad_pixels(n_pix: int, n_shards: int) -> int:
    return -(-n_pix // n_shards) * n_shards


def _gather(local, mesh: Mesh):
    """Every rank's ``local`` (equal shapes) concatenated in rank order."""
    if mesh.group is None:
        return local
    parts = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def render_sharded(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                   mesh: Optional[Mesh] = None, queue: int = 1 << 15,
                   backend: str = "bvh", interleave: bool = True,
                   with_stats: bool = False, fast: bool = False,
                   use_kernels: bool = True, pair_stage: str = "fused"):
    """Tile-sharded render over ``mesh`` (default :func:`make_mesh`, on the
    card) -> the whole (H, W, 3) image on every rank's device.

    The pixels are padded to ``ceil(n_pix / size) * size``; the padded ones
    are rendered and cut.  ``with_stats`` also returns the per-shard counts
    ``steps_run``, ``n_closest``, ``n_shadow``, ``n_overflow`` as (size,)
    int64 arrays.  ``fast`` is accepted and changes nothing: the port's loop
    always leaves early, with the same values."""
    del fast
    mesh = mesh or make_mesh()
    device, scene, cam, bvh = _on_device(mesh.device, scene, cam, bvh)
    n = mesh.size
    padded = _pad_pixels(cfg.n_pixels, n)
    block = padded // n
    sums, stats = [], []
    for s in mesh.local_shards:
        accum, (nc, ns, novf, n_iter) = wavefront_accum(
            scene, cam, cfg, key, bvh, queue, backend,
            s if interleave else s * block, block, with_counts=True,
            pix_stride=n if interleave else 1, use_kernels=use_kernels,
            pair_stage=pair_stage)
        sums.append(accum)
        stats.append(torch.stack([torch.tensor(n_iter, device=device),
                                  nc, ns, novf]))
    accum = _gather(torch.cat(sums), mesh)
    if interleave:
        # Row s*block + j holds pixel s + j*n.
        accum = accum.reshape(n, block, 3).transpose(0, 1).reshape(padded, 3)
    img = (accum / cfg.spp)[: cfg.n_pixels].reshape(cfg.height, cfg.width, 3)
    if not with_stats:
        return img
    st = _gather(torch.stack(stats), mesh).cpu().numpy()
    return img, dict(steps_run=st[:, 0], n_closest=st[:, 1],
                     n_shadow=st[:, 2], n_overflow=st[:, 3])


def loss_and_grad_sharded(params, scene: Scene, cam, cfg: RenderConfig, key,
                          target, bvh, mesh: Optional[Mesh] = None,
                          queue: int = 1 << 14, backend: str = "bvh",
                          steps_hint=None, with_stats: bool = False,
                          on_phase=None):
    """The sharded inverse-rendering step: loss ``mean((img - target)²)``
    over the whole image and its gradients with respect to ``params``
    (``diff/params.py``), the same on every rank.  target: (n_pixels, 3).

    Shards render contiguous pixel blocks through the differentiable
    wavefront loop; each shard's loss masks the padded pixels out and is
    normalised by the global ``n_pixels * 3``, and runs its backward right
    after its forward.  The gradients are reduced chunk by chunk during
    backward (:class:`~tpu_pt_torch.render.wavefront.ChunkReduce`), with no
    tail reduce on top; the loss is all-reduced.

    ``steps_hint`` caps each shard's loop (``wavefront_accum``); a cap that
    drops samples on any shard raises ``ValueError`` on every rank.
    ``with_stats`` adds a third item: the chunk counts ``(n_local, M)`` of
    each local shard, the reduces started in backward, the local shards'
    ``steps_run`` / ``n_closest`` / ``n_shadow`` / ``overflow``, and
    ``fwd_s`` / ``bwd_s`` / ``wait_s`` (the device synchronised at each
    boundary; ``wait_s`` from the end of the last backward to the reduced
    gradients).  ``on_phase``, if given, is called with ``"forward"`` after
    each shard's forward and ``"backward"`` after its backward."""
    mesh = mesh or make_mesh()
    device, scene, cam, bvh = _on_device(mesh.device, scene, cam, bvh)
    n = mesh.size
    padded = _pad_pixels(cfg.n_pixels, n)
    block = padded // n
    leaves = _leaves(params, device)
    sc = merge(leaves, scene)
    tgt = torch.zeros((padded, 3), dtype=torch.float32, device=device)
    tgt[: cfg.n_pixels] = _f32(target, device).reshape(-1, 3)
    cfg = cfg.replace(debug_checks=False)   # as loss_and_grad_wavefront
    reduce = ChunkReduce(mesh.group)
    loss = torch.zeros((), dtype=torch.float32, device=device)
    short = 0
    stats = dict(steps_run=[], n_closest=[], n_shadow=[], overflow=[],
                 fwd_s=0.0, bwd_s=0.0)
    for s in mesh.local_shards:
        pix_lo = s * block
        t0 = time.perf_counter()
        accum, (nc, ns, novf, n_iter), done = wavefront_accum(
            sc, cam, cfg, key, bvh, queue, backend, pix_lo, block,
            with_counts=True, differentiable=True, steps_hint=steps_hint,
            with_done=True, psum_group=reduce)
        img = accum / cfg.spp
        pix = pix_lo + torch.arange(block, device=device)
        sq = torch.sum(torch.where((pix < cfg.n_pixels)[:, None],
                                   (img - tgt[pix_lo: pix_lo + block]) ** 2,
                                   0.0))
        loss_s = sq / (cfg.n_pixels * 3)
        if with_stats:
            _sync(device)
        t1 = time.perf_counter()
        if on_phase is not None:
            on_phase("forward")
        loss_s.backward()
        if with_stats:
            _sync(device)
            stats["fwd_s"] += t1 - t0
            stats["bwd_s"] += time.perf_counter() - t1
            for k, v in zip(("n_closest", "n_shadow", "overflow"),
                            (nc, ns, novf)):
                stats[k].append(int(v))
            stats["steps_run"].append(n_iter)
        if on_phase is not None:
            on_phase("backward")
        loss = loss + loss_s.detach()
        short += not done
    t2 = time.perf_counter()
    total = torch.stack([loss, torch.tensor(float(short), device=device)])
    if mesh.group is not None:
        dist.all_reduce(total, group=mesh.group)
    grads = dict(zip(leaves, reduce.wait(list(leaves.values()))))
    if with_stats:
        _sync(device)
        stats.update(wait_s=time.perf_counter() - t2, chunks=reduce.chunks,
                     allreduces_bwd=reduce.n_reduces)
    if float(total[1]) > 0:
        raise ValueError(f"loss_and_grad_sharded: steps_hint={steps_hint} "
                         "is too small, samples were dropped")
    loss = total[0]
    return (loss, grads, stats) if with_stats else (loss, grads)


def dryrun_multichip(n_devices: int, device="cuda"):
    """The full sharded training step on tiny shapes (the Cornell spheres at
    16², spp 1, depth 1, queue 256, cluster backend) over a mesh of
    ``n_devices`` shards; raises unless the loss and every gradient are
    finite.  Returns (loss, grads)."""
    from tpu_pt_torch.bvh.cluster import build_cluster_bvh
    from tpu_pt_torch.diff.params import split
    from tpu_pt_torch.scene import cornell

    scene = cornell.cornell("spheres")
    cfg = RenderConfig(width=16, height=16, spp=1, max_depth=1)
    mesh = make_mesh(n_devices, device)
    params, _ = split(scene)
    loss, grads = loss_and_grad_sharded(
        params, scene, cornell.camera(16, 16), cfg, (0, 0),
        np.zeros((cfg.n_pixels, 3), np.float32), build_cluster_bvh(scene),
        mesh, queue=256, backend="cluster")
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if not bool(torch.isfinite(loss)) or bad:
        raise FloatingPointError(
            f"dryrun_multichip({n_devices}): loss {float(loss)}, "
            f"non-finite gradients {bad}")
    print(f"dryrun_multichip({n_devices}): loss={float(loss):.6f} grads ok",
          flush=True)
    return loss, grads
