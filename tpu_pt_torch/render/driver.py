"""Image rendering entry point and intersector selection.

``render`` turns the unrolled integrator (``integrator.render_chunk``) into
images: the image is a flat array of (pixel, sample) pairs processed in
fixed-size chunks of whole pixels, so that a chunk reduces to pixel means
with no scatter.  It is the reference/debug path and the oracle that the
wavefront renderer (``render/wavefront.py``, the performance path) is tested
against.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tpu_pt_torch.config import RenderConfig, resolve_device
from tpu_pt_torch.render import brute
from tpu_pt_torch.render.integrator import render_chunk
from tpu_pt_torch.scene.types import Scene

BACKENDS = ("brute", "pallas", "cluster", "packed", "bvh")


def _intersectors(backend: str, bvh=None, use_kernels: bool = True,
                  design: str = "rows"):
    """(intersect, occluded) closures of a backend: ``"brute"`` (the dense
    oracle, no structure), ``"pallas"`` (the dense-sweep kernels over a
    ``PallasScene``; the name is the JAX package's), ``"cluster"`` (a
    ``ClusterBVH``), ``"packed"`` (the per-ray walk over a ``PackedBVH``)
    or ``"bvh"`` (the per-ray walk over a ``FlatBVH``; ``design`` is its
    walk's, ``kernels/flat_walk.py``, and no other backend reads it).
    ``use_kernels=False`` runs the plain PyTorch versions of the backend's
    kernels."""
    if backend == "brute":
        return brute.intersect, brute.occluded
    if backend == "bvh":
        from tpu_pt_torch.bvh import flat

        if not isinstance(bvh, flat.FlatBVH):
            raise ValueError(f"backend='bvh' requires a FlatBVH, not "
                             f"{type(bvh).__name__}")
        return flat.intersectors(bvh, use_kernels, design)
    if backend == "pallas":
        from tpu_pt_torch.kernels import intersect as dense

        if bvh is None:
            raise ValueError("backend='pallas' requires a PallasScene")
        return (
            functools.partial(dense.intersect, bvh, use_kernels=use_kernels),
            functools.partial(dense.occluded, bvh, use_kernels=use_kernels),
        )
    if backend == "cluster":
        from tpu_pt_torch.bvh import cluster as cluster_mod

        if bvh is None:
            raise ValueError("backend='cluster' requires a ClusterBVH")
        return (
            functools.partial(cluster_mod.intersect, bvh,
                              use_kernels=use_kernels),
            functools.partial(cluster_mod.occluded, bvh,
                              use_kernels=use_kernels),
        )
    if backend == "packed":
        from tpu_pt_torch.bvh import packed as packed_mod

        if bvh is None:
            raise ValueError("backend='packed' requires a PackedBVH")
        return (
            functools.partial(packed_mod.intersect, bvh,
                              use_kernels=use_kernels),
            functools.partial(packed_mod.occluded, bvh,
                              use_kernels=use_kernels),
        )
    raise ValueError(f"unknown backend {backend!r}: this package has "
                     f"{', '.join(BACKENDS)}")


def _intersectors_counted(backend: str, bvh=None, use_kernels: bool = True,
                          pair_stage: str = "fused"):
    """Like ``_intersectors``, but each call ALSO returns the
    capacity-contract overflow count (candidates truncated by static
    budgets).  The cluster backend reports real counts (``pair_stage``
    selects the form of its pair stage, see ``bvh/cluster.py``); every
    other backend is exact by construction and returns a constant 0 (and
    ignores ``narrow`` and ``pair_stage``)."""
    if backend == "cluster":
        from tpu_pt_torch.bvh import cluster as cluster_mod

        if bvh is None:
            raise ValueError("backend='cluster' requires a ClusterBVH")
        cluster_mod._check_pair_stage(pair_stage)
        return (
            functools.partial(cluster_mod.intersect_counted, bvh,
                              use_kernels=use_kernels, pair_stage=pair_stage),
            functools.partial(cluster_mod.occluded_counted, bvh,
                              use_kernels=use_kernels, pair_stage=pair_stage),
        )
    isect, occl = _intersectors(backend, bvh, use_kernels)

    def isect_c(scene, ro, rd, t_min, t_max):
        zero = torch.zeros((), dtype=torch.int64, device=ro.device)
        return isect(scene, ro, rd, t_min, t_max), zero

    def occl_c(scene, ro, rd, t_max, narrow=False):
        del narrow  # exact backends have no pair budget
        zero = torch.zeros((), dtype=torch.int64, device=ro.device)
        return occl(scene, ro, rd, t_max), zero

    return isect_c, occl_c


def _intersectors_suspect(backend: str, bvh=None, use_kernels: bool = True,
                          pair_stage: str = "fused"):
    """Like ``_intersectors_counted``, but each call also returns the
    per-ray SUSPECT mask ((R,) bool: this ray's candidates were cut by a
    static budget, so its result may have lost a hit).  Backends that are
    exact by construction return all False."""
    if backend == "cluster":
        from tpu_pt_torch.bvh import cluster as cluster_mod

        if bvh is None:
            raise ValueError("backend='cluster' requires a ClusterBVH")
        cluster_mod._check_pair_stage(pair_stage)

        def isect_s(scene, ro, rd, t_min, t_max):
            sus = []
            hit, novf = cluster_mod.intersect_counted(
                bvh, scene, ro, rd, t_min, t_max, use_kernels=use_kernels,
                pair_stage=pair_stage, suspect_out=sus)
            return hit, novf, sus[0]

        def occl_s(scene, ro, rd, t_max, narrow=False):
            sus = []
            occ, novf = cluster_mod.occluded_counted(
                bvh, scene, ro, rd, t_max, narrow=narrow,
                use_kernels=use_kernels, pair_stage=pair_stage,
                suspect_out=sus)
            return occ, novf, sus[0]

        return isect_s, occl_s
    isect_c, occl_c = _intersectors_counted(backend, bvh, use_kernels,
                                            pair_stage)

    def isect_s(scene, ro, rd, t_min, t_max):
        hit, novf = isect_c(scene, ro, rd, t_min, t_max)
        return hit, novf, torch.zeros((ro.shape[0],), dtype=torch.bool,
                                      device=ro.device)

    def occl_s(scene, ro, rd, t_max, narrow=False):
        occ, novf = occl_c(scene, ro, rd, t_max, narrow=narrow)
        return occ, novf, torch.zeros((ro.shape[0],), dtype=torch.bool,
                                      device=ro.device)

    return isect_s, occl_s


def _on_device(device, scene, cam, bvh):
    """Resolve the entry points' ``device`` argument and move the inputs.
    Raises when a CUDA device is asked for and none is present."""
    device = resolve_device(device)
    return (device, scene.to(device), cam.to(device),
            bvh.to(device) if bvh is not None else None)


@torch.no_grad()
def render(scene: Scene, cam, cfg: RenderConfig, key, backend: str = "brute",
           bvh=None, pix_chunk: Optional[int] = None, device="cuda",
           use_kernels: bool = True):
    """Render to a (H, W, 3) linear-radiance tensor on ``device`` (row 0 =
    bottom row).  ``key`` is a pair of 32-bit ints.

    Each chunk is ``pix_chunk`` whole pixels × ``spp`` samples.  By default
    the brute backend keeps ``1 << 22`` ray × primitive pairs resident at
    once and the others take ``(1 << 17) // spp`` pixels a chunk.  A tail
    chunk is padded by re-rendering the last pixel."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    if pix_chunk is None:
        if backend == "brute":
            budget = 1 << 22  # ray × prim pairs resident at once
            pix_chunk = max(1, budget // max(1, cfg.spp * scene.n_prims))
        else:
            pix_chunk = max(1, (1 << 17) // cfg.spp)
        pix_chunk = min(pix_chunk, cfg.n_pixels)
    return _render_chunks(scene, cam, cfg, key,
                          *_intersectors(backend, bvh, use_kernels),
                          pix_chunk)


@torch.no_grad()
def _render_chunks(scene: Scene, cam, cfg: RenderConfig, key, isect, occl,
                   pix_chunk: int):
    """``render``'s loop over chunks of ``pix_chunk`` whole pixels on the
    device of ``scene`` (and ``cam``), through the intersectors given."""
    device = scene.vertices.device
    n_pix = cfg.n_pixels
    img = torch.zeros((n_pix, 3), dtype=scene.vertices.dtype, device=device)
    spp_ids = torch.arange(cfg.spp, device=device).repeat(pix_chunk)
    for start in range(0, n_pix, pix_chunk):
        ids = torch.arange(start, start + pix_chunk, device=device)
        ids = ids.clamp_max(n_pix - 1)  # tail padding re-renders last pixel
        pixel_ids = ids.repeat_interleave(cfg.spp)
        L = render_chunk(scene, cam, cfg, key, pixel_ids, spp_ids, isect, occl)
        L = L.reshape(pix_chunk, cfg.spp, 3).mean(dim=1)
        end = min(start + pix_chunk, n_pix)
        img[start:end] = L[: end - start]
    return img.reshape(cfg.height, cfg.width, 3)
