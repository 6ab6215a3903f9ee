"""Intersector selection for the renderers."""

from __future__ import annotations

import functools

import torch

from tpu_pt_torch.render import brute


def _intersectors_counted(backend: str, bvh=None, use_kernels: bool = True):
    """(intersect, occluded) closures that ALSO return the capacity-contract
    overflow count (candidates truncated by static budgets).  The cluster
    backend reports real counts; the brute backend is exact by construction
    and returns a constant 0.  ``use_kernels=False`` runs the cluster
    backend through the plain PyTorch versions of its kernels."""
    if backend == "cluster":
        from tpu_pt_torch.bvh import cluster as cluster_mod

        if bvh is None:
            raise ValueError("backend='cluster' requires a ClusterBVH")
        return (
            functools.partial(cluster_mod.intersect_counted, bvh,
                              use_kernels=use_kernels),
            functools.partial(cluster_mod.occluded_counted, bvh,
                              use_kernels=use_kernels),
        )
    if backend != "brute":
        raise ValueError(f"unknown backend {backend!r}")

    def isect_c(scene, ro, rd, t_min, t_max):
        zero = torch.zeros((), dtype=torch.int64, device=ro.device)
        return brute.intersect(scene, ro, rd, t_min, t_max), zero

    def occl_c(scene, ro, rd, t_max, narrow=False):
        del narrow  # exact backends have no pair budget
        zero = torch.zeros((), dtype=torch.int64, device=ro.device)
        return brute.occluded(scene, ro, rd, t_max), zero

    return isect_c, occl_c
