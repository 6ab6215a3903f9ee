"""Stackless walk of the flat skip-pointer SAH BVH (``bvh/sah.py``):
backend ``"bvh"`` of the oracle and wavefront renderers.

Every ray carries one node cursor: gather the node, slab test, test up to
``MAX_LEAF`` primitives at a leaf, then go to ``cursor + 1`` (an inner node
entered) or ``skip`` (a miss, or after a leaf).  Nearest hit at the lowest
primitive id at equal t; the any-hit form stops a ray at its first hit.
The walk itself is ``kernels/flat_walk.py``: a CUDA kernel on the card, its
plain version on the CPU.
"""

from __future__ import annotations

import torch

from tpu_pt_torch.bvh.sah import MAX_LEAF, FlatBVH
from tpu_pt_torch.core.intersect import INF, as_col
from tpu_pt_torch.kernels.flat_walk import flat_walk, flat_walk_ref
from tpu_pt_torch.render.brute import Hit
from tpu_pt_torch.scene.types import Scene


def _walk(bvh: FlatBVH, scene: Scene, ro, rd, t_min, t_max, any_hit: bool,
          use_kernels: bool):
    walk = flat_walk if use_kernels else flat_walk_ref
    return walk(bvh.node_min, bvh.node_max, bvh.skip, bvh.prim_start,
                bvh.prim_count, bvh.prim_ids, scene.tri_idx, scene.vertices,
                scene.sph_center, scene.sph_radius, ro.contiguous(),
                rd.contiguous(), t_min[:, 0].contiguous(),
                t_max[:, 0].contiguous(), MAX_LEAF, any_hit=any_hit)


def intersect(bvh: FlatBVH, scene: Scene, ro, rd, t_min, t_max,
              use_kernels: bool = True) -> Hit:
    """Nearest hit: ro, rd (R, 3); t_min, t_max scalars or (R, 1).
    ``found`` where the walk's best t is below t_max (strict).
    ``use_kernels=False`` runs the plain version on any device."""
    R = ro.shape[0]
    t_min = as_col(t_min, R, ro.device)
    t_max = as_col(t_max, R, ro.device)
    best_t, prim, u, v = _walk(bvh, scene, ro, rd, t_min, t_max, False,
                               use_kernels)
    best_t = best_t[:, None]
    found = best_t < t_max
    return Hit(hit=found,
               t=torch.where(found, best_t, torch.full_like(best_t, INF)),
               prim=prim, u=u[:, None], v=v[:, None])


def occluded(bvh: FlatBVH, scene: Scene, ro, rd, t_max,
             use_kernels: bool = True):
    """Any-hit test over [0, t_max]: (R, 1) bool."""
    R = ro.shape[0]
    t_min = torch.zeros((R, 1), dtype=torch.float32, device=ro.device)
    occ = _walk(bvh, scene, ro, rd, t_min, as_col(t_max, R, ro.device), True,
                use_kernels)
    return occ[:, None]
