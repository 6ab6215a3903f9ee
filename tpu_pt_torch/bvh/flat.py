"""Stackless walk of the flat skip-pointer SAH BVH (``bvh/sah.py``):
backend ``"bvh"`` of the oracle and wavefront renderers.

Every ray carries one node cursor: gather the node, slab test, test up to
``MAX_LEAF`` primitives at a leaf, then go to ``cursor + 1`` (an inner node
entered) or ``skip`` (a miss, or after a leaf).  Nearest hit at the lowest
primitive id at equal t; the any-hit form stops a ray at its first hit.
The walk itself is ``kernels/flat_walk.py``: a CUDA kernel on the card, its
plain version on the CPU.  Its default design, the row walk, reads the
tables :func:`row_tables` builds once per (BVH, scene), and on the card
raises without them; :func:`intersectors` builds them once for every call
of a render.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from tpu_pt_torch.bvh.native import prim_rows
from tpu_pt_torch.bvh.sah import MAX_LEAF, FlatBVH
from tpu_pt_torch.core.intersect import INF, as_col
from tpu_pt_torch.kernels.flat_walk import (FlatRows, _check_design,
                                            flat_walk, flat_walk_ref)
from tpu_pt_torch.render.brute import Hit
from tpu_pt_torch.scene.types import Scene


# The scene arrays a primitive row is made of.
_PRIM_FIELDS = ("vertices", "tri_idx", "tri_mat", "sph_center", "sph_radius",
                "sph_mat")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def check_preorder(skip, prim_count) -> None:
    """Raise ``ValueError`` unless the table is one the row walk can take:
    every node's skip points forward and inside the table (``i < skip[i] <=
    n``) and every leaf's skip is its own index + 1 (so that ``cursor + 1``
    follows a leaf).  ``build_bvh``'s preorder tables have both."""
    skip, count = _host(skip), _host(prim_count)
    idx = np.arange(skip.shape[0])
    bad = np.flatnonzero((skip <= idx) | (skip > skip.shape[0]))
    if bad.size:
        i = int(bad[0])
        raise ValueError(f"flat BVH node {i}: skip {int(skip[i])} is not in "
                         f"({i}, {skip.shape[0]}]")
    bad = np.flatnonzero((count > 0) & (skip != idx + 1))
    if bad.size:
        i = int(bad[0])
        raise ValueError(f"flat BVH leaf {i}: skip {int(skip[i])} is not its "
                         f"index + 1")


def row_tables(bvh: FlatBVH, scene: Scene) -> FlatRows:
    """The row walk's tables of ``bvh`` over ``scene`` (``FlatRows``), on
    the device of ``bvh``'s arrays: node rows [min.xyz, max.xyz, link,
    count] (link: skip for an inner node, prim_start for a leaf) and the
    packed primitive rows (``native.prim_rows``) in ``prim_ids`` slot
    order, with the ids beside them.  Raises where the table breaks
    :func:`check_preorder`.  Bits are copied, never computed, except a
    triangle's edges v1 - v0 and v2 - v0 (one f32 rounding each, as the
    thread walk forms them)."""
    check_preorder(bvh.skip, bvh.prim_count)
    dev = bvh.skip.device if torch.is_tensor(bvh.skip) else "cpu"
    count = _host(bvh.prim_count).astype(np.int32)
    link = np.where(count > 0, _host(bvh.prim_start),
                    _host(bvh.skip)).astype(np.int32)
    nodes = np.concatenate(
        [_host(bvh.node_min).astype(np.float32).view(np.int32),
         _host(bvh.node_max).astype(np.float32).view(np.int32),
         link[:, None], count[:, None]], axis=1).view(np.float32)
    host = SimpleNamespace(**{f: _host(getattr(scene, f))
                              for f in _PRIM_FIELDS})
    pid = _host(bvh.prim_ids).astype(np.int32)
    return FlatRows(node_rows=torch.from_numpy(np.ascontiguousarray(nodes)),
                    prim_rows=prim_rows(host, pid),
                    prim_gid=torch.from_numpy(pid.copy())).to(dev)


def _walk(bvh: FlatBVH, scene: Scene, ro, rd, t_min, t_max, any_hit: bool,
          use_kernels: bool, design: str, rows):
    _check_design(design)
    args = (bvh.node_min, bvh.node_max, bvh.skip, bvh.prim_start,
            bvh.prim_count, bvh.prim_ids, scene.tri_idx, scene.vertices,
            scene.sph_center, scene.sph_radius, ro.contiguous(),
            rd.contiguous(), t_min[:, 0].contiguous(),
            t_max[:, 0].contiguous(), MAX_LEAF)
    if not use_kernels:
        return flat_walk_ref(*args, any_hit=any_hit)
    return flat_walk(*args, any_hit=any_hit, design=design, rows=rows)


def intersect(bvh: FlatBVH, scene: Scene, ro, rd, t_min, t_max,
              use_kernels: bool = True, design: str = "rows",
              rows: FlatRows | None = None) -> Hit:
    """Nearest hit: ro, rd (R, 3); t_min, t_max scalars or (R, 1).
    ``found`` where the walk's best t is below t_max (strict).
    ``use_kernels=False`` runs the plain version on any device.  design:
    the walk's (``kernels/flat_walk.py``); ``rows``: the row walk's tables
    of this BVH and scene (:func:`row_tables`), which the row walk on the
    card needs (it raises without them; :func:`intersectors` builds them
    once a render).  On the CPU the plain version reads them where given
    and the arrays otherwise, the same bits."""
    R = ro.shape[0]
    t_min = as_col(t_min, R, ro.device)
    t_max = as_col(t_max, R, ro.device)
    best_t, prim, u, v = _walk(bvh, scene, ro, rd, t_min, t_max, False,
                               use_kernels, design, rows)
    best_t = best_t[:, None]
    found = best_t < t_max
    return Hit(hit=found,
               t=torch.where(found, best_t, torch.full_like(best_t, INF)),
               prim=prim, u=u[:, None], v=v[:, None])


def occluded(bvh: FlatBVH, scene: Scene, ro, rd, t_max,
             use_kernels: bool = True, design: str = "rows",
             rows: FlatRows | None = None):
    """Any-hit test over [0, t_max]: (R, 1) bool.  Arguments as
    :func:`intersect`'s."""
    R = ro.shape[0]
    t_min = torch.zeros((R, 1), dtype=torch.float32, device=ro.device)
    occ = _walk(bvh, scene, ro, rd, t_min, as_col(t_max, R, ro.device), True,
                use_kernels, design, rows)
    return occ[:, None]


def intersectors(bvh: FlatBVH, use_kernels: bool = True,
                 design: str = "rows"):
    """(intersect, occluded) closures over ``bvh`` taking ``(scene, ...)``,
    as the renderers call them.  The row tables are built at the first call
    and kept while the scene's primitive arrays are the same tensors,
    unchanged in place (a renderer hands every call a detached view of one
    scene, which shares its tensors' version counters), so a render builds
    them once, not once a call."""
    _check_design(design)
    kept = {}

    def rows_of(scene):
        if not use_kernels or design != "rows":
            return None
        key = tuple((x.data_ptr(), tuple(x.shape), x._version)
                    for x in (getattr(scene, f) for f in _PRIM_FIELDS))
        if kept.get("key") != key:
            # The scene is kept too, so that its memory is not reused by
            # other arrays while the key names it.
            kept.update(key=key, scene=scene, rows=row_tables(bvh, scene))
        return kept["rows"]

    def isect(scene, ro, rd, t_min, t_max):
        return intersect(bvh, scene, ro, rd, t_min, t_max, use_kernels,
                         design, rows_of(scene))

    def occl(scene, ro, rd, t_max):
        return occluded(bvh, scene, ro, rd, t_max, use_kernels, design,
                        rows_of(scene))

    return isect, occl
