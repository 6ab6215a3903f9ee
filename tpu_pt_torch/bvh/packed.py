"""Packed BVH: octant-ordered skip-pointer node tables and primitive rows in
one table, walked by one ray at a time.

The table is (K*N + P, 16) f32: K = 8 node tables of N rows each, one per
octant of the ray direction (the same tree, children swapped so that the
child nearer along the direction's signs comes first), then the P
primitive rows in leaf order.
  node row: [min.xyz, max.xyz, skip (i32 bits), meta (i32 bits), 0 x 8];
            meta -1 for an inner node, else ``start | (count << 26)``.
  prim row: triangle [v0, e1, e2, material bits, 0 (type), pad];
            sphere   [centre, r, 0 0, 0 0 0, material bits, 1 (type), pad].
``prim_gid`` maps a row slot to its global primitive id.

It is the exact fallback of the cluster BVH (``bvh/cluster.py::
attach_fallback``) and a backend of its own (``"packed"`` in
``render/driver.py``).  The tables come from the native builder
(``bvh/native.py::build_packed``) or, from a flat SAH tree, from
``pack_bvh`` (``native.build_packed_any`` takes the second where the first
cannot be built).  The walk is ``kernels/packed_walk.py``: a CUDA kernel on
the card (the window design, or with ``design="thread"`` its twin), its
plain version on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pt_torch.bvh.native import prim_rows
from tpu_pt_torch.bvh.sah import FlatBVH
from tpu_pt_torch.core.intersect import INF, as_col
from tpu_pt_torch.kernels.packed_walk import (  # noqa: F401 (re-exported)
    _octant_of, _prim_row_test, packed_walk, packed_walk_ref)
from tpu_pt_torch.render.brute import Hit
from tpu_pt_torch.scene.types import Scene


class PackedBVH(NamedTuple):
    """table: (n_tables * n_nodes + P, 16) f32; prim_gid: (P,) i32 (numpy
    on the host, tensors after ``.to(device)``); max_leaf: rows a leaf may
    hold (the walk tests at most that many)."""

    table: object
    prim_gid: object
    max_leaf: int
    n_tables: int
    n_nodes: int

    @staticmethod
    def build(nodes, prims, prim_gid, max_leaf: int = 4) -> "PackedBVH":
        """Assemble from host numpy parts: nodes (K, N, 8), prims (P, 16)."""
        k, n, _ = nodes.shape
        p = prims.shape[0]
        table = np.zeros((k * n + p, 16), np.float32)
        table[: k * n, :8] = nodes.reshape(k * n, 8)
        table[k * n:] = prims
        return PackedBVH(table=table, prim_gid=np.asarray(prim_gid, np.int32),
                         max_leaf=int(max_leaf), n_tables=int(k),
                         n_nodes=int(n))

    def to(self, device) -> "PackedBVH":
        """Tensors on ``device`` (no copy where they are there already)."""
        def dev(x):
            x = x if torch.is_tensor(x) else torch.from_numpy(
                np.ascontiguousarray(x))
            return x.to(device).contiguous()

        return self._replace(table=dev(self.table),
                             prim_gid=dev(self.prim_gid))

    @property
    def prim_base(self) -> int:
        return self.n_tables * self.n_nodes

    @property
    def n_prims(self) -> int:
        return self.prim_gid.shape[0]

    def node_rows(self) -> np.ndarray:
        """(K, N, 8) numpy copy of the node tables (tests, introspection)."""
        t = self.table[: self.prim_base, :8]
        t = t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
        return t.reshape(self.n_tables, self.n_nodes, 8)


def _subtree_sizes(skip, prim_count):
    """Node count of every subtree of the flat layout, O(N): children have
    larger indices, so one pass from the last node up."""
    n = len(skip)
    size = np.ones(n, np.int64)
    for i in range(n - 1, -1, -1):
        if prim_count[i] == 0:
            left = i + 1
            right = skip[left]
            size[i] = 1 + size[left] + size[right]
    return size


def _octant_tables(bvh: FlatBVH):
    """The 8 octant-ordered node tables (8, N, 8) of a flat BVH (host
    numpy): table k is the tree in the DFS order where, at each inner node,
    the child whose centroid is lower along the node's widest axis comes
    first, swapped where that axis' sign bit of k is set (a ray with that
    direction sign meets the other child first)."""
    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    skip = np.asarray(bvh.skip)
    start = np.asarray(bvh.prim_start)
    count = np.asarray(bvh.prim_count)
    n = len(skip)
    sizes = _subtree_sizes(skip, count)
    wide_axis = np.argmax(node_max - node_min, axis=1)
    cent_sum = node_min + node_max  # 2 x centroid

    tables = np.empty((8, n, 8), np.float32)
    for octant in range(8):
        sign = (bool(octant & 1), bool(octant & 2), bool(octant & 4))
        perm = np.empty(n, np.int64)
        new_skip = np.empty(n, np.int32)
        cursor = 0
        stack = [(0, n)]
        while stack:
            old, skip_to = stack.pop()
            new = cursor
            cursor += 1
            perm[new] = old
            new_skip[new] = skip_to
            if count[old] > 0:
                continue
            left = old + 1
            right = skip[left]
            axis = wide_axis[old]
            first, second = (
                (left, right)
                if cent_sum[left][axis] <= cent_sum[right][axis]
                else (right, left)
            )
            if sign[axis]:
                first, second = second, first
            stack.append((second, skip_to))
            stack.append((first, new + 1 + sizes[first]))
        t = tables[octant]
        t[:, 0:3] = node_min[perm]
        t[:, 3:6] = node_max[perm]
        t[:, 6] = new_skip.view(np.float32)
        meta = np.where(
            count[perm] > 0,
            (start[perm] | (count[perm] << 26)).astype(np.int32),
            np.int32(-1),
        )
        t[:, 7] = meta.view(np.float32)
    return tables


def pack_bvh(bvh: FlatBVH, scene: Scene, max_leaf: int = 4) -> PackedBVH:
    """A flat SAH tree (``bvh/sah.py::build_bvh``) of a host scene ->
    ``PackedBVH`` (host numpy): its octant tables and the primitive rows in
    leaf order."""
    pid = np.asarray(bvh.prim_ids)
    return PackedBVH.build(nodes=_octant_tables(bvh),
                           prims=prim_rows(scene, pid).numpy(), prim_gid=pid,
                           max_leaf=max_leaf)


def _traverse(packed: PackedBVH, ro, rd, t_min, t_max, any_hit: bool,
              use_kernels: bool = True, design: str = "window"):
    """The walk for rays ro, rd (R, 3) over [t_min, t_max] ((R, 1) each):
    the kernel of ``design`` (``packed_walk``, which takes CPU tensors to
    its plain version) or, with ``use_kernels=False``, the plain version on
    any device.  Returns (best_t (R, 1), slot (R,) i32, u (R, 1), v (R, 1)),
    or with ``any_hit`` occ (R, 1)."""
    args = (packed.table, packed.prim_gid, ro.contiguous(), rd.contiguous(),
            t_min[:, 0].contiguous(), t_max[:, 0].contiguous(),
            packed.n_nodes, packed.n_tables, packed.max_leaf)
    if use_kernels:
        out = packed_walk(*args, any_hit=any_hit, design=design)
    else:
        out = packed_walk_ref(*args, any_hit=any_hit)
    if any_hit:
        return out[:, None]
    t, slot, u, v = out
    return t[:, None], slot, u[:, None], v[:, None]


def intersect(packed: PackedBVH, scene: Scene, ro, rd, t_min, t_max,
              use_kernels: bool = True, design: str = "window") -> Hit:
    """Nearest hit of each ray: ``found`` where the walk's best t is below
    t_max (strict); lowest primitive id at equal t.  ``design`` names the
    walk kernel's design (``kernels.packed_walk.DESIGNS``)."""
    R = ro.shape[0]
    t_min = as_col(t_min, R, ro.device)
    t_max = as_col(t_max, R, ro.device)
    best_t, slot, u, v = _traverse(packed, ro, rd, t_min, t_max, False,
                                   use_kernels, design)
    found = best_t < t_max
    return Hit(hit=found,
               t=torch.where(found, best_t, torch.full_like(best_t, INF)),
               prim=packed.prim_gid[slot.long()], u=u, v=v)


def occluded(packed: PackedBVH, scene: Scene, ro, rd, t_max,
             use_kernels: bool = True, design: str = "window"):
    """Any-hit test over [0, t_max]: (R, 1) bool."""
    R = ro.shape[0]
    t_min = torch.zeros((R, 1), dtype=torch.float32, device=ro.device)
    return _traverse(packed, ro, rd, t_min, as_col(t_max, R, ro.device),
                     True, use_kernels, design)
