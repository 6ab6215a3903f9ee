"""Host-side binned-SAH BVH builder -> flat skip-pointer layout, and the
primitive bounds every host builder starts from.

Nodes are emitted in DFS pre-order with a *skip pointer* (escape index), so
a walk is stackless: each ray carries one node cursor.
  - node 0 is the root; an inner node's first (left) child is node i + 1;
  - ``skip[i]`` is the next DFS node when the box test misses (or after a
    leaf's primitives are tested); the last DFS node's skip is N (done);
  - leaves have ``prim_count > 0`` and reference
    ``prim_ids[start:start + count]``, a chunk of the global primitive
    index space ([0, T) triangles, [T, T + S) spheres);
  - every primitive is in exactly one leaf; parent boxes contain children.

``build_bvh`` is the Python builder: the tree of the flat walk (backend
``"bvh"``, ``bvh/flat.py``) and the builder the cluster and packed builds
fall back to where the native library cannot be built
(``bvh/native.py``).  It is numpy on the host, in the JAX package's
arithmetic and tie order, so its trees equal that package's array for array.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pt_torch.scene.types import Scene, as_tensor

MAX_LEAF = 4
N_BINS = 16


class FlatBVH(NamedTuple):
    """Host numpy arrays from ``build_bvh``; tensors after ``to(device)``."""

    node_min: object    # (N, 3) f32
    node_max: object    # (N, 3) f32
    skip: object        # (N,) i32 — escape index; N == walk done
    prim_start: object  # (N,) i32 — into prim_ids (leaves only)
    prim_count: object  # (N,) i32 — 0 for inner nodes
    prim_ids: object    # (P,) i32 — permuted global primitive ids

    @property
    def n_nodes(self) -> int:
        return self.skip.shape[0]

    def to(self, device) -> "FlatBVH":
        """Contiguous tensors on ``device`` (no copy where already there)."""
        def dev(x):
            x = x if torch.is_tensor(x) else torch.from_numpy(
                np.ascontiguousarray(x))
            return x.to(device).contiguous()

        return FlatBVH(*(dev(x) for x in self))


def prim_bounds(scene: Scene):
    """(lo, hi) (P, 3) f32 bounds of the primitives, triangles then spheres,
    for the combined index space: tensors on the device of the scene's
    tensors, or on the CPU where it holds host arrays (``.numpy()`` them)."""
    v, ti = as_tensor(scene.vertices), as_tensor(scene.tri_idx).long()
    p0, p1, p2 = v[ti[:, 0]], v[ti[:, 1]], v[ti[:, 2]]
    c = as_tensor(scene.sph_center)
    r = as_tensor(scene.sph_radius)[:, None]
    lo = torch.cat([torch.minimum(torch.minimum(p0, p1), p2), c - r])
    hi = torch.cat([torch.maximum(torch.maximum(p0, p1), p2), c + r])
    return lo.detach().float(), hi.detach().float()


def _sah_split(ids, lo, hi, cent):
    """Choose a binned-SAH split of ``ids``: (left_ids, right_ids).  The
    centroid extent picks the axis; a degenerate extent, or no split with
    primitives on both sides, halves the ids (the latter in stable
    centroid order)."""
    count = len(ids)
    c = cent[ids]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] <= 1e-12:
        half = count // 2
        return ids[:half], ids[half:]
    rel = (c[:, axis] - cmin[axis]) / ext[axis]
    bins = np.minimum((rel * N_BINS).astype(np.int32), N_BINS - 1)
    counts = np.bincount(bins, minlength=N_BINS)
    # Per-bin boxes by segmented min / max.
    bin_lo = np.full((N_BINS, 3), np.inf, np.float32)
    bin_hi = np.full((N_BINS, 3), -np.inf, np.float32)
    np.minimum.at(bin_lo, bins, lo[ids])
    np.maximum.at(bin_hi, bins, hi[ids])

    def sa(lo_a, hi_a):
        d = np.maximum(hi_a - lo_a, 0.0)
        return 2 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                    + d[..., 2] * d[..., 0])

    pre_lo = np.minimum.accumulate(bin_lo, axis=0)
    pre_hi = np.maximum.accumulate(bin_hi, axis=0)
    suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
    suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
    pre_n = np.cumsum(counts)
    nl = pre_n[:-1].astype(np.float64)
    nr = count - nl
    cost = sa(pre_lo[:-1], pre_hi[:-1]) * nl + sa(suf_lo[1:], suf_hi[1:]) * nr
    cost = np.where((nl == 0) | (nr == 0), np.inf, cost)
    s_best = int(np.argmin(cost))
    if not np.isfinite(cost[s_best]):
        half = count // 2
        part = np.argsort(c[:, axis], kind="stable")
        return ids[part[:half]], ids[part[half:]]
    mask = bins <= s_best
    return ids[mask], ids[~mask]


def build_bvh(scene: Scene, max_leaf: int = MAX_LEAF) -> FlatBVH:
    """Top-down binned-SAH build of a host scene into the flat layout.

    Built in DFS pre-order with an explicit stack: a popped node's header
    is emitted at the next index, and pushing the right child before the
    left one emits the left subtree contiguously at parent + 1.  An inner
    node's skip is patched once its subtree is emitted (a "patch" item
    below its children on the stack); a leaf's skip is its index + 1."""
    lo, hi = (x.numpy() for x in prim_bounds(scene))
    n = lo.shape[0]
    cent = (lo + hi) * 0.5
    prim_perm = np.empty(n, dtype=np.int32)
    out_lo, out_hi = [], []
    out_start, out_count = [], []
    skip_fix = []    # (node index, skip target; None for a leaf)

    # Each stack item: ("node", ids, offset) or ("patch", node index).
    stack = [("node", np.arange(n, dtype=np.int32), 0)]
    while stack:
        item = stack.pop()
        if item[0] == "patch":
            skip_fix.append((item[1], len(out_lo)))
            continue
        _, ids, off = item
        idx = len(out_lo)
        out_lo.append(lo[ids].min(axis=0))
        out_hi.append(hi[ids].max(axis=0))
        if len(ids) <= max_leaf:
            out_start.append(off)
            out_count.append(len(ids))
            prim_perm[off:off + len(ids)] = ids
            skip_fix.append((idx, None))
            continue
        out_start.append(0)
        out_count.append(0)
        left_ids, right_ids = _sah_split(ids, lo, hi, cent)
        stack.append(("patch", idx))
        stack.append(("node", right_ids, off + len(left_ids)))
        stack.append(("node", left_ids, off))

    skip = np.empty(len(out_lo), np.int32)
    for idx, target in skip_fix:
        skip[idx] = idx + 1 if target is None else target
    return FlatBVH(
        node_min=np.asarray(out_lo, np.float32),
        node_max=np.asarray(out_hi, np.float32),
        skip=skip,
        prim_start=np.asarray(out_start, np.int32),
        prim_count=np.asarray(out_count, np.int32),
        prim_ids=prim_perm,
    )
