"""Introspection render: the BVH traversal-cost heatmap.

Per-pixel node visits and leaf tests of the camera rays' walk over a packed
BVH (``bvh/packed.py``): the debugging image of a BVH and the signal for
tuning its quality.  The walk is the JAX package's XLA while-loop
(``tpu_pt/render/debug.py``), no kernel: plain torch ops on the device of
the BVH, one host read every ``_CHECK_EVERY`` rounds.  Its best t never
shrinks (it stays 1e30), so it counts the whole front-to-back walk.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pt_torch.core.camera import generate_rays, pixel_xy
from tpu_pt_torch.kernels.packed_walk import _octant_of

# Walk rounds between two host reads of "is any ray still walking": a ray
# that has finished stays at the end cursor and counts nothing, so the
# extra rounds change no count.
_CHECK_EVERY = 16


def _count_walk(table, n: int, n_tables: int, ro, rd):
    """Per-ray (visits, leaf_tests), int32, of a full closest-hit-style walk
    with best t fixed at 1e30.  Its cull stays the JAX heatmap's plain
    ``t_near <= t_far``, not the walks' ``widen_up`` bound: it counts
    visits, to be held to the JAX heatmap's counts, and picks no hit."""
    R = ro.shape[0]
    rd_inv = 1.0 / rd
    base = (_octant_of(rd) % n_tables) * n
    best_t = torch.full((R, 1), 1e30, dtype=torch.float32, device=ro.device)
    cur = torch.zeros((R,), dtype=torch.int64, device=ro.device)
    visits = torch.zeros((R,), dtype=torch.int32, device=ro.device)
    leafs = torch.zeros_like(visits)
    end = torch.full_like(cur, n)
    while bool(torch.any(cur < n)):
        for _ in range(_CHECK_EVERY):
            active = cur < n
            node = table[base + torch.where(active, cur, 0), :8]
            lo = (node[:, 0:3] - ro) * rd_inv
            hi = (node[:, 3:6] - ro) * rd_inv
            near = torch.minimum(lo, hi)
            far = torch.maximum(lo, hi)
            near = torch.where(torch.isnan(near), -torch.inf, near)
            far = torch.where(torch.isnan(far), torch.inf, far)
            tn = torch.clamp_min(near.amax(-1, keepdim=True), 0.0)
            tf = torch.minimum(far.amin(-1, keepdim=True), best_t)
            hit = (tn <= tf)[:, 0] & active
            bits = node[:, 6:8].contiguous().view(torch.int32)
            skip, is_leaf = bits[:, 0].long(), bits[:, 1] >= 0
            visits += active.int()
            leafs += (hit & is_leaf).int()
            nxt = torch.where(hit & ~is_leaf, cur + 1, skip)
            cur = torch.where(active, nxt, end)
    return visits, leafs


@torch.no_grad()
def bvh_heatmap(packed, cam, width: int, height: int):
    """-> dict with per-pixel visit and leaf-test counts ((H, W) int32
    numpy, row 0 the bottom row) and summary stats, for one camera ray
    through the centre of each pixel.  ``packed`` and ``cam`` hold tensors
    on one device (``PackedBVH.to``, ``Camera.to``)."""
    table = packed.table
    dev = table.device
    pix = torch.arange(width * height, device=dev)
    xy = pixel_xy(width, height, pix,
                  torch.full((width * height, 2), 0.5, device=dev))
    ro, rd = generate_rays(cam, xy)
    visits, leafs = _count_walk(table, packed.n_nodes, packed.n_tables,
                                ro, rd)
    visits = visits.reshape(height, width).cpu().numpy()
    leafs = leafs.reshape(height, width).cpu().numpy()
    return dict(
        visits=visits,
        leaf_tests=leafs,
        mean_visits=float(visits.mean()),
        max_visits=int(visits.max()),
        mean_leaf_tests=float(leafs.mean()),
    )


def heatmap_image(visits: np.ndarray):
    """Visit counts -> (H, W, 3) false-colour linear image (blue to red)."""
    v = visits.astype(np.float32)
    x = v / max(float(v.max()), 1.0)
    r = np.clip(2 * x - 0.5, 0, 1)
    g = 1.0 - np.abs(2 * x - 1.0)
    b = np.clip(1.0 - 2 * x, 0, 1)
    return np.stack([r, g, b], axis=-1)
