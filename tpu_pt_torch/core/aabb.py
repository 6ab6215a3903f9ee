"""Axis-aligned bounding boxes: the slab test and union helpers, batched
over rays and boxes with broadcasting."""

from __future__ import annotations

import torch


def slab_test(ro, rd_inv, bb_min, bb_max, t_min, t_max):
    """Ray-AABB slab test.

    ro: (..., 3) ray origin; rd_inv: (..., 3) 1 / direction (±inf where a
    component is 0); bb_min, bb_max: (..., 3); t_min, t_max: (..., 1).

    Returns (hit (..., 1) bool, t_near (..., 1)): the entry distance,
    clamped to t_min.  An axis-parallel ray whose origin lies on a slab
    plane gives 0 * inf = NaN there: a NaN near becomes -inf and a NaN far
    +inf, so that axis sets no bound."""
    lo = (bb_min - ro) * rd_inv
    hi = (bb_max - ro) * rd_inv
    near = torch.minimum(lo, hi)
    far = torch.maximum(lo, hi)
    near = torch.where(torch.isnan(near), -float("inf"), near)
    far = torch.where(torch.isnan(far), float("inf"), far)
    t_near = torch.maximum(torch.amax(near, dim=-1, keepdim=True), t_min)
    t_far = torch.minimum(torch.amin(far, dim=-1, keepdim=True), t_max)
    return t_near <= t_far, t_near


def union(bb_min_a, bb_max_a, bb_min_b, bb_max_b):
    return torch.minimum(bb_min_a, bb_min_b), torch.maximum(bb_max_a, bb_max_b)


def surface_area(bb_min, bb_max):
    d = torch.clamp_min(bb_max - bb_min, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                  + d[..., 2] * d[..., 0])
