"""Primitive intersection: Möller–Trumbore ray-triangle and ray-sphere,
dense and batched with broadcasting; misses are masked, never skipped."""

from __future__ import annotations

import torch

from tpu_pt_torch.core.vecmath import cross, dot

# A plain Python float: "no hit" distance used across the package.
INF = 1e30


def as_col(t, R: int, device):
    """Scalar or (R, 1)-broadcastable ray bound -> (R, 1) f32 tensor."""
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    return t.expand(R, 1) if t.dim() else t.reshape(1, 1).expand(R, 1)


def ray_triangle(ro, rd, v0, e1, e2, t_min, t_max):
    """ro, rd, v0, e1, e2: (..., 3); t_min, t_max: (..., 1).  Returns
    (hit (..., 1) bool, t, u, v) with t = INF where no hit; u, v are the
    barycentrics of v1, v2."""
    pvec = cross(rd, e2)
    det = dot(e1, pvec)
    parallel = torch.abs(det) < 1e-12
    one = torch.ones_like(det)
    inv_det = torch.where(parallel, torch.zeros_like(det),
                          1.0 / torch.where(parallel, one, det))
    tvec = ro - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(rd, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = (
        (~parallel)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return hit, torch.where(hit, t, torch.full_like(t, INF)), u, v


def ray_sphere(ro, rd, center, radius, t_min, t_max):
    """Two-root ray-sphere solve; radius is (..., 1).  Returns (hit, t,
    n_unscaled) where n_unscaled = hitpoint - center."""
    oc = ro - center
    a = dot(rd, rd)
    b = 2.0 * dot(oc, rd)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    has_root = disc >= 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv2a = 1.0 / torch.clamp_min(2.0 * a, 1e-20)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    valid0 = has_root & (t0 >= t_min) & (t0 <= t_max)
    valid1 = has_root & (t1 >= t_min) & (t1 <= t_max)
    inf = torch.full_like(t0, INF)
    t = torch.where(valid0, t0, torch.where(valid1, t1, inf))
    hit = valid0 | valid1
    n_unscaled = (ro + t * rd) - center
    return hit, torch.where(hit, t, inf), n_unscaled
