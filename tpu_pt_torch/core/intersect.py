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


def sphere_hit(ocx, ocy, ocz, dx, dy, dz, r, t_min, t_max):
    """The ray-sphere solve of every intersector of the package, written
    out in ``csrc/pair_isect_common.cuh::sphere_hit``'s operation order,
    one rounding per operation, so that each kernel agrees with its plain
    version bit for bit.  oc = origin - centre, d the direction (any
    length), r the radius, one component a tensor; all broadcast.  Returns
    (hit, t): t is the near root where it lies in [t_min, t_max], else the
    far one, and means nothing where hit is False.

    The well-conditioned float32 form of Haines et al., "Precision
    Improvements for Ray/Sphere Intersection" (Ray Tracing Gems, ch. 7):
    the discriminant is a (r^2 - |l|^2), l = oc - (b/a) d the centre's
    offset from the ray's nearest point, which does not cancel near
    tangency as b^2 - ac does; the roots are q/a and c/q, q = -b - sign(b)
    sqrt(disc), and neither cancels when the origin lies on the sphere
    (c ~ 0: every ray leaving the glass or the mirror), as -b + sqrt(disc)
    does.  b/a and q/a multiply by one reciprocal 1/a (two divisions in
    all, which keeps the kernels' registers down).  A miss where disc <= 0
    (a radius-0 sphere, such as the placeholder of a scene without spheres,
    has disc <= 0 for every ray), where q = 0, and where a = 0 (b/a and so
    disc are NaN there)."""
    rr = r * r
    a = dx * dx + dy * dy + dz * dz
    b = ocx * dx + ocy * dy + ocz * dz      # half the quadratic's b
    c = ocx * ocx + ocy * ocy + ocz * ocz - rr
    inv_a = 1.0 / a
    k = b * inv_a
    lx = ocx - k * dx
    ly = ocy - k * dy
    lz = ocz - k * dz
    disc = a * (rr - (lx * lx + ly * ly + lz * lz))
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    q = torch.where(b < 0, sq - b, -b - sq)
    r0 = q * inv_a
    r1 = c / q
    swap = r1 < r0
    s0 = torch.where(swap, r1, r0)
    s1 = torch.where(swap, r0, r1)
    has = (disc > 0) & (q != 0)
    ok0 = has & (s0 >= t_min) & (s0 <= t_max)
    ok1 = has & (s1 >= t_min) & (s1 <= t_max)
    return ok0 | ok1, torch.where(ok0, s0, s1)


def ray_sphere(ro, rd, center, radius, t_min, t_max):
    """Ray-sphere solve (:func:`sphere_hit`); radius is (..., 1).  Returns
    (hit, t, n_unscaled) where n_unscaled = hitpoint - center."""
    oc = ro - center
    hit, t = sphere_hit(oc[..., 0:1], oc[..., 1:2], oc[..., 2:3],
                        rd[..., 0:1], rd[..., 1:2], rd[..., 2:3], radius,
                        t_min, t_max)
    t = torch.where(hit, t, torch.full_like(t, INF))
    n_unscaled = (ro + t * rd) - center
    return hit, t, n_unscaled
