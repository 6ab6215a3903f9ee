"""The ray-sphere solve's witness: edge rays, and a float64 solve of the same
float32 inputs written independently of the port's.

The rays (:func:`edge_rays`), seeded, for one sphere, in five kinds:

- ``out``: origins on the sphere (the centre plus the radius along a random
  unit vector, rounded to float32, as a hit point is), moved out by the
  renderers' ray offset (``RenderConfig.eps``), leaving outward at 15 to 90
  degrees from the tangent plane: the ray after a mirror bounce, which
  must miss its own sphere;
- ``in``: the same, moved in by the offset and leaving inward: the ray
  after a refraction into the glass, which must hit the far side;
- ``tangent``: rays that pass the centre at the radius times 1 + e or 1 - e,
  |e| from 2^-12 to 2^-4, from 2 to 50 radii away;
- ``far``: rays from 10^2 to 10^4 radii away, aimed at random points inside
  0.99 of the sphere's outline;
- ``placeholder``: rays at the radius-0 sphere at (1e8, 1e8, 1e8) that
  stands in for the spheres of a scene without any
  (``scene/types.py::make_scene``), half of them aimed at its centre, and
  random rays.

The witness (:func:`solve64`) is the textbook quadratic, both roots, in
float64, its discriminant's sign settled exactly in rational arithmetic
where float64 cannot; :func:`ulp_error` measures a float32 t against it,
and :func:`as_float64` makes the float64 witness of a render.  Used by the
port's tests and ``chip_smoke.py``.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from tpu_pt_torch.config import RenderConfig

KINDS = ("out", "in", "tangent", "far", "placeholder")
EPS = RenderConfig().eps            # the renderers' ray offset
PLACEHOLDER = (np.full((3,), 1e8, np.float32), np.float32(0.0))


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _perp(rs, u):
    """A random unit vector at right angles to each row of ``u``."""
    w = _unit(rs, len(u))
    w -= np.sum(w * u, axis=1, keepdims=True) * u
    return w / np.linalg.norm(w, axis=1, keepdims=True)


def edge_rays(center, radius, kind: str, n: int, seed: int = 0):
    """``n`` rays of ``kind`` (see the module docstring) at the sphere
    (center (3,), radius): float32 numpy (ro (n, 3), rd (n, 3) unit,
    t_min (n,), t_max (n,)).  ``placeholder`` ignores the sphere."""
    rs = np.random.RandomState(seed)
    c = np.asarray(center, np.float64)
    r = float(radius)
    if kind in ("out", "in"):
        nrm = _unit(rs, n)
        p = (c + r * nrm).astype(np.float32).astype(np.float64)
        side = 1.0 if kind == "out" else -1.0
        cos = rs.uniform(0.25, 1.0, (n, 1))
        rd = side * (cos * nrm + np.sqrt(1.0 - cos * cos) * _perp(rs, nrm))
        ro = p + side * EPS * nrm
    elif kind == "tangent":
        rd = _unit(rs, n)
        e = rs.choice([-1.0, 1.0], n) * 2.0 ** -rs.uniform(4, 12, n)
        ro = (c + r * (1 + e)[:, None] * _perp(rs, rd)
              - rs.uniform(2, 50, (n, 1)) * r * rd)
    elif kind == "far":
        aim = c + 0.99 * r * _unit(rs, n) * rs.uniform(0, 1, (n, 1))
        ro = aim - 10 ** rs.uniform(2, 4, (n, 1)) * r * _unit(rs, n)
        rd = aim - ro
    elif kind == "placeholder":
        ro = rs.uniform(-3, 3, (n, 3))
        rd = np.where(np.arange(n)[:, None] % 2 == 0,
                      PLACEHOLDER[0].astype(np.float64) - ro, _unit(rs, n))
    else:
        raise ValueError(f"kind must be one of {KINDS}, not {kind!r}")
    rd = rd / np.linalg.norm(rd, axis=1, keepdims=True)
    return (ro.astype(np.float32), rd.astype(np.float32),
            np.zeros((n,), np.float32), np.full((n,), 1e30, np.float32))


def _quadratic(ro, rd, center, radius):
    """float64 (oc, A, B, C) of the textbook quadratic A t^2 + B t + C = 0
    of the ray-sphere test, from float32 inputs, which float64 holds
    exactly: A = d.d, B = 2 oc.d, C = oc.oc - r^2."""
    oc = np.asarray(ro, np.float64) - np.asarray(center, np.float64)
    d = np.asarray(rd, np.float64)
    r = np.asarray(radius, np.float64)
    return (oc, np.sum(d * d, -1), 2.0 * np.sum(oc * d, -1),
            np.sum(oc * oc, -1) - r * r)


def _exact_sign(ro, rd, center, radius):
    """The sign (-1, 0, 1) of B^2 - 4AC of one ray in rational arithmetic,
    exact from the float32 inputs."""
    F = Fraction
    oc = [F(float(o)) - F(float(c)) for o, c in zip(ro, center)]
    d = [F(float(x)) for x in rd]
    a = sum(x * x for x in d)
    b = 2 * sum(o * x for o, x in zip(oc, d))
    c = sum(o * o for o in oc) - F(float(radius)) ** 2
    disc = b * b - 4 * a * c
    return (disc > 0) - (disc < 0)


def discriminant64(ro, rd, center, radius):
    """B^2 - 4AC of :func:`_quadratic` in float64, with its sign exact:
    where the float64 value lies within its rounding bound of 0 (a ray
    that grazes the sphere, or any ray at a radius-0 sphere, whose
    discriminant is never positive), it is replaced by its exact sign
    (-1, 0 or 1, from :func:`_exact_sign`)."""
    oc, a, b, c = _quadratic(ro, rd, center, radius)
    disc = b * b - 4.0 * a * c
    r2 = np.asarray(radius, np.float64) ** 2
    near = np.abs(disc) <= 1e-12 * (b * b + 4.0 * a * (np.sum(oc * oc, -1)
                                                        + r2))
    if near.any():
        shape = disc.shape
        args = [np.broadcast_to(np.asarray(x, np.float64), shape + (3,))
                for x in (ro, rd, center)]
        rad = np.broadcast_to(np.asarray(radius, np.float64), shape)
        for i in zip(*np.nonzero(near)):
            disc[i] = _exact_sign(args[0][i], args[1][i], args[2][i], rad[i])
    return disc


def solve64(ro, rd, center, radius, t_min, t_max):
    """The ray-sphere test in float64 from the float32 inputs, written
    independently of the port's solve: ro, rd (..., 3), center (..., 3),
    radius, t_min, t_max (...), broadcast.  The textbook quadratic's
    roots (-B -+ sqrt(D)) / 2A, D = B^2 - 4AC (:func:`discriminant64`,
    its sign exact).  A hit needs D > 0: the ray passes strictly inside
    the sphere (a grazing ray, and every ray at a radius-0 sphere, miss)
    and A > 0.  Returns t (...) float64: the near root where it lies in
    [t_min, t_max], else the far one, inf where neither."""
    _, a, b, _ = _quadratic(ro, rd, center, radius)
    disc = discriminant64(ro, rd, center, radius)
    with np.errstate(divide="ignore", invalid="ignore"):
        sq = np.sqrt(np.maximum(disc, 0.0))
        t0, t1 = (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)
    has = (disc > 0) & (a > 0)
    t_min, t_max = np.asarray(t_min), np.asarray(t_max)
    ok0 = has & (t0 >= t_min) & (t0 <= t_max)
    ok1 = has & (t1 >= t_min) & (t1 <= t_max)
    return np.where(ok0, t0, np.where(ok1, t1, np.inf))


def ulp_error(t, t64, ro, rd, center, radius):
    """|t - t64| in float32 ulps of max(|t64|, |oc| / |d|) (the hit's
    distance, or the ray's from the centre), over the root's condition on
    the discriminant, max(1, r / sqrt(r^2 - l^2)), l the ray's distance
    from the centre (r^2 - l^2 = D / 4A): near tangency a rounding of the
    inputs moves the roots by that much more, in any precision."""
    oc, a, b, c = _quadratic(ro, rd, center, radius)
    r = np.asarray(radius, np.float64)
    h2 = (b * b - 4.0 * a * c) / (4.0 * a)
    kappa = np.maximum(1.0, r / np.sqrt(np.maximum(h2, 1e-300)))
    scale = np.maximum(np.abs(t64), np.sqrt(np.sum(oc * oc, -1) / a))
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    return np.abs(np.asarray(t, np.float64) - t64) / (ulp * kappa)


def as_float64(nt):
    """A NamedTuple of tensors (nested ones too: a Scene, a Camera) with
    every floating tensor in float64: the renderers follow their scene's
    and camera's dtype, so this makes the float64 witness of a render."""
    return type(nt)(*(as_float64(x) if hasattr(x, "_fields") else
                      x.double() if torch.is_tensor(x)
                      and x.is_floating_point() else x for x in nt))


def ray_sphere_np(ro, rd, center, radius, t_min, t_max):
    """``core/intersect.py::ray_sphere`` of one sphere on numpy rays:
    (hit (R,), t (R,) float32, INF where no hit)."""
    from tpu_pt_torch.core.intersect import ray_sphere

    def col(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32))

    hit, t, _ = ray_sphere(col(ro), col(rd), col(center)[None],
                           col(np.reshape(radius, (1, 1))),
                           col(t_min)[:, None], col(t_max)[:, None])
    return hit[:, 0].numpy(), t[:, 0].numpy()
