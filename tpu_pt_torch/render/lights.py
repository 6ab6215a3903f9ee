"""Light sampling for next-event estimation: one light-table row per
(ray, light, sample), with broadcasting; the light axis is unrolled by the
caller."""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pt_torch.core.vecmath import cross, dot, normalize
from tpu_pt_torch.scene.types import (
    LIGHT_AREA, LIGHT_POINT, LIGHT_DIRECTIONAL, LIGHT_TRI, LIGHT_ENV,
    LIGHT_SPOT,
)


class LightSample(NamedTuple):
    wi: torch.Tensor        # (R, 3) unit direction from shading point to light
    dist: torch.Tensor      # (R, 1) distance to the light sample (1e30 for dir/hemi)
    radiance: torch.Tensor  # (R, 3) incident radiance along wi (already /r^2 for point)
    pdf: torch.Tensor       # (R, 1) solid-angle pdf (1 for delta lights)
    delta: torch.Tensor     # (R, 1) bool — delta light (point/directional)


def sample_light(lights, li: int, p, u, env_map=None, env_tables=None):
    """Sample light row ``li`` from shading points p (R,3) with uniforms
    u (R,2).  LIGHT_ENV rows importance-sample the map's luminance CDF
    tables when ``env_tables=(marg_cdf, cond_cdf)`` is given, else fall
    back to the uniform sphere (unbiased either way — pdf rides along)."""
    from tpu_pt_torch.core.sampling import uniform_hemisphere, uniform_sphere

    kind = lights.kind[li]
    pos = lights.position[li]
    ex = lights.edge_x[li]
    ey = lights.edge_y[li]
    nrm = lights.normal[li]
    rad = lights.radiance[li]
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    one0 = torch.ones((), dtype=p.dtype, device=p.device)

    # ---- Area quad light.  LIGHT_TRI folds the unit square onto the
    # triangle (u1+u2<=1): uniform over the triangle, pdf = 1/(0.5*|ex×ey|).
    is_tri = kind == LIGHT_TRI
    fold = is_tri & ((u[..., 0:1] + u[..., 1:2]) > 1.0)
    u0 = torch.where(fold, 1.0 - u[..., 0:1], u[..., 0:1])
    u1 = torch.where(fold, 1.0 - u[..., 1:2], u[..., 1:2])
    q = pos + u0 * ex + u1 * ey
    d = q - p
    dist2 = torch.clamp_min(dot(d, d), 1e-12)
    dist_a = torch.sqrt(dist2)
    wi_a = d / dist_a
    area = torch.linalg.norm(cross(ex, ey)) * torch.where(is_tri, 0.5, 1.0)
    cos_l = dot(-wi_a, nrm)                      # emission side only
    # Solid-angle pdf of uniform-area sampling: r^2 / (A * cosL).
    pdf_a = dist2 / torch.clamp_min(area * torch.clamp_min(cos_l, 1e-9), 1e-12)
    rad_a = torch.where(cos_l > 0.0, rad, zero) * torch.ones_like(p)

    # ---- Point light: intensity / r^2, delta.  A spot light is a point
    # light masked to a cone about its axis; cos(half-angle) rides in
    # edge_x[0] and the falloff exponent in edge_x[1]. ----
    dp = pos - p
    dist2p = torch.clamp_min(dot(dp, dp), 1e-12)
    dist_p = torch.sqrt(dist2p)
    wi_p = dp / dist_p
    cos_axis = dot(-wi_p, normalize(nrm))
    in_cone = cos_axis >= ex[0]
    # The exponent is gated to the spot branch: for other kinds ex[1] is a
    # geometry edge component and could overflow the masked power.
    expo = torch.where(kind == LIGHT_SPOT, ex[1], zero)
    falloff = torch.pow(torch.clamp_min(cos_axis, 1e-9), expo)
    spot_gain = torch.where(kind == LIGHT_SPOT,
                            torch.where(in_cone, falloff, zero), one0)
    rad_p = rad / dist2p * spot_gain * torch.ones_like(p)

    # ---- Directional light: constant radiance from -direction, delta. ----
    wi_d = normalize(-nrm).expand_as(p)
    rad_d = rad.expand_as(p)

    # ---- Infinite hemisphere light: uniform over the world up hemisphere.
    # LIGHT_ENV: uniform over the full sphere, radiance from the map. ----
    is_env = kind == LIGHT_ENV
    dh, pdf_hemi = uniform_hemisphere(u)
    ds, pdf_sph = uniform_sphere(u)
    d_inf = torch.where(is_env, ds, dh)
    pdf_h = torch.where(is_env, pdf_sph, pdf_hemi)
    # local z -> world +y
    wi_h = torch.stack([d_inf[..., 0], d_inf[..., 2], d_inf[..., 1]], dim=-1)
    if env_tables is not None:
        from tpu_pt_torch.render.envmap import sample_env

        d_env, pdf_env = sample_env(env_tables[0], env_tables[1], u)
        wi_h = torch.where(is_env, d_env, wi_h)
        pdf_h = torch.where(is_env, pdf_env, pdf_h)
    if env_map is not None:
        from tpu_pt_torch.render.envmap import eval_env

        rad_h = torch.where(is_env, eval_env(env_map, wi_h), rad.expand_as(p))
    else:
        rad_h = rad.expand_as(p)

    inf = torch.full_like(dist_a, 1e30)
    one = torch.ones_like(dist_a)

    is_pnt = (kind == LIGHT_POINT) | (kind == LIGHT_SPOT)

    def sel(a, pnt, drc, hemi):
        return torch.where((kind == LIGHT_AREA) | is_tri, a,
               torch.where(is_pnt, pnt,
               torch.where(kind == LIGHT_DIRECTIONAL, drc, hemi)))

    return LightSample(
        wi=sel(wi_a, wi_p, wi_d, wi_h),
        dist=sel(dist_a, dist_p, inf, inf),
        radiance=sel(rad_a, rad_p, rad_d, rad_h),
        pdf=sel(pdf_a, one, one, pdf_h),
        delta=(is_pnt | (kind == LIGHT_DIRECTIONAL)).expand_as(dist_a),
    )
