"""BSDF evaluation and sampling over a material table.

Dispatch over material kinds is a branchless select: every kind's result
is computed for every ray and the right one chosen with ``torch.where``.
All directions are in the LOCAL shading frame (z = shading normal); wo
points away from the surface toward the viewer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from tpu_pt_torch.scene.types import (
    MAT_DIFFUSE, MAT_MIRROR, MAT_GLASS, MAT_REFRACT, MAT_EMISSIVE, MAT_GGX,
)


class MatProps(NamedTuple):
    """Material properties gathered per ray (R rows)."""

    kind: torch.Tensor       # (R,) int32
    albedo: torch.Tensor     # (R, 3)
    emission: torch.Tensor   # (R, 3)
    ior: torch.Tensor        # (R, 1)
    roughness: torch.Tensor  # (R, 1)


def gather_mat(materials, mat_id) -> MatProps:
    return MatProps(
        kind=materials.kind[mat_id],
        albedo=materials.albedo[mat_id],
        emission=materials.emission[mat_id],
        ior=materials.ior[mat_id][..., None],
        roughness=materials.roughness[mat_id][..., None],
    )


def is_delta(mat: MatProps):
    """(R, 1) bool — perfectly specular materials; the integrator skips
    next-event estimation for them."""
    k = mat.kind[..., None]
    return (k == MAT_MIRROR) | (k == MAT_GLASS) | (k == MAT_REFRACT)


def _ggx_alpha(roughness):
    """Perceptual roughness -> GGX alpha (r^2 mapping), clamped away from
    the singular alpha=0 limit."""
    return torch.clamp(roughness, 0.01, 1.0) ** 2


def _ggx_d(cos_h, alpha):
    """GGX normal distribution D(h) for half-vector cosine cos_h (>0)."""
    a2 = alpha * alpha
    c2 = cos_h * cos_h
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * denom * denom, 1e-12)


def _ggx_g1(cos_v, alpha):
    """Smith masking term G1 for GGX."""
    a2 = alpha * alpha
    c = torch.clamp_min(torch.abs(cos_v), 1e-6)
    return 2.0 * c / (c + torch.sqrt(a2 + (1.0 - a2) * c * c))


def _ggx_f(mat: MatProps, wo, wi):
    """Rough-conductor GGX lobe: D*G*F / (4 cosO cosI), F = Schlick with
    F0 = albedo."""
    alpha = _ggx_alpha(mat.roughness)
    h = wo + wi
    h = h / torch.clamp_min(torch.linalg.norm(h, dim=-1, keepdim=True), 1e-12)
    cos_h = h[..., 2:3]
    cos_o = torch.clamp_min(wo[..., 2:3], 1e-6)
    cos_i = torch.clamp_min(wi[..., 2:3], 1e-6)
    d = _ggx_d(cos_h, alpha)
    g = _ggx_g1(wo[..., 2:3], alpha) * _ggx_g1(wi[..., 2:3], alpha)
    oh = torch.clamp_min(torch.sum(wo * h, dim=-1, keepdim=True), 0.0)
    fres = mat.albedo + (1.0 - mat.albedo) * (1.0 - oh) ** 5
    return d * g * fres / (4.0 * cos_o * cos_i)


def eval_f(mat: MatProps, wo, wi):
    """BSDF value f(wo, wi) — (R, 3).  Zero for delta/emissive kinds."""
    k = mat.kind[..., None]
    same_side = (wi[..., 2:3] > 0.0) & (wo[..., 2:3] > 0.0)
    zero = torch.zeros_like(mat.albedo)
    f_diffuse = mat.albedo / math.pi
    f = torch.where((k == MAT_DIFFUSE) & same_side, f_diffuse, zero)
    f = f + torch.where((k == MAT_GGX) & same_side, _ggx_f(mat, wo, wi), zero)
    return f


def _schlick(cos_i, ior):
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def _refract(wo, ior):
    """Local-frame refraction through the z=0 plane.  Returns (wi, tir,
    eta): refracted direction, total-internal-reflection mask, and the
    relative index eta = n_i/n_t actually used."""
    entering = wo[..., 2:3] > 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    cos_i = torch.abs(wo[..., 2:3])
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wi = torch.cat(
        [-eta * wo[..., 0:1], -eta * wo[..., 1:2],
         -torch.sign(wo[..., 2:3]) * cos_t],
        dim=-1,
    )
    return wi, tir, eta


class BsdfSample(NamedTuple):
    wi: torch.Tensor       # (R, 3) local-frame sampled direction
    weight: torch.Tensor   # (R, 3) f * |cos| / pdf  (throughput multiplier)
    delta: torch.Tensor    # (R, 1) bool — sampled a delta lobe
    valid: torch.Tensor    # (R, 1) bool — sample carries energy


def sample(mat: MatProps, wo, u):
    """Sample the BSDF.  u: (R, 3) uniforms (2 for direction, 1 for lobe
    choice).  ``weight`` already folds f*|cos|/pdf."""
    from tpu_pt_torch.core.sampling import cosine_hemisphere

    k = mat.kind[..., None]
    zero3 = torch.zeros_like(mat.albedo)

    # ---- Diffuse: cosine-weighted hemisphere; weight = albedo. ----
    wi_d, _ = cosine_hemisphere(u[..., 0:2])
    # Viewer on the back side of the shading normal: flip the hemisphere.
    flip = torch.where(wo[..., 2:3] < 0.0, -1.0, 1.0).to(wo.dtype)
    flip3 = torch.cat([torch.ones_like(flip), torch.ones_like(flip), flip], -1)
    wi_d = wi_d * flip3
    w_d = mat.albedo

    # ---- Mirror: wi = reflect(wo); weight = albedo. ----
    wi_m = torch.cat([-wo[..., 0:1], -wo[..., 1:2], wo[..., 2:3]], dim=-1)
    w_m = mat.albedo

    # ---- Glass: Fresnel-weighted choice between reflection and refraction. ----
    wi_t, tir, eta = _refract(wo, mat.ior)
    cos_i = torch.abs(wo[..., 2:3])
    fresnel = torch.where(tir, torch.ones_like(cos_i), _schlick(cos_i, mat.ior))
    take_refl = (u[..., 2:3] < fresnel) | tir
    wi_g = torch.where(take_refl, wi_m, wi_t)
    # The lobe is chosen with probability equal to its Fresnel weight, which
    # cancels; refraction carries the eta^2 radiance compression.
    w_g = torch.where(take_refl, mat.albedo, mat.albedo * (eta * eta))

    # ---- Pure refraction: always refract; black on TIR. ----
    wi_r = wi_t
    w_r = torch.where(tir, zero3, mat.albedo * (eta * eta))

    # ---- GGX glossy: sample the half-vector from the NDF (detached alpha:
    # the sampling DECISION is not differentiated; the integrand f is, so
    # roughness gradients flow through ``weight`` via _ggx_f). ----
    alpha_d = _ggx_alpha(mat.roughness).detach()
    a2_d = alpha_d * alpha_d
    u0 = u[..., 0:1]
    c2 = (1.0 - u0) / torch.clamp_min(1.0 + (a2_d - 1.0) * u0, 1e-12)
    cos_h = torch.sqrt(torch.clamp(c2, 0.0, 1.0))
    sin_h = torch.sqrt(torch.clamp(1.0 - c2, 0.0, 1.0))
    phi = 2.0 * math.pi * u[..., 1:2]
    h = torch.cat(
        [torch.cos(phi) * sin_h, torch.sin(phi) * sin_h, cos_h * flip], dim=-1)
    oh = torch.sum(wo * h, dim=-1, keepdim=True)
    wi_gx = (2.0 * oh * h - wo).detach()
    pdf_h = (_ggx_d(cos_h, alpha_d) * cos_h / torch.clamp_min(
        4.0 * torch.abs(oh), 1e-9)).detach()
    same_side = (wi_gx[..., 2:3] * flip > 0.0)
    f_gx = _ggx_f(mat, wo * flip3, wi_gx * flip3)
    w_gx = torch.where(same_side & (pdf_h > 1e-12),
                       f_gx * torch.abs(wi_gx[..., 2:3]) /
                       torch.clamp_min(pdf_h, 1e-12), zero3)

    wi = torch.where(k == MAT_DIFFUSE, wi_d,
         torch.where(k == MAT_MIRROR, wi_m,
         torch.where(k == MAT_GLASS, wi_g,
         torch.where(k == MAT_REFRACT, wi_r,
         torch.where(k == MAT_GGX, wi_gx, wi_d)))))
    weight = torch.where(k == MAT_DIFFUSE, w_d,
             torch.where(k == MAT_MIRROR, w_m,
             torch.where(k == MAT_GLASS, w_g,
             torch.where(k == MAT_REFRACT, w_r,
             torch.where(k == MAT_GGX, w_gx, zero3)))))
    delta = is_delta(mat)
    valid = (k != MAT_EMISSIVE) & (
        torch.max(weight, dim=-1, keepdim=True).values > 0.0)
    return BsdfSample(wi=wi, weight=weight, delta=delta, valid=valid)
