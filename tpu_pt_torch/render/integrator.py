"""The path-tracing integrator, shared by every acceleration backend: the
draw-id layout, the hit-point gather (``shade_info``) and the unrolled
bounce loop (``radiance`` / ``render_chunk``) that ``render/driver.py::render``
turns into images.  The wavefront renderer reuses the draw ids and
``shade_info``, so the two renderers can only differ in scheduling, never
in shading math or random numbers (counter-based RNG, core/sampling.py).

The integrator takes an *intersector*, a pair of closures
``(intersect, occluded)``, so that the brute-force oracle, the dense-sweep
kernels and the cluster BVH all share this code.

Light transport:
  - radiance = emission at the first hit + next-event direct light +
    BSDF-sampled indirect light;
  - emission is added only on camera rays and after *delta* bounces, since
    next-event estimation already accounts for light hits after diffuse
    bounces;
  - Russian roulette starts at bounce ``rr_start`` with continuation
    probability ``rr_prob`` (throughput compensated).

Differentiability (detached-sampling reparameterized gradients, as in the
JAX package): the barycentrics, the hit distance, the pixel jitter and the
BSDF uniforms and sampled direction are ``detach()``ed, and the hit point
of a triangle is recomputed from its vertices, so gradients flow through
the shading geometry and the materials, never through a sampling decision.
Every intersector call runs under ``torch.no_grad()`` on detached rays: its
outputs are only read through detached values, so no gradient changes, and
autograd records nothing of the ray-primitive tests.  ``driver.render``
runs forward only; ``diff/adjoint.py`` differentiates ``render_chunk``."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tpu_pt_torch.config import RenderConfig
from tpu_pt_torch.core.camera import generate_rays, pixel_xy
from tpu_pt_torch.core.sampling import draws
from tpu_pt_torch.core.vecmath import (
    cross, dot, make_coord_space, normalize, to_local, to_world)
from tpu_pt_torch.render import bsdf as bsdf_mod
from tpu_pt_torch.render import lights as lights_mod
from tpu_pt_torch.render.brute import Hit
from tpu_pt_torch.render.envmap import eval_env
from tpu_pt_torch.scene.types import Scene

# draw_id layout: stride per bounce; draw ids make randomness independent of
# ray order (see core/sampling.py).
DRAW_JITTER = 0
_STRIDE = 64
_LIGHT0 = 0      # + li*ns + s   (light NEE draws)
_BSDF = 48       # bsdf lobe+direction draws
_RR = 49         # russian roulette


class ShadeInfo(NamedTuple):
    p: torch.Tensor        # (R, 3) hit position
    ns: torch.Tensor       # (R, 3) shading normal (unit)
    ng: torch.Tensor       # (R, 3) geometric normal (unit)
    mat: bsdf_mod.MatProps


def shade_info(scene: Scene, ro, rd, hit: Hit) -> ShadeInfo:
    """Gather hit-point geometry + material.  The triangle hit position is
    recomputed from the (detached) barycentrics as (1-u-v)·v0 + u·v1 +
    v·v2, so d(p)/d(vertices) flows; the hit distance is detached too."""
    is_tri = hit.prim < scene.n_tris
    zero_i = torch.zeros_like(hit.prim)
    tri_id = torch.where(is_tri, hit.prim, zero_i)
    sph_id = torch.where(is_tri, zero_i, hit.prim - scene.n_tris)

    idx = scene.tri_idx[tri_id]                      # (R, 3)
    v0 = scene.vertices[idx[:, 0]]
    v1 = scene.vertices[idx[:, 1]]
    v2 = scene.vertices[idx[:, 2]]
    u = hit.u.detach()
    v = hit.v.detach()
    w0 = 1.0 - u - v
    p_tri = w0 * v0 + u * v1 + v * v2
    n0 = scene.normals[idx[:, 0]]
    n1 = scene.normals[idx[:, 1]]
    n2 = scene.normals[idx[:, 2]]
    ns_tri = normalize(w0 * n0 + u * n1 + v * n2)
    ng_tri = normalize(cross(v1 - v0, v2 - v0))
    # Keep geometric normal on the same side as the shading normal.
    ng_tri = torch.where(dot(ng_tri, ns_tri) < 0.0, -ng_tri, ng_tri)

    center = scene.sph_center[sph_id]
    p_sph = ro + hit.t.detach() * rd
    ns_sph = normalize(p_sph - center)

    is_tri_c = is_tri[:, None]
    p = torch.where(is_tri_c, p_tri, p_sph)
    ns = torch.where(is_tri_c, ns_tri, ns_sph)
    ng = torch.where(is_tri_c, ng_tri, ns_sph)
    mat_id = torch.where(is_tri, scene.tri_mat[tri_id], scene.sph_mat[sph_id])
    return ShadeInfo(p=p, ns=ns, ng=ng,
                     mat=bsdf_mod.gather_mat(scene.materials, mat_id))


def radiance(scene: Scene, intersect_fn: Callable, occluded_fn: Callable,
             ro, rd, ray_ids, key, cfg: RenderConfig):
    """Estimate radiance along a batch of camera rays.  (R, 3) -> (R, 3).

    The bounce loop is unrolled over the whole batch with masked lanes:
    every ray is traced at every depth (dead lanes keep their last ray), and
    one shadow ray per light and sample is cast unconditionally."""
    R = ro.shape[0]
    flt = dict(dtype=ro.dtype, device=ro.device)
    beta = torch.ones((R, 3), **flt)
    L = torch.zeros((R, 3), **flt)
    zero3 = torch.zeros((R, 3), **flt)
    alive = torch.ones((R, 1), dtype=torch.bool, device=ro.device)
    include_le = torch.ones((R, 1), dtype=torch.bool, device=ro.device)
    t_min = torch.zeros((R, 1), **flt)
    t_max = torch.full((R, 1), 1e30, **flt)

    n_lights = scene.lights.count
    scene_d = scene.detach()   # what the intersectors see
    ns_samples = cfg.ns_area_light
    n_hits = 1 if cfg.direct_only else cfg.max_depth + 1

    for depth in range(n_hits):
        base = 1 + depth * _STRIDE
        with torch.no_grad():
            hit = intersect_fn(scene_d, ro.detach(), rd.detach(), t_min,
                               t_max)
        # Miss -> environment radiance ((1, 1, 3) zeros when none is set).
        L = L + torch.where(alive & ~hit.hit & include_le,
                            beta * eval_env(scene.env_map, rd), zero3)
        alive = alive & hit.hit
        si = shade_info(scene, ro, rd, hit)
        wo_world = -rd
        tb, bb = make_coord_space(si.ns)
        wo = to_local(wo_world, tb, bb, si.ns)

        # Emission at the hit (one-sided: emitting face only).
        front = dot(wo_world, si.ns) > 0.0
        L = L + torch.where(alive & include_le & front,
                            beta * si.mat.emission, zero3)

        # ---- Next-event estimation (direct lighting). ----
        delta_b = bsdf_mod.is_delta(si.mat)
        for li in range(n_lights):
            for s in range(ns_samples):
                u = draws(key, ray_ids, base + _LIGHT0 + li * ns_samples + s, 2)
                ls = lights_mod.sample_light(
                    scene.lights, li, si.p, u, env_map=scene.env_map,
                    env_tables=(scene.env_marg_cdf, scene.env_cond_cdf))
                wi_l = to_local(ls.wi, tb, bb, si.ns)
                f = bsdf_mod.eval_f(si.mat, wo, wi_l)
                cos_s = torch.clamp_min(wi_l[..., 2:3], 0.0)
                contrib_mask = (
                    alive & ~delta_b & (cos_s > 0.0)
                    & (torch.max(f * ls.radiance, dim=-1,
                                 keepdim=True).values > 0.0)
                )
                # Shadow ray (cast unconditionally; lanes are masked).
                shadow_o = si.p + si.ng * torch.where(
                    dot(ls.wi, si.ng) > 0.0, cfg.eps, -cfg.eps)
                with torch.no_grad():
                    occ = occluded_fn(scene_d, shadow_o.detach(),
                                      ls.wi.detach(),
                                      ls.dist.detach() * (1.0 - 1e-3))
                w = f * ls.radiance * cos_s / (ls.pdf * ns_samples)
                L = L + torch.where(contrib_mask & ~occ, beta * w, zero3)

        # ---- Scatter to the next bounce. ----
        if depth == n_hits - 1:
            break
        u3 = draws(key, ray_ids, base + _BSDF, 3)
        bs = bsdf_mod.sample(si.mat, wo, u3.detach())
        wi_world = to_world(bs.wi.detach(), tb, bb, si.ns)
        beta = beta * bs.weight
        include_le = bs.delta
        alive = alive & bs.valid
        # Russian roulette.
        if depth + 1 >= cfg.rr_start:
            u_rr = draws(key, ray_ids, base + _RR, 1)
            alive = alive & (u_rr < cfg.rr_prob)
            beta = beta / cfg.rr_prob
        ro = si.p + si.ng * torch.where(dot(wi_world, si.ng) > 0.0, cfg.eps,
                                        -cfg.eps)
        rd = wi_world

    return L  # already masked per term


def render_chunk(scene: Scene, cam, cfg: RenderConfig, key, pixel_ids,
                 sample_ids, intersect_fn, occluded_fn):
    """Radiance for a flat chunk of (pixel, sample) pairs -> (R, 3)."""
    ray_ids = pixel_ids * cfg.spp + sample_ids
    jitter = draws(key, ray_ids, DRAW_JITTER, 2)
    xy = pixel_xy(cfg.width, cfg.height, pixel_ids, jitter.detach())
    ro, rd = generate_rays(cam, xy)
    return radiance(scene, intersect_fn, occluded_fn, ro, rd, ray_ids, key,
                    cfg)
