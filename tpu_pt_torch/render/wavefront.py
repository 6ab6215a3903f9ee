"""Persistent-wavefront renderer (forward only).

Bounce depth is the OUTER loop over one global, fixed-size ray queue.  The
queue is kept always full: every step, dead lanes are refilled with fresh
camera samples from the remaining sample budget, so lanes at different
bounce depths coexist and occupancy stays at 100% until the tail.

Randomness is counter-based per (sample id, depth, purpose)
(core/sampling.py), so radiance samples do not depend on lane scheduling.

The loop is a Python loop that exits as soon as the sample budget is spent
and every lane is dead; its condition is one host read per step.  The
queue state is updated out of place except for the radiance accumulator,
which is added to in place.  Everything runs under ``torch.no_grad()``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pt_torch.config import RenderConfig
from tpu_pt_torch.core.camera import generate_rays, pixel_xy
from tpu_pt_torch.core.sampling import draws_lane
from tpu_pt_torch.core.vecmath import dot, make_coord_space, to_local, to_world
from tpu_pt_torch.render import bsdf as bsdf_mod
from tpu_pt_torch.render import lights as lights_mod
from tpu_pt_torch.render.driver import _intersectors_counted, _on_device
from tpu_pt_torch.render.envmap import eval_env
from tpu_pt_torch.render.integrator import (
    _BSDF, _LIGHT0, _RR, _STRIDE, DRAW_JITTER, shade_info)
from tpu_pt_torch.scene.types import Scene

# Wide-budget warm-up steps before the steady-state loop: the first waves'
# shadow batches are fully occupied and wide-angle coherent, so they run the
# WIDE any-hit pair budget; the loop body then uses the narrow one.
WIDE_PREFIX_STEPS = 2


class QueueState(NamedTuple):
    """One lane per in-flight path segment."""

    ro: torch.Tensor          # (Q, 3)
    rd: torch.Tensor          # (Q, 3)
    beta: torch.Tensor        # (Q, 3) path throughput
    ray_id: torch.Tensor      # (Q,) logical sample id (pixel*spp + s); -1 idle
    depth: torch.Tensor       # (Q,) current bounce depth
    include_le: torch.Tensor  # (Q, 1) add emission at next hit
    alive: torch.Tensor       # (Q, 1) lane carries a live path
    next_sample: torch.Tensor  # () int64 — next unspawned sample id
    accum: torch.Tensor       # (P + Q, 3) radiance sums; the Q spare rows
    #                           take the (zero) adds of dead lanes


def _respawn(cam, cfg: RenderConfig, key, st: QueueState, pix_lo, n_pix_local,
             spp_lo, spp_count, pix_stride: int = 1) -> QueueState:
    """Fill dead lanes with fresh camera samples from the remaining budget.

    The sample stream covers pixels {pix_lo + j*pix_stride : j <
    n_pix_local} × samples [spp_lo, spp_lo + spp_count); ray ids — and
    therefore random numbers — are global either way."""
    total = n_pix_local * spp_count
    dead = ~st.alive[:, 0]
    dead_i = dead.to(torch.int64)
    rank = torch.cumsum(dead_i, dim=0) - dead_i
    cand = st.next_sample + rank
    spawn = dead & (cand < total)
    n_spawned = torch.sum(spawn)

    pixel_local = torch.div(cand, spp_count, rounding_mode="floor")
    pixel = pix_lo + torch.where(spawn, pixel_local,
                                 torch.zeros_like(pixel_local)) * pix_stride
    new_id = torch.where(
        spawn, pixel * cfg.spp + spp_lo + cand % spp_count, st.ray_id)
    jitter = draws_lane(key, new_id, torch.zeros_like(new_id) + DRAW_JITTER, 2)
    xy = pixel_xy(cfg.width, cfg.height, pixel, jitter)
    ro_new, rd_new = generate_rays(cam, xy)

    spawn_c = spawn[:, None]
    return st._replace(
        ro=torch.where(spawn_c, ro_new, st.ro),
        rd=torch.where(spawn_c, rd_new, st.rd),
        beta=torch.where(spawn_c, torch.ones_like(st.beta), st.beta),
        ray_id=new_id,
        depth=torch.where(spawn, torch.zeros_like(st.depth), st.depth),
        include_le=st.include_le | spawn_c,
        alive=st.alive | spawn_c,
        next_sample=st.next_sample + n_spawned,
    )


def _step(scene: Scene, cam, cfg: RenderConfig, key, intersect_fn, occluded_fn,
          st: QueueState, pix_lo, n_pix_local, spp_lo, spp_count,
          pix_stride: int = 1, shadow_narrow: bool = False):
    """One wavefront iteration: respawn → intersect → shade/NEE → scatter.
    Returns (state, (n_closest, n_shadow, n_overflow))."""
    st = _respawn(cam, cfg, key, st, pix_lo, n_pix_local, spp_lo, spp_count,
                  pix_stride)
    Q = st.ro.shape[0]
    (contrib, pixel, cont, ro_n, rd_n, beta_n, inc_n,
     nc, ns_, novf) = _step_slice(
        scene, cam, cfg, key, intersect_fn, occluded_fn,
        (st.ro, st.rd, st.beta, st.ray_id, st.depth, st.include_le,
         st.alive), pix_lo, n_pix_local, spp_lo, pix_stride, shadow_narrow)

    contrib = torch.where(st.alive, contrib, torch.zeros_like(contrib))
    if cfg.spp == 1:
        # spp=1: in-flight ray ids are unique and ray_id == pixel, so live
        # lanes add to DISTINCT pixels; dead lanes are remapped to distinct
        # spare rows past the image.  Every row gets at most one add, so the
        # in-place index_add_ is deterministic.
        lane = torch.arange(Q, device=pixel.device)
        pixel_u = torch.where(st.alive[:, 0], pixel, n_pix_local + lane)
        st.accum.index_add_(0, pixel_u, contrib)
    else:
        # Dead lanes may land anywhere: they add 0.0.
        st.accum.index_add_(0, pixel.clamp(0, n_pix_local - 1), contrib)
    st = st._replace(
        ro=torch.where(cont, ro_n, st.ro),
        rd=torch.where(cont, rd_n, st.rd),
        beta=torch.where(cont, beta_n, st.beta),
        depth=st.depth + 1,
        include_le=torch.where(cont, inc_n, st.include_le),
        alive=cont,
    )
    return st, (nc, ns_, novf)


def _step_slice(scene: Scene, cam, cfg: RenderConfig, key, intersect_fn,
                occluded_fn, lanes, pix_lo, n_pix_local, spp_lo, pix_stride,
                shadow_narrow):
    """Post-respawn step body.  Returns per-lane (contrib, pixel, cont,
    ro_next, rd_next, beta_next, include_le_next, n_closest, n_shadow,
    n_ovf)."""
    ro0, rd0, beta0, ray_id, depth, include_le, alive0 = lanes
    Q = ro0.shape[0]
    dev = ro0.device
    n_closest = torch.sum(alive0[:, 0])  # rays traced now
    base = 1 + depth * _STRIDE  # (Q,) per-lane draw base

    t_min = torch.zeros((Q, 1), dtype=torch.float32, device=dev)
    # Dead lanes get t_max < t_min: every backend reports a trivial miss
    # AND the cluster walk spawns no candidate pairs for them (budget +
    # work proportional to LIVE lanes only).
    t_max = torch.where(alive0, 1e30, -1.0).to(torch.float32)
    hit, n_ovf = intersect_fn(scene, ro0, rd0, t_min, t_max)
    si = shade_info(scene, ro0, rd0, hit)
    wo_world = -rd0
    tb, bb = make_coord_space(si.ns)
    wo = to_local(wo_world, tb, bb, si.ns)
    # Local accum index.
    pixel = torch.div(
        torch.div(torch.clamp_min(ray_id, 0), cfg.spp, rounding_mode="floor")
        - pix_lo, pix_stride, rounding_mode="floor")

    zero3 = torch.zeros((Q, 3), dtype=torch.float32, device=dev)
    # Miss → environment radiance.
    contrib = torch.where(
        alive0 & ~hit.hit & include_le,
        beta0 * eval_env(scene.env_map, rd0), zero3)
    alive = alive0 & hit.hit
    # Emission at hit (one-sided).
    front = dot(wo_world, si.ns) > 0.0
    contrib = contrib + torch.where(
        alive & include_le & front, beta0 * si.mat.emission, zero3)

    # ---- Next-event estimation. ----
    delta_b = bsdf_mod.is_delta(si.mat)
    # Useful shadow rays this step (non-delta live hits × lights × samples).
    n_shadow = torch.sum((alive & ~delta_b)[:, 0]) * (
        scene.lights.count * cfg.ns_area_light)
    ns = cfg.ns_area_light
    for li in range(scene.lights.count):
        for s in range(ns):
            u = draws_lane(key, ray_id, base + _LIGHT0 + li * ns + s, 2)
            ls = lights_mod.sample_light(
                scene.lights, li, si.p, u, env_map=scene.env_map,
                env_tables=(scene.env_marg_cdf, scene.env_cond_cdf))
            wi_l = to_local(ls.wi, tb, bb, si.ns)
            f = bsdf_mod.eval_f(si.mat, wo, wi_l)
            cos_s = torch.clamp_min(wi_l[..., 2:3], 0.0)
            mask = (
                alive & ~delta_b & (cos_s > 0.0)
                & (torch.max(f * ls.radiance, dim=-1, keepdim=True).values > 0.0)
            )
            shadow_o = si.p + si.ng * torch.where(
                dot(ls.wi, si.ng) > 0.0, cfg.eps, -cfg.eps)
            # Masked lanes get a negative range: trivial miss, no pair work.
            sh_tmax = torch.where(mask, ls.dist * (1.0 - 1e-3),
                                  torch.full_like(ls.dist, -1.0))
            occ, ovf_s = occluded_fn(scene, shadow_o, ls.wi, sh_tmax,
                                     narrow=shadow_narrow)
            n_ovf = n_ovf + ovf_s
            w = f * ls.radiance * cos_s / (ls.pdf * ns)
            contrib = contrib + torch.where(mask & ~occ, beta0 * w, zero3)

    # ---- Scatter to next bounce. ----
    max_depth = 0 if cfg.direct_only else cfg.max_depth
    u3 = draws_lane(key, ray_id, base + _BSDF, 3)
    bs = bsdf_mod.sample(si.mat, wo, u3)
    wi_world = to_world(bs.wi, tb, bb, si.ns)
    cont = alive & bs.valid & (depth < max_depth)[:, None]
    beta = beta0 * torch.where(cont, bs.weight, torch.ones_like(bs.weight))
    # Russian roulette on the segment about to be traced.
    do_rr = (depth + 1 >= cfg.rr_start)[:, None]
    u_rr = draws_lane(key, ray_id, base + _RR, 1)
    rr_kill = do_rr & (u_rr >= cfg.rr_prob)
    beta = torch.where(cont & do_rr, beta / cfg.rr_prob, beta)
    cont = cont & ~rr_kill

    ro_next = si.p + si.ng * torch.where(dot(wi_world, si.ng) > 0.0, cfg.eps,
                                         -cfg.eps)
    return (contrib, pixel, cont, ro_next, wi_world, beta, bs.delta,
            n_closest, n_shadow, n_ovf)


def init_queue(Q: int, n_pix_local: int, device) -> QueueState:
    """Fresh all-dead queue + zero accumulator."""
    f32 = dict(dtype=torch.float32, device=device)
    rd = torch.zeros((Q, 3), **f32)
    rd[:, 2] = 1.0
    return QueueState(
        ro=torch.zeros((Q, 3), **f32),
        rd=rd,
        beta=torch.zeros((Q, 3), **f32),
        ray_id=torch.full((Q,), -1, dtype=torch.int64, device=device),
        depth=torch.zeros((Q,), dtype=torch.int64, device=device),
        include_le=torch.zeros((Q, 1), dtype=torch.bool, device=device),
        alive=torch.zeros((Q, 1), dtype=torch.bool, device=device),
        next_sample=torch.zeros((), dtype=torch.int64, device=device),
        accum=torch.zeros((n_pix_local + Q, 3), **f32),
    )


def n_steps(cfg: RenderConfig, queue: int, n_pix: int = 0,
            spp_count: int = 0) -> int:
    """Static upper bound on wavefront iterations: every step consumes Q
    path segments while the budget lasts, plus a drain tail of max path
    length."""
    n_pix = n_pix or cfg.n_pixels
    spp_count = spp_count or cfg.spp
    depth = 1 if cfg.direct_only else cfg.max_depth + 1
    total_segments = n_pix * spp_count * depth
    return -(-total_segments // queue) + depth


@torch.no_grad()
def wavefront_accum(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                    queue: int, backend: str, pix_lo: int, n_pix_local: int,
                    spp_lo: int = 0, spp_count: int = 0,
                    with_counts: bool = False, pix_stride: int = 1,
                    use_kernels: bool = True, pair_stage: str = "fused"):
    """Render pixels {pix_lo + j*pix_stride : j < n_pix_local} × samples
    [spp_lo, spp_lo+spp_count) -> (n_pix_local, 3) radiance sums (divide by
    cfg.spp for the full-spp mean).  ``scene``, ``cam`` and ``bvh`` hold
    tensors on one device; ``key`` is two ints.  ``pair_stage`` selects the
    form of the cluster backend's pair stage: ``"fused"``, ``"split"`` or
    ``"dedup"`` (see ``bvh/cluster.py::intersect_counted``).

    Forward-only early-exit loop.  With ``with_counts`` also returns
    (n_closest, n_shadow, n_overflow, steps_run) as device scalars / int."""
    spp_count = spp_count or cfg.spp
    intersect_fn, occluded_fn = _intersectors_counted(backend, bvh,
                                                      use_kernels, pair_stage)
    device = scene.vertices.device
    Q = min(queue, n_pix_local * spp_count)
    st = init_queue(Q, n_pix_local, device)
    steps = n_steps(cfg, Q, n_pix_local, spp_count)
    total = n_pix_local * spp_count

    # Wide warm-up PREFIX: the first waves' shadow batches are fully
    # occupied and wide-angle coherent — the binding any-hit pair
    # population — so they run the wide any-hit budget; later steps run the
    # NARROW one (pair_mults[3]).
    prefix = min(WIDE_PREFIX_STEPS, steps)
    nc = ns = novf = torch.zeros((), dtype=torch.int64, device=device)
    n_iter = 0
    while n_iter < steps:
        if n_iter >= prefix:
            # One host read per step: anything alive or left to spawn?
            if not bool(torch.any(st.alive) | (st.next_sample < total)):
                break
        st, (c, s, o) = _step(
            scene, cam, cfg, key, intersect_fn, occluded_fn, st, pix_lo,
            n_pix_local, spp_lo, spp_count, pix_stride=pix_stride,
            # direct-only renders: EVERY wave is a fresh fully-occupied
            # primary wave, so the steady-state budget never applies.
            shadow_narrow=n_iter >= prefix and not cfg.direct_only)
        nc, ns, novf = nc + c, ns + s, novf + o
        n_iter += 1
    accum = st.accum[:n_pix_local]
    return (accum, (nc, ns, novf, n_iter)) if with_counts else accum


def render_wavefront(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                     queue: int = 1 << 17, backend: str = "cluster",
                     device="cuda", use_kernels: bool = True,
                     pair_stage: str = "fused"):
    """Full-image render -> (H, W, 3) linear radiance tensor on ``device``.
    ``key`` is a pair of 32-bit ints."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    accum = wavefront_accum(scene, cam, cfg, key, bvh, queue, backend,
                            0, cfg.n_pixels, use_kernels=use_kernels,
                            pair_stage=pair_stage)
    return (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)


def render_wavefront_counts(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                            queue: int = 1 << 17, backend: str = "cluster",
                            device="cuda", use_kernels: bool = True,
                            pair_stage: str = "fused"):
    """Full-image render + ray accounting.

    Returns (image, n_closest, n_shadow, n_overflow, n_steps_run): the
    image plus the number of closest-hit path segments and useful NEE
    shadow rays traced, the summed capacity-contract overflow (candidates
    truncated by static budgets; nonzero means the render may have dropped
    hits and the BVH needs larger caps), and the number of loop iterations
    executed (vs the static n_steps bound).  The counts are Python ints."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    accum, (nc, ns, novf, n_iter) = wavefront_accum(
        scene, cam, cfg, key, bvh, queue, backend, 0, cfg.n_pixels,
        with_counts=True, use_kernels=use_kernels, pair_stage=pair_stage)
    img = (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return img, int(nc), int(ns), int(novf), n_iter
