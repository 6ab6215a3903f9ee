"""Persistent-wavefront renderer, forward and differentiable.

Bounce depth is the OUTER loop over one global, fixed-size ray queue.  The
queue is kept always full: every step, dead lanes are refilled with fresh
camera samples from the remaining sample budget, so lanes at different
bounce depths coexist and occupancy stays at 100% until the tail.

Randomness is counter-based per (sample id, depth, purpose)
(core/sampling.py), so radiance samples do not depend on lane scheduling.

The loop is a Python loop that exits as soon as the sample budget is spent
and every lane is dead; its condition is one host read per step.  The
queue state, the radiance accumulator and the per-pixel suspect flags are
updated out of place.  The accumulator has one row per local (pixel,
sample): an in-flight sample id is unique among the live lanes, so every
row gets at most one add a step, and the samples of a pixel are summed in
sample order when the loop ends.  The sum therefore has one order, on the
card as on the host, at every spp.

The forward renders run under ``torch.no_grad()``.  The differentiable
loop (``wavefront_accum(differentiable=True)``) records the shading of
every step on the autograd tape; every traversal runs under
``torch.no_grad()`` on detached inputs, so the tape keeps only its hit and
occlusion records and backward never traverses.  Sampling decisions (the
pixel jitter, the BSDF uniforms and direction, barycentrics and hit
distance) are detached, as in the JAX package.  The loop runs in chunks of
``round(sqrt(steps))`` steps.  Past 16 steps (or under ``psum_group``) each
chunk is recomputed in backward (``torch.utils.checkpoint``) from its
lanes at its start and its traversal records, which the forward keeps: the
tape holds the records of every step, the lanes at every chunk boundary
and one chunk's shading at a time, O(sqrt(steps) x queue) in all, where a
tape of every step's shading grows with steps x queue (``remat=False``,
the twin).  Under ``psum_group`` (a ``ChunkReduce``,
``dist/sharding.py``'s gradient step) each chunk's scene gradients are
all-reduced across ranks while backward runs.

Suspect-pixel repair: a render with ``with_suspects`` flags every pixel one
of whose path segments had its traversal candidates cut by a static budget
(``render_wavefront_suspect_counts``); ``repair_suspect_pixels`` renders
only those pixels again on a cluster BVH with the exact fallback attached
and splices them in.  A pixel subset renders through a ``pix_ids``
indirection with every random draw keyed by the GLOBAL sample id, so a
repaired pixel is the value it has in a full render.

The sanitizer: ``render_wavefront_checked`` renders with
``cfg.debug_checks`` on and raises ``CheckError`` on the first violated
invariant (non-finite scene input, a hit t that is not positive and finite
or lies beyond t_max, barycentrics outside the triangle, a non-finite
throughput or shading contribution).  Each check is a host read, made only
under the flag.  Every other entry point of this module raises
``ValueError`` on the flag, as the JAX package's do (its checks cannot run
outside ``checkify``); the gradient path ignores it, as the JAX package's
does (``diff/adjoint.py::wavefront_loss``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from tpu_pt_torch.bvh.cluster import _interleave
from tpu_pt_torch.config import RenderConfig
from tpu_pt_torch.core.camera import generate_rays, pixel_xy
from tpu_pt_torch.core.sampling import draws_lane
from tpu_pt_torch.core.vecmath import dot, make_coord_space, to_local, to_world
from tpu_pt_torch.render import bsdf as bsdf_mod
from tpu_pt_torch.render import lights as lights_mod
from tpu_pt_torch.render.driver import (
    _intersectors_counted, _intersectors_suspect, _on_device)
from tpu_pt_torch.render.envmap import eval_env
from tpu_pt_torch.render.integrator import (
    _BSDF, _LIGHT0, _RR, _STRIDE, DRAW_JITTER, shade_info)
from tpu_pt_torch.scene.types import Scene

# Wide-budget warm-up steps before the steady-state loop: the first waves'
# shadow batches are fully occupied and wide-angle coherent, so they run the
# WIDE any-hit pair budget; the loop body then uses the narrow one.
WIDE_PREFIX_STEPS = 2


class CheckError(ValueError):
    """An invariant the sanitizer (``render_wavefront_checked``) checks was
    violated; the message names it.  A ``ValueError``, as the JAX package's
    ``checkify`` error is."""


def _check(ok, message: str) -> None:
    """Raise ``CheckError(message)`` unless the bool tensor ``ok`` holds."""
    if not bool(ok):
        raise CheckError(message)


def _check_hits(hit, t_max, beta) -> None:
    """The sanitizer's checks of a closest-hit batch and the throughput of
    its lanes, in the JAX package's order and words."""
    ht, hh = hit.t[:, 0], hit.hit[:, 0]
    _check(torch.all(~hh | ((ht > 0.0) & torch.isfinite(ht))),
           "traversal: hit.t must be positive finite where hit")
    _check(torch.all(~hh | (ht <= t_max[:, 0])),
           "traversal: hit.t beyond t_max")
    u, v = hit.u[:, 0], hit.v[:, 0]
    _check(torch.all(~hh | ((u >= -1e-4) & (v >= -1e-4)
                            & (u + v <= 1 + 1e-4))),
           "traversal: barycentrics outside the triangle")
    _check(torch.all(torch.isfinite(beta)),
           "wavefront: non-finite path throughput")


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
    accum: torch.Tensor       # (S + Q, 3) radiance sums, one row per local
    #                           (pixel, sample), S = P * spp_count; the Q
    #                           spare rows take the (zero) adds of dead lanes
    suspect: torch.Tensor     # (P,) i32 per-pixel suspect flags when
    #                           tracked; (1,) unused otherwise


def _respawn(cam, cfg: RenderConfig, key, st: QueueState, pix_lo, n_pix_local,
             spp_lo, spp_count, pix_stride: int = 1,
             pix_ids=None) -> QueueState:
    """Fill dead lanes with fresh camera samples from the remaining budget.

    The sample stream covers pixels {pix_lo + j*pix_stride : j <
    n_pix_local} × samples [spp_lo, spp_lo + spp_count); ray ids — and
    therefore random numbers — are global either way.  With ``pix_ids``
    ((n_pix_local,) int64, the global pixel of each accumulator row) the
    stream covers those pixels instead: ``ray_id`` then holds the LOCAL
    sample id and every draw uses the global one (``_global_ray_id``)."""
    total = n_pix_local * spp_count
    dead = ~st.alive[:, 0]
    dead_i = dead.to(torch.int64)
    rank = torch.cumsum(dead_i, dim=0) - dead_i
    cand = st.next_sample + rank
    spawn = dead & (cand < total)
    n_spawned = torch.sum(spawn)

    pixel_local = torch.div(cand, spp_count, rounding_mode="floor")
    sample = spp_lo + cand % spp_count
    if pix_ids is not None:
        pixel = pix_ids[torch.where(spawn, pixel_local,
                                    torch.zeros_like(pixel_local)).clamp(
            0, pix_ids.shape[0] - 1)]
        new_id = torch.where(spawn, pixel_local * cfg.spp + sample,
                             st.ray_id)
        gid = torch.where(spawn, pixel * cfg.spp + sample,
                          _global_ray_id(st.ray_id, cfg, pix_ids))
    else:
        pixel = pix_lo + torch.where(spawn, pixel_local,
                                     torch.zeros_like(pixel_local)) * pix_stride
        new_id = torch.where(spawn, pixel * cfg.spp + sample, st.ray_id)
        gid = new_id
    jitter = draws_lane(key, gid, torch.zeros_like(gid) + DRAW_JITTER, 2)
    xy = pixel_xy(cfg.width, cfg.height, pixel, jitter.detach())
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


def _global_ray_id(ray_id, cfg: RenderConfig, pix_ids):
    """Local sample id -> global sample id under a ``pix_ids`` indirection
    (identity when ``pix_ids`` is None); idle lanes (-1) stay -1."""
    if pix_ids is None:
        return ray_id
    rid = torch.clamp_min(ray_id, 0)
    row = torch.div(rid, cfg.spp, rounding_mode="floor").clamp(
        0, pix_ids.shape[0] - 1)
    g = pix_ids[row] * cfg.spp + rid % cfg.spp
    return torch.where(ray_id < 0, ray_id, g)


def _step(scene: Scene, cam, cfg: RenderConfig, key, intersect_fn, occluded_fn,
          st: QueueState, pix_lo, n_pix_local, spp_lo, spp_count,
          pix_stride: int = 1, shadow_narrow: bool = False,
          track_suspects: bool = False, pix_ids=None,
          ray_probe: list | None = None, step_slices: int = 1):
    """One wavefront iteration: respawn → intersect → shade/NEE → scatter.
    Returns (state, (n_closest, n_shadow, n_overflow)).  With
    ``track_suspects`` the intersectors are ``_intersectors_suspect``'s and
    the step raises the flag of every pixel whose live segment was suspect
    in any of the step's traversals.

    ray_probe: when a list is passed, every traversal's ray batch is
    appended as (ro, rd, t_max (Q, 1)): entry 0 is the closest-hit batch,
    the rest are the NEE shadow batches in light-then-sample order.  It is
    the real mixed-depth population that the capacity autotuner
    (``bvh/cluster.py::autotune_for_render``) sizes the budgets from; the
    hook changes nothing else the step computes.

    ``step_slices`` > 1 runs the post-respawn body as that many independent
    strided lane slices (lane i in slice i % k), halved while the queue is
    not a multiple of it or a slice would be under 2,048 lanes.  Per-lane
    math is unchanged and every lane adds to its own accumulator row, so
    the image is the unsliced one bit for bit; only a static pair budget,
    applied per traversal call, sees a slice instead of the queue."""
    lanes, adds, counts = _advance(
        scene, cam, cfg, key, intersect_fn, occluded_fn, st, pix_lo,
        n_pix_local, spp_lo, spp_count, pix_stride, shadow_narrow,
        track_suspects, pix_ids, ray_probe, step_slices)
    accum, suspect = _apply(st.accum, st.suspect, adds, n_pix_local)
    return lanes._replace(accum=accum, suspect=suspect), counts


def _slices(Q: int, step_slices: int) -> int:
    """The slice count a queue of Q lanes takes: ``step_slices`` halved while
    Q is not a multiple of it or a slice would be under 2,048 lanes."""
    k = max(1, int(step_slices))
    while k > 1 and (Q % k != 0 or Q // k < 2048):
        k //= 2
    return k


def _advance(scene: Scene, cam, cfg: RenderConfig, key, intersect_fn,
             occluded_fn, st: QueueState, pix_lo, n_pix_local, spp_lo,
             spp_count, pix_stride: int = 1, shadow_narrow: bool = False,
             track_suspects: bool = False, pix_ids=None, ray_probe=None,
             step_slices: int = 1):
    """:func:`_step` on the lanes alone: returns (state with its lanes
    advanced and its ``accum`` and ``suspect`` as they were, adds,
    counts); :func:`_apply` adds ``adds`` to the accumulator and the
    suspect flags.  It reads neither, so a chunk of steps can run without
    them."""
    st = _respawn(cam, cfg, key, st, pix_lo, n_pix_local, spp_lo, spp_count,
                  pix_stride, pix_ids)
    lanes = (st.ro, st.rd, st.beta, st.ray_id, st.depth, st.include_le,
             st.alive)
    k = _slices(st.ro.shape[0], step_slices)
    parts = [_step_slice(scene, cam, cfg, key, intersect_fn, occluded_fn,
                         tuple(x[i::k].contiguous() for x in lanes) if k > 1
                         else lanes, pix_lo, n_pix_local, spp_lo, pix_stride,
                         shadow_narrow, track_suspects, pix_ids, ray_probe)
             for i in range(k)]
    # The per-lane outputs of the slices interleaved back (lane j of slice
    # i is lane j * k + i), the counts summed.
    (contrib, pixel, cont, ro_n, rd_n, beta_n, inc_n, sus_lane) = (
        v[0] if k == 1 or v[0] is None else _interleave(v)
        for v in zip(*(p[:8] for p in parts)))
    nc, ns_, novf = (sum(c) for c in zip(*(p[8:] for p in parts)))
    # The lane's row: its local (pixel, sample).
    sample = torch.clamp_min(st.ray_id, 0) % cfg.spp - spp_lo
    adds = (pixel * spp_count + sample, contrib, st.alive, pixel, sus_lane)
    st = st._replace(
        ro=torch.where(cont, ro_n, st.ro),
        rd=torch.where(cont, rd_n, st.rd),
        beta=torch.where(cont, beta_n, st.beta),
        depth=st.depth + 1,
        include_le=torch.where(cont, inc_n, st.include_le),
        alive=cont,
    )
    return st, adds, (nc, ns_, novf)


def _apply(accum, suspect, adds, n_pix_local: int):
    """One step's ``adds`` (from :func:`_advance`) on the accumulator and,
    where tracked, the per-pixel suspect flags."""
    row, contrib, alive, pixel, sus_lane = adds
    if sus_lane is not None:
        # A max, so the order of the lanes does not matter; dead lanes
        # carry 0 and change nothing wherever they land.
        suspect = suspect.scatter_reduce(0, pixel.clamp(0, n_pix_local - 1),
                                         sus_lane, "amax")
    return _accumulate(accum, row, contrib, alive), suspect


def _accumulate(accum, row, contrib, alive):
    """accum (S + Q, 3) plus each live lane's contribution at its ``row`` in
    [0, S); dead lanes add zero to the distinct spare rows S + lane.  The
    live lanes' rows are distinct (in-flight sample ids are unique), so
    every row gets at most one add: the result does not depend on the order
    of the adds, on the card as on the host.  Out of place, so that
    autograd can record it."""
    Q = row.shape[0]
    lane = torch.arange(Q, device=row.device)
    row_u = torch.where(alive[:, 0], row, accum.shape[0] - Q + lane)
    return accum.index_add(
        0, row_u, torch.where(alive, contrib, torch.zeros_like(contrib)))


def _sample_sum(accum, n_pix_local: int, spp_count: int):
    """(n_pix_local, 3) radiance sums from the per-sample rows, added in
    sample order (at spp_count 1, the rows themselves)."""
    acc = accum[: n_pix_local * spp_count].reshape(n_pix_local, spp_count, 3)
    out = acc[:, 0]
    for s in range(1, spp_count):
        out = out + acc[:, s]
    return out


def _untaped(traverse, scene, *rays, **kw):
    """A traversal outside autograd, on detached rays: its outputs are
    records with no graph behind them, so backward never runs it (and a
    recomputed chunk reads them back: :class:`_Chunk`)."""
    with torch.no_grad():
        return traverse(scene, *(r.detach() for r in rays), **kw)


def _step_slice(scene: Scene, cam, cfg: RenderConfig, key, intersect_fn,
                occluded_fn, lanes, pix_lo, n_pix_local, spp_lo, pix_stride,
                shadow_narrow, track_suspects=False, pix_ids=None,
                ray_probe=None):
    """Post-respawn step body.  Returns per-lane (contrib, pixel, cont,
    ro_next, rd_next, beta_next, include_le_next, suspect (i32, or None
    when not tracked), n_closest, n_shadow, n_ovf).  ``ray_probe``: see
    :func:`_step`."""
    ro0, rd0, beta0, ray_id, depth, include_le, alive0 = lanes
    Q = ro0.shape[0]
    dev = ro0.device
    rid_g = _global_ray_id(ray_id, cfg, pix_ids)   # keys every draw
    n_closest = torch.sum(alive0[:, 0])  # rays traced now
    base = 1 + depth * _STRIDE  # (Q,) per-lane draw base

    t_min = torch.zeros((Q, 1), dtype=ro0.dtype, device=dev)
    # Dead lanes get t_max < t_min: every backend reports a trivial miss
    # AND the cluster walk spawns no candidate pairs for them (budget +
    # work proportional to LIVE lanes only).
    t_max = torch.where(alive0, 1e30, -1.0).to(ro0.dtype)
    sus_lane = None
    scene_d = scene.detach()   # what the traversals see
    if ray_probe is not None:
        ray_probe.append((ro0, rd0, t_max))
    if track_suspects:
        hit, n_ovf, sus_c = _untaped(intersect_fn, scene_d, ro0, rd0, t_min,
                                     t_max)
        # Dead lanes are never suspect (t_max < 0 spawns no candidates).
        sus_lane = (sus_c & alive0[:, 0]).to(torch.int32)
    else:
        hit, n_ovf = _untaped(intersect_fn, scene_d, ro0, rd0, t_min, t_max)
    if cfg.debug_checks:
        _check_hits(hit, t_max, beta0)
    si = shade_info(scene, ro0, rd0, hit)
    wo_world = -rd0
    tb, bb = make_coord_space(si.ns)
    wo = to_local(wo_world, tb, bb, si.ns)
    # Local accum index (ray_id is LOCAL under pix_ids).
    pixel = torch.div(torch.clamp_min(ray_id, 0), cfg.spp,
                      rounding_mode="floor")
    if pix_ids is None:
        pixel = torch.div(pixel - pix_lo, pix_stride, rounding_mode="floor")

    zero3 = torch.zeros((Q, 3), dtype=ro0.dtype, device=dev)
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
            u = draws_lane(key, rid_g, base + _LIGHT0 + li * ns + s, 2)
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
            if ray_probe is not None:
                ray_probe.append((shadow_o, ls.wi, sh_tmax))
            if track_suspects:
                occ, ovf_s, sus_s = _untaped(occluded_fn, scene_d, shadow_o,
                                             ls.wi, sh_tmax,
                                             narrow=shadow_narrow)
                sus_lane = torch.maximum(
                    sus_lane, (sus_s & mask[:, 0]).to(torch.int32))
            else:
                occ, ovf_s = _untaped(occluded_fn, scene_d, shadow_o, ls.wi,
                                      sh_tmax, narrow=shadow_narrow)
            n_ovf = n_ovf + ovf_s
            w = f * ls.radiance * cos_s / (ls.pdf * ns)
            contrib = contrib + torch.where(mask & ~occ, beta0 * w, zero3)
    if cfg.debug_checks:
        _check(torch.all(torch.isfinite(torch.where(alive0, contrib, zero3))),
               "shading: non-finite radiance contribution")

    # ---- Scatter to next bounce. ----
    max_depth = 0 if cfg.direct_only else cfg.max_depth
    u3 = draws_lane(key, rid_g, base + _BSDF, 3)
    bs = bsdf_mod.sample(si.mat, wo, u3.detach())
    wi_world = to_world(bs.wi.detach(), tb, bb, si.ns)
    cont = alive & bs.valid & (depth < max_depth)[:, None]
    beta = beta0 * torch.where(cont, bs.weight, torch.ones_like(bs.weight))
    # Russian roulette on the segment about to be traced.
    do_rr = (depth + 1 >= cfg.rr_start)[:, None]
    u_rr = draws_lane(key, rid_g, base + _RR, 1)
    rr_kill = do_rr & (u_rr >= cfg.rr_prob)
    beta = torch.where(cont & do_rr, beta / cfg.rr_prob, beta)
    cont = cont & ~rr_kill

    ro_next = si.p + si.ng * torch.where(dot(wi_world, si.ng) > 0.0, cfg.eps,
                                         -cfg.eps)
    return (contrib, pixel, cont, ro_next, wi_world, beta, bs.delta,
            sus_lane, n_closest, n_shadow, n_ovf)


class ChunkReduce:
    """The per-chunk gradient all-reduces of differentiable wavefront renders
    over a process group: what ``wavefront_accum``'s ``psum_group`` takes,
    the port's form of the JAX package's ``psum_axis``
    (``tpu_pt/render/wavefront.py:549-594``, "grad allreduce overlapped").

    A render's steps fall in chunks: step i is in chunk ``i // inner``, with
    ``inner = max(1, round(sqrt(steps)))`` and ``steps`` the loop's static
    bound (``n_steps`` of the block, or the hint), the same on every rank.
    Each chunk reads the scene's float tensors that require grad through an
    autograd node of its own (``_ChunkView``).  When backward reaches that
    node it flattens the chunk's gradient into one buffer, starts an async
    ``all_reduce(SUM)`` of it on ``group`` (``None``: one process, nothing
    to reduce) and passes nothing on to the scene's tensors; :meth:`wait`
    waits on every reduce and sums them.  Integer fields take no part.

    The eager loop runs a different number of steps on each rank, so the
    collectives are paired by an agreed count: after the forward loop one
    ``all_reduce(MAX)`` of the render's chunk count gives ``M``, and a
    render with fewer chunks starts its ``M - n`` missing reduces as zeros,
    first, when its backward starts.  Every rank then starts as many reduces
    of one shape, and since all of them are summed, any pairing gives the
    same total (the sum is linear)."""

    def __init__(self, group=None):
        self.group = group
        self.tensors = None     # what every chunk reads, in buffer order
        self.chunks = []        # (local chunk count, agreed M) per render
        self.n_reduces = 0      # reduces started during backward
        self._pending = []      # (buffer, work or None)

    def _bind(self, tensors):
        if self.tensors is None:
            self.tensors = tensors
        elif len(tensors) != len(self.tensors) or any(
                a is not b for a, b in zip(tensors, self.tensors)):
            raise ValueError("psum_group: every render of one ChunkReduce "
                             "must differentiate the same scene tensors")

    def _agree(self, n_local: int, device) -> int:
        """M = the largest chunk count of this render over the group."""
        m = n_local
        if self.group is not None:
            import torch.distributed as dist

            t = torch.tensor([n_local], dtype=torch.int64, device=device)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
            m = int(t)
        self.chunks.append((n_local, m))
        return m

    def _start(self, buf) -> None:
        work = None
        if self.group is not None:
            import torch.distributed as dist

            work = dist.all_reduce(buf, group=self.group, async_op=True)
        self._pending.append((buf, work))
        self.n_reduces += 1

    def wait(self, tensors) -> list:
        """Wait on every reduce; the summed gradient of each of
        ``tensors`` (zeros for a tensor no chunk read)."""
        total = None
        for buf, work in self._pending:
            if work is not None:
                work.wait()
            total = buf if total is None else total + buf
        self._pending = []
        grads, at = {}, 0
        for x in self.tensors or ():
            if total is not None:
                grads[id(x)] = total[at: at + x.numel()].reshape(x.shape)
            at += x.numel()
        return [grads.get(id(x), torch.zeros_like(x.detach())) for x in tensors]


def _scene_leaves(scene, path=()):
    """(path, tensor) of every float tensor of ``scene`` (and its nested
    tuples) that requires grad."""
    out = []
    for name, x in zip(scene._fields, scene):
        if hasattr(x, "_fields"):
            out += _scene_leaves(x, path + (name,))
        elif torch.is_tensor(x) and x.requires_grad and x.is_floating_point():
            out.append((path + (name,), x))
    return out


def _with_fields(nt, path, value):
    if len(path) == 1:
        return nt._replace(**{path[0]: value})
    return nt._replace(**{path[0]: _with_fields(getattr(nt, path[0]),
                                                path[1:], value)})


class _ChunkView(torch.autograd.Function):
    """Identity on a chunk's scene tensors; its backward hands their
    gradients to the render's ``_RenderChunks``."""

    @staticmethod
    def forward(ctx, chunks, *xs):
        ctx.chunks = chunks
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.chunks.backward(grads)
        return (None,) * (1 + len(grads))


class _RenderChunks:
    """One render's chunks on a ``ChunkReduce``."""

    def __init__(self, reduce: ChunkReduce, scene: Scene):
        self.reduce = reduce
        self.leaves = _scene_leaves(scene)
        reduce._bind([x for _, x in self.leaves])
        self.pad = 0
        self.started = False

    def view(self, scene: Scene) -> Scene:
        """``scene`` reading its differentiable tensors through a new
        chunk node."""
        if not self.leaves or not torch.is_grad_enabled():
            return scene
        views = _ChunkView.apply(self, *(x for _, x in self.leaves))
        for (path, _), v in zip(self.leaves, views):
            scene = _with_fields(scene, path, v)
        return scene

    def backward(self, grads) -> None:
        buf = torch.cat([g.reshape(-1) for g in grads])
        if not self.started:
            # The reduces this rank is short of, as zeros, first.
            self.started = True
            for _ in range(self.pad):
                self.reduce._start(torch.zeros_like(buf))
        self.reduce._start(buf)


class _Chunk:
    """Steps [i0, i0 + n) of the loop on the lanes alone, as
    ``torch.utils.checkpoint`` runs them.  Its first call traverses, keeps
    every traversal's outputs in call order and ends early where the queue
    runs dry (a host read before each step past the wide prefix); it
    records how many steps it ran.  Every later call is backward's
    recomputation: it runs that many steps on the same lanes and returns
    the kept records in place of every traversal, so it traverses nothing
    and reads nothing back to the host (the port's form of the JAX
    package's ``save_only_these_names("isect")``).  Its scene, first step
    and step count are its own, bound when the forward runs."""

    def __init__(self, advance, scene, i0: int, n_max: int, prefix: int,
                 busy, intersect_fn, occluded_fn):
        self.advance, self.scene, self.busy = advance, scene, busy
        self.i0, self.n_max, self.prefix = i0, n_max, prefix
        self.isect = self._kept(intersect_fn)
        self.occl = self._kept(occluded_fn)
        self.records = []
        self.n = None          # steps run, once the first call has run
        self.replays = 0
        self._at = 0

    def _kept(self, traverse):
        def call(*a, **kw):
            if self.n is None:
                out = traverse(*a, **kw)
                self.records.append(out)
            else:
                out = self.records[self._at]
                self._at += 1
            return out
        return call

    def __call__(self, lanes):
        replay = self.n is not None
        self.replays += replay
        self._at = 0
        out = []
        for k in range(self.n if replay else self.n_max):
            i = self.i0 + k
            if not replay and k and i >= self.prefix and not self.busy(lanes):
                break
            lanes, adds, counts = self.advance(self.scene, lanes, i,
                                               self.isect, self.occl)
            out.append((adds, counts))
        self.n = len(out)
        return lanes, out


def init_queue(Q: int, n_pix_local: int, device,
               track_suspects: bool = False,
               spp_count: int = 1, dtype=torch.float32) -> QueueState:
    """Fresh all-dead queue + zero accumulator (one row per local (pixel,
    sample) and Q spare rows) and zero suspect flags; rays, throughput and
    sums in ``dtype``."""
    flt = dict(dtype=dtype, device=device)
    rd = torch.zeros((Q, 3), **flt)
    rd[:, 2] = 1.0
    return QueueState(
        ro=torch.zeros((Q, 3), **flt),
        rd=rd,
        beta=torch.zeros((Q, 3), **flt),
        ray_id=torch.full((Q,), -1, dtype=torch.int64, device=device),
        depth=torch.zeros((Q,), dtype=torch.int64, device=device),
        include_le=torch.zeros((Q, 1), dtype=torch.bool, device=device),
        alive=torch.zeros((Q, 1), dtype=torch.bool, device=device),
        next_sample=torch.zeros((), dtype=torch.int64, device=device),
        accum=torch.zeros((n_pix_local * spp_count + Q, 3), **flt),
        suspect=torch.zeros((n_pix_local if track_suspects else 1,),
                            dtype=torch.int32, device=device),
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


def wavefront_accum(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                    queue: int, backend: str, pix_lo: int, n_pix_local: int,
                    spp_lo: int = 0, spp_count: int = 0,
                    with_counts: bool = False, pix_stride: int = 1,
                    use_kernels: bool = True, pair_stage: str = "fused",
                    with_suspects: bool = False, pix_ids=None,
                    differentiable: bool = False, steps_hint=None,
                    with_done: bool = False, checked: bool = False,
                    psum_group: ChunkReduce | None = None, remat=None,
                    step_slices: int = 1):
    """Render pixels {pix_lo + j*pix_stride : j < n_pix_local} × samples
    [spp_lo, spp_lo+spp_count) -> (n_pix_local, 3) radiance sums (divide by
    cfg.spp for the full-spp mean).  ``scene``, ``cam`` and ``bvh`` hold
    tensors on one device; ``key`` is two ints.  ``pair_stage`` selects the
    form of the cluster backend's pair stage: ``"fused"``, ``"split"`` or
    ``"dedup"`` (see ``bvh/cluster.py::intersect_counted``).  ``pix_ids``
    ((n_pix_local,) global pixel ids, in place of ``pix_lo`` and
    ``pix_stride``) renders that pixel subset, each pixel as in a full
    render.

    Early-exit loop.  By default it runs under ``torch.no_grad()``, and
    after ``WIDE_PREFIX_STEPS`` wide-budget steps its shadow traversals
    run the narrow any-hit budget.  With ``differentiable`` the sums carry
    the autograd graph back to the scene's tensors (the traversals stay
    outside it), and every step runs the WIDE any-hit budget, as the JAX
    package's differentiable scan does; the loop still leaves as soon as
    nothing is alive or left to spawn, which changes no value: the steps it
    skips add nothing.

    ``step_slices`` (the JAX package's ``STEP_SLICES``) runs each step of
    the forward loop as that many strided lane slices (see :func:`_step`):
    the same image bit for bit.  It applies to the non-differentiable loop
    only, as in the JAX package; ``differentiable`` runs every step whole.

    ``steps_hint`` caps the loop at ``max(1, min(bound, steps_hint))``
    steps (the JAX package's static scan length); a cap that is too small
    drops samples, so pass ``with_done`` and check it.

    With ``with_counts`` also returns (n_closest, n_shadow, n_overflow,
    steps_run) as device scalars / int; with ``with_suspects`` the
    (n_pix_local,) i32 suspect flags follow; with ``with_done`` the last
    item is a bool: no lane alive and every sample spawned.
    ``cfg.debug_checks`` raises ``ValueError`` unless ``checked`` (the
    sanitizer's own call, ``render_wavefront_checked``).

    ``psum_group`` (a :class:`ChunkReduce`; needs ``differentiable``): the
    scene's gradient reaches the group's reduce chunk by chunk during
    backward instead of the scene's tensors; the caller takes it from
    ``psum_group.wait()`` and reduces nothing again.

    Under autograd the steps run in chunks of ``inner = max(1,
    round(sqrt(steps)))``, ``steps`` the bound or the hint, and each
    chunk's adds reach the accumulator after it, in step order.
    ``remat=None`` (the JAX package's rule): past 16 steps, or under
    ``psum_group``, each chunk runs under ``torch.utils.checkpoint`` and
    is recomputed in backward from its lanes at its start and its kept
    traversal records (:class:`_Chunk`); the tape then holds no chunk's
    shading past the chunk's own backward.  ``remat=False``: the twin,
    which keeps every step's shading on the tape; the same graph, the
    same loss and gradients bit for bit."""
    if cfg.debug_checks and not checked:
        raise ValueError(
            "RenderConfig(debug_checks=True): the wavefront's checks run "
            "only through render_wavefront_checked")
    if psum_group is not None and not differentiable:
        raise ValueError("psum_group reduces gradients: it needs "
                         "differentiable=True")
    if remat is not None and remat is not False:
        raise ValueError(f"remat must be None (recompute past 16 steps) or "
                         f"False (the twin), not {remat!r}")
    spp_count = spp_count or cfg.spp
    pick = _intersectors_suspect if with_suspects else _intersectors_counted
    intersect_fn, occluded_fn = pick(backend, bvh, use_kernels, pair_stage)
    device = scene.vertices.device
    if pix_ids is not None:
        pix_ids = torch.as_tensor(pix_ids, dtype=torch.int64, device=device)
    Q = min(queue, n_pix_local * spp_count)
    st = init_queue(Q, n_pix_local, device, track_suspects=with_suspects,
                    spp_count=spp_count, dtype=scene.vertices.dtype)
    steps = n_steps(cfg, Q, n_pix_local, spp_count)
    if steps_hint is not None:
        steps = max(1, min(steps, int(steps_hint)))
    total = n_pix_local * spp_count

    def busy(lanes):
        # One host read: anything alive or left to spawn?
        return bool(torch.any(lanes.alive) | (lanes.next_sample < total))

    # Wide warm-up PREFIX: the first waves' shadow batches are fully
    # occupied and wide-angle coherent — the binding any-hit pair
    # population — so they run the wide any-hit budget; later steps of a
    # forward render run the NARROW one (pair_mults[3]).
    prefix = min(WIDE_PREFIX_STEPS, steps)
    if differentiable:
        step_slices = 1

    def advance(chunk_scene, lanes, i, isect, occl):
        return _advance(
            chunk_scene, cam, cfg, key, isect, occl, lanes, pix_lo,
            n_pix_local, spp_lo, spp_count, pix_stride=pix_stride,
            # direct-only renders: EVERY wave is a fresh fully-occupied
            # primary wave, so the steady-state budget never applies.
            shadow_narrow=(i >= prefix and not cfg.direct_only
                           and not differentiable),
            track_suspects=with_suspects, pix_ids=pix_ids,
            step_slices=step_slices)

    nc = ns = novf = torch.zeros((), dtype=torch.int64, device=device)
    n_iter = 0
    taped = differentiable and torch.is_grad_enabled()
    remat = taped and remat is None and (steps > 16 or psum_group is not None)
    chunks = None if psum_group is None else _RenderChunks(psum_group, scene)
    inner = max(1, int(round(steps ** 0.5)))      # steps a chunk
    with torch.set_grad_enabled(taped):
        while n_iter < steps and (n_iter < prefix or busy(st)):
            # Untaped, a chunk is one step: its adds need not wait.
            run = _Chunk(advance,
                         scene if chunks is None else chunks.view(scene),
                         n_iter, min(inner if taped else 1, steps - n_iter),
                         prefix, busy, intersect_fn, occluded_fn)
            # The accumulator and the flags stay out of the chunk: a
            # checkpoint keeps its inputs.
            lanes = st._replace(accum=None, suspect=None)
            if remat:
                lanes, out = checkpoint(run, lanes, use_reentrant=False,
                                        preserve_rng_state=False)
            else:
                lanes, out = run(lanes)
            accum, suspect = st.accum, st.suspect
            for adds, (c, s, o) in out:
                accum, suspect = _apply(accum, suspect, adds, n_pix_local)
                nc, ns, novf = nc + c, ns + s, novf + o
            st = lanes._replace(accum=accum, suspect=suspect)
            n_iter += run.n
        accum = _sample_sum(st.accum, n_pix_local, spp_count)
    if chunks is not None:
        n_chunks = -(-n_iter // inner)
        chunks.pad = psum_group._agree(n_chunks, device) - n_chunks
    ret = (accum, (nc, ns, novf, n_iter)) if with_counts else (accum,)
    if with_suspects:
        ret = (*ret, st.suspect)
    if with_done:
        ret = (*ret, not busy(st))
    return ret if len(ret) > 1 else ret[0]


def render_wavefront(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                     queue: int = 1 << 17, backend: str = "bvh",
                     device="cuda", use_kernels: bool = True,
                     pair_stage: str = "fused", fast: bool = True):
    """Full-image render -> (H, W, 3) linear radiance tensor on ``device``.
    ``key`` is a pair of 32-bit ints.  ``fast=False`` renders through the
    differentiable loop (``wavefront_accum(differentiable=True)``): the
    image carries the graph back to the scene's tensors."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    accum = wavefront_accum(scene, cam, cfg, key, bvh, queue, backend,
                            0, cfg.n_pixels, use_kernels=use_kernels,
                            pair_stage=pair_stage, differentiable=not fast)
    return (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)


def render_wavefront_checked(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                             queue: int = 1 << 17, backend: str = "bvh",
                             device="cuda"):
    """The sanitizer render: ``render_wavefront(fast=False)``'s loop (the
    wide any-hit budget every step; no autograd tape) with
    ``cfg.debug_checks`` forced on.  Raises ``CheckError`` on the first
    violated invariant: the scene's vertices, normals and sphere centres
    and radii finite, then per step a positive, finite hit t no farther
    than t_max, barycentrics inside the triangle, a finite throughput and a
    finite shading contribution.  On a sound scene the image is
    ``render_wavefront(fast=False)``'s, bit for bit."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    # Inputs first: NaN geometry masks into misses downstream (every NaN
    # comparison is False), so no later check would see it.
    for name in ("vertices", "normals", "sph_center", "sph_radius"):
        _check(torch.all(torch.isfinite(getattr(scene, name))),
               f"scene.{name} has non-finite values")
    with torch.no_grad():
        accum = wavefront_accum(
            scene, cam, cfg.replace(debug_checks=True), key, bvh, queue,
            backend, 0, cfg.n_pixels, differentiable=True, checked=True)
    return (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)


def render_wavefront_counts(scene: Scene, cam, cfg: RenderConfig, key, bvh,
                            queue: int = 1 << 17, backend: str = "bvh",
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


def render_wavefront_suspect_counts(scene: Scene, cam, cfg: RenderConfig, key,
                                    bvh, queue: int = 1 << 17,
                                    backend: str = "bvh", device="cuda",
                                    use_kernels: bool = True,
                                    pair_stage: str = "fused"):
    """``render_wavefront_counts`` + a per-pixel SUSPECT flag: pixel p is
    flagged iff a traversal of one of its path segments had that segment's
    candidates cut by a static budget, i.e. exactly the pixels a render on
    the exact fallback could change.  Returns (image, n_closest, n_shadow,
    n_overflow, n_steps_run, suspect (n_pixels,) i32 tensor on the device);
    the input of :func:`repair_suspect_pixels`."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    accum, (nc, ns, novf, n_iter), sus = wavefront_accum(
        scene, cam, cfg, key, bvh, queue, backend, 0, cfg.n_pixels,
        with_counts=True, use_kernels=use_kernels, pair_stage=pair_stage,
        with_suspects=True)
    img = (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return img, int(nc), int(ns), int(novf), n_iter, sus


def repair_suspect_pixels(scene: Scene, cam, cfg: RenderConfig, key,
                          bvh_exact, img, suspect_flags, queue: int = 1 << 17,
                          backend: str = "cluster", device="cuda",
                          use_kernels: bool = True,
                          pair_stage: str = "fused"):
    """Render ONLY the suspect pixels again on ``bvh_exact`` (a cluster BVH
    with the fallback attached) and splice them into ``img`` (H, W, 3).
    Returns (repaired image on ``device``, overflow count of the subset
    render).

    The cost follows the suspect count, not the image size.  The subset is
    padded to the next power of two, at least 16, by repeating the first
    suspect pixel; the repeats fill accumulator rows of their own and are
    dropped at the splice."""
    device, scene, cam, bvh_exact = _on_device(device, scene, cam, bvh_exact)
    sus = torch.nonzero(torch.as_tensor(suspect_flags).reshape(-1).to(
        device)).reshape(-1)
    out = torch.as_tensor(img, device=device).reshape(-1, 3).clone()
    if sus.numel() == 0:
        return out.reshape(cfg.height, cfg.width, 3), 0
    n = 1 << max(4, (sus.numel() - 1).bit_length())
    ids = torch.full((n,), int(sus[0]), dtype=torch.int64, device=device)
    ids[: sus.numel()] = sus
    accum, (_, _, novf, _) = wavefront_accum(
        scene, cam, cfg, key, bvh_exact, min(queue, n * cfg.spp), backend, 0,
        n, with_counts=True, use_kernels=use_kernels, pair_stage=pair_stage,
        pix_ids=ids)
    out[sus] = (accum / cfg.spp)[: sus.numel()]
    return out.reshape(cfg.height, cfg.width, 3), int(novf)
