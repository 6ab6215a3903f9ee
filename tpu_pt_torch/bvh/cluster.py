"""Cluster BVH: SAH leaves as dense primitive tiles under an implicit 8-ary
AABB pyramid, traversed level-synchronously for a whole batch of rays.

  1. **Clusters**: SAH leaves of <= TILE (128) primitives, pretransformed to
     a (C, 12, TILE) tile tensor — primitive lane = minor axis, so one
     cluster is one contiguous 6 KB block.
  2. **Implicit 8-ary level pyramid** over cluster AABBs: level l+1 packs
     the 8 children of node i at rows [8i, 8i+8), so the traversal needs no
     index tables; a child fetch is one contiguous block gather.
  3. **Sort-free compact descent**: a dense slab test of every ray against
     the top level, then per level a block gather of the live nodes'
     children (``kernels.fetch.fetch_fields``: their box fields as planes),
     a dense slab test and a 1-bit lane compaction.
  4. **Pair stage**: the live (ray, cluster) candidates are flattened to one
     ray-major pair list; every pair is tile-tested and the results are
     reduced per ray.  Exact: every live candidate is tested, no best-t
     feedback.  ``pair_stage`` names the form (``PAIR_STAGES``):
     ``"fused"`` (the default) does both in one kernel,
     ``kernels.pair_fused.pair_ray_reduce``; ``"split"`` tile-tests the
     list (``kernels.cluster_isect.pair_tile_isect``) and reduces it
     (``kernels.pair_scan.pair_segmin``) with array code around the two,
     and gives the same bits; ``"dedup"`` is cluster-major instead: the
     list is sorted by cluster id, tile-tested by
     ``kernels.cluster_isect.pair_tile_isect_dedup`` (pairs of one id sit
     side by side, so their tile is found in cache) and reduced per ray by scatter-min / scatter-add.

Capacity contract: the per-level frontier widths, the leaf candidate count
and the flat pair budget are static.  Truncation is *counted* (the
``*_counted`` entry points return it) and a count of 0 means the traversal
was exact.  A ray whose candidates were cut anywhere is SUSPECT (its
result may have lost a hit); ``suspect_out`` hands the per-ray mask to the
caller.  With an exact fallback attached (``attach_fallback``: a packed
BVH), every traversal call also walks the packed BVH for its suspect rays
and takes the walk's answer for them, so truncation costs time, never a
hit.  The walk is launched on every such call (non-suspect rays get
``t_max = -1`` and leave at the root), so that no host read decides it.

Two builds make the structure: ``build_cluster_bvh`` on the host (SAH
leaves from the native builder, numpy), and ``build_cluster_device``,
torch ops on the card (Morton-ordered chunks, refined by SAH window
splits, under wider default caps: ``cap_scale``).

``ClusterBVH.traversal_mode`` selects the walk: the compact traversal
above (the default, the only one that flags suspects), the "frontier" walk (per-ray t-sorted, truncated frontiers and
best-t feedback rounds, ``_traverse``; ``candidate_stats``) or the "pairs"
walk (a ray-sorted list of live (ray, node) pairs cut to a budget at every
level, ``_traverse_pairs``; ``pairs_stats``), the JAX package's earlier
traversals; those two take the "fused" and "split" pair stages for every
pair batch (round 1 of the frontier walk as gapped segments, one a ray)
and refuse "dedup".  The capacity tooling sizes the
compact budgets from measured rays (``level_hit_counts``, ``autotune_*``);
everything runs under ``torch.no_grad()`` semantics (no tensor requires
grad).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from tpu_pt_torch.bvh import native, packed as packed_mod
from tpu_pt_torch.bvh.lbvh import morton_codes
from tpu_pt_torch.bvh.sah import build_bvh, prim_bounds
from tpu_pt_torch.config import resolve_device
from tpu_pt_torch.core.intersect import INF, as_col
from tpu_pt_torch.kernels.cluster_isect import (
    B as PBLK, _mt_group, pair_rows as _pair_rows, pair_tile_isect,
    pair_tile_isect_dedup, pair_tile_isect_dedup_ref, pair_tile_isect_ref)
from tpu_pt_torch.kernels.fetch import (
    fetch_fields, fetch_fields_ref, fetch_rows, fetch_rows_ref)
from tpu_pt_torch.kernels.pair_fused import (
    pair_ray_reduce, pair_ray_reduce_ref, row_segments)
from tpu_pt_torch.kernels.pair_scan import pair_segmin, pair_segmin_ref
from tpu_pt_torch.render.brute import Hit
from tpu_pt_torch.scene.types import Scene

TILE = 128  # primitives per cluster

# Forms of the pair stage (the ``pair_stage`` keyword of the traversal).
PAIR_STAGES = ("fused", "split", "dedup")


def _check_pair_stage(pair_stage: str) -> None:
    if pair_stage not in PAIR_STAGES:
        raise ValueError(f"unknown pair_stage {pair_stage!r}: expected one "
                         f"of {', '.join(PAIR_STAGES)}")


def _bf16_outward(lo: np.ndarray, hi: np.ndarray):
    """Round AABBs OUTWARD onto the bf16 grid (lo down, hi up) so that a
    bf16 slab test can only produce false POSITIVES, never a false miss.
    Returns the uint16 bit patterns (h_lo, h_hi).

    Works in bf16 magnitude-bit space: truncating an f32 to its high 16
    bits rounds toward zero, so the needed 1-ulp nudge is sign-dependent.
    """
    def trunc(x):
        b = x.astype(np.float32).view(np.uint32)
        return (b >> 16).astype(np.uint16)

    def val(h):
        return (h.astype(np.uint32) << 16).view(np.float32)

    h_lo = trunc(lo)
    need = val(h_lo) > lo          # only for negative lo (trunc went up)
    h_lo = (h_lo + need.astype(np.uint16))
    h_hi = trunc(hi)
    need = val(h_hi) < hi          # only for positive hi (trunc went down)
    h_hi = (h_hi + need.astype(np.uint16))
    return h_lo, h_hi


def _levels16(levels):
    """bf16 outward-rounded copies of the level tables, as (N, 8) uint16
    arrays of bf16 BIT PATTERNS (numpy has no bfloat16; the tensors view
    them as ``torch.bfloat16``, whose ``.float()`` is exact)."""
    out = []
    for lv in levels:
        lv = np.asarray(lv)
        h_lo, h_hi = _bf16_outward(lv[:, 0:3], lv[:, 3:6])
        row = np.zeros((lv.shape[0], 8), np.uint16)
        row[:, 0:3] = h_lo
        row[:, 3:6] = h_hi
        out.append(row)
    return out


def _bf16_tensor(bits: np.ndarray, device):
    """uint16 bf16 bit patterns -> a ``torch.bfloat16`` tensor."""
    return torch.from_numpy(
        np.ascontiguousarray(bits).view(np.int16)).to(device).view(
        torch.bfloat16)


class ClusterBVH(NamedTuple):
    """levels[l]: (N_l, 8) f32 rows [min.xyz, max.xyz, 0, 0], root-first;
    level[l+1] has exactly 8*N_l rows (empty slots have min=+INF, max=-INF
    and fail every slab test).
    levels16[l]: bf16 copies rounded OUTWARD — the gathered tables of the
      descent (host: uint16 bit patterns; device: ``torch.bfloat16``).
    tiles: (C, 12, L) f32 — lane p of cluster c holds primitive p as rows
      [v0.xyz, e1.xyz, e2.xyz, type, 0, 0] (tri: edges; sphere: v0=centre,
      e1.x=radius, type=1; padding lanes are all-zero => miss).
    tile_gid: (C, L) i32 global primitive id (pad lanes 0 — never hit).
    frontiers / k_leaf: static per-level frontier capacities and the leaf
      candidate budget.
    pair_mults: pair budgets × Q: (top flatten, intermediate levels,
      closest leaf pairs, NARROW any-hit leaf pairs).
    top_soa / child16: device-side derived tables (``to`` fills them):
      ``levels[0].T`` and, per level l >= 1, the (N_l / 8, 64) field-major
      sibling rows [f0 of children 0..7, f1 of children 0..7, ...].
    fallback: None, or the exact-retrace ``PackedBVH`` of the same scene
      (``attach_fallback``), moved with the rest by ``to``.
    traversal_mode: the walk every traversal call runs (the JAX package's
      ``TRAVERSAL_MODE``, there a module global; here it travels with the
      budgets it reads): one of ``TRAVERSAL_MODES``, checked at the call;
      ``cb._replace(traversal_mode="frontier")`` selects another."""

    levels: tuple
    tiles: object
    tile_gid: object
    frontiers: tuple
    k_leaf: int
    pair_budget: int
    pair_mults: tuple
    levels16: tuple
    top_soa: object = None
    child16: tuple = ()
    fallback: object = None
    traversal_mode: str = "compact"

    @property
    def n_clusters(self) -> int:
        return self.tiles.shape[0]

    def to(self, device) -> "ClusterBVH":
        """Tensors on ``device`` plus the derived descent tables."""
        device = torch.device(device)
        here = self.tiles.device if torch.is_tensor(self.tiles) else None
        fallback = None if self.fallback is None else \
            self.fallback.to(device)
        if self.top_soa is not None and here is not None \
                and here.type == device.type \
                and device.index in (None, here.index):
            return self if fallback is None else \
                self._replace(fallback=fallback)

        def dev(x):
            return x.to(device) if torch.is_tensor(x) else torch.from_numpy(
                np.ascontiguousarray(x)).to(device)

        levels = tuple(dev(lv) for lv in self.levels)
        levels16 = tuple(
            lv.to(device) if torch.is_tensor(lv) else _bf16_tensor(lv, device)
            for lv in self.levels16)
        child16 = (None,) + tuple(
            lv.reshape(-1, 8, 8).transpose(1, 2).reshape(-1, 64).contiguous()
            for lv in levels16[1:])
        return self._replace(
            levels=levels, tiles=dev(self.tiles).contiguous(),
            tile_gid=dev(self.tile_gid), levels16=levels16,
            top_soa=levels[0].T.contiguous(), child16=child16,
            fallback=fallback)


def make_cluster_bvh(levels, tiles, tile_gid, frontiers, k_leaf: int,
                     pair_budget: int, pair_mults=(8, 8, 6),
                     levels16=None) -> ClusterBVH:
    """Host container from numpy arrays.  A 3-entry ``pair_mults`` gets the
    derived 4th entry, the NARROW any-hit pair budget: about 2/3 of the
    closest leaf multiplier, at least 2."""
    pair_mults = tuple(pair_mults)
    if len(pair_mults) == 3:
        pair_mults += (max(2, -(-2 * pair_mults[2] // 3)),)
    if levels16 is None:
        levels16 = _levels16(levels)
    return ClusterBVH(tuple(levels), tiles, tile_gid, tuple(frontiers),
                      int(k_leaf), int(pair_budget), pair_mults,
                      tuple(levels16))


def _prim_lane_rows(scene: Scene, pid) -> torch.Tensor:
    """(len(pid), 12) packed rows for the tile tensor (before transpose):
    ``native.prim_rows`` without its material column, so the type moves to
    column 9."""
    r = native.prim_rows(scene, pid)
    return torch.cat([r[:, :9], r[:, 10:13]], 1)


def default_frontiers(level_sizes: Sequence[int]):
    """Per-level frontier capacities (top-first) + leaf candidate budget K.

    A ray through an n^3-cell grid pierces ~3n cells; the leaf level follows
    that model (2.5n + 8).  INTERMEDIATE levels need ~4n: their AABBs
    overlap more (each is the union of 8 children), so a ray stabs more of
    them than the disjoint-grid estimate (4n + 10)."""
    caps = []
    last = len(level_sizes) - 1
    for i, s in enumerate(level_sizes):
        n = max(1.0, float(s)) ** (1.0 / 3.0)
        if i == last:
            caps.append(int(min(s, max(12, int(2.5 * n) + 8))))
        else:
            caps.append(int(min(s, max(16, int(4.0 * n) + 10))))
    return tuple(caps), caps[-1]


def build_cluster_bvh(scene: Scene, tile: int = TILE,
                      frontiers: Sequence[int] | None = None,
                      k_leaf: int | None = None,
                      pair_budget: int | None = None,
                      dense_start: int = 512,
                      pair_mults: Sequence[int] | None = None) -> ClusterBVH:
    """Host build: SAH leaves (<= tile prims) from the native C++ builder
    (where it cannot be built, from the Python SAH builder, with a
    ``native.BuilderFallbackWarning``) -> padded tile tensor + implicit
    8-ary AABB pyramid (all numpy; upload with ``.to(device)``).  ``scene``
    holds host arrays."""
    leaves = native.build_leaves(scene, max_leaf=tile)
    if leaves is not None:
        start, cnt, lo, hi, pid = leaves
    else:
        native.warn_fallback("the cluster BVH's leaves")
        bvh = build_bvh(scene, max_leaf=tile)
        count = np.asarray(bvh.prim_count)
        leaf = np.flatnonzero(count > 0)
        start = np.asarray(bvh.prim_start)[leaf]
        cnt = count[leaf]
        lo = np.asarray(bvh.node_min)[leaf]
        hi = np.asarray(bvh.node_max)[leaf]
        pid = np.asarray(bvh.prim_ids)
    C = len(start)

    # Tile tensor: (C, 12, tile) with zero padding (zero rows never hit:
    # zero edges => det 0 for triangles, radius 0 for spheres).  Lanes are
    # sorted by gid within each cluster so "first lane at min t" — the rule
    # the pair kernel uses — IS the lowest-gid tie-break.
    rows_all = _prim_lane_rows(scene, pid).numpy()  # (P, 12), leaf order
    rows = np.zeros((C, tile, 12), np.float32)
    gid = np.zeros((C, tile), np.int32)
    for c in range(C):
        s, n = start[c], cnt[c]
        o = np.argsort(pid[s:s + n], kind="stable")
        rows[c, :n] = rows_all[s:s + n][o]
        gid[c, :n] = pid[s:s + n][o]
    tiles = np.ascontiguousarray(rows.transpose(0, 2, 1))  # (C, 12, tile)

    # Implicit 8-ary pyramid: sizes fixed top-down so level l+1 has exactly
    # 8x the rows of level l (the ladder N0, 8*N0, 64*N0, ... >= C); slots
    # beyond real nodes are empty AABBs (min=+INF > max=-INF, never hit).
    # The top level is tested DENSELY against every ray, so it can be
    # hundreds of nodes wide — every level it replaces removes a block
    # gather + compaction step.
    sizes = _ladder_sizes(C, dense_start)
    n_levels = len(sizes)

    bot = np.zeros((sizes[-1], 8), np.float32)
    bot[:, 0:3] = np.inf
    bot[:, 3:6] = -np.inf
    bot[:C, 0:3] = lo
    bot[:C, 3:6] = hi
    levels = [bot]
    for _ in range(n_levels - 1):
        child = levels[0]
        parent = np.zeros((child.shape[0] // 8, 8), np.float32)
        parent[:, 0:3] = child[:, 0:3].reshape(-1, 8, 3).min(1)
        parent[:, 3:6] = child[:, 3:6].reshape(-1, 8, 3).max(1)
        levels.insert(0, parent)

    if frontiers is None or k_leaf is None:
        df, dk = default_frontiers([lv.shape[0] for lv in levels])
        frontiers = tuple(frontiers) if frontiers is not None else df
        k_leaf = int(k_leaf) if k_leaf is not None else dk
    if len(frontiers) != len(levels):
        raise ValueError(f"{len(frontiers)} frontier caps {tuple(frontiers)} "
                         f"for {len(levels)} levels {sizes}")
    pair_budget = pair_budget or min(k_leaf, 4)
    return make_cluster_bvh(
        levels, tiles, gid, tuple(frontiers), int(k_leaf), int(pair_budget),
        pair_mults=tuple(pair_mults) if pair_mults is not None else (8, 8, 6))


def _ladder_sizes(C: int, dense_start: int):
    """Row counts of the implicit 8-ary pyramid over C clusters, top-first:
    the top level is the first of C, C/8, C/64, ... (rounded up) at most
    ``dense_start`` wide, and each level below has 8x its rows."""
    n_levels = 1
    top = C
    while top > dense_start:
        top = -(-top // 8)
        n_levels += 1
    return [top * 8 ** l for l in range(n_levels)]


def _levels16_t(levels):
    """``_levels16`` on tensors: the bf16 outward-rounded copies of the
    level tables as ``torch.bfloat16`` (N, 8) tensors on the levels'
    device, the same bits.  The f32 words are read as int64 so that no
    sign bit smears into the bf16 half."""
    def trunc(x):
        return (x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF) >> 16

    def val(h):
        w = h << 16
        return torch.where(w >= 1 << 31, w - (1 << 32), w).to(
            torch.int32).view(torch.float32)

    out = []
    for lv in levels:
        lo, hi = lv[:, 0:3].contiguous(), lv[:, 3:6].contiguous()
        h_lo = trunc(lo)
        h_lo = (h_lo + (val(h_lo) > lo).to(torch.int64)) & 0xFFFF
        h_hi = trunc(hi)
        h_hi = (h_hi + (val(h_hi) < hi).to(torch.int64)) & 0xFFFF
        row = torch.zeros((lv.shape[0], 8), dtype=torch.int64,
                          device=lv.device)
        row[:, 0:3] = h_lo
        row[:, 3:6] = h_hi
        row = torch.where(row >= 1 << 15, row - (1 << 16), row)
        out.append(row.to(torch.int16).view(torch.bfloat16))
    return out


def _sah_costs(live, lo_f, hi_f, C: int, tile: int):
    """The exact 1-D SAH cost of every internal cut of each of C windows
    and of the unsplit window: ((C, tile-1) areaL*nL + areaR*nR, (C,)
    area*n), from prefix / suffix box scans, in the reference's order of
    operations (each product and sum rounded once)."""
    lo_w = lo_f.reshape(C, tile, 3)
    hi_w = hi_f.reshape(C, tile, 3)
    pre_lo = torch.cummin(lo_w, dim=1).values
    pre_hi = torch.cummax(hi_w, dim=1).values
    suf_lo = torch.cummin(lo_w.flip(1), dim=1).values.flip(1)
    suf_hi = torch.cummax(hi_w.flip(1), dim=1).values.flip(1)

    def _area(l, h):
        d = torch.clamp_min(h - l, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    n_w = torch.sum(live.reshape(C, tile), dim=1)           # live a window
    i_cut = torch.arange(1, tile, device=lo_f.device)
    nL = torch.minimum(i_cut[None, :], n_w[:, None]).to(torch.float32)
    nR = n_w[:, None].to(torch.float32) - nL
    # Cut at i: left = lanes [0, i) (prefix index i-1), right = [i, tile).
    cost = (_area(pre_lo[:, :-1], pre_hi[:, :-1]) * nL
            + _area(suf_lo[:, 1:], suf_hi[:, 1:]) * nR)
    return cost, _area(pre_lo[:, -1], pre_hi[:, -1]) * n_w.to(torch.float32)


def _sah_split_round(rows, gid_f, live, lo_f, hi_f, C: int, tile: int,
                     split_tau: float):
    """One SAH-swept window-split round of the device cluster build.

    Each of the C current chunks (lanes filled from 0) is a window: every
    internal cut is costed (``_sah_costs``) and the window splits into
    chunk slots 2w / 2w+1 iff its best cut costs less than ``split_tau`` x
    the unsplit cost.  An unsplit window leaves slot 2w+1 empty (an
    inverted box, never a candidate).  Returns the arrays at 2C chunks and
    2C."""
    dev = lo_f.device
    cost, whole = _sah_costs(live, lo_f, hi_f, C, tile)
    best_cost, best = torch.min(cost, dim=1)   # the first minimum, as argmin
    cut = torch.where(best_cost < split_tau * whole, best + 1, tile)

    o = torch.arange(tile, device=dev)[None, :]
    right = o >= cut[:, None]
    chunk = 2 * torch.arange(C, device=dev)[:, None] + right.to(torch.int64)
    lane = o - torch.where(right, cut[:, None], 0)
    slot = (chunk * tile + lane).reshape(-1)                # unique slots
    C2 = 2 * C

    def spread(x, fill):
        out = torch.full((C2 * tile,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=dev)
        out[slot] = x
        return out

    return (spread(rows, 0.0), spread(gid_f, 0), spread(live, False),
            spread(lo_f, float("inf")), spread(hi_f, float("-inf")), C2)


def _morton_chunks(scene: Scene, tile: int):
    """The device build's input before refinement, from a tensor scene:
    the primitives in Morton order (a stable sort of their centroids'
    codes) as (C*tile, 12) tile rows, gids, live flags and bounds, padded
    to C = ceil(P / tile) chunks (padding: zero rows, gid 0, dead, an
    inverted box).  Returns (rows, gid_f, live, lo_f, hi_f, C)."""
    lo, hi = prim_bounds(scene)
    P = lo.shape[0]
    cent = (lo + hi) * 0.5
    codes = morton_codes(cent, torch.amin(lo, 0), torch.amax(hi, 0))
    og = torch.sort(codes, stable=True).indices
    rows = _prim_lane_rows(scene, og)
    dev = rows.device

    C = -(-P // tile)
    pad = C * tile - P
    inf = float("inf")
    return (torch.cat([rows, rows.new_zeros((pad, 12))]),
            torch.cat([og, og.new_zeros((pad,))]),
            torch.arange(C * tile, device=dev) < P,
            torch.cat([lo[og], lo.new_full((pad, 3), inf)]),
            torch.cat([hi[og], hi.new_full((pad, 3), -inf)]), C)


@torch.no_grad()
def build_cluster_device(scene: Scene, tile: int = TILE,
                         frontiers: Sequence[int] | None = None,
                         k_leaf: int | None = None,
                         pair_budget: int | None = None,
                         dense_start: int = 512,
                         cap_scale: float = 1.35,
                         split_tau: float | None = 0.5,
                         split_rounds: int = 1,
                         device="cuda") -> ClusterBVH:
    """Device cluster build: primitives Morton-sorted by centroid and
    chopped into consecutive ``tile``-wide chunks, whose boxes form the
    pyramid; torch ops on ``device`` (the card by default; raises without
    one unless ``device="cpu"``), no host build.  Returns the
    ``ClusterBVH`` on ``device`` with its descent tables filled.  Cluster
    quality is below the host SAH build (Morton chunks overlap more), which
    costs traversal time, not correctness: the same capacity contract.

    ``split_tau``: SAH window refinement.  Each ``tile``-wide window is
    swept for its best internal cut (exact 1-D SAH over every cut) and
    splits into two chunks iff that cut's cost, areaL*nL + areaR*nR, is
    below ``split_tau`` x the unsplit cost; ``split_rounds`` rounds, each
    doubling the chunk slots (an unsplit window leaves an empty slot).
    ``None`` turns it off (plain chunking).

    ``cap_scale`` and ``split_tau`` are coupled.  Morton chunks need wider
    frontiers than SAH clusters, so the default caps are the geometric
    model's times ``cap_scale`` (1.35), computed on the PRE-split ladder:
    with refinement on, half the slots of every level are empty, so the
    n^(1/3) model runs on the level sizes shifted right by
    ``split_rounds``.  With ``split_tau=None`` the same 1.35 scales the
    caps of the plain chunking's full ladder.  The pair multipliers are
    ``(8, 8, ceil(6 * cap_scale), ceil(4 * cap_scale))``, (8, 8, 9, 6) at
    the default."""
    scene = scene.to(resolve_device(device))
    rows, gid_f, live, lo_f, hi_f, C = _morton_chunks(scene, tile)
    dev = rows.device
    inf = float("inf")

    if split_tau is not None:
        for _ in range(max(1, int(split_rounds))):
            rows, gid_f, live, lo_f, hi_f, C = _sah_split_round(
                rows, gid_f, live, lo_f, hi_f, C, tile, split_tau)

    # Lanes sorted by gid within each cluster, padding last: the first lane
    # at the least t is then the lowest gid, the tie rule of the pair stage
    # (``pair_ray_reduce`` relies on it).
    gid = gid_f.reshape(C, tile)
    live_w = live.reshape(C, tile)
    key = torch.where(live_w, gid, 2 ** 31 - 1)
    lane_o = torch.sort(key, dim=1, stable=True).indices
    gid = torch.where(torch.gather(live_w, 1, lane_o),
                      torch.gather(gid, 1, lane_o), 0).to(torch.int32)
    rows = torch.gather(rows.reshape(C, tile, 12), 1,
                        lane_o[:, :, None].expand(C, tile, 12))
    tiles = rows.transpose(1, 2).contiguous()

    sizes = _ladder_sizes(C, dense_start)
    pad_c = sizes[-1] - C
    cur_lo = torch.cat([torch.amin(lo_f.reshape(C, tile, 3), 1),
                        lo_f.new_full((pad_c, 3), inf)])
    cur_hi = torch.cat([torch.amax(hi_f.reshape(C, tile, 3), 1),
                        hi_f.new_full((pad_c, 3), -inf)])
    levels = []
    for li in range(len(sizes)):
        levels.insert(0, torch.cat(
            [cur_lo, cur_hi, cur_lo.new_zeros((cur_lo.shape[0], 2))], 1))
        if li < len(sizes) - 1:
            cur_lo = torch.amin(cur_lo.reshape(-1, 8, 3), 1)
            cur_hi = torch.amax(cur_hi.reshape(-1, 8, 3), 1)

    if frontiers is None or k_leaf is None:
        sz = [lv.shape[0] for lv in levels]
        eff = sz if split_tau is None else \
            [max(1, s >> int(split_rounds)) for s in sz]
        df, dk = default_frontiers(eff)
        df = tuple(min(s, int(np.ceil(c * cap_scale)))
                   for s, c in zip(sz, df))
        dk = min(sz[-1], int(np.ceil(dk * cap_scale)))
        frontiers = tuple(frontiers) if frontiers is not None else df
        k_leaf = int(k_leaf) if k_leaf is not None else dk
    if len(frontiers) != len(levels):
        raise ValueError(f"{len(frontiers)} frontier caps {tuple(frontiers)} "
                         f"for {len(levels)} levels {sizes}")
    pair_budget = pair_budget or min(k_leaf, 4)
    mults = (8, 8, int(np.ceil(6 * cap_scale)), int(np.ceil(4 * cap_scale)))
    return ClusterBVH(tuple(levels), tiles, gid, tuple(frontiers),
                      int(k_leaf), int(pair_budget), mults,
                      tuple(_levels16_t(levels))).to(dev)


# ---------------------------------------------------------------------------
# Pair stage
# ---------------------------------------------------------------------------


def _prim_tile_test(tile, ro, rd, t_min, t_max):
    """Dense MT + sphere test of rays vs their tile.  tile: (P, 12, L);
    ro/rd: (P, 3); t bounds (P, 1).  Returns (t (P, L), u, v) with INF on
    miss.  (The arithmetic is ``kernels.cluster_isect._mt_group``.)"""
    rays = torch.zeros((tile.shape[0], 16), dtype=tile.dtype,
                       device=tile.device)
    rays[:, 0:3] = ro
    rays[:, 3:6] = rd
    rays[:, 6:7] = t_min
    rays[:, 7:8] = t_max
    rays[:, 8] = 1.0
    return _mt_group(tile, rays)


def _test_pair_batch(cb: ClusterBVH, ro, rd, t_min1, t_max1, ray_c, cid_c,
                     pair_ok, use_kernels: bool = True):
    """Tile intersection of a flat pair batch.  Returns per-pair
    (t (P,), u, v, gid i32) with INF on miss."""
    cid_c = torch.clamp(cid_c, 0, cb.n_clusters - 1)
    P = cid_c.shape[0]
    cid_p, rays = _pair_rows(ro, rd, t_min1, t_max1, ray_c, cid_c, pair_ok)
    isect = pair_tile_isect if use_kernels else pair_tile_isect_ref
    out = isect(cb.tiles, cid_p, rays)[:P]
    lane = out[:, 1].to(torch.int64).clamp(0, cb.tiles.shape[2] - 1)
    return out[:, 0], out[:, 2], out[:, 3], cb.tile_gid[cid_c, lane]


def _seg_min(t, seg_start, gid=None):
    """Segmented running minimum along axis 0, reset where ``seg_start``:
    returns (min_t, position of that minimum) at every element (inclusive).
    With ``gid``, ties in t go to the LOWEST gid; remaining ties (and every
    tie without ``gid``) to the earliest position.  A NaN that heads a
    segment is its minimum all through the segment.  The minimum comes back
    with -0 as +0, as the JAX package's scan gives it.

    The JAX package computes this as an associative scan; here it is one
    running minimum (``torch.cummin``) of a unique integer key: the
    segment, counted down, above the element's rank in the lexicographic
    (t, gid, position) order (two stable sorts; -0 ranks with +0, as the
    scan compares them).  A NaN head ranks first in its segment."""
    n = t.shape[0]
    key_t = t + 0.0                       # -0 -> +0
    if gid is None:
        order = torch.sort(key_t, stable=True).indices
    else:
        order = torch.sort(gid, stable=True).indices
        order = order[torch.sort(key_t[order], stable=True).indices]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=t.device)
    seg = torch.cumsum(seg_start.to(torch.int64), 0)
    rank = torch.where(seg_start & torch.isnan(t), 0, rank + 1)
    mi = torch.cummin((seg[-1] + 1 - seg) * (n + 1) + rank, 0).indices
    return t[mi] + 0.0, mi


def _child_planes(cb: ClusterBVH, l: int, node):
    """The six box fields of the 8 children of each node id in ``node`` (any
    shape) at level ``l``, as f32 (*node.shape, 8) planes, gathered by
    indexing the field-major rows (the bf16 outward-rounded table under
    ``GATHER_BF16``)."""
    if GATHER_BF16:
        child = cb.child16[l]
    else:
        child = cb.levels[l].reshape(-1, 8, 8).transpose(1, 2).reshape(-1, 64)
    blk = child[node].float()
    return tuple(blk[..., f * 8:(f + 1) * 8] for f in range(6))


# ---------------------------------------------------------------------------
# Frontier traversal (traversal_mode "frontier"): per ray a t-sorted,
# truncated frontier per level, then best-t feedback rounds over the leaf
# candidates.
# ---------------------------------------------------------------------------


def _sort_trunc(te, idx, cap: int):
    """Sort each ray's candidates by entry t and keep the first ``cap``.
    The keys are the entry t ROUNDED DOWN to bf16 (the low 16 bits cleared:
    exact for t >= 0), so the t kept is a lower bound and best-t pruning
    stays exact; the INF sentinel rounds down to 9.953038e29 and is put
    back.  A stable sort.  Returns (te, idx, per-ray count of finite
    candidates cut)."""
    te16 = (te.contiguous().view(torch.int32) & -65536).view(torch.float32)
    te16, order = torch.sort(te16, dim=1, stable=True)
    idx = torch.gather(idx, 1, order)
    te = torch.where(te16 >= 9.953038e29, INF, te16)
    ovf = torch.sum(te[:, cap:] < INF, dim=1) if te.shape[1] > cap else \
        torch.zeros((te.shape[0],), dtype=torch.int64, device=te.device)
    return te[:, :cap], idx[:, :cap], ovf


def _top_sorted(cb: ClusterBVH) -> bool:
    """Whether ``_descend`` sorts (and cuts) the top level: only where it is
    wider than its cap."""
    return cb.levels[0].shape[0] > cb.frontiers[0]


def _descend(cb: ClusterBVH, ro, rd_inv, t_min, t_max):
    """Frontier descent: a dense slab test of the top level, then per level
    the children of the kept nodes (a gather of their rows), a slab test
    and ``_sort_trunc`` to the level's cap (``frontiers[l]``; ``k_leaf`` at
    the leaves).  Returns (cand (Q, K) i64 cluster ids, t-ascending,
    cand_t (Q, K) rounded-down entry t, INF in dead slots, overflow (Q,)
    i64 finite candidates cut at any level).  The top level is sorted only
    where it is wider than its cap (``_top_sorted``)."""
    Q = ro.shape[0]
    levels = cb.levels
    caps = cb.frontiers
    ro_c = tuple(ro[:, i:i + 1] for i in range(3))          # (Q, 1) each
    ri_c = tuple(rd_inv[:, i:i + 1] for i in range(3))

    topT = cb.top_soa
    te = _slab_soa(tuple(topT[i][None, :] for i in range(3)),
                   tuple(topT[3 + i][None, :] for i in range(3)),
                   ro_c, ri_c, t_min, t_max)                # (Q, N0)
    idx = torch.arange(levels[0].shape[0], device=ro.device)[None, :] \
        .expand(te.shape)
    overflow = torch.zeros((Q,), dtype=torch.int64, device=ro.device)
    if _top_sorted(cb):
        te, idx, ovf = _sort_trunc(te, idx, caps[0])
        overflow = overflow + ovf

    eight = torch.arange(8, device=ro.device)
    for l in range(1, len(levels)):
        K8 = idx.shape[1] * 8
        planes = tuple(p.reshape(Q, K8) for p in _child_planes(cb, l, idx))
        tc = _slab_soa(planes[0:3], planes[3:6], ro_c, ri_c, t_min, t_max)
        alive = (te < INF)[:, :, None].expand(Q, idx.shape[1], 8)
        tc = torch.where(alive.reshape(Q, K8), tc, INF)     # dead parents
        cidx = (idx[:, :, None] * 8 + eight).reshape(Q, K8)
        cap = cb.k_leaf if l == len(levels) - 1 else \
            min(caps[l], levels[l].shape[0])
        te, idx, ovf = _sort_trunc(tc, cidx, cap)
        overflow = overflow + ovf
    return idx, te, overflow


def _round_min(t_p, u_p, v_p, g_p, Q: int, pb: int):
    """Round 1 of the frontier walk's split stage: per ray the (t, lowest
    gid) minimum of its first ``pb`` pairs, a plain (Q, pb) reduce.
    Returns (best_t, u, v, gid), gid 0 where nothing hits."""
    t_p = t_p.reshape(Q, pb)
    g_2d = g_p.reshape(Q, pb)
    best_t = torch.min(t_p, dim=1).values
    at_min = t_p == best_t[:, None]
    g_min = torch.min(torch.where(at_min, g_2d, 2**31 - 1), dim=1).values
    # argmax of a 0/1 row is its first 1.
    slot = torch.argmax((at_min & (g_2d == g_min[:, None])).to(torch.int32),
                        dim=1)
    arq = torch.arange(Q, device=t_p.device)
    return (best_t, u_p.reshape(Q, pb)[arq, slot],
            v_p.reshape(Q, pb)[arq, slot],
            torch.where(best_t < INF, g_min, torch.zeros_like(g_min)))


def _live_pairs(cand, live, Q: int, P2: int):
    """The live (ray, candidate) slots flattened ray-major (a stable sort of
    the ray keys, dead slots keyed Q) and cut to the first ``P2``.
    Returns (ray (<= P2,) with Q on dead pairs, cluster id)."""
    ray_of = torch.arange(Q, device=cand.device)[:, None].expand(cand.shape)
    key = torch.where(live, ray_of, Q).reshape(-1)
    ray_c, order = torch.sort(key, stable=True)
    return ray_c[:P2], cand.reshape(-1)[order[:P2]]


def _consumed(ray_c, Q: int):
    """(left, right): ray q's pairs occupy [left, right) of the ray-sorted
    list ``ray_c``."""
    arq = torch.arange(Q, device=ray_c.device)
    return (torch.searchsorted(ray_c, arq, side="left"),
            torch.searchsorted(ray_c, arq, side="right"))


def _list_closest(cb: ClusterBVH, ro, rd, t_min1, t_max1, ray, cid,
                  use_kernels: bool, pair_stage: str):
    """Per-ray nearest hit over a ray-sorted pair list (``ray`` Q on the
    dead tail): one batch of the frontier walk's feedback rounds, or the
    pair-major walk's whole list.  Returns (t, gid, u, v, pairs of each
    ray).  t is INF where nothing hits, -0 as +0; u, v are 0 there.

    "fused": ``pair_ray_reduce`` on the list's segments; gid 0 where
    nothing hits.  "split": K2 ``pair_tile_isect`` (``_test_pair_batch``),
    then ``_seg_min`` and the segment ends' gathers; where a ray has pairs
    but no hit, gid is the id on lane 0 of a tile of its (K2's lane on a
    miss).  Both select the same (t, lowest gid) and its u, v; no caller
    reads gid, u or v where nothing hits (``intersect_counted`` reports no
    hit there, and the frontier walk takes a round's result only where it
    is nearer)."""
    Q = ro.shape[0]
    left, right = _consumed(ray, Q)
    cnt = right - left
    if pair_stage == "fused":
        t, g, u, v = _reduce_pairs_closest_fused(
            cb, ro, rd, t_min1, t_max1, cid, cnt, right, use_kernels)
        return t + 0.0, g, u, v, cnt
    ray_c = torch.clamp_max(ray, Q - 1)
    t_p, u_p, v_p, g_p = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1, ray_c, cid, ray < Q, use_kernels)
    seg_start = torch.ones_like(ray, dtype=torch.bool)
    seg_start[1:] = ray_c[1:] != ray_c[:-1]
    mt, mi = _seg_min(t_p, seg_start, gid=g_p)
    has = cnt > 0
    endpos = torch.clamp(right - 1, 0, ray.shape[0] - 1)
    bi = mi[endpos]
    return (torch.where(has, mt[endpos], INF), torch.where(has, g_p[bi], 0),
            torch.where(has, u_p[bi], 0.0), torch.where(has, v_p[bi], 0.0),
            cnt)


def _list_anyhit(cb: ClusterBVH, ro, rd, t_min1, t_max1, ray, cid,
                 use_kernels: bool, pair_stage: str):
    """Per-ray occlusion over a ray-sorted pair list: a live pair with a hit
    in range occludes its ray.  "fused": ``pair_ray_reduce``'s any-hit
    form; "split": K2, then an integer scatter-add.  Returns ((Q,) bool,
    pairs of each ray)."""
    Q = ro.shape[0]
    left, right = _consumed(ray, Q)
    cnt = right - left
    if pair_stage == "fused":
        return _reduce_pairs_anyhit_fused(cb, ro, rd, t_min1, t_max1, cid,
                                          cnt, right, use_kernels), cnt
    ok = ray < Q
    ray_c = torch.clamp_max(ray, Q - 1)
    t_p = _test_pair_batch(cb, ro, rd, t_min1, t_max1, ray_c, cid, ok,
                           use_kernels)[0]
    hit_pair = ((t_p < INF) & ok).to(torch.int32)
    n_hit = torch.zeros((Q,), dtype=torch.int32, device=ro.device)
    return n_hit.index_add_(0, ray_c, hit_pair) > 0, cnt


def _cand_sorted(cb: ClusterBVH) -> bool:
    """Whether ``_descend``'s candidates are sorted by entry t (then a ray's
    finite candidates come first): every level below the top is."""
    return len(cb.levels) > 1 or _top_sorted(cb)


def _first_round(cb: ClusterBVH, ro, rd, t_min1, t_max1, use_kernels: bool,
                 pair_stage: str, any_hit: bool):
    """The frontier descent and round 1 of its walks: the first
    ``pair_budget`` slots of every ray tested.  Returns (cand, cand_t,
    overflow, pb, round 1's per-ray result: (t, gid, u, v) with gid 0 and
    u = v = 0 where nothing hits, or the (Q,) occlusion).

    "fused": one ``pair_ray_reduce`` over ray q's segment at the start of
    its slots ``[q pb, (q + 1) pb)`` (``row_segments``: its finite
    candidates, moved there by a lane compaction where ``_descend`` left
    them unsorted; the rest of the row a gap); "split": K2 on the (Q x pb)
    slots, then ``_round_min`` or a row ``any``."""
    cand, cand_t, ovf = _descend(cb, ro, 1.0 / rd, t_min1[:, None],
                                 t_max1[:, None])
    Q = ro.shape[0]
    pb = min(cb.pair_budget, cand.shape[1])
    live = cand_t[:, :pb] < INF
    if pair_stage == "fused":
        rows = cand[:, :pb]
        if not _cand_sorted(cb):
            rows = _compact_lanes(live, rows, pb)[0]
        reduce = _reduce_pairs_anyhit_fused if any_hit else \
            _reduce_pairs_closest_fused
        return cand, cand_t, ovf, pb, reduce(
            cb, ro, rd, t_min1, t_max1,
            *row_segments(rows, torch.sum(live, dim=1)), use_kernels)
    arq = torch.arange(Q, device=ro.device)
    t_p, u_p, v_p, g_p = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1, arq.repeat_interleave(pb),
        cand[:, :pb].reshape(-1), live.reshape(-1), use_kernels)
    if any_hit:
        return cand, cand_t, ovf, pb, torch.any(t_p.reshape(Q, pb) < INF,
                                                dim=1)
    t, u, v, g = _round_min(t_p, u_p, v_p, g_p, Q, pb)
    return cand, cand_t, ovf, pb, (t, g, u, v)


def _traverse(cb: ClusterBVH, ro, rd, t_min, t_max, use_kernels: bool = True,
              pair_stage: str = "fused"):
    """Closest hit over the frontier descent's candidates, exact for any
    pair budget: the candidates of a ray are t_entry-ascending, so the
    untested ones lie behind its best hit.  Round 1 tests the first
    ``pair_budget`` slots of every ray; then each round flattens the slots
    [cursor, end) of every ray, end = the candidates whose entry t is <=
    the ray's best t, cuts the list to P2 = max(Q // 2, 1024) pairs, tests
    them and takes the per-ray (t, lowest gid) minimum (``_list_closest``).
    A round consumes at least one pair, and it runs while any ray has one
    left (one host read a round).  ``pair_stage`` ("fused" or "split")
    picks how every batch is tested and reduced; both give the same bits
    and rounds.  Returns (best_t (Q, 1), gid, u (Q, 1), v (Q, 1),
    n_overflow); gid, u and v are 0 where nothing hits."""
    Q = ro.shape[0]
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    cand, cand_t, ovf, pb, (bt, bg, bu, bv) = _first_round(
        cb, ro, rd, t_min1, t_max1, use_kernels, pair_stage, any_hit=False)

    P2 = max(Q // 2, 1024)
    slots = torch.arange(cand.shape[1], device=ro.device)[None, :]
    cur = torch.full((Q,), pb, dtype=torch.int64, device=ro.device)
    while True:
        # <= so that a cluster whose entry t ties the best t is still
        # tested: it may hold an equal-t prim of a LOWER gid.
        end = torch.sum((cand_t <= bt[:, None]) & (cand_t < INF), dim=1)
        if not bool(torch.any(end > cur)):
            break
        live = (slots >= cur[:, None]) & (slots < end[:, None])
        ray_c, cid_c = _live_pairs(cand, live, Q, P2)
        bt_new, g_new, u_new, v_new, n = _list_closest(
            cb, ro, rd, t_min1, t_max1, ray_c, cid_c, use_kernels, pair_stage)
        # bt_new is INF where the ray had no pair or no hit: never better.
        better = (bt_new < bt) | ((bt_new == bt) & (bt < INF) & (g_new < bg))
        bt = torch.where(better, bt_new, bt)
        bu = torch.where(better, u_new, bu)
        bv = torch.where(better, v_new, bv)
        bg = torch.where(better, g_new, bg)
        cur = cur + n
    return bt[:, None], bg, bu[:, None], bv[:, None], torch.sum(ovf)


def _traverse_anyhit(cb: ClusterBVH, ro, rd, t_min, t_max,
                     use_kernels: bool = True, pair_stage: str = "fused"):
    """Occlusion over the frontier descent's candidates: round 1 tests the
    first ``pair_budget`` slots of every ray; then each round tests the
    remaining finite candidates of the rays not yet occluded (cut to P2
    pairs), until none is left.  Returns ((Q,) bool, n_overflow)."""
    Q = ro.shape[0]
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    cand, cand_t, ovf, pb, occ = _first_round(
        cb, ro, rd, t_min1, t_max1, use_kernels, pair_stage, any_hit=True)

    P2 = max(Q // 2, 1024)
    slots = torch.arange(cand.shape[1], device=ro.device)[None, :]
    n_fin = torch.sum(cand_t < INF, dim=1)
    cur = torch.full((Q,), pb, dtype=torch.int64, device=ro.device)
    while bool(torch.any(~occ & (n_fin > cur))):
        live = (slots >= cur[:, None]) & (slots < n_fin[:, None]) \
            & ~occ[:, None]
        ray_c, cid_c = _live_pairs(cand, live, Q, P2)
        occ_new, n = _list_anyhit(cb, ro, rd, t_min1, t_max1, ray_c, cid_c,
                                  use_kernels, pair_stage)
        occ = occ | occ_new
        cur = cur + n
    return occ, torch.sum(ovf)


def candidate_stats(cb: ClusterBVH, ro, rd, t_min, t_max):
    """The frontier descent's capacity contract: (per-ray candidate count,
    per-ray truncation count).  A truncation > 0 means the frontier caps or
    ``k_leaf`` are too small for this scene and these rays.  t bounds are
    (Q,) or (Q, 1)."""
    cand, cand_t, overflow = _descend(
        cb, ro, 1.0 / rd, t_min[:, None] if t_min.dim() == 1 else t_min,
        t_max[:, None] if t_max.dim() == 1 else t_max)
    return torch.sum(cand_t < INF, dim=1), overflow


# ---------------------------------------------------------------------------
# Pair-major traversal (traversal_mode "pairs"): after the dense top test the
# walk's state is one ray-sorted list of live (ray, node) pairs, compacted
# by a stable 1-D sort at every level and cut to a budget of pair_mults[:3]
# x Q; every live leaf candidate is tile-tested, so no feedback is needed.
# ---------------------------------------------------------------------------


def _descend_pairs(cb: ClusterBVH, ro, rd_inv, t_min1, t_max1,
                   collect: list | None = None):
    """Dense top test + pair-major level walk.  Returns (rayP, cidP,
    dropped): the ray-sorted live (ray, cluster) candidate pairs (sentinel
    ray Q on the padding at the tail) and the count of live pairs the
    static budgets cut (the capacity contract: 0 on supported scenes).

    collect: when a list is passed, one (live pairs before the cut, pairs
    cut) pair of scalars per level is appended."""
    Q = ro.shape[0]
    m_top, m_mid, m_leaf = cb.pair_mults[:3]
    levels = cb.levels
    topT = cb.top_soa
    te = _slab_soa(tuple(topT[i][None, :] for i in range(3)),
                   tuple(topT[3 + i][None, :] for i in range(3)),
                   tuple(ro[:, i:i + 1] for i in range(3)),
                   tuple(rd_inv[:, i:i + 1] for i in range(3)),
                   t_min1[:, None], t_max1[:, None])        # (Q, N0)
    arq = torch.arange(Q, device=ro.device)
    key = torch.where(te < INF, arq[:, None], Q)
    node = torch.arange(te.shape[1], device=ro.device)[None, :].expand(
        te.shape)
    rayP, nodeP, dropped = _flatten_live(
        key.reshape(-1), node.reshape(-1), min(m_top * Q, Q * te.shape[1]), Q)
    if collect is not None:
        collect.append((torch.sum(key < Q), dropped))

    eight = torch.arange(8, device=ro.device)
    for l in range(1, len(levels)):
        keep = (m_leaf if l == len(levels) - 1 else m_mid) * Q
        rayPc = torch.clamp_max(rayP, Q - 1)
        node_c = torch.clamp(nodeP, 0, levels[l - 1].shape[0] - 1)
        planes = _child_planes(cb, l, node_c)               # (P, 8) each
        tc = _slab_soa(planes[0:3], planes[3:6],
                       tuple(ro[rayPc, i:i + 1] for i in range(3)),
                       tuple(rd_inv[rayPc, i:i + 1] for i in range(3)),
                       t_min1[rayPc][:, None], t_max1[rayPc][:, None])
        live_c = (tc < INF) & (rayP < Q)[:, None]
        cidx = nodeP[:, None] * 8 + eight
        key = torch.where(live_c, rayPc[:, None], Q)
        rayP, nodeP, drop = _flatten_live(key.reshape(-1), cidx.reshape(-1),
                                          keep, Q)
        dropped = dropped + drop
        if collect is not None:
            collect.append((torch.sum(live_c), drop))
    return rayP, nodeP, dropped


def _traverse_pairs(cb: ClusterBVH, ro, rd, t_min, t_max,
                    use_kernels: bool = True, pair_stage: str = "fused"):
    """Closest hit through the pair-major walk, exact: every live candidate
    is tile-tested and the per-ray nearest is a segmented (t, lowest gid)
    minimum over the ray-sorted pair list (``_list_closest``, in the form
    ``pair_stage`` names).  Returns (best_t (Q, 1), gid, u (Q, 1),
    v (Q, 1), n_dropped)."""
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    rayP, cidP, dropped = _descend_pairs(cb, ro, 1.0 / rd, t_min1, t_max1)
    t, g, u, v, _ = _list_closest(cb, ro, rd, t_min1, t_max1, rayP, cidP,
                                  use_kernels, pair_stage)
    return t[:, None], g, u[:, None], v[:, None], dropped


def _traverse_pairs_anyhit(cb: ClusterBVH, ro, rd, t_min, t_max,
                           use_kernels: bool = True,
                           pair_stage: str = "fused"):
    """Occlusion through the pair-major walk (``_list_anyhit``).  Returns
    ((Q,) bool, n_dropped)."""
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    rayP, cidP, dropped = _descend_pairs(cb, ro, 1.0 / rd, t_min1, t_max1)
    return _list_anyhit(cb, ro, rd, t_min1, t_max1, rayP, cidP, use_kernels,
                        pair_stage)[0], dropped


def pairs_stats(cb: ClusterBVH, ro, rd, t_min, t_max):
    """The pair-major walk's capacity contract: (n_live_pairs, n_dropped).
    dropped > 0 means pair_mults x Q is too small for this scene and these
    rays.  t bounds are (Q,) or (Q, 1)."""
    t_min1 = t_min[:, 0] if t_min.dim() == 2 else t_min
    t_max1 = t_max[:, 0] if t_max.dim() == 2 else t_max
    rayP, _, dropped = _descend_pairs(cb, ro, 1.0 / rd, t_min1, t_max1)
    return torch.sum(rayP < ro.shape[0]), dropped


# ---------------------------------------------------------------------------
# Compact traversal: the descent needs neither ORDER nor best-t feedback,
# only COMPACTION.  1-bit compaction is sort-free: an inclusive cumsum ranks
# the live lanes and one scatter places them.
# ---------------------------------------------------------------------------


def _rank_inclusive(live):
    """Per-row inclusive rank of live lanes: rank[q, i] = #live in
    live[q, :i+1] (int64)."""
    return torch.cumsum(live, dim=1)


def _compact_lanes(live, idx, cap: int):
    """Stable 1-bit lane compaction: move live lanes to the front.

    live: (Q, N) bool; idx: (Q, N) i64 payload; cap: static output width.
    Returns (idx_c (Q, cap) i64, live_c (Q, cap) bool, overflow (Q,) i64 —
    live lanes beyond cap, dropped).  out[q, j] = idx of the (j+1)-th live
    lane, 0 in the slots past the live count: a masked scatter of ``idx``
    to column ``rank - 1`` of a zero tensor (dead and overflowing lanes go
    to a spare column that is cut off)."""
    n = live.shape[1]
    cap = min(cap, n)
    rank = _rank_inclusive(live)                           # (Q, N) inclusive
    total = rank[:, -1]
    col = torch.where(live & (rank <= cap), rank - 1, cap)
    buf = torch.zeros((live.shape[0], cap + 1), dtype=idx.dtype,
                      device=idx.device)
    buf.scatter_(1, col, idx)
    live_c = torch.arange(cap, device=live.device)[None, :] < total[:, None]
    return buf[:, :cap], live_c, torch.clamp_min(total - cap, 0)


def _slab_soa(blo, bhi, ro, rd_inv, t_min, t_max):
    """Component-wise (SoA) slab test: blo/bhi are 3-tuples of per-axis
    arrays broadcastable against per-axis ray columns ro[i]/rd_inv[i].
    Returns the entry t, INF on miss.  0·inf = NaN on an axis-parallel ray
    at a slab boundary is mapped to "no constraint"."""
    t0 = t_min
    t1 = t_max
    for i in range(3):
        lo = (blo[i] - ro[i]) * rd_inv[i]
        hi = (bhi[i] - ro[i]) * rd_inv[i]
        near = torch.minimum(lo, hi)
        far = torch.maximum(lo, hi)
        near = torch.nan_to_num(near, nan=-float("inf"), posinf=float("inf"),
                                neginf=-float("inf"))
        far = torch.nan_to_num(far, nan=float("inf"), posinf=float("inf"),
                               neginf=-float("inf"))
        t0 = torch.maximum(t0, near)
        t1 = torch.minimum(t1, far)
    return torch.where((blo[0] <= bhi[0]) & (t0 <= t1), t0,
                       torch.full_like(t0, INF))


# Forms of the descent's child fetch (the ``fetch`` keyword of
# ``_descend_compact``).
FETCH_FORMS = ("fields", "rows")


def _descend_compact(cb: ClusterBVH, ro, rd_inv, t_min, t_max,
                     collect: list | None = None, use_kernels: bool = True,
                     fetch: str = "fields"):
    """Sort-free frontier descent.  Returns (cand (Q, K) i64 cluster ids,
    live (Q, K) bool, overflow (Q,) i64 live candidates truncated at any
    level).  Candidates are lane-compacted but UNORDERED by t — the compact
    traversal tests all of them, so order is irrelevant.

    collect: when a list is passed, one (needed (Q,), truncated (Q,)) pair
    per level is appended (needed = live candidates BEFORE the cap).
    use_kernels: the child fetch goes through its kernel's wrapper (on CUDA
    tensors the kernel), else through its plain version.
    fetch: ``"fields"`` (the default) fetches the six box fields of the
    children as (Q, K * 8) planes (``fetch_fields``), which the slab test
    reads as they are; ``"rows"`` fetches whole (Q, K, 64) rows
    (``fetch_rows``) and copies each field out of them.  The two give the
    same cand, live and overflow.  With ``GATHER_BF16`` off, the f32 tables
    are gathered by indexing, whatever ``fetch`` says."""
    if fetch not in FETCH_FORMS:
        raise ValueError(f"unknown fetch {fetch!r}: expected one of "
                         f"{', '.join(FETCH_FORMS)}")
    Q = ro.shape[0]
    levels = cb.levels
    caps = cb.frontiers
    ro_c = tuple(ro[:, i:i + 1] for i in range(3))          # (Q, 1) each
    ri_c = tuple(rd_inv[:, i:i + 1] for i in range(3))

    topT = cb.top_soa                                       # (8, N0)
    te = _slab_soa(tuple(topT[i][None, :] for i in range(3)),
                   tuple(topT[3 + i][None, :] for i in range(3)),
                   ro_c, ri_c, t_min, t_max)                # (Q, N0)
    idx0 = torch.arange(levels[0].shape[0], device=ro.device)[None, :] \
        .expand(te.shape)
    cand, live, overflow = _compact_lanes(te < INF, idx0, caps[0])
    if collect is not None:
        collect.append((torch.sum(te < INF, dim=1), overflow))

    eight = torch.arange(8, device=ro.device)
    for l in range(1, len(levels)):
        K8 = cand.shape[1] * 8
        # Field-major sibling rows from the bf16 outward-rounded table
        # (GATHER_BF16): field f of the 8 children is word f of a row.
        if GATHER_BF16 and fetch == "fields":
            fetch_k = fetch_fields if use_kernels else fetch_fields_ref
            planes = fetch_k(cb.child16[l], cand, 6).unbind(0)  # (Q, cap*8)
        else:
            if GATHER_BF16:
                fetch_k = fetch_rows if use_kernels else fetch_rows_ref
                blk = fetch_k(cb.child16[l], cand, clamp=True)  # (Q, cap, 64)
            else:
                child = levels[l].reshape(-1, 8, 8).transpose(1, 2) \
                    .reshape(-1, 64)
                blk = child[torch.clamp(cand, 0, child.shape[0] - 1)]
            blk = blk.reshape(Q, cand.shape[1], 8, 8)
            planes = tuple(blk[:, :, f, :].reshape(Q, K8) for f in range(6))
        tc = _slab_soa(planes[0:3], planes[3:6], ro_c, ri_c, t_min,
                       t_max)                               # (Q, cap*8)
        live_c = (tc < INF) & live[:, :, None].expand(
            live.shape + (8,)).reshape(Q, K8)
        cidx = (cand[:, :, None] * 8 + eight).reshape(Q, K8)
        cap = cb.k_leaf if l == len(levels) - 1 else caps[l]
        cand, live, ovf = _compact_lanes(live_c, cidx, cap)
        overflow = overflow + ovf
        if collect is not None:
            collect.append((torch.sum(live_c, dim=1), ovf))
    return cand, live, overflow


def _flatten_live(key_ray, payload, keep: int, Q: int):
    """Compact live pairs to the front (a stable sort used as a
    compaction), truncate to ``keep``.

    key_ray: (M,) — ray id for live pairs, Q (sentinel) for dead.
    Returns (rayP (keep,), payloadP (keep,), n_dropped scalar)."""
    k, order = torch.sort(key_ray, stable=True)
    p = payload[order]
    n_live = torch.sum(key_ray < Q)
    dropped = torch.clamp_min(n_live - keep, 0)
    return k[:keep], p[:keep], dropped


def _flat_pairs(cand, live, Q: int, budget: int):
    """(Q, K) compacted candidates -> ray-sorted flat pair list.
    Returns (rayP (budget,), cidP (budget,), dropped scalar, cnt_c (Q,),
    right_c (Q,), lost (Q,)): ray q's pairs occupy
    [right_c - cnt_c, right_c); ``lost`` counts its pairs cut by the
    static budget."""
    arq = torch.arange(Q, device=cand.device)
    key = torch.where(live, arq[:, None], Q)
    rayP, cidP, dropped = _flatten_live(key.reshape(-1), cand.reshape(-1),
                                        budget, Q)
    cnt = torch.sum(live, dim=1)                         # (Q,)
    right = torch.cumsum(cnt, dim=0)
    base = right - cnt
    right_c = torch.clamp_max(right, budget)
    cnt_c = torch.clamp_min(right_c - torch.clamp_max(base, budget), 0)
    lost = cnt - cnt_c                                   # per-ray drops
    return rayP, cidP, dropped, cnt_c, right_c, lost


def _reduce_pairs_closest(cb, ro, rd, t_min1, t_max1, rayP, cidP, cnt,
                          right, use_kernels: bool = True):
    """Tile-test a ray-sorted pair list and reduce to per-ray nearest —
    the SORT form, kept as the twin of the kernel path
    (:func:`_reduce_pairs_closest_scan`).  Returns (best_t (Q,), gid, u, v).

    The pair list is already ray-major, so sorting by (ray, t, gid) puts
    each ray's winning pair — nearest t, lowest gid at ties — at its
    segment head."""
    Q = ro.shape[0]
    P = rayP.shape[0]
    pair_ok = rayP < Q
    rayPc = torch.clamp_max(rayP, Q - 1)
    t_p, u_p, v_p, g_p = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1, rayPc, cidP, pair_ok, use_kernels)
    g_key = torch.where(t_p < INF, g_p, torch.full_like(g_p, 2**31 - 1))
    # Lexicographic (ray, t, gid) order by three stable sorts, last key first.
    order = torch.sort(g_key, stable=True).indices
    order = order[torch.sort(t_p[order], stable=True).indices]
    order = order[torch.sort(rayP[order], stable=True).indices]
    head = order[torch.clamp_max(right - cnt, P - 1)]      # segment starts
    best_t = t_p[head]
    has = (cnt > 0) & (best_t < INF)
    zero = torch.zeros_like(best_t)
    return (torch.where(has, best_t, torch.full_like(best_t, INF)),
            torch.where(has, g_key[head], torch.zeros_like(g_key[head])),
            torch.where(has, u_p[head], zero),
            torch.where(has, v_p[head], zero))


def _scan_supported(cb: ClusterBVH, Q: int) -> bool:
    """Always True: the per-ray reduce carries gid and the segment bounds as
    int32, which lifts the f32 ``< 2^24`` limit on primitive and ray ids of
    a scan that rides them on float lanes."""
    return True


def _segmin_pairs(cb, ro, rd, t_min1, t_max1, rayP, cidP, cnt, right,
                  use_kernels: bool, with_gid: bool):
    Q = ro.shape[0]
    pair_ok = rayP < Q
    rayPc = torch.clamp_max(rayP, Q - 1)
    t_p, u_p, v_p, g_p = _test_pair_batch(
        cb, ro, rd, t_min1, t_max1, rayPc, cidP, pair_ok, use_kernels)
    if not with_gid:
        g_p = torch.zeros_like(g_p)
    segmin = pair_segmin if use_kernels else pair_segmin_ref
    return segmin(t_p.contiguous(), g_p.contiguous(), u_p.contiguous(),
                  v_p.contiguous(), cnt.to(torch.int32), right.to(torch.int32))


def _reduce_pairs_closest_scan(cb, ro, rd, t_min1, t_max1, rayP, cidP, cnt,
                               right, use_kernels: bool = True):
    """Kernel form of _reduce_pairs_closest: same inputs, same bit-exact
    outputs, no sort (per-ray segmented (t, gid)-min)."""
    best_t, best_g, best_u, best_v = _segmin_pairs(
        cb, ro, rd, t_min1, t_max1, rayP, cidP, cnt, right, use_kernels,
        with_gid=True)
    has = (cnt > 0) & (best_t < INF)
    zero = torch.zeros_like(best_t)
    return (torch.where(has, best_t, torch.full_like(best_t, INF)),
            torch.where(has, best_g, torch.zeros_like(best_g)),
            torch.where(has, best_u, zero),
            torch.where(has, best_v, zero))


def _reduce_pairs_anyhit_scan(cb, ro, rd, t_min1, t_max1, rayP, cidP, cnt,
                              right, use_kernels: bool = True):
    """Any-hit reduce: occluded iff the ray's segment minimum is a hit
    (gid = 0 for every pair; only t is read)."""
    best_t = _segmin_pairs(cb, ro, rd, t_min1, t_max1, rayP, cidP, cnt,
                           right, use_kernels, with_gid=False)[0]
    return (cnt > 0) & (best_t < INF)


def _reduce_pairs_closest_fused(cb, ro, rd, t_min1, t_max1, cidP, cnt, right,
                                use_kernels: bool = True):
    """One-kernel form of _reduce_pairs_closest_scan: same bit-exact
    outputs straight from the traversal's tensors (the pairs' rays follow
    from the segment bounds, so ``rayP`` is not needed)."""
    fused = pair_ray_reduce if use_kernels else pair_ray_reduce_ref
    return fused(cb.tiles, cb.tile_gid, ro.contiguous(), rd.contiguous(),
                 t_min1.contiguous(), t_max1.contiguous(), cidP, cnt, right)


def _reduce_pairs_anyhit_fused(cb, ro, rd, t_min1, t_max1, cidP, cnt, right,
                               use_kernels: bool = True):
    """One-kernel form of _reduce_pairs_anyhit_scan."""
    fused = pair_ray_reduce if use_kernels else pair_ray_reduce_ref
    return fused(cb.tiles, cb.tile_gid, ro.contiguous(), rd.contiguous(),
                 t_min1.contiguous(), t_max1.contiguous(), cidP, cnt, right,
                 any_hit=True)


def _dedup_supported(cb: ClusterBVH, budget: int) -> bool:
    """The cluster-major pair stage takes 128-lane tiles and a pair budget
    that is a multiple of the pair kernel's block."""
    return tuple(cb.tiles.shape[1:]) == (12, 128) and budget % PBLK == 0


def _require_dedup(cb: ClusterBVH, budget: int) -> None:
    """``pair_stage="dedup"`` with a shape the stage does not take raises,
    so that the stage asked for is the stage that ran."""
    if not _dedup_supported(cb, budget):
        raise ValueError(
            "pair_stage='dedup' needs (12, 128) tiles and a pair budget that "
            f"is a multiple of {PBLK}; got tiles {tuple(cb.tiles.shape)} and "
            f"budget {budget}")


def _dedup_rows(cb: ClusterBVH, ro, rd, t_min1, t_max1, rayP, cidP):
    """Operands of the cluster-major pair kernel: the pair list sorted by
    CLUSTER id (stable; dead pairs keyed ``n_clusters`` so they sort last).
    Returns (cid (P,) i32 ascending, clipped into range; rays (P, 16);
    rayC (P,) ray of each sorted pair, clipped; okS (P,) live mask)."""
    Q = ro.shape[0]
    key = torch.where(rayP < Q, cidP, torch.full_like(cidP, cb.n_clusters))
    cidS, order = torch.sort(key, stable=True)
    okS = cidS < cb.n_clusters
    cid_clip = torch.clamp_max(cidS, cb.n_clusters - 1)
    rayC = torch.clamp_max(rayP[order], Q - 1)
    cid, rays = _pair_rows(ro, rd, t_min1, t_max1, rayC, cid_clip, okS)
    return cid, rays, rayC, okS


def _test_pairs_dedup(cb: ClusterBVH, ro, rd, t_min1, t_max1, rayP, cidP,
                      use_kernels: bool = True):
    """Sort the pair list by cluster id and run the cluster-major pair
    kernel, whose neighbouring warps share a tile through the cache.  Returns
    per-pair results in the cid-sorted order:
    (t (P,), u, v, gid, rayC, okS)."""
    cid, rays, rayC, okS = _dedup_rows(cb, ro, rd, t_min1, t_max1, rayP, cidP)
    isect = pair_tile_isect_dedup if use_kernels else pair_tile_isect_dedup_ref
    out = isect(cb.tiles, cid, rays)
    t_p = torch.where(okS, out[:, 0], torch.full_like(out[:, 0], INF))
    lane = out[:, 1].to(torch.int64).clamp(0, 127)
    return t_p, out[:, 2], out[:, 3], cb.tile_gid[cid.long(), lane], rayC, okS


def _reduce_pairs_closest_dedup(cb, ro, rd, t_min1, t_max1, rayP, cidP,
                                use_kernels: bool = True):
    """Cluster-major closest-hit pair stage: tile-test the cid-sorted list,
    then reduce per ray by scatter-min of t and a second scatter-min of the
    pair index among the pairs that equal the best t.  min is
    order-independent, so the atomics of the card give one result.  The tie
    rule is therefore the LOWEST POSITION IN THE CID-SORTED LIST, not the
    lowest gid: at equal t the primitive may differ from the ray-major
    stage's; t itself is selected, never recomputed.
    Returns (best_t (Q,), gid, u, v)."""
    Q = ro.shape[0]
    t_p, u_p, v_p, g_p, rayC, okS = _test_pairs_dedup(
        cb, ro, rd, t_min1, t_max1, rayP, cidP, use_kernels)
    P = t_p.shape[0]
    best_t = torch.full((Q,), INF, dtype=torch.float32, device=ro.device)
    best_t.scatter_reduce_(0, rayC, t_p, "amin", include_self=True)
    is_best = okS & (t_p <= best_t[rayC]) & (t_p < INF)
    pidx = torch.arange(P, device=ro.device)
    widx = torch.full((Q,), P, dtype=torch.int64, device=ro.device)
    widx.scatter_reduce_(0, rayC, torch.where(is_best, pidx, P), "amin",
                         include_self=True)
    has = widx < P
    wc = torch.clamp(widx, 0, P - 1)
    zero = torch.zeros_like(best_t)
    return (torch.where(has, best_t, torch.full_like(best_t, INF)),
            torch.where(has, g_p[wc], torch.zeros_like(g_p[wc])),
            torch.where(has, u_p[wc], zero),
            torch.where(has, v_p[wc], zero))


def _reduce_pairs_anyhit_dedup(cb, ro, rd, t_min1, t_max1, rayP, cidP,
                               use_kernels: bool = True):
    """Cluster-major any-hit pair stage: an integer scatter-add of the
    pairs that hit (deterministic)."""
    Q = ro.shape[0]
    t_p, _, _, _, rayC, okS = _test_pairs_dedup(
        cb, ro, rd, t_min1, t_max1, rayP, cidP, use_kernels)
    hit_pair = ((t_p < INF) & okS).to(torch.int32)
    n_hit = torch.zeros((Q,), dtype=torch.int32, device=ro.device)
    return n_hit.index_add_(0, rayC, hit_pair) > 0


def _retrace_suspects_closest(cb: ClusterBVH, ro, rd, t_min1, t_max1,
                              suspect, best, use_kernels: bool = True):
    """Exact repair: walk the packed fallback for the SUSPECT rays (the
    others get ``t_max = -1`` and leave at the root) and take the walk's
    answer for them.  best: (best_t (Q,), gid, u, v) of the pair stage;
    returns the same four."""
    best_t, best_g, best_u, best_v = best
    t_max_f = torch.where(suspect, t_max1, torch.full_like(t_max1, -1.0))
    bt, slot, bu, bv = packed_mod._traverse(
        cb.fallback, ro, rd, t_min1[:, None], t_max_f[:, None], False,
        use_kernels)
    found = bt[:, 0] < t_max_f
    gid = cb.fallback.prim_gid[slot.long()]
    zero = torch.zeros_like(best_t)
    return (torch.where(suspect, torch.where(found, bt[:, 0],
                                             torch.full_like(best_t, INF)),
                        best_t),
            torch.where(suspect, torch.where(found, gid,
                                             torch.zeros_like(gid)), best_g),
            torch.where(suspect, torch.where(found, bu[:, 0], zero), best_u),
            torch.where(suspect, torch.where(found, bv[:, 0], zero), best_v))


def _retrace_suspects_anyhit(cb: ClusterBVH, ro, rd, t_min1, t_max1,
                             suspect, occ, use_kernels: bool = True):
    """Any-hit form of :func:`_retrace_suspects_closest`: occ (Q,) bool."""
    t_max_f = torch.where(suspect, t_max1, torch.full_like(t_max1, -1.0))
    occ_fb = packed_mod._traverse(cb.fallback, ro, rd, t_min1[:, None],
                                  t_max_f[:, None], True, use_kernels)
    return torch.where(suspect, occ_fb[:, 0], occ)


# Intra-batch traversal split: run the traversal as SPLIT independent
# sub-batches of Q/SPLIT rays each.  Per-ray results are identical (all
# stages reduce per ray); only the static pair budget is sliced per
# sub-batch, so truncation PATTERNS can differ — which the overflow counter
# reports.
SPLIT_CLOSEST = 4
SPLIT_ANYHIT = 4

# Gather the descent's child AABBs from the bf16 outward-rounded tables
# (half the gathered bytes; candidate selection stays exact because the
# rounding is conservative).
GATHER_BF16 = True

# Traversal mode, read at every call of intersect_counted / occluded_counted:
# ClusterBVH.traversal_mode: "compact" (the sort-free compact descent and
# one flat pair batch, in SPLIT_CLOSEST / SPLIT_ANYHIT strided sub-batches),
# "frontier" (per-ray t-sorted frontiers and best-t feedback rounds,
# ``_traverse``) or "pairs" (the pair-major walk, ``_traverse_pairs``).  The
# last two traverse the whole batch at once and take the ray-major pair
# stages only (``MODE_PAIR_STAGES``: "fused" reduces every pair batch with
# ``pair_ray_reduce``, "split" with ``pair_tile_isect`` and array code);
# they report their truncation but flag no ray suspect and never walk the
# fallback.
TRAVERSAL_MODES = ("compact", "frontier", "pairs")
MODE_PAIR_STAGES = ("fused", "split")


def _traversal_mode(cb: ClusterBVH, pair_stage: str) -> str:
    """``cb.traversal_mode``, checked, refusing a ``pair_stage`` the mode
    does not run."""
    _check_pair_stage(pair_stage)
    mode = cb.traversal_mode
    if mode not in TRAVERSAL_MODES:
        raise ValueError(f"unknown traversal_mode {mode!r}: expected one of "
                         f"{', '.join(TRAVERSAL_MODES)}")
    if mode != "compact" and pair_stage not in MODE_PAIR_STAGES:
        raise ValueError(f"traversal_mode {mode!r} has no pair_stage "
                         f"{pair_stage!r}: it takes "
                         f"{' or '.join(map(repr, MODE_PAIR_STAGES))} (the "
                         f"compact mode also takes 'dedup')")
    return mode


def _split_batches(Q: int, split: int) -> int:
    """Effective split factor: sub-batches stay >= 1024 rays wide so that
    fixed per-stage costs don't dominate."""
    k = max(1, int(split))
    while k > 1 and (Q % k != 0 or Q // k < 1024):
        k //= 2
    return k


def _interleave(parts):
    """Inverse of the strided split x[i::k]: stack on a new axis 1, fold."""
    return torch.stack(parts, 1).reshape(-1, *parts[0].shape[1:])


def _traverse_compact(cb: ClusterBVH, ro, rd, t_min, t_max,
                      use_kernels: bool = True, pair_stage: str = "fused",
                      suspect_out: list | None = None):
    """Closest hit: sort-free descent + one flat all-candidates pair batch
    + per-ray segmented min.  Exact because every live candidate is tested.
    Returns (best_t (Q,1), gid, u (Q,1), v (Q,1), n_overflow).

    Sub-batches are STRIDED (sub-batch i takes lanes i, i+k, ...), not
    contiguous: wavefront respawn fills lanes in pixel order, so contiguous
    slices would concentrate coherent hot blocks and blow the per-sub-batch
    pair budget.  The strided views are made contiguous here (the kernel
    wrappers refuse anything else).

    suspect_out: when a list is passed, the (Q,) bool suspect mask (this
    ray's candidates were cut by some static budget) is appended."""
    _check_pair_stage(pair_stage)
    k = _split_batches(ro.shape[0], SPLIT_CLOSEST)
    if k > 1:
        subs = [[] if suspect_out is not None else None for _ in range(k)]
        outs = [_traverse_compact_1(cb, ro[i::k].contiguous(),
                                    rd[i::k].contiguous(),
                                    t_min[i::k].contiguous(),
                                    t_max[i::k].contiguous(), use_kernels,
                                    pair_stage, suspect_out=subs[i])
                for i in range(k)]
        bt, g, u, v, novf = zip(*outs)
        if suspect_out is not None:
            suspect_out.append(_interleave([sub[0] for sub in subs]))
        return (_interleave(bt), _interleave(g), _interleave(u),
                _interleave(v), sum(novf))
    return _traverse_compact_1(cb, ro, rd, t_min, t_max, use_kernels,
                               pair_stage, suspect_out=suspect_out)


def _traverse_compact_1(cb: ClusterBVH, ro, rd, t_min, t_max,
                        use_kernels: bool = True, pair_stage: str = "fused",
                        suspect_out: list | None = None):
    Q = ro.shape[0]
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    cand, live, ovf = _descend_compact(cb, ro, 1.0 / rd, t_min1[:, None],
                                       t_max1[:, None],
                                       use_kernels=use_kernels)
    budget = int(cb.pair_mults[2] * Q)
    rayP, cidP, dropped, cnt, right, lost = _flat_pairs(cand, live, Q, budget)
    n_ovf = torch.sum(ovf) + dropped
    suspect = (ovf > 0) | (lost > 0)
    if suspect_out is not None:
        suspect_out.append(suspect)
    if pair_stage == "fused":
        best_t, best_g, best_u, best_v = _reduce_pairs_closest_fused(
            cb, ro, rd, t_min1, t_max1, cidP, cnt, right, use_kernels)
    elif pair_stage == "dedup":
        _require_dedup(cb, budget)
        best_t, best_g, best_u, best_v = _reduce_pairs_closest_dedup(
            cb, ro, rd, t_min1, t_max1, rayP, cidP, use_kernels)
    else:
        best_t, best_g, best_u, best_v = _reduce_pairs_closest_scan(
            cb, ro, rd, t_min1, t_max1, rayP, cidP, cnt, right, use_kernels)
    if cb.fallback is not None:
        best_t, best_g, best_u, best_v = _retrace_suspects_closest(
            cb, ro, rd, t_min1, t_max1, suspect,
            (best_t, best_g, best_u, best_v), use_kernels)
    return best_t[:, None], best_g, best_u[:, None], best_v[:, None], n_ovf


def _traverse_compact_anyhit(cb: ClusterBVH, ro, rd, t_min, t_max,
                             narrow: bool = False, use_kernels: bool = True,
                             pair_stage: str = "fused",
                             suspect_out: list | None = None):
    """Occlusion: any tested pair with a hit in range occludes its ray.
    narrow=True selects the steady-state shadow pair budget
    (pair_mults[3]).  Returns (occ (Q,) bool, n_overflow); ``suspect_out``
    as in :func:`_traverse_compact`."""
    _check_pair_stage(pair_stage)
    k = _split_batches(ro.shape[0], SPLIT_ANYHIT)
    if k > 1:  # strided slices — see _traverse_compact
        subs = [[] if suspect_out is not None else None for _ in range(k)]
        outs = [_traverse_compact_anyhit_1(
                    cb, ro[i::k].contiguous(), rd[i::k].contiguous(),
                    t_min[i::k].contiguous(), t_max[i::k].contiguous(),
                    narrow, use_kernels, pair_stage, suspect_out=subs[i])
                for i in range(k)]
        occ, novf = zip(*outs)
        if suspect_out is not None:
            suspect_out.append(_interleave([sub[0] for sub in subs]))
        return _interleave(occ), sum(novf)
    return _traverse_compact_anyhit_1(cb, ro, rd, t_min, t_max, narrow,
                                      use_kernels, pair_stage,
                                      suspect_out=suspect_out)


def _traverse_compact_anyhit_1(cb: ClusterBVH, ro, rd, t_min, t_max,
                               narrow: bool = False,
                               use_kernels: bool = True,
                               pair_stage: str = "fused",
                               suspect_out: list | None = None):
    Q = ro.shape[0]
    t_min1 = t_min[:, 0]
    t_max1 = t_max[:, 0]
    cand, live, ovf = _descend_compact(cb, ro, 1.0 / rd, t_min1[:, None],
                                       t_max1[:, None],
                                       use_kernels=use_kernels)
    # Any-hit pair budget: callers that KNOW the batch is a steady-state
    # shadow wave (the wavefront loop body after its wide warm-up prefix)
    # pass narrow=True for the pair_mults[3] budget (shadow batches are
    # about half-occupied in steady state); all other calls use the wide
    # pair_mults[2] budget, which also covers fully-occupied first-wave
    # shadows.
    mult = cb.pair_mults[3] if narrow else cb.pair_mults[2]
    budget = int(mult * Q)
    rayP, cidP, dropped, cnt, right, lost = _flat_pairs(cand, live, Q, budget)
    n_ovf = torch.sum(ovf) + dropped
    suspect = (ovf > 0) | (lost > 0)
    if suspect_out is not None:
        suspect_out.append(suspect)
    if pair_stage == "fused":
        occ = _reduce_pairs_anyhit_fused(
            cb, ro, rd, t_min1, t_max1, cidP, cnt, right, use_kernels)
    elif pair_stage == "dedup":
        _require_dedup(cb, budget)
        occ = _reduce_pairs_anyhit_dedup(
            cb, ro, rd, t_min1, t_max1, rayP, cidP, use_kernels)
    else:
        occ = _reduce_pairs_anyhit_scan(
            cb, ro, rd, t_min1, t_max1, rayP, cidP, cnt, right, use_kernels)
    if cb.fallback is not None:
        occ = _retrace_suspects_anyhit(cb, ro, rd, t_min1, t_max1, suspect,
                                       occ, use_kernels)
    return occ, n_ovf


def compact_stats(cb: ClusterBVH, ro, rd, t_min, t_max):
    """Observability for the capacity contract.  Returns (n_live_pairs,
    n_overflow) where n_overflow counts candidates truncated ANYWHERE:
    descent frontier caps (including the k_leaf lane cap) plus
    flat-pair-budget drops.  The compact traversal is exact iff
    n_overflow == 0 for the scene/ray population."""
    t_min1 = t_min[:, 0] if t_min.dim() == 2 else t_min
    t_max1 = t_max[:, 0] if t_max.dim() == 2 else t_max
    Q = ro.shape[0]
    cand, live, overflow = _descend_compact(
        cb, ro, 1.0 / rd, t_min1[:, None], t_max1[:, None])
    budget = int(cb.pair_mults[2] * Q)
    rayP, _, dropped, _, _, _ = _flat_pairs(cand, live, Q, budget)
    n_live = torch.sum(rayP < Q)
    return n_live, torch.sum(overflow) + dropped


def intersect_counted(cb: ClusterBVH, scene: Scene, ro, rd, t_min, t_max,
                      use_kernels: bool = True, pair_stage: str = "fused",
                      suspect_out: list | None = None):
    """Nearest hit + the capacity-contract overflow count for this call
    (candidates truncated by frontier caps / k_leaf / the flat pair
    budget).  The traversal is exact iff the count is 0, or where a
    fallback is attached (the count is still reported).  suspect_out: when
    a list is passed, the (Q,) bool mask of the rays whose candidates were
    cut is appended — the input of suspect-pixel repair.

    ``pair_stage`` is one of ``PAIR_STAGES`` (anything else raises):
    ``"fused"`` and ``"split"`` are the ray-major stage as one kernel and
    as two, bit-identical; ``"dedup"`` runs the cluster-major stage (pairs
    sorted by cluster id, the tile-sharing kernel, scatter-min per-ray
    reduce) and raises on a shape that stage does not take (see
    ``_dedup_supported``).

    ``cb.traversal_mode`` selects the walk; the "frontier" and
    "pairs" modes take ``"fused"`` (every pair batch through
    ``pair_ray_reduce``) and ``"split"`` (through ``pair_tile_isect`` and
    array code), bit-identical in hit, t, occlusion and rounds (and in
    prim, u, v where there is a hit), and refuse ``"dedup"``; they append
    an all-False suspect mask (their truncation is counted, not located:
    the repair flow cannot repair it) and ignore an attached fallback, as
    the JAX package's do."""
    mode = _traversal_mode(cb, pair_stage)
    t_max_b = as_col(t_max, ro.shape[0], ro.device)
    if mode == "compact":
        best_t, gid, u, v, ovf = _traverse_compact(
            cb, ro, rd, t_min, t_max_b, use_kernels, pair_stage, suspect_out)
    else:
        walk = _traverse_pairs if mode == "pairs" else _traverse
        best_t, gid, u, v, ovf = walk(cb, ro, rd, t_min, t_max_b,
                                      use_kernels, pair_stage)
        if suspect_out is not None:
            suspect_out.append(torch.zeros((ro.shape[0],), dtype=torch.bool,
                                           device=ro.device))
    found = best_t < t_max_b
    return Hit(hit=found,
               t=torch.where(found, best_t, torch.full_like(best_t, INF)),
               prim=gid, u=u, v=v), ovf


def intersect(cb: ClusterBVH, scene: Scene, ro, rd, t_min, t_max,
              use_kernels: bool = True, pair_stage: str = "fused") -> Hit:
    return intersect_counted(cb, scene, ro, rd, t_min, t_max, use_kernels,
                             pair_stage)[0]


def occluded_counted(cb: ClusterBVH, scene: Scene, ro, rd, t_max,
                     narrow: bool = False, use_kernels: bool = True,
                     pair_stage: str = "fused",
                     suspect_out: list | None = None):
    """Occlusion + overflow count (and suspect mask: see
    intersect_counted; ``narrow`` is the compact mode's)."""
    t_min = torch.zeros((ro.shape[0], 1), dtype=torch.float32,
                        device=ro.device)
    t_max = as_col(t_max, ro.shape[0], ro.device)
    mode = _traversal_mode(cb, pair_stage)
    if mode == "compact":
        occ, ovf = _traverse_compact_anyhit(
            cb, ro, rd, t_min, t_max, narrow=narrow, use_kernels=use_kernels,
            pair_stage=pair_stage, suspect_out=suspect_out)
    else:
        walk = _traverse_pairs_anyhit if mode == "pairs" else \
            _traverse_anyhit
        occ, ovf = walk(cb, ro, rd, t_min, t_max, use_kernels, pair_stage)
        if suspect_out is not None:
            suspect_out.append(torch.zeros((ro.shape[0],), dtype=torch.bool,
                                           device=ro.device))
    return occ[:, None], ovf


def occluded(cb: ClusterBVH, scene: Scene, ro, rd, t_max,
             use_kernels: bool = True, pair_stage: str = "fused"):
    return occluded_counted(cb, scene, ro, rd, t_max,
                            use_kernels=use_kernels,
                            pair_stage=pair_stage)[0]


def attach_fallback(cb: ClusterBVH, scene: Scene,
                    max_leaf: int = 4) -> ClusterBVH:
    """A copy of ``cb`` carrying the exact-retrace fallback: the packed BVH
    of ``scene`` (host arrays), from ``native.build_packed_any``, on
    ``cb``'s device.  Every traversal call then re-walks its suspect rays
    exactly, so truncation can cost time, never a hit."""
    from tpu_pt_torch.bvh import native

    pk = native.build_packed_any(scene, max_leaf=max_leaf)
    if torch.is_tensor(cb.tiles):
        pk = pk.to(cb.tiles.device)
    return cb._replace(fallback=pk)


# ---------------------------------------------------------------------------
# Capacity tooling: size the static budgets from measured ray populations.
# ---------------------------------------------------------------------------


def level_hit_counts(cb: ClusterBVH, ro, rd):
    """(Q, n_levels) i32: how many node boxes of each level every ray truly
    enters over [0, INF) (dense, no frontier cap).  That is the frontier
    width the ray needs at that level (a child hit implies its parent hit),
    so it sizes the capacity contract from data.  ``cb`` holds tensors on
    the rays' device; wide levels are tested in chunks of 2,048 nodes."""
    rd_inv = 1.0 / rd
    Q = ro.shape[0]
    t_min = torch.zeros((Q, 1), dtype=torch.float32, device=ro.device)
    t_max = torch.full((Q, 1), INF, dtype=torch.float32, device=ro.device)
    ro_c = tuple(ro[:, i:i + 1] for i in range(3))
    ri_c = tuple(rd_inv[:, i:i + 1] for i in range(3))
    counts = []
    for lv in cb.levels:
        tot = torch.zeros((Q,), dtype=torch.int64, device=ro.device)
        for s in range(0, lv.shape[0], 2048):
            blk = lv[s:s + 2048]
            te = _slab_soa(tuple(blk[None, :, i] for i in range(3)),
                           tuple(blk[None, :, 3 + i] for i in range(3)),
                           ro_c, ri_c, t_min, t_max)
            tot = tot + torch.sum(te < INF, dim=1)
        counts.append(tot)
    return torch.stack(counts, dim=1).to(torch.int32)


def autotune_frontiers(scene: Scene, ro, rd, slack: float = 1.5,
                       tile: int = TILE, dense_start: int = 512,
                       pair_budget: int | None = None) -> ClusterBVH:
    """A host ``ClusterBVH`` whose frontier caps are the measured per-level
    hit counts of the sample rays ``ro``, ``rd`` (tensors, on the device the
    counts run on) x ``slack``, and whose closest-hit pair multiplier is the
    measured leaf maximum x ``slack`` (the flat pair budget is shared across
    a batch, whose rays may all be coherent-high at once).  Prefer
    :func:`autotune_for_render`, which probes the real wavefront
    population."""
    cb = build_cluster_bvh(scene, tile=tile, dense_start=dense_start)
    counts = level_hit_counts(cb.to(ro.device), ro, rd).cpu().numpy()
    caps = []
    for l, lv in enumerate(cb.levels):
        need = int(counts[:, l].max())
        caps.append(int(min(lv.shape[0], max(8, round(need * slack)))))
    max_leaf_hits = float(counts[:, -1].max())
    leaf_mult = max(4, int(np.ceil(max_leaf_hits * slack)))
    return build_cluster_bvh(scene, tile=tile, frontiers=tuple(caps),
                             k_leaf=caps[-1], pair_budget=pair_budget,
                             dense_start=dense_start,
                             pair_mults=(8, 8, leaf_mult))


def _probe_segment(probe_cb: ClusterBVH, scene, cam, cfg, key, ifn, ofn,
                   Q: int, pix_lo: int, n_steps: int):
    """``n_steps`` wavefront steps of a fresh queue from pixel ``pix_lo``
    on, every traversal batch measured: returns (need (L,) i64, the maximum
    per level of the candidates a ray needs before the cap; pairs (2,) i64,
    the maximum strided-sub-batch pair total x the split, for the wide and
    the narrow pair budget), read from the device once."""
    from tpu_pt_torch.render import wavefront as W

    dev = scene.vertices.device
    n_pix = cfg.n_pixels
    st = W.init_queue(Q, n_pix, dev)
    need_max = torch.zeros((len(probe_cb.levels),), dtype=torch.int64,
                           device=dev)
    wide = narrow = torch.zeros((), dtype=torch.int64, device=dev)
    for step_i in range(n_steps):
        probes = []
        st, _ = W._step(scene, cam, cfg, key, ifn, ofn, st, pix_lo,
                        n_pix - pix_lo, 0, cfg.spp, ray_probe=probes)
        for j, (ro, rd, t_max) in enumerate(probes):
            collect = []
            _, live, _ = _descend_compact(probe_cb, ro, 1.0 / rd,
                                          torch.zeros_like(t_max), t_max,
                                          collect=collect)
            need_max = torch.maximum(
                need_max, torch.stack([torch.max(n) for n, _ in collect]))
            # The pair budgets apply per STRIDED sub-batch (SPLIT_CLOSEST /
            # SPLIT_ANYHIT), so they are sized from the largest slice's pair
            # sum.  Slot 0 (the wide budget, pair_mults[2]) takes the
            # closest batches and the shadow batches of the wide prefix;
            # slot 1 (the narrow any-hit budget, pair_mults[3]) the later
            # shadow batches.
            ks = _split_batches(live.shape[0],
                                SPLIT_CLOSEST if j == 0 else SPLIT_ANYHIT)
            per_ray = torch.max(torch.stack(
                [torch.sum(live[i::ks]) for i in range(ks)])) * ks
            if j == 0 or step_i < W.WIDE_PREFIX_STEPS:
                wide = torch.maximum(wide, per_ray)
            else:
                narrow = torch.maximum(narrow, per_ray)
    out = torch.cat([need_max, torch.stack([wide, narrow])]).cpu().numpy()
    return out[:-2], out[-2:]


def autotune_for_render(scene: Scene, cam, cfg, queue: int = 4096,
                        segments: int = 8, warm_steps: int = 6,
                        probe_steps: int = 10, slack: float = 1.3,
                        tile: int = TILE, dense_start: int = 512,
                        pair_budget: int | None = None,
                        exact_fallback: bool = True,
                        device="cuda") -> ClusterBVH:
    """Size the capacity contract from the REAL wavefront population.

    Runs the renderer's own step (``render/wavefront.py::_step``, key
    ``(0, 7)``) for ``segments`` runs of ``warm_steps + probe_steps`` steps
    from a fresh queue at strided pixel offsets, so the whole image
    contributes, on a probe BVH with doubled caps (so the need measured is
    not clipped by the caps being measured).  Every step is measured, the
    first included: the first shadow wave is fully occupied and coherent,
    later steps give the mixed-depth population.  It records per level the
    largest candidate width a ray needs and the largest pair total of a
    strided sub-batch, for the wide and the narrow budget, and builds the
    host ``ClusterBVH`` with caps ``ceil(need x slack) + 2`` and pair
    multipliers ``ceil(pairs x min(slack, 1.05) / Q)`` (at least 2), in
    float64 on the host.  With ``exact_fallback`` it carries the packed
    fallback, so a population outside the probed envelope costs time,
    never a hit.

    Above 512² the probe renders a scaled-down image of the same field of
    view: a ray's frontier widths do not depend on the pixel count, and the
    per-slice pair maxima are decorrelated at any resolution.  ``scene`` and
    ``cam`` are host containers (or on ``device``); the probe runs on
    ``device``."""
    from tpu_pt_torch.render.driver import _intersectors_counted, _on_device

    if cfg.n_pixels > 512 * 512:
        scale = (cfg.n_pixels / (512 * 512)) ** 0.5
        cfg = cfg.replace(width=max(1, round(cfg.width / scale)),
                          height=max(1, round(cfg.height / scale)))
    cb0 = build_cluster_bvh(scene, tile=tile, dense_start=dense_start)
    wide_caps = tuple(min(lv.shape[0], 2 * c)
                      for lv, c in zip(cb0.levels, cb0.frontiers))
    probe_cb = build_cluster_bvh(
        scene, tile=tile, dense_start=dense_start, frontiers=wide_caps,
        k_leaf=wide_caps[-1],
        pair_mults=(cb0.pair_mults[0], cb0.pair_mults[1],
                    2 * cb0.pair_mults[2]))
    _, scene_d, cam_d, probe_d = _on_device(device, scene, cam, probe_cb)
    ifn, ofn = _intersectors_counted("cluster", probe_d)
    n_pix = cfg.n_pixels
    Q = min(queue, n_pix * cfg.spp)
    need_max = np.zeros((len(probe_cb.levels),), np.int64)
    pair_max = np.zeros((2,), np.int64)
    with torch.no_grad():
        for i in range(segments):
            nm, pm = _probe_segment(probe_d, scene_d, cam_d, cfg, (0, 7),
                                    ifn, ofn, Q, (n_pix // segments) * i,
                                    warm_steps + probe_steps)
            need_max = np.maximum(need_max, nm)
            pair_max = np.maximum(pair_max, pm)

    caps = tuple(
        int(min(lv.shape[0], max(8, int(np.ceil(n * slack)) + 2)))
        for lv, n in zip(probe_cb.levels, need_max))
    # Pair budgets get a thinner margin than the caps: every budgeted pair
    # slot is tile-tested, live or dead, and the exact fallback makes a thin
    # margin safe.
    pair_slack = min(slack, 1.05)
    leaf_mult = max(2, int(np.ceil(pair_max[0] * pair_slack / Q)))
    anyhit_mult = max(2, int(np.ceil(pair_max[1] * pair_slack / Q)))
    tuned = build_cluster_bvh(
        scene, tile=tile, dense_start=dense_start, frontiers=caps,
        k_leaf=caps[-1], pair_budget=pair_budget,
        pair_mults=(cb0.pair_mults[0], cb0.pair_mults[1], leaf_mult,
                    anyhit_mult))
    return attach_fallback(tuned, scene) if exact_fallback else tuned


def autotune_for_camera(scene: Scene, cam, width: int, height: int,
                        slack: float = 1.5, pair_budget: int | None = None,
                        queue: int = 4096, device="cuda") -> ClusterBVH:
    """:func:`autotune_for_render` at the standard render workload (spp 1,
    4 bounces, Russian roulette from bounce 2 at 0.7) at the given size:
    what the command line's ``--autotune`` runs."""
    from tpu_pt_torch.config import RenderConfig

    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=4,
                       rr_start=2, rr_prob=0.7)
    return autotune_for_render(scene, cam, cfg, queue=queue, slack=slack,
                               pair_budget=pair_budget, device=device)
