"""The one-kernel ray-major pair stage of the port on the CPU
(``tpu_pt_torch.kernels.pair_fused.pair_ray_reduce``): its plain version
against the JAX package's two-kernel stage (Pallas kernels in interpret
mode), against the port's split and sort forms bit for bit, against a direct
evaluation of what the CUDA kernel computes (the (t, gid) minimum over all
lanes of all of a ray's pairs) on hand-made edge cases, and through the
renderer's ``pair_stage`` keyword.  The CUDA kernel itself is held against
the plain version on the card by chip_smoke.py and by the ``gpu``-marked test
below.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt.scene import types as jt
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.core.intersect import INF
from tpu_pt_torch.kernels import cluster_isect as tki
from tpu_pt_torch.kernels import pair_fused as tpf
from tpu_pt_torch.kernels import pair_scan as tps
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc

from torch_port_util import (T, bvh_dict, hold_apart_to_witness, rays,
                             scene_dict, witness_lanes)

NAMES = ["big", "big128", "deep", "mesh", "cornell"]


def _mesh_scene():
    v, f = jm.icosphere(subdiv=3)
    return jt.make_scene(v, f, np.zeros(len(f), np.int32),
                         jt.make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
                         jt.make_lights([]))


@pytest.fixture(scope="module")
def setups():
    """name -> (jax bvh, port bvh): the set-ups of
    test_torch_cluster_traverse.py (tile widths 128, 64 and 32)."""
    out = {}
    for name, scene, kw in (
            ("cornell", jc.cornell("spheres"), {}),
            ("mesh", _mesh_scene(), dict(tile=32)),
            ("big", jm.big_scene(4), dict(tile=64)),
            ("big128", jm.big_scene(4), dict(tile=128)),
            ("deep", jm.big_scene(4), dict(tile=32, dense_start=8))):
        cb = jcl.build_cluster_bvh(scene, **kw)
        out[name] = (cb, convert.cluster_bvh_from_numpy(bvh_dict(cb), "cpu"))
    return out


def _aimed_rays(n, seed):
    """Rays from around the scene aimed into it, so that most reach leaf
    clusters."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    ro[:, 1] = np.abs(ro[:, 1]) + 0.2
    target = rs.uniform(-0.8, 0.8, (n, 3)) + np.array([0.0, 0.9, 0.0])
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def _pair_list(ct, Q, seed, t_max=1e30, budget=None):
    """The operands the traversal hands to its pair stage: rays (half of
    them aimed at the scene), bounds and the flat ray-major pair list."""
    ro, rd = rays(Q, seed)
    ro[::2], rd[::2] = _aimed_rays(len(ro[::2]), seed + 100)
    tmin = T(np.zeros((Q,), np.float32))
    tmax = T(np.full((Q,), t_max, np.float32))
    cand, live, _ = tcl._descend_compact(ct, T(ro), 1.0 / T(rd), tmin[:, None],
                                         tmax[:, None])
    budget = budget or ct.pair_mults[2] * Q
    rayP, cidP, dropped, cnt, right, _ = tcl._flat_pairs(cand, live, Q, budget)
    return T(ro), T(rd), tmin, tmax, rayP, cidP, cnt, right, int(dropped)


def _i32(x):
    return jnp.asarray(x.numpy().astype(np.int32))


def _pairs_witness(ct, ro, rd, tmin, tmax, cidP, cnt, right):
    """(Q,) float64 witness t of each ray over the lanes of its segment's
    tiles (``witness_lanes``), inf where none hits."""
    cnt, right = cnt.numpy(), right.numpy()
    pair = np.concatenate([np.arange(r - c, r) for c, r in zip(cnt, right)])
    ray = np.repeat(np.arange(len(cnt)), cnt)
    t_p = witness_lanes(ct.tiles.numpy()[cidP.numpy()[pair]],
                        *(x.numpy()[ray] for x in (ro, rd, tmin, tmax)))
    t_w = np.full((len(cnt),), np.inf)
    np.minimum.at(t_w, ray, t_p.min(1))
    return t_w


@pytest.mark.parametrize("name", NAMES)
def test_fused_ref_matches_the_jax_two_kernel_stage(setups, name):
    cj, ct = setups[name]
    Q = 256
    t_max = 4.0 if name == "cornell" else 1e30
    ro, rd, tmin, tmax, rayP, cidP, cnt, right, dropped = _pair_list(
        ct, Q, 7, t_max)
    assert dropped == 0 and int((cnt == 0).sum()) > 0
    cjd = jax.tree.map(jnp.asarray, cj)
    jargs = (cjd, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()),
             jnp.asarray(tmin.numpy()), jnp.asarray(tmax.numpy()),
             _i32(rayP), _i32(cidP), _i32(cnt), _i32(right))
    t_j, g_j, u_j, v_j = (np.asarray(x)
                          for x in jcl._reduce_pairs_closest_scan(*jargs))
    occ_j = np.asarray(jcl._reduce_pairs_anyhit_scan(*jargs))
    args = (ct.tiles, ct.tile_gid, ro, rd, tmin, tmax, cidP, cnt, right)
    t_t, g_t, u_t, v_t = (x.numpy() for x in tpf.pair_ray_reduce_ref(*args))
    occ_t = tpf.pair_ray_reduce_ref(*args, any_hit=True).numpy()
    hit = t_t < INF
    assert hit.sum() > 20 and (~hit).sum() > 0
    # Hit mask and occlusion exact; t to one ulp (XLA fuses the
    # multiply-adds); gid equal wherever t is bitwise equal and on > 0.999
    # of the hits: the tolerances of test_intersect_matches_jax_and_brute.
    # Rows where the JAX package's sphere solve parts from the port's are
    # held to the float64 witness of each ray's pairs instead.
    apart = ~np.isclose(t_t, t_j, rtol=1e-6, atol=1e-6)
    n, _ = hold_apart_to_witness(apart, t_t, t_j, _pairs_witness(
        ct, ro, rd, tmin, tmax, cidP, cnt, right))
    assert n <= Q // 100
    np.testing.assert_array_equal(hit[~apart], (t_j < INF)[~apart])
    np.testing.assert_array_equal(occ_j[~apart], occ_t[~apart])
    np.testing.assert_array_equal(occ_t, hit)
    np.testing.assert_allclose(t_t[~apart], t_j[~apart], rtol=1e-6,
                               atol=1e-6)
    t_same = (t_j == t_t) & hit
    np.testing.assert_array_equal(g_j[t_same], g_t[t_same])
    assert (g_j == g_t)[hit].mean() > 0.999
    same = hit & (g_j == g_t)
    np.testing.assert_allclose(u_t[same], u_j[same], atol=1e-4)
    np.testing.assert_allclose(v_t[same], v_j[same], atol=1e-4)
    assert (t_t[~hit] == np.float32(INF)).all() and (g_t[~hit] == 0).all()
    assert (u_t[~hit] == 0).all() and (v_t[~hit] == 0).all()


@pytest.mark.parametrize("name", NAMES)
def test_fused_equals_split_and_sort_forms_bitwise(setups, name):
    _, ct = setups[name]
    Q = 512
    ro, rd, tmin, tmax, rayP, cidP, cnt, right, dropped = _pair_list(
        ct, Q, 29, 4.0 if name == "cornell" else 1e30)
    assert dropped == 0
    fused = tcl._reduce_pairs_closest_fused(ct, ro, rd, tmin, tmax, cidP, cnt,
                                            right)
    split = tcl._reduce_pairs_closest_scan(ct, ro, rd, tmin, tmax, rayP, cidP,
                                           cnt, right)
    sort = tcl._reduce_pairs_closest(ct, ro, rd, tmin, tmax, rayP, cidP, cnt,
                                     right)
    assert bool((fused[0] < INF).any()) and bool((fused[0] >= INF).any())
    for a, b, c in zip(fused, split, sort):
        assert a.dtype == b.dtype == c.dtype and a.shape == (Q,)
        assert torch.equal(a, b) and torch.equal(a, c)
    assert [x.dtype for x in fused] == [torch.float32, torch.int32,
                                       torch.float32, torch.float32]
    occ_f = tcl._reduce_pairs_anyhit_fused(ct, ro, rd, tmin, tmax, cidP, cnt,
                                           right)
    occ_s = tcl._reduce_pairs_anyhit_scan(ct, ro, rd, tmin, tmax, rayP, cidP,
                                          cnt, right)
    assert occ_f.dtype == torch.bool and torch.equal(occ_f, occ_s)
    assert torch.equal(occ_f, fused[0] < INF)
    # The plain-version switch changes nothing on the CPU.
    for a, b in zip(fused, tcl._reduce_pairs_closest_fused(
            ct, ro, rd, tmin, tmax, cidP, cnt, right, use_kernels=False)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Edge cases, against a direct evaluation of what the CUDA kernel computes
# ---------------------------------------------------------------------------

def _definition(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt, right):
    """Per ray, the (t, gid) minimum over ALL lanes of ALL its pairs (not
    lane-min per pair first), u, v of the winner, masked: the kernel's walk
    written as a loop."""
    C, _, L = tiles.shape
    P, Q = cid.shape[0], cnt.shape[0]
    out = []
    for q in range(Q):
        end = min(int(right[q]), P)
        start = max(end - int(cnt[q]), 0)
        best = (np.float32(INF), 0, np.float32(0), np.float32(0))
        key = (np.float32(INF), 2**31 - 1)
        for j in range(start, end):
            c = min(max(int(cid[j]), 0), C - 1)
            row = torch.zeros((1, 16))
            row[0, 0:3], row[0, 3:6] = ro[q], rd[q]
            row[0, 6], row[0, 7], row[0, 8] = t_min[q], t_max[q], 1.0
            t, u, v = tki._mt_group(tiles[c:c + 1], row)
            for lane in range(L):
                k = (t[0, lane].item(), int(tile_gid[c, lane]))
                if k[0] < INF and k < key:
                    key = k
                    best = (t[0, lane].item(), k[1], u[0, lane].item(),
                            v[0, lane].item())
        out.append(best)
    t, g, u, v = zip(*out)
    return (torch.tensor(t, dtype=torch.float32),
            torch.tensor(g, dtype=torch.int32),
            torch.tensor(u, dtype=torch.float32),
            torch.tensor(v, dtype=torch.float32))


def _floor_tile(L, y, gid0, x0=-1.0, size=2.0):
    """A (12, L) tile whose lanes 0 and 1 are the two triangles of a square
    at height y (facing up), the rest padding; and its gid row (ascending)."""
    tile = np.zeros((12, L), np.float32)
    a = np.array([x0, y, x0], np.float32)
    tile[0:3, 0], tile[3:6, 0], tile[6:9, 0] = a, (size, 0, 0), (0, 0, size)
    b = a + np.array([size, 0, size], np.float32)
    tile[0:3, 1], tile[3:6, 1], tile[6:9, 1] = b, (-size, 0, 0), (0, 0, -size)
    gid = np.zeros((L,), np.int32)
    gid[0:2] = (gid0, gid0 + 1)
    return tile, gid


def _sphere_tile(L, centre, radius, gid0):
    tile = np.zeros((12, L), np.float32)
    tile[0:3, 3] = centre
    tile[3, 3] = radius
    tile[9, 3] = 1.0
    gid = np.zeros((L,), np.int32)
    gid[3] = gid0
    return tile, gid


def _down_rays(Q, seed):
    """Rays from y = 5 straight down at random (x, z) inside the squares."""
    rs = np.random.RandomState(seed)
    ro = np.empty((Q, 3), np.float32)
    ro[:, 0], ro[:, 2] = rs.uniform(-0.9, 0.9, (2, Q))
    ro[:, 1] = 5.0
    rd = np.tile(np.array([0.0, -1.0, 0.0], np.float32), (Q, 1))
    return ro, rd


def _edge_case(name):
    """Operands of pair_ray_reduce (numpy) for one hand-made case, and what
    the winner's gid must be per ray (-1: a miss)."""
    L = 32 if name == "lanes_32" else 128
    Q = 8
    # Tiles: 0 floor y=0 gids 100..; 1 the SAME floor with gids 50.. (equal
    # t, lower gid); 2 floor y=-1 gids 10..; 3 sphere r=1 at y=2 gid 7;
    # 4 all padding.
    parts = [_floor_tile(L, 0.0, 100), _floor_tile(L, 0.0, 50),
             _floor_tile(L, -1.0, 10), _sphere_tile(L, (0, 2, 0), 1.0, 7),
             (np.zeros((12, L), np.float32), np.zeros((L,), np.int32))]
    tiles = np.stack([p[0] for p in parts])
    gid = np.stack([p[1] for p in parts])
    ro, rd = _down_rays(Q, 3)
    segs = {
        # ray 2 and ray 5 have no pairs; ray 6 only a padding tile.
        "empty_segment": [[0], [2, 0], [], [0, 2], [2], [], [4], [0]],
        # the same floor twice under two gid ranges, in both orders.
        "cross_tile_tie": [[0, 1], [1, 0], [2, 0, 1], [1, 2, 0], [0], [1],
                           [0, 1, 4], [4, 1, 0]],
        # rays through the sphere (|x|, |z| < 0.6) stop on it, above the floor.
        "sphere_winner": [[0, 3], [3, 0], [3], [2, 3, 0], [3, 4], [0, 3],
                          [3, 2], [1, 3]],
        # ids below 0 and beyond C - 1 are clamped: -5 -> tile 0, 99 -> tile 4.
        "cid_out_of_range": [[-5], [99], [99, -5], [-1, 2], [5], [7, 0],
                             [-9, 99], [0]],
        "lanes_32": [[0, 1], [2], [], [3, 0], [1, 0, 2], [4], [0], [2, 1]],
        "budget_cut": [[0, 2], [2, 0], [0], [2, 1, 0], [0, 2], [1], [2], [0]],
    }[name]
    if name == "sphere_winner":
        ro[:, 0] *= 0.6
        ro[:, 2] *= 0.6
    cid = np.array([c for s in segs for c in s], np.int64)
    cnt = np.array([len(s) for s in segs], np.int64)
    right = np.cumsum(cnt)
    if name == "budget_cut":
        # The pair budget ends inside ray 3's segment: _flat_pairs' clamping
        # keeps its first pair and leaves rays 4-7 empty; the list is cut.
        budget = 6
        base = right - cnt
        right = np.minimum(right, budget)
        cnt = np.maximum(right - np.minimum(base, budget), 0)
        cid = cid[:budget]
        segs = [s for s in segs]
        segs[3], segs[4:] = [2], [[], [], [], []]
    C = len(parts)
    floor_gid = {0: 100, 1: 50, 2: 10}

    def winner(q, seg):
        seg = [min(max(c, 0), C - 1) for c in seg]
        if 3 in seg and ro[q, 0] ** 2 + ro[q, 2] ** 2 < 1.0:
            return 7                                  # the sphere is on top
        ys = [(0.0 if c < 2 else -1.0, floor_gid[c]) for c in seg if c < 3]
        if not ys:
            return -1
        top = max(y for y, _ in ys)
        return min(g for y, g in ys if y == top)      # lane 0 or 1: see test
    want = [winner(q, s) for q, s in enumerate(segs)]
    tmin = np.zeros((Q,), np.float32)
    tmax = np.full((Q,), 1e30, np.float32)
    return (tiles, gid, ro, rd, tmin, tmax, cid, cnt, right), want


EDGE_CASES = ["empty_segment", "budget_cut", "cross_tile_tie",
              "sphere_winner", "cid_out_of_range", "lanes_32"]


@pytest.mark.parametrize("name", EDGE_CASES)
def test_edge_case_matches_the_all_lanes_definition(name):
    ops, want = _edge_case(name)
    ops = tuple(T(x) for x in ops)
    got = tpf.pair_ray_reduce(*ops)
    ref = _definition(*ops)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    t, g, u, v = got
    hit = t < INF
    assert hit.tolist() == [w >= 0 for w in want]
    assert bool(hit.any())
    if name in ("empty_segment", "budget_cut", "cid_out_of_range", "lanes_32"):
        assert not bool(hit.all())
    # A square's two triangles share the diagonal; the ray is on one of
    # them, so the winner is the square's first gid or the one after it.
    for q, w in enumerate(want):
        if w == 7 or w < 0:
            assert int(g[q]) == max(w, 0)
        else:
            assert int(g[q]) in (w, w + 1)
    miss = ~hit
    assert bool((t[miss] == INF).all()) and bool((g[miss] == 0).all())
    assert bool((u[miss] == 0).all()) and bool((v[miss] == 0).all())
    if name == "sphere_winner":
        assert bool((u == 0).all()) and bool((v == 0).all())
        assert bool(((t > 1.9) & (t < 3.0)).all())     # on the sphere, not y=0
    occ = tpf.pair_ray_reduce(*ops, any_hit=True)
    assert occ.dtype == torch.bool and torch.equal(occ, hit)
    # The split stage on the same operands, through its own functions.
    tiles, gid, ro, rd, tmin, tmax, cid, cnt, right = ops
    P, Q = cid.shape[0], cnt.shape[0]
    ray = torch.repeat_interleave(torch.arange(Q), cnt)
    assert ray.shape[0] <= P
    cid_c = cid.clamp(0, tiles.shape[0] - 1)[:ray.shape[0]]
    cid_p, rows = tki.pair_rows(ro, rd, tmin, tmax, ray, cid_c,
                                torch.ones_like(ray, dtype=torch.bool))
    out = tki.pair_tile_isect(tiles, cid_p, rows)[:ray.shape[0]]
    g_p = gid[cid_c, out[:, 1].long()]
    split = tps.pair_segmin(out[:, 0].contiguous(), g_p.contiguous(),
                            out[:, 2].contiguous(), out[:, 3].contiguous(),
                            cnt.to(torch.int32), right.to(torch.int32))
    has = (cnt > 0) & (split[0] < INF)
    assert torch.equal(torch.where(has, split[0], torch.full_like(t, INF)), t)
    assert torch.equal(torch.where(has, split[1], torch.zeros_like(g)), g)


def test_pair_list_tail_beyond_the_last_segment_is_never_read():
    ops, _ = _edge_case("empty_segment")
    ops = [T(x) for x in ops]
    base = tpf.pair_ray_reduce(*ops)
    ops[6] = torch.cat([ops[6], torch.tensor([2**40, -2**40, 3])])   # cid
    for a, b in zip(base, tpf.pair_ray_reduce(*ops)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Gapped segments: the frontier walk's round 1
# ---------------------------------------------------------------------------

def _packed_segments(cid_rows, n):
    """The segments of ``row_segments`` packed densely, without a sort: ray
    q's ``n[q]`` pairs at ``[right[q] - n[q], right[q])``, ``right`` the
    running sum of ``n``, moved by one scatter; the slots past
    ``right[Q - 1]`` hold 0."""
    Q, R = cid_rows.shape
    cnt = n.to(torch.int64)
    right = torch.cumsum(cnt, 0)
    cols = torch.arange(R, device=cnt.device)[None, :]
    pos = torch.where(cols < cnt[:, None], (right - cnt)[:, None] + cols,
                      Q * R)
    out = cid_rows.new_zeros((Q * R + 1,))
    out.scatter_(0, pos.reshape(-1), cid_rows.reshape(-1))
    return out[:Q * R], cnt, right


def _round_one(ct, Q, seed):
    """Rays (half aimed at the scene), their (Q,) bounds, the frontier
    descent's first ``pb`` candidate rows (finite ones first) and counts:
    the operands of round 1."""
    ro, rd = rays(Q, seed)
    ro[::2], rd[::2] = _aimed_rays(len(ro[::2]), seed + 100)
    tmin = T(np.zeros((Q,), np.float32))
    tmax = T(np.full((Q,), 1e30, np.float32))
    cand, cand_t, _ = tcl._descend(ct, T(ro), 1.0 / T(rd), tmin[:, None],
                                   tmax[:, None])
    pb = min(ct.pair_budget, cand.shape[1])
    live = cand_t[:, :pb] < INF
    rows = cand[:, :pb]
    if not tcl._cand_sorted(ct):
        rows = tcl._compact_lanes(live, rows, pb)[0]
    return T(ro), T(rd), tmin, tmax, rows, live.sum(1), pb


@pytest.mark.parametrize("name", NAMES)
def test_row_layout_round_one_equals_round_min(setups, name):
    """Round 1 of the frontier walk: ``pair_ray_reduce_ref`` on the gapped
    segments of the candidate rows (``row_segments``) gives ``_round_min``'s (t, gid, u, v)
    over the split stage's (Q, pb) slots bit for bit, and its any-hit form
    the rows' ``any``, rays with no live slot included; so does
    ``_first_round`` in both stages."""
    _, ct = setups[name]
    Q = 512
    ro, rd, tmin, tmax, rows, n, pb = _round_one(ct, Q, 21)
    assert bool((n == 0).any()) and bool((n > 0).any())
    cid, cnt, right = tpf.row_segments(rows, n)
    assert cid.is_contiguous()                  # as the kernel takes it
    ops = (ct.tiles, ct.tile_gid, ro, rd, tmin, tmax, cid, cnt, right)
    fused = tpf.pair_ray_reduce_ref(*ops)
    slots = torch.arange(Q * pb) % pb < n.repeat_interleave(pb)
    t_p, u_p, v_p, g_p = tcl._test_pair_batch(
        ct, ro, rd, tmin, tmax, torch.arange(Q).repeat_interleave(pb),
        rows.reshape(-1), slots, use_kernels=False)
    t, u, v, g = tcl._round_min(t_p, u_p, v_p, g_p, Q, pb)
    for a, b in zip(fused, (t, g, u, v)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    occ = tpf.pair_ray_reduce_ref(*ops, any_hit=True)
    assert torch.equal(occ, torch.any(t_p.reshape(Q, pb) < INF, dim=1))
    assert bool((t < INF).any())
    firsts = [tcl._first_round(ct, ro, rd, tmin, tmax, False, stage, False)
              for stage in ("fused", "split")]
    for a, b in zip(firsts[0][4], firsts[1][4]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_packed_and_row_layouts_agree(setups, name):
    """The same round-1 segments packed densely (``_packed_segments``: one
    scatter) and left in their rows with gaps (``row_segments``): equal
    results, closest and any hit."""
    _, ct = setups[name]
    ro, rd, tmin, tmax, rows, n, pb = _round_one(ct, 512, 23)
    head = (ct.tiles, ct.tile_gid, ro, rd, tmin, tmax)
    cid_p, cnt_p, right_p = _packed_segments(rows, n)
    assert int(right_p[-1]) == int(n.sum()) and cid_p.shape == (512 * pb,)
    for any_hit in (False, True):
        a = tpf.pair_ray_reduce_ref(*head, *tpf.row_segments(rows, n),
                                    any_hit=any_hit)
        b = tpf.pair_ray_reduce_ref(*head, cid_p, cnt_p, right_p,
                                    any_hit=any_hit)
        for x, y in zip((a,) if any_hit else a, (b,) if any_hit else b):
            assert torch.equal(x, y)


def test_checked_form_takes_gaps_and_rows_and_refuses_overlap(setups):
    """``pair_ray_reduce_checked`` on round 1's gapped row segments: the
    unchecked results; a segment moved back into the gap before it is still
    a valid list; a segment reaching into the one before it is refused."""
    _, ct = setups["deep"]
    ro, rd, tmin, tmax, rows, n, pb = _round_one(ct, 256, 25)
    cid, cnt, right = tpf.row_segments(rows, n)
    head = (ct.tiles, ct.tile_gid, ro, rd, tmin, tmax, cid)
    assert bool((right[1:] - cnt[1:] > right[:-1]).any())      # gaps
    q = int(torch.nonzero((cnt[1:] > 0) & (cnt[:-1] == 0))[0]) + 1
    early = right.clone()
    early[q] -= 1       # ray q's segment one slot into the empty row before
    for ends in (right, early):
        for any_hit in (False, True):
            a = tpf.pair_ray_reduce_checked(*head, cnt, ends, any_hit)
            b = tpf.pair_ray_reduce(*head, cnt, ends, any_hit)
            for x, y in zip((a,) if any_hit else a, (b,) if any_hit else b):
                assert torch.equal(x, y)
    q = int(torch.nonzero((cnt > 0) & (torch.arange(256) > 0))[0])
    back = right.clone()
    back[q - 1] = right[q] - cnt[q] + 1     # ray q - 1 ends inside q's
    with pytest.raises(AssertionError, match="disagree"):
        tpf.pair_ray_reduce_checked(*head, cnt, back)


# ---------------------------------------------------------------------------
# The keyword, the wrapper's refusals, the counter
# ---------------------------------------------------------------------------

def test_pair_stage_keyword_gives_equal_images_and_unknown_raises():
    st = tc.cornell("spheres")
    ct = tcl.build_cluster_bvh(st)
    cfg = TConfig(width=16, height=16, spp=2, max_depth=3)
    cam = tc.camera(16, 16)
    n0 = (tpf.pair_ray_reduce.launches, tki.pair_tile_isect.launches,
          tps.pair_segmin.launches, tki.pair_tile_isect_dedup.launches)
    out = {s: twf.render_wavefront_counts(st, cam, cfg, (0, 3), ct, queue=256,
                                          backend="cluster", device="cpu",
                                          pair_stage=s)
           for s in tcl.PAIR_STAGES}
    default = twf.render_wavefront_counts(st, cam, cfg, (0, 3), ct, queue=256,
                                          backend="cluster", device="cpu")
    assert tcl.PAIR_STAGES == ("fused", "split", "dedup")
    assert bool(torch.isfinite(default[0]).all()) and float(default[0].mean()) > 0
    for s in tcl.PAIR_STAGES:
        assert torch.equal(out[s][0], default[0]), s
        assert out[s][1:] == default[1:], s
    assert default[3] == 0
    for s in ("Fused", "", "scan", None, True):
        with pytest.raises(ValueError, match="unknown pair_stage"):
            twf.render_wavefront_counts(st, cam, cfg, (0, 3), ct, queue=256,
                                        backend="cluster", device="cpu",
                                        pair_stage=s)
    ro, rd = (T(x) for x in rays(64, 3))
    z, big = torch.zeros((64, 1)), torch.full((64, 1), 1e30)
    with pytest.raises(ValueError, match="unknown pair_stage"):
        tcl.intersect(ct, st, ro, rd, z, big, pair_stage="both")
    with pytest.raises(ValueError, match="unknown pair_stage"):
        tcl.occluded(ct, st, ro, rd, big, pair_stage="both")
    # CPU tensors take the plain versions: nothing was launched.
    assert n0 == (tpf.pair_ray_reduce.launches, tki.pair_tile_isect.launches,
                  tps.pair_segmin.launches,
                  tki.pair_tile_isect_dedup.launches)


def test_unsplit_traversal_takes_broadcast_bounds_in_every_stage():
    """Fewer than 2048 rays run as one batch, with the caller's tensors as
    they are: a scalar bound arrives as a stride-0 column."""
    st = tc.cornell("spheres").to("cpu")
    ct = tcl.build_cluster_bvh(st).to("cpu")
    ro, rd = (T(x) for x in _aimed_rays(128, 5))  # 6 x 128 pairs: all stages
    z = torch.zeros((128, 1))
    hits = [tcl.intersect(ct, st, ro, rd, z, 1e30, pair_stage=s)
            for s in tcl.PAIR_STAGES]
    assert bool(hits[0].hit.any())
    for h in hits[1:]:
        assert torch.equal(h.t, hits[0].t) and torch.equal(h.hit, hits[0].hit)
    occ = [tcl.occluded(ct, st, ro, rd, 3.0, pair_stage=s)
           for s in tcl.PAIR_STAGES]
    assert bool(occ[0].any()) and all(torch.equal(o, occ[0]) for o in occ[1:])


BAD = [
    ("tiles_rows", 0, lambda x: x[:, :11], ValueError),
    ("tiles_width", 0, lambda x: x[:, :, :48], ValueError),
    ("tiles_dtype", 0, lambda x: x.double(), TypeError),
    ("gid_shape", 1, lambda x: x[:, :64], ValueError),
    ("gid_dtype", 1, lambda x: x.long(), TypeError),
    ("ro_shape", 2, lambda x: x[:, :2], ValueError),
    ("rd_rows", 3, lambda x: x[:-1], ValueError),
    ("t_min_column", 4, lambda x: x[:, None], ValueError),
    ("t_max_dtype", 5, lambda x: x.double(), TypeError),
    ("cid_dtype", 6, lambda x: x.int(), TypeError),
    ("cid_shape", 6, lambda x: x[:, None], ValueError),
    ("cnt_dtype", 7, lambda x: x.int(), TypeError),
    ("right_shape", 8, lambda x: x[:-1], ValueError),
    ("right_dtype", 8, lambda x: x.int(), TypeError),
    ("cid_device", 6, lambda x: x.to("meta"), ValueError),
    ("ro_device", 2, lambda x: x.to("meta"), ValueError),
]


@pytest.mark.parametrize("what,i,change,err", BAD, ids=[b[0] for b in BAD])
def test_bad_operands_raise(what, i, change, err):
    ops = [T(x) for x in _edge_case("empty_segment")[0]]
    ops[i] = change(ops[i])
    n0 = tpf.pair_ray_reduce.launches
    for any_hit in (False, True):
        with pytest.raises(err):
            tpf.pair_ray_reduce(*ops, any_hit=any_hit)
    assert tpf.pair_ray_reduce.launches == n0


def test_no_rays_and_no_pairs():
    ops = [T(x) for x in _edge_case("empty_segment")[0]]
    none = ops[:2] + [ops[2][:0], ops[3][:0], ops[4][:0], ops[5][:0],
                      ops[6], ops[7][:0], ops[8][:0]]
    out = tpf.pair_ray_reduce(*none)
    assert [tuple(x.shape) for x in out] == [(0,)] * 4
    assert out[1].dtype == torch.int32
    assert tpf.pair_ray_reduce(*none, any_hit=True).shape == (0,)
    nop = ops[:6] + [ops[6][:0], torch.zeros_like(ops[7]),
                     torch.zeros_like(ops[8])]
    t, g, u, v = tpf.pair_ray_reduce(*nop)
    assert bool((t == INF).all()) and not bool(g.any())
    assert not bool(tpf.pair_ray_reduce(*nop, any_hit=True).any())


def test_checked_form_passes_and_catches_bad_segments_and_poison(setups):
    _, ct = setups["big128"]
    ro, rd, tmin, tmax, _, cidP, cnt, right, _ = _pair_list(ct, 256, 11)
    ops = [ct.tiles, ct.tile_gid, ro, rd, tmin, tmax, cidP, cnt, right]
    for a, b in zip(tpf.pair_ray_reduce_checked(*ops),
                    tpf.pair_ray_reduce(*ops)):
        assert torch.equal(a, b)
    assert torch.equal(tpf.pair_ray_reduce_checked(*ops, any_hit=True),
                       tpf.pair_ray_reduce(*ops, any_hit=True))
    # The pair budget's cut is a shape the checks accept.
    cut = [T(x) for x in _edge_case("budget_cut")[0]]
    for a, b in zip(tpf.pair_ray_reduce_checked(*cut),
                    tpf.pair_ray_reduce(*cut)):
        assert torch.equal(a, b)
    q = int(torch.nonzero(cnt > 0)[1])             # a ray with pairs, not ray 0
    down = right.clone()
    down[q] = right[q - 1] - 1
    with pytest.raises(AssertionError, match="decrease"):
        tpf.pair_ray_reduce_checked(*ops[:8], down)
    with pytest.raises(AssertionError, match="outside the pair list"):
        tpf.pair_ray_reduce_checked(*ops[:8], right + cidP.shape[0])
    long = cnt.clone()
    long[q] += 1                                   # reaches into ray q - 1's
    with pytest.raises(AssertionError, match="disagree"):
        tpf.pair_ray_reduce_checked(*ops[:7], long, right)
    with pytest.raises(AssertionError, match="disagree"):
        tpf.pair_ray_reduce_checked(*ops[:7], -cnt - 1, right)
    poisoned = ct.tiles.clone()
    poisoned[0, 0, 0] = float("nan")
    with pytest.raises(AssertionError, match="non-finite"):
        tpf.pair_ray_reduce_checked(poisoned, *ops[1:])
    with pytest.raises(TypeError):                 # the wrapper's refusals stay
        tpf.pair_ray_reduce_checked(*ops[:8], right.int())


@pytest.mark.gpu
def test_fused_kernel_matches_plain_version_and_split_kernels_on_the_card():
    """Needs an NVIDIA GPU and nvcc: the kernel, through its checked form,
    bit for bit against its plain version and against the split stage's
    kernels, on real pair lists of three tile widths (and their frontier
    round 1, gapped and packed) and on the edge cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene = jm.big_scene(4)
    for tile in (128, 64, 32):
        ct = convert.cluster_bvh_from_numpy(
            bvh_dict(jcl.build_cluster_bvh(scene, tile=tile)), "cpu")
        ro, rd, tmin, tmax, rayP, cidP, cnt, right, _ = _pair_list(ct, 1024, 5)
        cd = ct.to("cuda")
        dro, drd, dmin, dmax, drayP, dcidP, dcnt, dright = (
            x.cuda() for x in (ro, rd, tmin, tmax, rayP, cidP, cnt, right))
        ops = (cd.tiles, cd.tile_gid, dro, drd, dmin, dmax, dcidP, dcnt, dright)
        ref = tpf.pair_ray_reduce_ref(*ops)
        split = tcl._reduce_pairs_closest_scan(cd, dro, drd, dmin, dmax, drayP,
                                               dcidP, dcnt, dright)
        n0 = tpf.pair_ray_reduce.launches
        out = tpf.pair_ray_reduce_checked(*ops)
        occ = tpf.pair_ray_reduce_checked(*ops, any_hit=True)
        for a, b, c in zip(out, ref, split):
            assert a.dtype == b.dtype and torch.equal(a, b)
            assert torch.equal(a, c)
        assert torch.equal(occ, ref[0] < INF)
        assert tpf.pair_ray_reduce.launches == n0 + 2
        # Round 1 of the frontier walk: gapped row segments and packed.
        ro, rd, tmin, tmax, rows, n, pb = _round_one(ct, 1024, 5)
        head = (cd.tiles, cd.tile_gid) + tuple(
            x.cuda() for x in (ro, rd, tmin, tmax))
        rows, n = rows.cuda(), n.cuda()
        for any_hit in (False, True):
            ref = tpf.pair_ray_reduce_ref(*head, *tpf.row_segments(rows, n),
                                          any_hit=any_hit)
            got = (tpf.pair_ray_reduce_checked(
                       *head, *tpf.row_segments(rows, n), any_hit),
                   tpf.pair_ray_reduce_checked(
                       *head, *_packed_segments(rows, n), any_hit))
            for out in got:
                for a, b in zip((out,) if any_hit else out,
                                (ref,) if any_hit else ref):
                    assert torch.equal(a, b)
    for name in EDGE_CASES:
        ops = tuple(T(x).cuda() for x in _edge_case(name)[0])
        for a, b in zip(tpf.pair_ray_reduce_checked(*ops),
                        tpf.pair_ray_reduce_ref(*ops)):
            assert torch.equal(a, b), name
        assert torch.equal(
            tpf.pair_ray_reduce_checked(*ops, any_hit=True),
            tpf.pair_ray_reduce_ref(*ops, any_hit=True)), name
    with pytest.raises(ValueError):                  # strided view refused
        tpf.pair_ray_reduce(ops[0], ops[1], ops[2].repeat(1, 2)[:, :3],
                            *ops[3:])
    with pytest.raises(ValueError):                  # host tensor among them
        tpf.pair_ray_reduce(*ops[:6], ops[6].cpu(), *ops[7:])
