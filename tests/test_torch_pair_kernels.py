"""The two modules that hold CUDA kernels, on the CPU: their plain PyTorch
versions against the Pallas kernels they replace (interpret mode), and the
checked wrappers.  The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py (and by the ``gpu``-marked test below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.kernels import cluster_isect as jki
from tpu_pt.kernels import pair_scan as jps
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt_torch.core.intersect import INF
from tpu_pt_torch.kernels import cluster_isect as tki
from tpu_pt_torch.kernels import pair_scan as tps

from torch_port_util import T, hold_apart_to_witness, witness_lanes


# ---------------------------------------------------------------- K2 ------

def _tiles():
    """Real 128-lane tiles: the 5k-triangle mesh scene, the Cornell box with
    its two sphere primitives, an all-padding tile and a tile whose lanes 2
    and 5 hold the same triangle (two lanes with equal t)."""
    big = np.asarray(jcl.build_cluster_bvh(jm.big_scene(4)).tiles)
    corn = np.asarray(jcl.build_cluster_bvh(jc.cornell("spheres")).tiles)
    assert (corn[:, 9] > 0.5).any(), "expected sphere lanes"
    full = int(np.flatnonzero((np.abs(big).sum(1) > 0).sum(1) >= 8)[0])
    dup = big[full:full + 1].copy()
    dup[0, :, 5] = dup[0, :, 2]
    pad = np.zeros_like(big[0:1])
    tiles = np.concatenate([big, corn, pad, dup]).astype(np.float32)
    return tiles, dict(corn0=len(big), pad=len(big) + len(corn),
                       dup=len(big) + len(corn) + 1)


def _aimed_rays(tiles, cid, seed, aim_lane=None):
    """(P, 16) ray rows aimed at a real primitive of each pair's tile, so that
    most pairs hit; every 7th pair dead, some with a short t_max."""
    rs = np.random.RandomState(seed)
    P = len(cid)
    n_real = np.maximum((np.abs(tiles[cid]).sum(1) > 0).sum(1), 1)
    lane = (rs.rand(P) * n_real).astype(np.int64)
    if aim_lane is not None:
        lane = np.where(aim_lane >= 0, aim_lane, lane)
    tl = tiles[cid, :, lane]                                   # (P, 12)
    is_sph = tl[:, 9] > 0.5
    target = np.where(is_sph[:, None], tl[:, 0:3],
                      tl[:, 0:3] + (tl[:, 3:6] + tl[:, 6:9]) / 3.0)
    ro = (target + rs.normal(size=(P, 3)) * 2.0).astype(np.float32)
    rd = target - ro + rs.normal(size=(P, 3)) * 0.01
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    rays = np.zeros((P, 16), np.float32)
    rays[:, 0:3], rays[:, 3:6] = ro, rd
    rays[:, 7] = np.where(rs.rand(P) < 0.1, 1.0, 1e30)         # t_max
    rays[:, 8] = (np.arange(P) % 7 != 0).astype(np.float32)    # live
    return rays


def _compare_k2(tiles, cid, rays):
    out_j = np.asarray(jki.pair_tile_isect(
        jnp.asarray(tiles), jnp.asarray(cid), jnp.asarray(rays)))
    out_t = tki.pair_tile_isect(T(tiles), T(cid), T(rays)).numpy()
    assert out_t.shape == out_j.shape == (len(cid), 8)
    # Pairs where the JAX package's sphere solve parts from the port's are
    # held to the float64 witness of the pair's tile instead.
    apart = ~np.isclose(out_t[:, 0], out_j[:, 0], rtol=1e-6, atol=1e-6)
    t_w = np.where(rays[:, 8] > 0, witness_lanes(
        tiles[cid], rays[:, 0:3], rays[:, 3:6], rays[:, 6],
        rays[:, 7]).min(1), np.inf)
    n, _ = hold_apart_to_witness(apart, out_t[:, 0], out_j[:, 0], t_w)
    assert n <= len(cid) // 50
    hit_j, hit_t = out_j[:, 0] < INF, out_t[:, 0] < INF
    np.testing.assert_array_equal(hit_j[~apart], hit_t[~apart])
    # One ulp apart at most (operation fusion differs), as between the Pallas
    # kernel and XLA's gather path.
    np.testing.assert_allclose(out_t[~apart, 0], out_j[~apart, 0], rtol=1e-6,
                               atol=1e-6)
    t_same = (out_j[:, 0] == out_t[:, 0]) & hit_j
    np.testing.assert_array_equal(out_j[t_same, 1], out_t[t_same, 1])
    if hit_j.any():
        assert (out_j[hit_j, 1] == out_t[hit_j, 1]).mean() > 0.99
    same = hit_j & (out_j[:, 1] == out_t[:, 1])
    # u, v = dot(tvec, pvec) / det cancel against small edges from origins a
    # few units away: the ulp of t shows two digits earlier in them.
    np.testing.assert_allclose(out_t[same, 2:4], out_j[same, 2:4], atol=1e-4)
    # Misses and dead pairs: t = INF, u = v = 0; pad columns always 0.
    assert (out_t[~hit_t, 0] == np.float32(INF)).all()
    assert (out_t[~hit_t, 2:4] == 0).all() and (out_t[:, 4:] == 0).all()
    return out_t, hit_t


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_tile_isect_ref_matches_pallas_real_tiles(seed):
    tiles, _ = _tiles()
    rs = np.random.RandomState(100 + seed)
    cid = rs.randint(0, len(tiles), size=512).astype(np.int32)
    rays = _aimed_rays(tiles, cid, seed)
    out, hit = _compare_k2(tiles, cid, rays)
    assert hit.sum() > 200
    assert not hit[rays[:, 8] == 0].any()          # dead pairs never hit


def test_pair_tile_isect_ref_sphere_padding_and_tie_tiles():
    tiles, at = _tiles()
    cid = np.repeat(np.array([at["corn0"], at["corn0"] + 1, at["pad"],
                              at["dup"]], np.int32), 64)       # P = 256
    # Half of the duplicated tile's rays aim at lane 5, the copy of lane 2.
    aim = np.where(cid == at["dup"], np.where(np.arange(256) % 2, 5, 2), -1)
    rays = _aimed_rays(tiles, cid, 5, aim_lane=aim)
    rays[:, 7], rays[:, 8] = 1e30, 1.0
    out, hit = _compare_k2(tiles, cid, rays)
    assert not hit[cid == at["pad"]].any()          # all-padding tile: miss
    # Sphere lanes report u = v = 0.
    lane = out[:, 1].astype(np.int64)
    sph = hit & (tiles[cid, 9, lane] > 0.5)
    assert sph.sum() > 0 and (out[sph, 2:4] == 0).all()
    # Equal t on lanes 2 and 5 of the duplicated tile: the lower lane wins.
    dup_hit = hit & (cid == at["dup"])
    assert dup_hit.sum() > 0 and not (out[dup_hit, 1] == 5).any()
    assert (out[dup_hit, 1] == 2).sum() > 32


@pytest.mark.parametrize("L", [32, 64])
def test_pair_tile_isect_ref_narrow_tiles_match_dense_test(L):
    """Tile widths the Pallas kernel does not take: the plain version against
    the JAX package's dense gather path (_prim_tile_test + argmin)."""
    cb = jcl.build_cluster_bvh(jm.big_scene(4), tile=L)
    tiles = np.asarray(cb.tiles)
    rs = np.random.RandomState(L)
    cid = rs.randint(0, len(tiles), size=256).astype(np.int32)
    rays = _aimed_rays(tiles, cid, L)
    t_l, u_l, v_l = jcl._prim_tile_test(
        jnp.asarray(tiles)[cid], jnp.asarray(rays[:, 0:3]),
        jnp.asarray(rays[:, 3:6]), jnp.asarray(rays[:, 6:7]),
        jnp.asarray(rays[:, 7:8]))
    # The port's dense test is the same arithmetic as its pair kernel.
    from tpu_pt_torch.bvh.cluster import _prim_tile_test

    t_p, u_p, v_p = _prim_tile_test(T(tiles)[T(cid).long()], T(rays[:, 0:3]),
                                    T(rays[:, 3:6]), T(rays[:, 6:7]),
                                    T(rays[:, 7:8]))
    # Lanes where the JAX package's sphere solve parts from the port's are
    # held to the float64 witness instead; the pair kernel's plain version
    # is then the port's dense test's minimum, bit for bit.
    t_l, t_p = np.asarray(t_l), t_p.numpy()
    apart = ~np.isclose(t_p, t_l, rtol=1e-6, atol=1e-6)
    n, _ = hold_apart_to_witness(apart, t_p, t_l, witness_lanes(
        tiles[cid], rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7]))
    assert n <= apart.size // 1000
    np.testing.assert_array_equal((t_l < INF)[~apart], (t_p < INF)[~apart])
    np.testing.assert_allclose(t_p[~apart], t_l[~apart], rtol=1e-6, atol=1e-6)
    t_l = np.where(rays[:, 8:9] > 0, t_l, np.float32(INF))
    out = tki.pair_tile_isect(T(tiles), T(cid), T(rays)).numpy()
    t_p = np.where(rays[:, 8:9] > 0, t_p, np.float32(INF))
    np.testing.assert_array_equal(out[:, 0], t_p.min(1))
    np.testing.assert_array_equal(t_l.min(1)[~apart.any(1)] < INF,
                                  out[~apart.any(1), 0] < INF)
    np.testing.assert_allclose(out[~apart.any(1), 0],
                               t_l.min(1)[~apart.any(1)], rtol=1e-6,
                               atol=1e-6)
    same_t = (out[:, 0] == t_l.min(1)) & (out[:, 0] < INF)
    np.testing.assert_array_equal(out[same_t, 1], t_l.argmin(1)[same_t])


def test_pair_tile_isect_rejects_bad_shapes():
    tiles, _ = _tiles()
    t = T(tiles)
    rays = torch.zeros((128, 16))
    cid = torch.zeros((128,), dtype=torch.int32)
    with pytest.raises(ValueError):
        tki.pair_tile_isect(t, cid[:100], rays[:100])      # P % 128 != 0
    with pytest.raises(ValueError):
        tki.pair_tile_isect(t, cid, rays[:, :8])           # ray rows too short
    with pytest.raises(ValueError):
        tki.pair_tile_isect(t[:, :10], cid, rays)          # tile rows != 12


def test_checked_pair_kernel_passes_and_catches_poison():
    """The checks of the JAX package's sanitizer test, as plain assertions
    that raise: healthy tiles pass, NaN-poisoned tiles and out-of-range
    cluster ids fire, and the output contract catches a forged output."""
    tiles = T(np.asarray(jcl.build_cluster_bvh(jc.cornell("spheres")).tiles))
    P = 2 * tki.B
    rs = np.random.RandomState(5)
    rays = torch.zeros((P, 16))
    rays[:, 0:3] = T(rs.uniform(-3, 3, (P, 3)).astype(np.float32))
    rd = rs.normal(size=(P, 3))
    rays[:, 3:6] = T((rd / np.linalg.norm(rd, axis=1, keepdims=True))
                     .astype(np.float32))
    rays[:, 7], rays[:, 8] = 1e30, 1.0
    cid = torch.zeros((P,), dtype=torch.int32)

    out = tki.pair_tile_isect_checked(tiles, cid, rays)
    assert out.shape == (P, 8)

    poisoned = tiles.clone()
    poisoned[0, 0:9, :] = float("nan")
    with pytest.raises(AssertionError, match="non-finite tile geometry"):
        tki.pair_tile_isect_checked(poisoned, cid, rays)
    with pytest.raises(AssertionError, match="cluster id out of range"):
        tki.pair_tile_isect_checked(tiles, cid + tiles.shape[0], rays)

    forged = out.clone()
    forged[0, 0], forged[0, 1] = 1.0, 200.0
    with pytest.raises(AssertionError, match="lane index out of range"):
        tki.check_pair_out(forged, rays)
    dead = rays.clone()
    dead[:, 8] = 0.0
    hit_row = int(torch.nonzero(out[:, 0] < INF)[0])
    with pytest.raises(AssertionError, match="dead pair reported a hit"):
        tki.check_pair_out(out, dead)
    short = rays.clone()
    short[hit_row, 7] = float(out[hit_row, 0]) * 0.5
    with pytest.raises(AssertionError, match="outside the query range"):
        tki.check_pair_out(out, short)


# ---------------------------------------------------------------- K1 ------

def _scan_reference(t, gid, u, v, cnt, right):
    """pair_segmin_scan(f)[:, right - 1] with the field rows and the pad
    columns the JAX traversal builds."""
    P = len(t)
    ray = np.repeat(np.arange(len(cnt)), cnt).astype(np.float32)
    ray = np.concatenate([ray, np.full(P - len(ray), len(cnt), np.float32)])
    z = np.zeros(P, np.float32)
    f = np.stack([t, gid.astype(np.float32), u, v, ray, z, z, z])
    pad = (-P) % jps.B
    if pad:
        padcol = np.zeros((8, pad), np.float32)
        padcol[0], padcol[4] = INF, -2.0
        f = np.concatenate([f, padcol], axis=1)
    scanned = np.asarray(jps.pair_segmin_scan(jnp.asarray(f)))
    idx = np.clip(right - 1, 0, P + pad - 1)
    return scanned[:, idx]


def _segments(seed, Q, max_cnt, tail=0):
    rs = np.random.RandomState(seed)
    cnt = rs.randint(0, max_cnt + 1, size=Q).astype(np.int32)
    cnt[::5] = 0                                   # empty rays
    right = np.cumsum(cnt).astype(np.int32)
    P = int(right[-1]) + tail                      # tail: unowned dead pairs
    # Few distinct t values: many exact ties, broken by gid.
    t = rs.choice(np.array([0.25, 0.5, 1.0, 2.0, INF], np.float32), size=P)
    gid = rs.randint(0, 1 << 20, size=P).astype(np.int32)
    u = rs.rand(P).astype(np.float32)
    v = rs.rand(P).astype(np.float32)
    return t, gid, u, v, cnt, right


def _assert_segmin_bitwise(t, gid, u, v, cnt, right):
    ref = _scan_reference(t, gid, u, v, cnt, right)
    got = tps.pair_segmin(T(t), T(gid), T(u), T(v), T(cnt), T(right))
    has = cnt > 0
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(ref[0][has].view(np.int32),
                                  got[0].numpy()[has].view(np.int32))
    np.testing.assert_array_equal(ref[1][has].astype(np.int32),
                                  got[1].numpy()[has])
    np.testing.assert_array_equal(ref[2][has], got[2].numpy()[has])
    np.testing.assert_array_equal(ref[3][has], got[3].numpy()[has])
    # Rays without pairs: (INF, 0, 0, 0).
    assert (got[0].numpy()[~has] == np.float32(INF)).all()
    for k in (1, 2, 3):
        assert (got[k].numpy()[~has] == 0).all()
    return got


@pytest.mark.parametrize("seed,Q,max_cnt,tail", [
    (0, 700, 8, 0),        # ~2.4k pairs: segments cross the 1024-pair blocks
    (1, 300, 30, 100),     # long segments + a dead tail + pad columns
    (2, 1024, 6, 0),
    (3, 64, 200, 7),       # segments longer than a whole block row
])
def test_pair_segmin_ref_matches_scan_segment_ends(seed, Q, max_cnt, tail):
    t, gid, u, v, cnt, right = _segments(seed, Q, max_cnt, tail)
    assert len(t) > jps.B or Q <= 64
    _assert_segmin_bitwise(t, gid, u, v, cnt, right)


def test_pair_segmin_tie_in_t_broken_by_gid():
    t = np.array([1.0, 1.0, 1.0, 2.0, 0.5, 0.5], np.float32)
    gid = np.array([9, 3, 7, 1, 8, 8], np.int32)
    u = np.arange(6, dtype=np.float32)
    v = u + 10
    cnt = np.array([4, 0, 2], np.int32)
    right = np.cumsum(cnt).astype(np.int32)
    got = _assert_segmin_bitwise(t, gid, u, v, cnt, right)
    assert got[1].tolist() == [3, 0, 8]
    assert got[2].tolist() == [1.0, 0.0, 4.0]      # first of two equal pairs


def test_pair_segmin_any_hit_form():
    """gid = 0 for every pair and only t < INF is read."""
    t, gid, u, v, cnt, right = _segments(4, 500, 9)
    z = np.zeros_like(t)
    ref = _scan_reference(t, np.zeros_like(gid), z, z, cnt, right)
    got = tps.pair_segmin(T(t), T(np.zeros_like(gid)), T(z), T(z), T(cnt),
                          T(right))[0].numpy()
    has = cnt > 0
    np.testing.assert_array_equal((ref[0] < INF) & has, (got < INF) & has)


def test_pair_segmin_nan_heading_a_segment_is_kept():
    """Documented NaN behaviour: no later element compares below a NaN, so
    a NaN t that heads a segment stays the segment's answer, in the scan
    and in the per-ray reduce alike."""
    t, gid, u, v, cnt, right = _segments(6, 200, 8)
    q = int(np.flatnonzero(cnt >= 3)[0])
    t[right[q] - cnt[q]] = np.nan
    got = _assert_segmin_bitwise(t, gid, u, v, cnt, right)
    assert np.isnan(got[0].numpy()[q])


def test_pair_segmin_int32_gid_beyond_float_range():
    """gid rides as int32: ids above 2^24 (not exact in f32) keep their
    low bits and still break ties."""
    t = np.array([1.0, 1.0], np.float32)
    gid = np.array([(1 << 24) + 3, (1 << 24) + 1], np.int32)
    z = np.zeros(2, np.float32)
    got = tps.pair_segmin(T(t), T(gid), T(z), T(z), T(np.array([2], np.int32)),
                          T(np.array([2], np.int32)))
    assert int(got[1][0]) == (1 << 24) + 1


def test_pair_segmin_rejects_bad_shapes():
    z = torch.zeros(8)
    zi = torch.zeros(8, dtype=torch.int32)
    c = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError):
        tps.pair_segmin(z, zi[:4], z, z, c, c)
    with pytest.raises(ValueError):
        tps.pair_segmin(z, zi, z, z, c, c[:2])


# ------------------------------------------------------ dispatch / card ---

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    tiles, _ = _tiles()
    cid = np.zeros(128, np.int32)
    rays = _aimed_rays(tiles, cid, 0)
    n2, n1 = tki.pair_tile_isect.launches, tps.pair_segmin.launches
    a = tki.pair_tile_isect(T(tiles), T(cid), T(rays))
    b = tki.pair_tile_isect_ref(T(tiles), T(cid), T(rays))
    assert torch.equal(a, b)
    t, gid, u, v, cnt, right = _segments(0, 50, 5)
    x = tps.pair_segmin(T(t), T(gid), T(u), T(v), T(cnt), T(right))
    y = tps.pair_segmin_ref(T(t), T(gid), T(u), T(v), T(cnt), T(right))
    assert all(torch.equal(p, q) for p, q in zip(x, y))
    assert (tki.pair_tile_isect.launches, tps.pair_segmin.launches) == (n2, n1)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_on_the_card():
    """Needs an NVIDIA GPU and nvcc: both kernels bit for bit against their
    plain versions (the library is compiled with -fmad=false)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tiles, _ = _tiles()
    rs = np.random.RandomState(0)
    cid = rs.randint(0, len(tiles), size=1024).astype(np.int32)
    rays = _aimed_rays(tiles, cid, 0)
    dt, dc, dr = (T(x).cuda() for x in (tiles, cid, rays))
    assert torch.equal(tki.pair_tile_isect(dt, dc, dr),
                       tki.pair_tile_isect_ref(dt, dc, dr))
    args = [T(x).cuda() for x in _segments(1, 300, 70)]
    for p, q in zip(tps.pair_segmin(*args), tps.pair_segmin_ref(*args)):
        assert torch.equal(p, q)
    wide = torch.zeros((1024, 32), device="cuda")
    with pytest.raises(ValueError):                  # strided view refused
        tki.pair_tile_isect(dt, dc, wide[:, :16])
