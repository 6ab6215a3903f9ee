"""Compact cluster-BVH traversal of the PyTorch port vs tpu_pt.bvh.cluster
and vs the port's own brute-force oracle."""

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
from tpu_pt_torch.render import brute as tbrute

from torch_port_util import T, bvh_dict, rays, scene_dict


def _mesh_scene():
    v, f = jm.icosphere(subdiv=3)
    return jt.make_scene(v, f, np.zeros(len(f), np.int32),
                         jt.make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
                         jt.make_lights([]))


@pytest.fixture(scope="module")
def setups():
    """name -> (jax scene, jax bvh, port scene, port bvh); the port's
    containers are carried across by convert.py, so both sides hold the very
    same arrays."""
    out = {}
    for name, scene, kw in (
            ("cornell", jc.cornell("spheres"), {}),
            ("mesh", _mesh_scene(), dict(tile=32)),
            ("big", jm.big_scene(4), dict(tile=64)),
            ("big128", jm.big_scene(4), dict(tile=128)),
            ("deep", jm.big_scene(4), dict(tile=32, dense_start=8))):
        cb = jcl.build_cluster_bvh(scene, **kw)
        out[name] = (scene, cb,
                     convert.scene_from_numpy(scene_dict(scene), "cpu"),
                     convert.cluster_bvh_from_numpy(bvh_dict(cb), "cpu"))
    return out


def _bounds(n, t_max=1e30):
    return (np.zeros((n, 1), np.float32), np.full((n, 1), t_max, np.float32))


def test_compact_lanes_and_rank_equal():
    rs = np.random.RandomState(0)
    live = rs.rand(64, 200) < 0.3
    live[0] = False
    live[1] = True                                   # overflows every cap
    idx = rs.randint(0, 10**6, size=live.shape).astype(np.int32)
    np.testing.assert_array_equal(
        np.asarray(jcl._rank_inclusive(jnp.asarray(live))),
        tcl._rank_inclusive(T(live)).numpy())
    for cap in (1, 17, 64, 200, 500):
        a = jcl._compact_lanes(jnp.asarray(live), jnp.asarray(idx), cap)
        b = tcl._compact_lanes(T(live), T(idx).long(), cap)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())


def test_slab_soa_equal_with_axis_parallel_rays():
    """0 * inf = NaN on an axis-parallel ray at a slab boundary must map to
    "no constraint" in both; the hit masks and entry distances agree."""
    rs = np.random.RandomState(1)
    Q, N = 256, 40
    lo = rs.uniform(-2, 1, (N, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.1, 1.5, (N, 3)).astype(np.float32)
    lo[-1], hi[-1] = np.inf, -np.inf                  # an empty slot
    ro = rs.uniform(-3, 3, (Q, 3)).astype(np.float32)
    rd = rs.normal(size=(Q, 3)).astype(np.float32)
    rd[::4, 0] = 0.0                                  # axis-parallel
    ro[::8, 0] = lo[rs.randint(0, N - 1, size=len(ro[::8])), 0]  # on a boundary
    rd[1::16, 1] = -0.0
    with np.errstate(divide="ignore"):
        ri = (1.0 / rd).astype(np.float32)
    tmin, tmax = _bounds(Q)

    def run(mod, A):
        return mod._slab_soa(tuple(A(lo[None, :, i]) for i in range(3)),
                             tuple(A(hi[None, :, i]) for i in range(3)),
                             tuple(A(ro[:, i:i + 1]) for i in range(3)),
                             tuple(A(ri[:, i:i + 1]) for i in range(3)),
                             A(tmin), A(tmax))

    a = np.asarray(run(jcl, jnp.asarray))
    b = run(tcl, T).numpy()
    np.testing.assert_array_equal(a < 1e30, b < 1e30)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["big", "deep", "mesh"])
def test_descend_compact_and_flat_pairs_equal(setups, name):
    _, cj, _, ct = setups[name]
    Q = 1024
    ro, rd = rays(Q, 7)
    tmin, tmax = _bounds(Q)
    cjd = jax.tree.map(jnp.asarray, cj)
    c1, l1, o1 = jcl._descend_compact(cjd, jnp.asarray(ro),
                                      1.0 / jnp.asarray(rd),
                                      jnp.asarray(tmin), jnp.asarray(tmax))
    c2, l2, o2 = tcl._descend_compact(ct, T(ro), 1.0 / T(rd), T(tmin), T(tmax))
    np.testing.assert_array_equal(np.asarray(c1), c2.numpy())
    np.testing.assert_array_equal(np.asarray(l1), l2.numpy())
    np.testing.assert_array_equal(np.asarray(o1), o2.numpy())
    assert l2.any()
    # Budgets: ample, and one that truncates (drops and per-ray losses).
    n_live = int(l2.sum())
    for budget in (6 * Q, max(1, n_live // 2)):
        f1 = jcl._flat_pairs(c1, l1, Q, budget)
        f2 = tcl._flat_pairs(c2, l2, Q, budget)
        assert len(f1) == len(f2) == 6
        for x, y in zip(f1, f2):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert int(f2[2]) > 0 and int(f2[5].sum()) == int(f2[2])


def test_descend_collects_per_level_needs(setups):
    _, cj, _, ct = setups["deep"]
    ro, rd = rays(256, 3)
    tmin, tmax = _bounds(256)
    ca, cb = [], []
    jcl._descend_compact(jax.tree.map(jnp.asarray, cj), jnp.asarray(ro),
                         1.0 / jnp.asarray(rd), jnp.asarray(tmin),
                         jnp.asarray(tmax), collect=ca)
    tcl._descend_compact(ct, T(ro), 1.0 / T(rd), T(tmin), T(tmax), collect=cb)
    assert len(ca) == len(cb) == len(ct.levels)
    for (n1, t1), (n2, t2) in zip(ca, cb):
        np.testing.assert_array_equal(np.asarray(n1), n2.numpy())
        np.testing.assert_array_equal(np.asarray(t1), t2.numpy())


@pytest.mark.parametrize("name", ["cornell", "mesh", "big", "big128", "deep"])
def test_intersect_matches_jax_and_brute(setups, name):
    sj, cj, st, ct = setups[name]
    n = 1024
    ro, rd = rays(n, 7)
    tmin, tmax = _bounds(n)
    h_j = jcl.intersect(cj, sj, jnp.asarray(ro), jnp.asarray(rd),
                        jnp.asarray(tmin), jnp.asarray(tmax))
    h_t, ovf = tcl.intersect_counted(ct, st, T(ro), T(rd), T(tmin), T(tmax))
    assert int(ovf) == 0
    # Against the JAX traversal: same candidates, same pair test up to an
    # ulp of t (XLA fuses the multiply-adds).
    np.testing.assert_array_equal(np.asarray(h_j.hit), h_t.hit.numpy())
    np.testing.assert_allclose(h_t.t.numpy(), np.asarray(h_j.t), rtol=1e-6,
                               atol=1e-6)
    m = np.asarray(h_j.hit)[:, 0]
    t_same = (np.asarray(h_j.t) == h_t.t.numpy())[:, 0][m]
    prim_eq = (np.asarray(h_j.prim) == h_t.prim.numpy())[m]
    np.testing.assert_array_equal(prim_eq[t_same], True)
    assert prim_eq.mean() > 0.999
    assert h_t.prim.dtype == torch.int32 and h_t.t.shape == (n, 1)

    # Against the port's own dense oracle.
    h_ref = tbrute.intersect(st, T(ro), T(rd), T(tmin), T(tmax))
    assert torch.equal(h_ref.hit, h_t.hit)
    mt = h_ref.hit[:, 0]
    np.testing.assert_allclose(h_ref.t[mt].numpy(), h_t.t[mt].numpy(),
                               rtol=1e-5, atol=1e-6)
    t_same = (h_ref.t[:, 0] == h_t.t[:, 0])[mt]
    prim_eq = (h_ref.prim == h_t.prim)[mt]
    assert bool(prim_eq[t_same].all())
    assert float(prim_eq.float().mean()) > 0.999


@pytest.mark.parametrize("name", ["cornell", "mesh", "big", "big128", "deep"])
def test_occluded_matches_jax_and_brute(setups, name):
    sj, cj, st, ct = setups[name]
    n = 1024
    ro, rd = rays(n, 8)
    tmax = np.full((n, 1), 2.0, np.float32)
    o_j = jcl.occluded(cj, sj, jnp.asarray(ro), jnp.asarray(rd),
                       jnp.asarray(tmax))
    o_t, ovf = tcl.occluded_counted(ct, st, T(ro), T(rd), T(tmax))
    assert int(ovf) == 0 and o_t.shape == (n, 1) and o_t.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(o_j), o_t.numpy())
    assert torch.equal(tbrute.occluded(st, T(ro), T(rd), T(tmax)), o_t)
    # narrow=True only changes the pair budget; nothing truncates here.
    o_n, ovf_n = tcl.occluded_counted(ct, st, T(ro), T(rd), T(tmax),
                                      narrow=True)
    assert int(ovf_n) == 0 and torch.equal(o_n, o_t)
    # A scalar bound broadcasts like a (n, 1) column.
    assert torch.equal(tcl.occluded(ct, st, T(ro), T(rd), 2.0), o_t)


def test_dead_lanes_spawn_no_pairs(setups):
    """t_max < t_min marks a dead lane: a miss and no candidate pairs."""
    _, _, st, ct = setups["big"]
    ro, rd = rays(512, 4)
    tmin, tmax = _bounds(512)
    tmax[::2] = -1.0
    h = tcl.intersect(ct, st, T(ro), T(rd), T(tmin), T(tmax))
    assert not h.hit[::2].any() and h.hit[1::2].any()
    n_live, _ = tcl.compact_stats(ct, T(ro), T(rd), T(tmin), T(tmax))
    n_all, _ = tcl.compact_stats(ct, T(ro[1::2]), T(rd[1::2]), T(tmin[1::2]),
                                 T(tmax[1::2]))
    assert int(n_live) == int(n_all)


@pytest.mark.parametrize("name", ["cornell", "big", "deep"])
def test_compact_stats_equal(setups, name):
    _, cj, _, ct = setups[name]
    ro, rd = rays(1024, 9)
    tmin, tmax = _bounds(1024)
    a = jcl.compact_stats(cj, jnp.asarray(ro), jnp.asarray(rd),
                          jnp.asarray(tmin), jnp.asarray(tmax))
    b = tcl.compact_stats(ct, T(ro), T(rd), T(tmin), T(tmax))
    assert (int(a[0]), int(a[1])) == (int(b[0]), int(b[1]))
    assert int(b[1]) == 0


def test_overflow_counted_equal_out_of_contract(setups):
    """Caps too small for the scene: both packages report the same count."""
    sj, _, st, _ = setups["mesh"]
    n_lv = len(setups["mesh"][1].levels)
    cj = jcl.build_cluster_bvh(sj, tile=32, frontiers=(2,) * n_lv, k_leaf=2,
                               pair_mults=(1, 1, 1))
    ct = convert.cluster_bvh_from_numpy(bvh_dict(cj), "cpu")
    ro, rd = rays(512, 5)
    tmin, tmax = _bounds(512)
    _, ovf_j = jcl.intersect_counted(cj, sj, jnp.asarray(ro), jnp.asarray(rd),
                                     jnp.asarray(tmin), jnp.asarray(tmax))
    _, ovf_t = tcl.intersect_counted(ct, st, T(ro), T(rd), T(tmin), T(tmax))
    assert int(ovf_t) == int(ovf_j) > 0


def test_split_traversal_identical(setups, monkeypatch):
    """Sub-batch splitting is identical per ray to the unsplit traversal
    (every stage reduces per ray; nothing truncates on this scene)."""
    _, _, _, ct = setups["big"]
    Q = 2048
    ro, rd = (T(x) for x in rays(Q, 13))
    tmin, tmax = (T(x) for x in _bounds(Q))
    t2 = torch.full((Q, 1), 2.0)
    monkeypatch.setattr(tcl, "_split_batches", lambda Q, s: max(1, int(s)))
    monkeypatch.setattr(tcl, "SPLIT_CLOSEST", 1)
    monkeypatch.setattr(tcl, "SPLIT_ANYHIT", 1)
    base = tcl._traverse_compact(ct, ro, rd, tmin, tmax)
    occ0, novfo0 = tcl._traverse_compact_anyhit(ct, ro, rd, tmin, t2)
    assert int(base[4]) == 0 and int(novfo0) == 0
    for k in (2, 4):
        monkeypatch.setattr(tcl, "SPLIT_CLOSEST", k)
        monkeypatch.setattr(tcl, "SPLIT_ANYHIT", k)
        out = tcl._traverse_compact(ct, ro, rd, tmin, tmax)
        occ, novfo = tcl._traverse_compact_anyhit(ct, ro, rd, tmin, t2)
        assert int(out[4]) == 0 and int(novfo) == 0
        for a, b in zip(base[:4], out[:4]):
            assert a.shape == b.shape and torch.equal(a, b)
        assert torch.equal(occ0, occ)


def test_split_batches_keeps_sub_batches_wide():
    assert tcl._split_batches(4096, 4) == 4
    assert tcl._split_batches(2048, 4) == 2
    assert tcl._split_batches(1024, 4) == 1
    assert tcl._split_batches(4096 + 2, 4) == 2
    assert [jcl._split_batches(q, 4) for q in (4096, 2048, 1024, 3000)] == \
        [tcl._split_batches(q, 4) for q in (4096, 2048, 1024, 3000)]


def test_segmin_reduce_matches_sort_reduce(setups):
    """The per-ray segmented-min reduce (the kernel path) picks the same
    winner as its twin, the sort reduce, on the same pair list: lowest t,
    then lowest gid.  The any-hit reduce agrees with both on which rays
    hit."""
    _, _, st, ct = setups["big"]
    n = 2048
    ro, rd = (T(x) for x in rays(n, 29))
    tmin, tmax = (T(x) for x in _bounds(n))
    assert tcl._scan_supported(ct, n)
    cand, live, _ = tcl._descend_compact(ct, ro, 1.0 / rd, tmin, tmax)
    rayP, cidP, dropped, cnt, right, _ = tcl._flat_pairs(
        cand, live, n, ct.pair_mults[2] * n)
    assert int(dropped) == 0 and int((cnt == 0).sum()) > 0
    args = (ct, ro, rd, tmin[:, 0], tmax[:, 0], rayP, cidP, cnt, right)
    r_sort = tcl._reduce_pairs_closest(*args)
    r_scan = tcl._reduce_pairs_closest_scan(*args)
    assert bool((r_sort[0] < 1e30).any())
    for a, b in zip(r_sort, r_scan):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(tcl._reduce_pairs_anyhit_scan(*args), r_sort[0] < 1e30)
    # And the plain-version switch changes nothing on the CPU.
    h1 = tcl.intersect(ct, st, ro, rd, tmin, tmax)
    h2 = tcl.intersect(ct, st, ro, rd, tmin, tmax, use_kernels=False)
    for f in ("t", "hit", "prim", "u", "v"):
        assert torch.equal(getattr(h1, f), getattr(h2, f)), f


def test_f32_gather_tables_give_the_same_hits(setups, monkeypatch):
    """GATHER_BF16 only widens the candidate set (outward rounding); with the
    f32 tables the hits are the same."""
    _, _, st, ct = setups["deep"]
    ro, rd = (T(x) for x in rays(512, 31))
    tmin, tmax = (T(x) for x in _bounds(512))
    h16 = tcl.intersect(ct, st, ro, rd, tmin, tmax)
    monkeypatch.setattr(tcl, "GATHER_BF16", False)
    h32 = tcl.intersect(ct, st, ro, rd, tmin, tmax)
    for f in ("t", "hit", "prim", "u", "v"):
        assert torch.equal(getattr(h16, f), getattr(h32, f)), f


def test_build_rejects_wrong_number_of_frontier_caps():
    from tpu_pt_torch.scene import cornell as tc

    with pytest.raises(ValueError, match="frontier caps"):
        tcl.build_cluster_bvh(tc.cornell("spheres"), frontiers=(4, 4, 4))
