"""The cluster BVH's other traversal modes (``ClusterBVH.traversal_mode``
"frontier" and "pairs", the JAX package's ``TRAVERSAL_MODE``:
tpu_pt_torch.bvh.cluster against tpu_pt.bvh.cluster), their capacity
tooling (``candidate_stats``, ``pairs_stats``), the segmented minimum
``_seg_min``, and whole-step lane slicing (``wavefront_accum``'s
``step_slices``, the JAX package's ``STEP_SLICES``).

Tolerances: hit mask, occlusion, overflow counts and the stats exact; t
rtol 1e-6 (XLA fuses the tile test's multiply-adds, torch does not), prim
exact where t is equal and agreement > 0.99 (tests/test_cluster.py); inside
the port the three modes select (t, lowest gid) from the same tile test,
so they agree bit for bit; images rtol 2e-4 / atol 2e-5 against the JAX
package.  Both modes run both ray-major pair stages ("fused": every pair
batch through ``pair_ray_reduce``; "split": through ``pair_tile_isect`` and
array code), held to the JAX package alike and to each other bit for bit,
round for round."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.render import wavefront as jwf
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt.scene import types as jt
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.kernels import cluster_isect as tki
from tpu_pt_torch.kernels import pair_fused as tpf
from tpu_pt_torch.render import brute as tbrute
from tpu_pt_torch.render import driver as tdriver
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc

from torch_port_util import T, bvh_dict, rays, scene_dict

MODES = ("frontier", "pairs")
STAGES = ("fused", "split")
HIT_FIELDS = ("hit", "t", "prim", "u", "v")


def _starved(sj):
    """big_scene(4) at tile 32 under a 4-level pyramid, its frontier caps
    cut to a quarter and every pair budget to one pair a ray: both modes
    truncate."""
    deep = jcl.build_cluster_bvh(sj, tile=32, dense_start=8)
    return jcl.build_cluster_bvh(
        sj, tile=32, dense_start=8, k_leaf=max(2, deep.k_leaf // 4),
        frontiers=tuple(max(2, c // 4) for c in deep.frontiers),
        pair_mults=(1, 1, 1))


@pytest.fixture(scope="module")
def setups():
    """name -> (JAX scene, JAX ClusterBVH, port scene, port ClusterBVH):
    the Cornell spheres and mesh and big_scene(5) at the default build (one
    level each), big_scene(4) under a deep pyramid (every level of both
    descents) and starved (truncating)."""
    big4 = jm.big_scene(4)
    out = {}
    for name, sj, cj in (
            ("cornell", jc.cornell("spheres"), None),
            ("mesh", jc.cornell("mesh"), None),
            ("big", jm.big_scene(5), None),
            ("deep", big4, jcl.build_cluster_bvh(big4, tile=32,
                                                 dense_start=8)),
            ("starved", big4, _starved(big4))):
        cj = cj if cj is not None else jcl.build_cluster_bvh(sj)
        out[name] = (sj, cj, convert.scene_from_numpy(scene_dict(sj), "cpu"),
                     convert.cluster_bvh_from_numpy(bvh_dict(cj), "cpu"))
    return out


def _bounds(n, t_max=1e30):
    return np.zeros((n, 1), np.float32), np.full((n, 1), t_max, np.float32)


_JAX_RUNS = {}


def _jax_mode(cj, mode, ro, rd, t_min, t_max, t_occ):
    """The JAX package's counted closest hit and occlusion under ``mode``,
    one jitted call (the mode is read while it traces)."""
    old = jcl.TRAVERSAL_MODE
    jcl.TRAVERSAL_MODE = mode
    try:
        return jax.jit(lambda cb, *a: (
            jcl.intersect_counted(cb, None, *a[:4]),
            jcl.occluded_counted(cb, None, a[0], a[1], a[4])))(
            jax.tree.map(jnp.asarray, cj),
            *(jnp.asarray(x) for x in (ro, rd, t_min, t_max, t_occ)))
    finally:
        jcl.TRAVERSAL_MODE = old


def _port_mode(ct, st, mode, ro, rd, t_min, t_max, t_occ, **kw):
    ct = ct._replace(traversal_mode=mode)
    return (tcl.intersect_counted(ct, st, T(ro), T(rd), T(t_min), T(t_max),
                                  **kw),
            tcl.occluded_counted(ct, st, T(ro), T(rd), T(t_occ), **kw))


@pytest.mark.parametrize("pair_stage", STAGES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["cornell", "mesh", "big", "starved"])
def test_mode_matches_jax(setups, name, mode, pair_stage):
    sj, cj, st, ct = setups[name]
    n = 1024
    ro, rd = rays(n, 7)
    t_min, t_max = _bounds(n)
    t_occ = np.full((n, 1), 2.0, np.float32)
    if (name, mode) not in _JAX_RUNS:       # one JAX compile for both stages
        _JAX_RUNS[name, mode] = _jax_mode(cj, mode, ro, rd, t_min, t_max,
                                          t_occ)
    (h_j, ovf_j), (o_j, ovf_oj) = _JAX_RUNS[name, mode]
    (h_t, ovf_t), (o_t, ovf_ot) = _port_mode(ct, st, mode, ro, rd, t_min,
                                             t_max, t_occ,
                                             pair_stage=pair_stage)
    assert (int(ovf_t), int(ovf_ot)) == (int(ovf_j), int(ovf_oj))
    if name == "starved":
        assert int(ovf_t) > 0 or mode == "pairs"
    np.testing.assert_array_equal(h_t.hit.numpy(), np.asarray(h_j.hit))
    np.testing.assert_allclose(h_t.t.numpy(), np.asarray(h_j.t), rtol=1e-6)
    m = np.asarray(h_j.hit)[:, 0]
    assert m.sum() > n // 10
    t_same = (np.asarray(h_j.t) == h_t.t.numpy())[:, 0][m]
    prim_eq = (np.asarray(h_j.prim) == h_t.prim.numpy())[m]
    np.testing.assert_array_equal(prim_eq[t_same], True)
    assert prim_eq.mean() > 0.99
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    assert h_t.prim.dtype == torch.int32 and o_t.shape == (n, 1)


@pytest.mark.parametrize("name", ["big", "starved"])
def test_stats_equal_jax(setups, name):
    """candidate_stats (per ray) and pairs_stats, exactly, on rays from
    inside the scene, where the starved build cuts at every budget."""
    _, cj, _, ct = setups[name]
    ro, rd = rays(2048, 10)
    ro = ro * np.float32(0.3)
    t_min, t_max = _bounds(2048)
    a = jax.jit(lambda cb, *x: (jcl.candidate_stats(cb, x[0], x[1], x[2][:, 0],
                                                   x[3][:, 0]),
                               jcl.pairs_stats(cb, *x)))(
        jax.tree.map(jnp.asarray, cj),
        *(jnp.asarray(x) for x in (ro, rd, t_min, t_max)))
    b = (tcl.candidate_stats(ct, T(ro), T(rd), T(t_min[:, 0]),
                             T(t_max[:, 0])),
         tcl.pairs_stats(ct, T(ro), T(rd), T(t_min), T(t_max)))
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    assert [int(x) for x in a[1]] == [int(x) for x in b[1]]
    assert int(b[1][0]) > 0
    if name == "starved":
        assert int(b[1][1]) > 0 and int(b[0][1].sum()) > 0
    # The per-level loads of the pair-major descent add up to its totals.
    col = []
    rayP, _, dropped = tcl._descend_pairs(ct, T(ro), 1.0 / T(rd),
                                          T(t_min[:, 0]), T(t_max[:, 0]),
                                          collect=col)
    assert len(col) == len(ct.levels)
    assert sum(int(d) for _, d in col) == int(dropped) == int(b[1][1])
    assert int(col[-1][0]) - int(col[-1][1]) == int((rayP < 2048).sum())
    # (Q, 1) bounds give the same stats as (Q,) bounds.
    for x, y in zip(b[0], tcl.candidate_stats(ct, T(ro), T(rd), T(t_min),
                                              T(t_max))):
        assert torch.equal(x, y)


@pytest.mark.parametrize("with_gid", [True, False])
def test_seg_min_matches_jax(with_gid):
    """Random segments, t drawn from a few values (ties; -0 beside +0), gids
    with ties, NaN at the head of some segments: the running minimum and
    its position, exactly."""
    rs = np.random.RandomState(3)
    n = 2000
    t = rs.choice(np.array([0.0, -0.0, 0.5, 1.0, 2.0, 1e30], np.float32), n)
    t[rs.rand(n) < 0.3] = rs.rand(int((rs.rand(n) < 0.3).sum()) or 1)[0]
    gid = rs.randint(0, 20, n).astype(np.int32)
    seg_start = rs.rand(n) < 0.1
    seg_start[0] = True
    heads = np.flatnonzero(seg_start)
    t[heads[rs.rand(len(heads)) < 0.3]] = np.nan
    g = (jnp.asarray(gid), T(gid)) if with_gid else (None, None)
    mt_j, mi_j = jax.jit(jcl._seg_min)(jnp.asarray(t), jnp.asarray(seg_start),
                                       g[0])
    mt_t, mi_t = tcl._seg_min(T(t), T(seg_start), g[1])
    np.testing.assert_array_equal(mi_t.numpy(), np.asarray(mi_j))
    np.testing.assert_array_equal(mt_t.numpy().view(np.int32),
                                  np.asarray(mt_j).view(np.int32))
    assert np.isnan(mt_t.numpy()).any()


def _coincident_scene():
    """tests/test_tiebreak.py's scene: three identical quads stacked at z = 0
    and an offset quad behind them."""
    verts, tris = [], []
    for c in range(3):
        b = len(verts)
        verts += [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)]
        tris += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    b = len(verts)
    verts += [(-2, -2, -1), (2, -2, -1), (2, 2, -1), (-2, 2, -1)]
    tris += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
    return jt.make_scene(np.asarray(verts, np.float32),
                         np.asarray(tris, np.int32),
                         np.zeros(len(tris), np.int32),
                         jt.make_materials([dict(kind=jt.MAT_DIFFUSE)]),
                         jt.make_lights([]))


@pytest.mark.parametrize("pair_stage", STAGES)
@pytest.mark.parametrize("mode", ("compact",) + MODES)
def test_tiebreak_in_every_mode(mode, pair_stage):
    """tests/test_tiebreak.py::test_cluster_tiebreak in the port: every ray
    hits the three coincident copies at one t; each mode returns the
    lowest primitive id, brute force's hit, prim and t bit for bit."""
    sj = _coincident_scene()
    st = convert.scene_from_numpy(scene_dict(sj), "cpu")
    ct = convert.cluster_bvh_from_numpy(bvh_dict(jcl.build_cluster_bvh(sj)),
                                        "cpu")
    rs = np.random.RandomState(0)
    ro = np.stack([rs.uniform(-0.9, 0.9, 64), rs.uniform(-0.9, 0.9, 64),
                   np.full(64, 3.0)], 1).astype(np.float32)
    rd = np.tile(np.float32([[0, 0, -1]]), (64, 1))
    t_min, t_max = (T(x) for x in _bounds(64))
    ref = tbrute.intersect(st, T(ro), T(rd), t_min, t_max)
    assert bool(ref.hit.all()) and set(ref.prim.tolist()) <= {0, 1}
    got = tcl.intersect(ct._replace(traversal_mode=mode), st, T(ro), T(rd),
                        t_min, t_max, pair_stage=pair_stage)
    for f in ("hit", "prim", "t"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f


@pytest.mark.parametrize("pair_stage", STAGES)
@pytest.mark.parametrize("name", ["mesh", "deep"])
def test_modes_agree_bitwise_in_the_port(setups, name, pair_stage):
    """At overflow 0 the three modes keep the same (t, lowest gid) of the
    same tile test: hit, t, prim, u and v (where hit) and occlusion bit for
    bit; the compact mode in its default stage, the other two in
    ``pair_stage``."""
    _, _, st, ct = setups[name]
    n = 512
    ro, rd = rays(n, 17)
    t_min, t_max = _bounds(n)
    t_occ = np.full((n, 1), 2.0, np.float32)
    out = {m: _port_mode(ct, st, m, ro, rd, t_min, t_max, t_occ,
                         **({} if m == "compact" else
                            {"pair_stage": pair_stage}))
           for m in ("compact",) + MODES}
    (h_c, ovf), (o_c, ovf_o) = out["compact"]
    assert int(ovf) == int(ovf_o) == 0
    m = h_c.hit[:, 0]
    for mode in MODES:
        (h, ovf), (o, ovf_o) = out[mode]
        assert int(ovf) == int(ovf_o) == 0
        assert torch.equal(h.hit, h_c.hit) and torch.equal(h.t, h_c.t), mode
        for f in ("prim", "u", "v"):
            assert torch.equal(getattr(h, f)[m], getattr(h_c, f)[m]), (mode, f)
        assert torch.equal(o, o_c), mode


@pytest.mark.parametrize("pair_stage", STAGES)
def test_each_pair_stage_launches_its_own_kernel(setups, monkeypatch,
                                                 pair_stage):
    """In both modes every pair batch goes through ``pair_ray_reduce``
    under "fused" and never through ``pair_tile_isect``, and the reverse
    under "split" (the wrappers' plain versions on the CPU)."""
    _, _, st, ct = setups["deep"]
    ro, rd = rays(256, 5)
    t_min, t_max = _bounds(256)
    calls = {"pair_tile_isect": 0, "pair_ray_reduce": 0}
    for mod, name in ((tki, "pair_tile_isect"), (tpf, "pair_ray_reduce")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(tcl, name, spy)
    for mode in MODES:
        _port_mode(ct, st, mode, ro, rd, t_min, t_max, t_max,
                   pair_stage=pair_stage)
    used, unused = ("pair_ray_reduce", "pair_tile_isect")[::(
        1 if pair_stage == "fused" else -1)]
    assert calls[used] >= 4 and calls[unused] == 0, calls


def test_other_pair_stages_and_unknown_modes_raise(setups):
    _, _, st, cb = setups["mesh"]
    ro, rd = (T(x) for x in rays(64, 2))
    t_min, t_max = (T(x) for x in _bounds(64))
    for mode in MODES:
        ct = cb._replace(traversal_mode=mode)
        with pytest.raises(ValueError, match="no pair_stage 'dedup'"):
            tcl.intersect_counted(ct, st, ro, rd, t_min, t_max,
                                  pair_stage="dedup")
        with pytest.raises(ValueError, match="no pair_stage 'dedup'"):
            tcl.occluded_counted(ct, st, ro, rd, t_max, pair_stage="dedup")
        with pytest.raises(ValueError, match="unknown pair_stage"):
            tcl.intersect(ct, st, ro, rd, t_min, t_max, pair_stage="both")
    with pytest.raises(ValueError, match="unknown traversal_mode"):
        tcl.intersect(cb._replace(traversal_mode="Frontier"), st, ro, rd,
                      t_min, t_max)


def _soup(n=4096, size=0.03, seed=0):
    """``n`` small triangles scattered through [-1, 1]^3: a ray inside
    crosses many overlapping cluster boxes and hits few triangles, so the
    frontier walk needs several feedback rounds."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(-1, 1, (n, 1, 3))
    v = (c + rs.normal(scale=size, size=(n, 3, 3))).reshape(-1, 3)
    return jt.make_scene(v.astype(np.float32),
                         np.arange(3 * n, dtype=np.int32).reshape(n, 3),
                         np.zeros(n, np.int32),
                         jt.make_materials([dict(kind=jt.MAT_DIFFUSE)]),
                         jt.make_lights([]))


@pytest.fixture(scope="module")
def stage_cases(setups):
    """name -> (port scene, port ClusterBVH, rays scale): "soup" (a 4-level
    pyramid at a pair budget of 2: rays with 0, 1, 2 and more candidates,
    three and more feedback rounds), "unsorted" (the Cornell mesh's one
    level under a cap as wide as the level, so ``_descend`` leaves the
    candidates unsorted and round 1 compacts them) and "starved" (both
    modes truncate)."""
    sj = _soup()
    soup = convert.cluster_bvh_from_numpy(
        bvh_dict(jcl.build_cluster_bvh(sj, tile=32, dense_start=8)), "cpu")
    _, _, st_m, ct_m = setups["mesh"]
    _, _, st_s, ct_s = setups["starved"]
    n0 = ct_m.levels[0].shape[0]
    return {"soup": (convert.scene_from_numpy(scene_dict(sj), "cpu"),
                     soup._replace(pair_budget=2), 0.5),
            "unsorted": (st_m, ct_m._replace(frontiers=(n0,), k_leaf=n0),
                         1.0),
            "starved": (st_s, ct_s, 0.3)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["soup", "unsorted", "starved"])
def test_stages_agree_bitwise_round_for_round(stage_cases, monkeypatch,
                                              name, mode):
    """"fused" and "split" in both modes: hit, t, u, v and occlusion bit for
    bit on every ray, prim where there is a hit (and on every ray in the
    frontier walk: its gid is 0 on a miss in both stages), the same
    overflow, and as many rounds (batches through ``_live_pairs``)."""
    st, ct, scale = stage_cases[name]
    ct = ct._replace(traversal_mode=mode)
    n = 2048
    ro, rd = rays(n, 17)
    ro = ro * np.float32(scale)
    t_min, t_max = _bounds(n)
    t_occ = np.full((n, 1), 2.0, np.float32)
    rounds = []
    real = tcl._live_pairs

    def spy(*a, **kw):
        rounds[-1] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tcl, "_live_pairs", spy)
    out = {}
    for stage in STAGES:
        rounds.append(0)
        h, ovf = tcl.intersect_counted(ct, st, T(ro), T(rd), T(t_min),
                                       T(t_max), pair_stage=stage)
        rounds.append(0)
        o, ovf_o = tcl.occluded_counted(ct, st, T(ro), T(rd), T(t_occ),
                                        pair_stage=stage)
        out[stage] = (h, int(ovf), o, int(ovf_o))
    (h_f, ovf_f, o_f, ovf_of), (h_s, ovf_s, o_s, ovf_os) = out.values()
    m = h_s.hit[:, 0]
    assert rounds[:2] == rounds[2:] and (ovf_f, ovf_of) == (ovf_s, ovf_os)
    for f in ("hit", "t", "u", "v"):
        assert torch.equal(getattr(h_f, f), getattr(h_s, f)), f
    assert torch.equal(h_f.prim[m], h_s.prim[m])
    if mode == "frontier":
        assert torch.equal(h_f.prim, h_s.prim)
    assert torch.equal(o_f, o_s) and int(m.sum()) > 0
    if name == "starved":
        assert ovf_f + ovf_of > 0
    if name == "unsorted":
        assert not tcl._cand_sorted(ct)
    if name == "soup" and mode == "frontier":
        n_cand, _ = tcl.candidate_stats(ct, T(ro), T(rd), T(t_min), T(t_max))
        pb = ct.pair_budget
        for want in (n_cand == 0, n_cand == 1, n_cand == pb, n_cand > pb):
            assert bool(want.any())
        assert rounds[0] >= 3 and rounds[1] >= 2, rounds     # feedback rounds


@pytest.mark.parametrize("pair_stage", STAGES)
@pytest.mark.parametrize("mode", MODES)
def test_truncation_is_counted_but_no_ray_is_suspect(setups, mode,
                                                     pair_stage):
    """The standing contract of both modes, as in the JAX package: the
    overflow is counted, the suspect mask is all False (so the repair flow
    finds nothing to repair), and an attached fallback is not walked."""
    _, _, st, ct = setups["starved"]
    ct = ct._replace(traversal_mode=mode)
    ro, rd = rays(2048, 10)
    ro = ro * np.float32(0.3)
    t_min, t_max = (T(x) for x in _bounds(2048))
    isect, occl = tdriver._intersectors_suspect("cluster", ct,
                                                pair_stage=pair_stage)
    _, ovf, sus = isect(st, T(ro), T(rd), t_min, t_max)
    _, ovf_o, sus_o = occl(st, T(ro), T(rd), t_max)
    assert int(ovf) + int(ovf_o) > 0
    assert sus.dtype == torch.bool and not bool(sus.any() | sus_o.any())
    h = tcl.intersect(ct, st, T(ro), T(rd), t_min, t_max,
                      pair_stage=pair_stage)
    h_fb = tcl.intersect(tcl.attach_fallback(ct, st), st, T(ro), T(rd),
                         t_min, t_max, pair_stage=pair_stage)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(h, f), getattr(h_fb, f)), f


# ---- whole-step lane slicing -----------------------------------------------

def test_slice_count_follows_the_reference_rule():
    """Halved while the queue is no multiple of it or a slice would be
    under 2,048 lanes (tpu_pt/render/wavefront.py::_step)."""
    for Q, want, got in ((4096, 2, 2), (4096, 4, 2), (2048, 2, 1),
                         (6144, 4, 2), (8192, 4, 4), (4095, 2, 1),
                         (4096, 1, 1), (4096, 0, 1)):
        assert twf._slices(Q, want) == got, (Q, want)


def _sliced_setup(spp, scene="spheres"):
    """A Cornell box with 4,096 samples in flight (64 x 64 at spp 1, 64 x 32
    at spp 2; queue 4,096, depth 2, RR from 1 at 0.8: the JAX package's
    step-slice case, tests/test_wavefront.py::test_step_slices_match): two
    slices of 2,048 lanes."""
    kw = dict(width=64, height=64 // spp, spp=spp, max_depth=2, rr_start=1,
              rr_prob=0.8)
    st = tc.cornell(scene).to("cpu")
    return kw, st, tc.camera(kw["width"], kw["height"]).to("cpu")


@pytest.mark.parametrize("spp", [1, 2])
def test_step_slices_render_the_same_bits(spp, monkeypatch):
    """``wavefront_accum(step_slices=2)``, and ``step_slices=4`` (halved to
    2 by the reference's rule), run each step as two slices of 2,048 lanes
    and give the unsliced sums bit for bit (every lane adds to its own
    row); the differentiable loop ignores the slicing."""
    kw, st, cam = _sliced_setup(spp)
    cfg = TConfig(**kw)
    n_pix = cfg.n_pixels
    widths = []
    real = twf._step_slice

    def spy(scene, cam, cfg, key, isect, occl, lanes, *a):
        widths.append(lanes[0].shape[0])
        return real(scene, cam, cfg, key, isect, occl, lanes, *a)

    monkeypatch.setattr(twf, "_step_slice", spy)

    def accum(**k):
        widths.clear()
        with torch.no_grad():
            out = twf.wavefront_accum(st, cam, cfg, (0, 11), None, 4096,
                                      "brute", 0, n_pix, with_counts=True,
                                      **k)
        return out, set(widths)

    (a, ca), wa = accum()
    (b, cb), wb = accum(step_slices=2)
    (c, cc), wc = accum(step_slices=4)
    (d, cd), wd = accum(differentiable=True, step_slices=2)
    assert (wa, wb, wc, wd) == ({4096}, {2048}, {2048}, {4096})
    assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
    assert [int(x) for x in ca] == [int(x) for x in cb] == \
        [int(x) for x in cc]


def test_step_slices_match_jax_sliced_render():
    """The sliced render at spp 2 against the JAX package's
    (``wavefront_accum(fast=True, step_slices=2)``) at every pixel, on the
    Cornell mesh and the Cornell spheres; on the spheres each package's
    sliced sums are its unsliced sums bit for bit."""
    jit = jax.jit(jwf.wavefront_accum, static_argnames=(
        "cfg", "queue", "backend", "n_pix_local", "fast", "step_slices"))
    for scene in ("mesh", "spheres"):
        kw, st, cam = _sliced_setup(2, scene)
        sj = jc.cornell(scene)
        cfg = TConfig(**kw)

        def jax_render(k):
            return np.asarray(jit(
                sj, jc.camera(kw["width"], kw["height"]), JConfig(**kw),
                jax.random.key(11), None, queue=4096, backend="brute",
                pix_lo=0, n_pix_local=cfg.n_pixels, fast=True,
                step_slices=k))[:cfg.n_pixels]

        def port_render(k):
            with torch.no_grad():
                return twf.wavefront_accum(
                    st, cam, cfg, (0, 11), None, 4096, "brute", 0,
                    cfg.n_pixels, step_slices=k).numpy()

        img_j, img_t = jax_render(2), port_render(2)
        assert float(img_t.mean()) > 0.01
        if scene == "spheres":
            np.testing.assert_array_equal(img_j, jax_render(1))
            np.testing.assert_array_equal(img_t, port_render(1))
        np.testing.assert_allclose(img_t, img_j, rtol=2e-4, atol=2e-5)
