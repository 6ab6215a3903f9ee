"""The device cluster build of the port (bvh/cluster.py::
build_cluster_device, _sah_split_round, _levels16_t, _ladder_sizes)
against tpu_pt.bvh.cluster, jitted on the CPU as the reference's tests run
it, and the port's traversal of it against the brute-force oracle.

Tolerances: without refinement every array (their bits) and every static
field exact.  With refinement every window's cut exact, except at a window
where the reference's costs tie within 4 ulps: its two best cuts, or its
best cut against split_tau x the unsplit cost.  XLA on the CPU contracts
a*b + c into one rounding, eager torch rounds twice, so only such a window
can cut differently; the test lists them.  Traversal: hit and primitive id
exact, t rtol 1e-5 / atol 1e-6 (tests/test_cluster.py:121-150)."""

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

from torch_port_util import T, rays, scene_dict


def _mesh():
    v, f = jm.icosphere(subdiv=3)
    return jt.make_scene(v, f, np.zeros(len(f), np.int32),
                         jt.make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
                         jt.make_lights([]))


SCENES = {"cornell": lambda: jc.cornell("spheres"), "mesh": _mesh,
          "big": lambda: jm.big_scene(4)}


@pytest.fixture(scope="module")
def scenes():
    """name -> (JAX scene, port scene of CPU tensors)."""
    out = {}
    for name, make in SCENES.items():
        sj = make()
        out[name] = (sj, convert.scene_from_numpy(scene_dict(sj), "cpu").to(
            "cpu"))
    return out


_jit_build = jax.jit(jcl.build_cluster_device,
                     static_argnames=("tile", "split_tau", "split_rounds"))


def _assert_builds_equal(cj, ct):
    """Every array of the two builds bit for bit, and the static fields."""
    assert len(cj.levels) == len(ct.levels)
    for a, b in zip(cj.levels, ct.levels):
        np.testing.assert_array_equal(b.numpy().view(np.uint32),
                                      np.asarray(a).view(np.uint32))
    for a, b in zip(cj.levels16, ct.levels16):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    np.testing.assert_array_equal(ct.tiles.numpy().view(np.uint32),
                                  np.asarray(cj.tiles).view(np.uint32))
    np.testing.assert_array_equal(ct.tile_gid.numpy(),
                                  np.asarray(cj.tile_gid))
    assert ct.tile_gid.dtype == torch.int32
    assert (ct.frontiers, ct.k_leaf, ct.pair_budget, ct.pair_mults) == \
        (tuple(cj.frontiers), cj.k_leaf, cj.pair_budget, tuple(cj.pair_mults))


@pytest.mark.parametrize("name,tile", [("cornell", 128), ("mesh", 64),
                                       ("big", 64), ("big", 128)])
def test_device_build_without_refinement_equals_jax(scenes, name, tile):
    sj, st = scenes[name]
    cj = _jit_build(sj, tile=tile, split_tau=None)
    ct = tcl.build_cluster_device(st, tile=tile, split_tau=None, device="cpu")
    _assert_builds_equal(cj, ct)
    assert ct.top_soa is not None and len(ct.child16) == len(ct.levels)
    assert ct.pair_mults == (8, 8, 9, 6)


@jax.jit
def _jax_costs(live, lo_f, hi_f):
    """The reference's cost of every cut and of the unsplit window
    (tpu_pt/bvh/cluster.py:339-357), jitted as the build is."""
    C, tile = live.shape
    lo_w, hi_w = lo_f.reshape(C, tile, 3), hi_f.reshape(C, tile, 3)
    pre_lo = jax.lax.cummin(lo_w, axis=1)
    pre_hi = jax.lax.cummax(hi_w, axis=1)
    suf_lo = jax.lax.cummin(lo_w, axis=1, reverse=True)
    suf_hi = jax.lax.cummax(hi_w, axis=1, reverse=True)

    def _area(l, h):
        d = jnp.maximum(h - l, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    n_w = jnp.sum(live, axis=1, dtype=jnp.int32)
    nL = jnp.minimum(jnp.arange(1, tile)[None, :],
                     n_w[:, None]).astype(jnp.float32)
    nR = n_w[:, None].astype(jnp.float32) - nL
    cost = (_area(pre_lo[:, :-1], pre_hi[:, :-1]) * nL
            + _area(suf_lo[:, 1:], suf_hi[:, 1:]) * nR)
    return cost, _area(pre_lo[:, -1], pre_hi[:, -1]) * n_w.astype(jnp.float32)


def _ulps(a, b):
    """Distance in units of the last place of two non-negative f32 arrays."""
    return np.abs(np.asarray(a, np.float32).view(np.int32).astype(np.int64)
                  - np.asarray(b, np.float32).view(np.int32).astype(np.int64))


def _near_ties(cost, whole, n_live, split_tau):
    """Windows whose reference costs tie within 4 ulps: its two best cuts,
    or its best cut against split_tau x the unsplit cost.  Only the cuts
    that leave a live lane on each side count (every cut past the last
    live lane makes the same two chunks), and a window of fewer than two
    live lanes has no cut."""
    cost, whole = np.asarray(cost), np.asarray(whole)
    out = []
    for w, n in enumerate(np.asarray(n_live)):
        if n < 2:
            continue
        c = np.sort(cost[w, :n - 1])
        thresh = np.float32(split_tau) * whole[w]
        if _ulps(c[0], thresh) <= 4 or (n > 2 and _ulps(c[0], c[1]) <= 4):
            out.append(w)
    return out


@pytest.mark.parametrize("name,tile,rounds", [("big", 128, 1), ("big", 64, 2),
                                              ("mesh", 64, 2)])
def test_device_build_refinement_cuts_equal_jax(scenes, name, tile, rounds):
    """Each refinement round on the same input cuts every window where the
    reference does, but at near ties (listed); where no window differs the
    whole build equals the reference's, array for array."""
    sj, st = scenes[name]
    state = tcl._morton_chunks(st, tile)
    C, tau = state[-1], 0.5
    jround = jax.jit(jcl._sah_split_round, static_argnums=(5, 6, 7))
    differ_all = []
    for r in range(rounds):
        rows, gid_f, live, lo_f, hi_f = (x.numpy() for x in state[:5])
        out_t = tcl._sah_split_round(*state[:5], C, tile, tau)
        out_j = jround(*(jnp.asarray(x) for x in (rows, gid_f, live, lo_f,
                                                  hi_f)), C, tile, tau)
        cut_t = out_t[2].reshape(2 * C, tile).sum(1).numpy()[0::2]
        cut_j = np.asarray(out_j[2]).reshape(2 * C, tile).sum(1)[0::2]
        cost_j, whole_j = _jax_costs(jnp.asarray(live.reshape(C, tile)),
                                     jnp.asarray(lo_f), jnp.asarray(hi_f))
        ties = _near_ties(cost_j, whole_j, live.reshape(C, tile).sum(1), tau)
        differ = np.flatnonzero(cut_t != cut_j)
        # Where XLA's contraction rounds the costs apart from torch's.
        cost_t = tcl._sah_costs(*state[2:5], C, tile)[0].numpy()
        apart = _ulps(cost_t, cost_j)
        print(f"{name} tile {tile} round {r}: {C} windows, cuts differ at "
              f"{differ.tolist()}, near ties at {ties}; costs rounded apart "
              f"{int((apart > 0).sum())} of {apart.size}, at most "
              f"{int(apart.max())} ulps")
        assert int(apart.max()) <= 4
        assert set(differ.tolist()) <= set(ties), \
            f"windows {sorted(set(differ) - set(ties))} cut apart, no tie"
        differ_all += differ.tolist()
        # The next round takes the reference's output on both sides.
        state = tuple(torch.from_numpy(np.array(x)) for x in out_j[:5]) + \
            (int(out_j[5]),)
        C = state[-1]
    if not differ_all:
        cj = _jit_build(sj, tile=tile, split_tau=tau, split_rounds=rounds)
        ct = tcl.build_cluster_device(st, tile=tile, split_rounds=rounds,
                                      device="cpu")
        _assert_builds_equal(cj, ct)


@pytest.mark.parametrize("name,tile", [("cornell", 64), ("big", 64),
                                       ("cornell", 128)])
def test_device_build_traversal_matches_brute(scenes, name, tile):
    """tests/test_cluster.py:121-150 and :351 on the port's build (the
    default refinement); the tiny scene at tile 128 is one window, two
    chunk slots."""
    sj, st = scenes[name]
    cb = tcl.build_cluster_device(st, tile=tile, device="cpu")
    if name == "cornell" and tile == 128:
        assert cb.n_clusters == 2
    ro, rd = rays(512, 11)
    R = 512
    t_min, t_max = torch.zeros((R, 1)), torch.full((R, 1), 1e30)
    h_ref = tbrute.intersect(st, T(ro), T(rd), t_min, t_max)
    h_cl = tcl.intersect(cb, st, T(ro), T(rd), t_min, t_max)
    assert torch.equal(h_cl.hit, h_ref.hit) and int(h_cl.hit.sum()) > 0
    m = h_ref.hit[:, 0]
    assert torch.equal(h_cl.prim[m], h_ref.prim[m])
    np.testing.assert_allclose(h_cl.t[m].numpy(), h_ref.t[m].numpy(),
                               rtol=1e-5, atol=1e-6)
    short = torch.full((R, 1), 2.0)
    assert torch.equal(tcl.occluded(cb, st, T(ro), T(rd), short),
                       tbrute.occluded(st, T(ro), T(rd), short))


@pytest.mark.parametrize("tile", [64, 128])
def test_device_build_keeps_the_pair_stage_invariants(scenes, tile):
    """``pair_ray_reduce``'s first build invariant: ``tile_gid`` ascends
    over a tile's live lanes, which come first.  With it (and ``right``
    non-decreasing, from ``_flat_pairs``) the fused stage is the split
    stage bit for bit; ``"dedup"`` takes 128-lane tiles only."""
    sj, st = scenes["big"]
    cb = tcl.build_cluster_device(st, tile=tile, device="cpu")
    live = cb.tiles.abs().sum(1) > 0                       # (C, L)
    n_live = live.sum(1)
    assert torch.equal(live, torch.arange(tile)[None, :] < n_live[:, None])
    gid = cb.tile_gid.long()
    step = gid[:, 1:] - gid[:, :-1]
    both = live[:, 1:]
    assert bool((step[both] > 0).all())
    assert bool((gid[~live] == 0).all())
    assert sorted(gid[live].tolist()) == list(range(sj.n_prims))
    ro, rd = rays(1024, 17)
    args = (st, T(ro), T(rd), torch.zeros((1024, 1)), 1e30)
    fused = tcl.intersect(cb, *args, pair_stage="fused")
    split = tcl.intersect(cb, *args, pair_stage="split")
    for f in ("hit", "t", "prim", "u", "v"):
        assert torch.equal(getattr(fused, f), getattr(split, f)), f
    assert torch.equal(tcl.occluded(cb, st, T(ro), T(rd), 2.0),
                       tcl.occluded(cb, st, T(ro), T(rd), 2.0,
                                    pair_stage="split"))
    if tile != 128:
        with pytest.raises(ValueError, match="dedup"):
            tcl.intersect(cb, *args, pair_stage="dedup")


def test_levels16_tensor_equals_numpy_at_the_edges():
    """The tensor ``_levels16_t`` gives the numpy ``_levels16``'s bf16 bits
    on +-inf, +-0.0, negative and tiny boxes, values on the bf16 grid and
    values just off it either way."""
    rs = np.random.RandomState(2)
    lv = rs.normal(scale=50.0, size=(64, 8)).astype(np.float32)
    special = np.array([np.inf, -np.inf, 0.0, -0.0, 1.0, -1.0, 1e-30, -1e-30,
                        1e-45, -1e-45, 3.4e38, -3.4e38,
                        np.float32(1.0) + np.float32(2 ** -20),
                        -(np.float32(1.0) + np.float32(2 ** -20))],
                       np.float32)
    lv[:14, 0] = special
    lv[:14, 4] = special[::-1]
    lv[20:34, 1] = special
    lv[40:54, 5] = -special
    lv[:, 6:] = 0.0
    want = tcl._levels16([lv])[0]
    got = tcl._levels16_t([T(lv)])[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  want)
    # Outward: lo rounded down, hi up, so no box shrinks.
    g = got.float().numpy()
    assert (g[:, 0:3] <= lv[:, 0:3]).all() and (g[:, 3:6] >= lv[:, 3:6]).all()


def test_ladder_sizes_equal_jax():
    for C in (1, 2, 8, 511, 512, 513, 4097, 14901, 20482):
        for dense in (8, 512):
            assert tcl._ladder_sizes(C, dense) == jcl._ladder_sizes(C, dense)
