"""The cluster-major ("dedup") pair stage of the port on the CPU: the plain
version of its pair kernel against the Pallas kernel it replaces
(tpu_pt.kernels.cluster_isect.pair_tile_isect_dedup, interpret mode), the
stage and the traversal built on it against the JAX package with
``DEDUP_PAIRS = True``, and against the port's own ray-major stage.  The
CUDA kernel is held against the plain version, and against the ray-major
kernel on the same rows, on the card by chip_smoke.py (and by the
``gpu``-marked test below).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.kernels import cluster_isect as jki
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.core.intersect import INF
from tpu_pt_torch.kernels import cluster_isect as tki
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc

from torch_port_util import T, bvh_dict, rays, scene_dict


@pytest.fixture(scope="module")
def setups():
    """name -> (jax scene, jax bvh, port scene, port bvh), 128-lane tiles."""
    out = {}
    for name, scene in (("big", jm.big_scene(4)),
                        ("cornell", jc.cornell("spheres"))):
        cb = jcl.build_cluster_bvh(scene)
        out[name] = (scene, cb,
                     convert.scene_from_numpy(scene_dict(scene), "cpu"),
                     convert.cluster_bvh_from_numpy(bvh_dict(cb), "cpu"))
    return out


def _bounds(n, t_max=1e30):
    return (np.zeros((n, 1), np.float32), np.full((n, 1), t_max, np.float32))


def _aimed_rays(n, seed):
    """Rays from around the scene aimed into it, so that most of them reach
    leaf clusters (random directions mostly miss everything)."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    ro[:, 1] = np.abs(ro[:, 1]) + 0.2
    target = rs.uniform(-0.8, 0.8, (n, 3)) + np.array([0.0, 0.9, 0.0])
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def _pair_list(ct, Q, seed):
    """The flat ray-major pair list the traversal hands to its pair stage."""
    ro, rd = _aimed_rays(Q, seed)
    tmin, tmax = _bounds(Q)
    cand, live, _ = tcl._descend_compact(ct, T(ro), 1.0 / T(rd), T(tmin),
                                         T(tmax))
    budget = ct.pair_mults[2] * Q
    rayP, cidP, dropped, cnt, right, _ = tcl._flat_pairs(cand, live, Q, budget)
    assert int(dropped) == 0
    return ro, rd, tmin, tmax, rayP, cidP, cnt, right


def _sorted_operands(ct, ro, rd, tmin, tmax, rayP, cidP):
    """cid (sorted) and ray rows as the cluster-major stage builds them."""
    cid, rows, _, _ = tcl._dedup_rows(ct, T(ro), T(rd), T(tmin[:, 0]),
                                      T(tmax[:, 0]), rayP, cidP)
    return cid.numpy(), rows.numpy()


@pytest.mark.parametrize("name,seed", [("big", 13), ("big", 14),
                                       ("cornell", 13)])
def test_dedup_ref_matches_pallas_on_real_sorted_pair_lists(setups, name, seed):
    _, cj, _, ct = setups[name]
    ro, rd, tmin, tmax, rayP, cidP, _, _ = _pair_list(ct, 128, seed)
    cid, rows = _sorted_operands(ct, ro, rd, tmin, tmax, rayP, cidP)
    assert (np.diff(cid) >= 0).all() and len(cid) % tki.B == 0
    live = rows[:, 8] > 0
    assert live.sum() > 100 and ((~live).sum() > 0 or name == "cornell")
    out_j = np.asarray(jki.pair_tile_isect_dedup(
        jnp.asarray(np.asarray(cj.tiles)), jnp.asarray(cid),
        jnp.asarray(rows)))
    out_t = tki.pair_tile_isect_dedup(ct.tiles, T(cid), T(rows)).numpy()
    hit_j, hit_t = out_j[:, 0] < INF, out_t[:, 0] < INF
    np.testing.assert_array_equal(hit_j, hit_t)
    assert hit_t.sum() > 20 and not hit_t[~live].any()
    # t to one ulp (operation fusion differs), lane exact where t is bitwise
    # equal, u / v to 1e-4 (they cancel against small edges): the tolerances
    # of the ray-major kernel's test (test_torch_pair_kernels.py).
    np.testing.assert_allclose(out_t[:, 0], out_j[:, 0], rtol=1e-6, atol=1e-6)
    t_same = (out_j[:, 0] == out_t[:, 0]) & hit_j
    np.testing.assert_array_equal(out_j[t_same, 1], out_t[t_same, 1])
    same = hit_j & (out_j[:, 1] == out_t[:, 1])
    np.testing.assert_allclose(out_t[same, 2:4], out_j[same, 2:4], atol=1e-4)
    assert (out_t[~hit_t, 2:4] == 0).all() and (out_t[:, 4:] == 0).all()
    # The function is the ray-major kernel's, pair by pair, in any order.
    assert torch.equal(tki.pair_tile_isect(ct.tiles, T(cid), T(rows)),
                       torch.from_numpy(out_t))
    perm = np.random.RandomState(0).permutation(len(cid))
    shuffled = tki.pair_tile_isect_dedup_ref(ct.tiles, T(cid[perm]),
                                             T(rows[perm])).numpy()
    np.testing.assert_array_equal(shuffled, out_t[perm])


def test_test_pairs_dedup_matches_jax(setups):
    """The cid-sorted stage as a whole: same order, same dead mask, same
    rays, t to one ulp, gid equal where t is bitwise equal."""
    _, cj, _, ct = setups["big"]
    Q = 128
    ro, rd, tmin, tmax, rayP, cidP, _, _ = _pair_list(ct, Q, 13)
    cjd = jax.tree.map(jnp.asarray, cj)
    a = jcl._test_pairs_dedup(
        cjd, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tmin[:, 0]),
        jnp.asarray(tmax[:, 0]), jnp.asarray(rayP.numpy().astype(np.int32)),
        jnp.asarray(cidP.numpy().astype(np.int32)))
    b = tcl._test_pairs_dedup(ct, T(ro), T(rd), T(tmin[:, 0]), T(tmax[:, 0]),
                              rayP, cidP)
    t_j, u_j, v_j, g_j, rayC_j, ok_j = (np.asarray(x) for x in a)
    t_t, u_t, v_t, g_t, rayC_t, ok_t = (x.numpy() for x in b)
    np.testing.assert_array_equal(ok_j, ok_t)
    np.testing.assert_array_equal(rayC_j, rayC_t)
    np.testing.assert_array_equal(t_j < INF, t_t < INF)
    np.testing.assert_allclose(t_t, t_j, rtol=1e-6, atol=1e-6)
    t_same = (t_j == t_t) & (t_j < INF)
    np.testing.assert_array_equal(g_j[t_same], g_t[t_same])
    assert t_same.sum() > 20 and not (t_t[~ok_t] < INF).any()
    assert g_t.dtype == np.int32


@pytest.mark.parametrize("name", ["big", "cornell"])
def test_dedup_traversal_matches_jax_and_the_ray_major_stage(setups, name):
    sj, cj, st, ct = setups[name]
    Q = 128                        # budget = 6 Q = 768 = 6 kernel blocks
    ro, rd = (_aimed_rays if name == "cornell" else rays)(Q, 13)
    tmin, tmax = _bounds(Q)
    t4 = np.full((Q, 1), 4.0, np.float32)
    old = jcl.DEDUP_PAIRS
    try:
        jcl.DEDUP_PAIRS = True
        h_j = jcl.intersect(cj, sj, jnp.asarray(ro), jnp.asarray(rd),
                            jnp.asarray(tmin), jnp.asarray(tmax))
        o_j = jcl.occluded(cj, sj, jnp.asarray(ro), jnp.asarray(rd),
                           jnp.asarray(t4))
    finally:
        jcl.DEDUP_PAIRS = old
    h_d, ovf = tcl.intersect_counted(ct, st, T(ro), T(rd), T(tmin), T(tmax),
                                     pair_stage="dedup")
    o_d, ovf_o = tcl.occluded_counted(ct, st, T(ro), T(rd), T(t4), pair_stage="dedup")
    assert int(ovf) == 0 and int(ovf_o) == 0
    # Against the JAX package's dedup stage: hit mask exact, t to one ulp;
    # prim agreement > 0.96 is the JAX package's own allowance for this
    # stage, whose tie rule is the position in the cid-sorted list.
    np.testing.assert_array_equal(np.asarray(h_j.hit), h_d.hit.numpy())
    np.testing.assert_allclose(h_d.t.numpy(), np.asarray(h_j.t), rtol=1e-6,
                               atol=1e-6)
    m = np.asarray(h_j.hit)[:, 0]
    assert m.sum() > 5
    assert (np.asarray(h_j.prim) == h_d.prim.numpy())[m].mean() > 0.96
    np.testing.assert_array_equal(np.asarray(o_j), o_d.numpy())

    # Against the port's ray-major stage: t is selected, never recomputed,
    # so it is bitwise equal and the masks are exact.
    h_r = tcl.intersect(ct, st, T(ro), T(rd), T(tmin), T(tmax))
    o_r = tcl.occluded(ct, st, T(ro), T(rd), T(t4))
    assert torch.equal(h_r.hit, h_d.hit) and torch.equal(h_r.t, h_d.t)
    mt = h_r.hit[:, 0]
    same = (h_r.prim == h_d.prim)
    assert float(same[mt].float().mean()) > 0.96
    mm = mt & same
    assert torch.equal(h_r.u[mm], h_d.u[mm]) and torch.equal(h_r.v[mm],
                                                            h_d.v[mm])
    assert torch.equal(o_r, o_d)
    assert h_d.prim.dtype == torch.int32 and h_d.t.shape == (Q, 1)
    # The plain-version switch changes nothing on the CPU; the convenience
    # forms pass the keyword on.
    h_p = tcl.intersect(ct, st, T(ro), T(rd), T(tmin), T(tmax),
                        use_kernels=False, pair_stage="dedup")
    for f in ("t", "hit", "prim", "u", "v"):
        assert torch.equal(getattr(h_p, f), getattr(h_d, f)), f
    assert torch.equal(tcl.occluded(ct, st, T(ro), T(rd), T(t4), pair_stage="dedup"),
                       o_d)


def test_dedup_tie_goes_to_the_first_pair_of_the_sorted_list(setups):
    """Two pairs of one ray with equal t: the scatter-min of the pair index
    keeps the one that comes first in the cid-sorted list."""
    _, _, _, ct = setups["big"]
    Q = 4
    t_p = torch.tensor([2.0, 1.0, 1.0, 3.0, INF, 1.5])
    ray = torch.tensor([0, 0, 0, 1, 2, 3])

    def fake(cb, ro, rd, t_min1, t_max1, rayP, cidP, use_kernels=True):
        ok = torch.ones(6, dtype=torch.bool)
        g = torch.arange(10, 16, dtype=torch.int32)
        return t_p, torch.arange(6.0), torch.arange(6.0) + 10, g, ray, ok

    real = tcl._test_pairs_dedup
    tcl._test_pairs_dedup = fake
    try:
        z = torch.zeros(Q)
        bt, bg, bu, bv = tcl._reduce_pairs_closest_dedup(
            ct, torch.zeros((Q, 3)), torch.zeros((Q, 3)), z, z, None, None)
        occ = tcl._reduce_pairs_anyhit_dedup(
            ct, torch.zeros((Q, 3)), torch.zeros((Q, 3)), z, z, None, None)
    finally:
        tcl._test_pairs_dedup = real
    assert bt.tolist() == [1.0, 3.0, np.float32(INF), 1.5]
    assert bg.tolist() == [11, 13, 0, 15]              # pair 1, not pair 2
    assert bu.tolist() == [1.0, 3.0, 0.0, 5.0]
    assert bv.tolist() == [11.0, 13.0, 0.0, 15.0]
    assert occ.tolist() == [True, True, False, True]


def test_checked_form_catches_unsorted_ids_and_poison(setups):
    _, _, _, ct = setups["big"]
    ro, rd, tmin, tmax, rayP, cidP, _, _ = _pair_list(ct, 128, 13)
    cid, rows = _sorted_operands(ct, ro, rd, tmin, tmax, rayP, cidP)
    out = tki.pair_tile_isect_dedup_checked(ct.tiles, T(cid), T(rows))
    assert torch.equal(out, tki.pair_tile_isect_dedup(ct.tiles, T(cid),
                                                      T(rows)))
    swapped = cid.copy()
    i = int(np.flatnonzero(np.diff(cid) > 0)[0])
    swapped[i], swapped[i + 1] = cid[i + 1], cid[i]
    with pytest.raises(AssertionError, match="not sorted"):
        tki.pair_tile_isect_dedup_checked(ct.tiles, T(swapped), T(rows))
    poisoned = ct.tiles.clone()
    poisoned[0, 0:9, :] = float("nan")
    with pytest.raises(AssertionError, match="non-finite tile geometry"):
        tki.pair_tile_isect_dedup_checked(poisoned, T(cid), T(rows))
    with pytest.raises(AssertionError, match="cluster id out of range"):
        tki.pair_tile_isect_dedup_checked(ct.tiles, T(cid) + ct.n_clusters,
                                          T(rows))


def test_unsupported_shape_raises_instead_of_falling_through():
    """64-lane tiles, or a pair budget that is no multiple of 128: the JAX
    package silently runs the ray-major stage; the port raises."""
    scene = jm.big_scene(4)
    st = convert.scene_from_numpy(scene_dict(scene), "cpu")
    c64 = convert.cluster_bvh_from_numpy(
        bvh_dict(jcl.build_cluster_bvh(scene, tile=64)), "cpu")
    ro, rd = (T(x) for x in rays(128, 3))
    tmin, tmax = (T(x) for x in _bounds(128))
    assert not tcl._dedup_supported(c64, 768)
    with pytest.raises(ValueError, match="pair_stage='dedup' needs"):
        tcl.intersect(c64, st, ro, rd, tmin, tmax, pair_stage="dedup")
    with pytest.raises(ValueError, match="pair_stage='dedup' needs"):
        tcl.occluded(c64, st, ro, rd, tmax, pair_stage="dedup")
    c128 = convert.cluster_bvh_from_numpy(
        bvh_dict(jcl.build_cluster_bvh(scene)), "cpu")
    assert tcl._dedup_supported(c128, 768)
    assert not tcl._dedup_supported(c128, 6 * 100)
    with pytest.raises(ValueError, match="pair_stage='dedup' needs"):
        tcl.intersect(c128, st, ro[:100], rd[:100], tmin[:100], tmax[:100],
                      pair_stage="dedup")
    # Without the keyword the same calls run the ray-major stage.
    assert tcl.intersect(c64, st, ro, rd, tmin, tmax).t.shape == (128, 1)
    for c, b in ((c64, 768), (c128, 768), (c128, 600)):
        assert tcl._dedup_supported(c, b) == bool(jcl._dedup_supported(c, b))


def test_wavefront_with_dedup_matches_the_ray_major_render():
    """The keyword reaches the traversal through the renderer; the image
    agrees to the cluster tolerance and the counts are equal (t is bitwise
    equal, so no hit flips)."""
    st = tc.cornell("spheres")
    ct = tcl.build_cluster_bvh(st)
    cfg = TConfig(width=16, height=16, spp=2, max_depth=3)
    cam = tc.camera(16, 16)
    n2, n3 = tki.pair_tile_isect.launches, tki.pair_tile_isect_dedup.launches
    a = twf.render_wavefront_counts(st, cam, cfg, (0, 3), ct, queue=256,
                                    backend="cluster", device="cpu")
    b = twf.render_wavefront_counts(st, cam, cfg, (0, 3), ct, queue=256,
                                    backend="cluster", device="cpu",
                                    pair_stage="dedup")
    np.testing.assert_allclose(b[0].numpy(), a[0].numpy(), rtol=2e-4,
                               atol=2e-5)
    assert a[1:] == b[1:] and b[3] == 0
    c = twf.render_wavefront(st, cam, cfg, (0, 3), ct, queue=256,
                             backend="cluster", device="cpu",
                             pair_stage="dedup")
    assert torch.equal(c, b[0])
    # CPU tensors take the plain versions: nothing was launched.
    assert (tki.pair_tile_isect.launches,
            tki.pair_tile_isect_dedup.launches) == (n2, n3)


@pytest.mark.parametrize("P,n_sm,want", [
    (6144, 132, 660), (4096, 132, 660), (2640, 132, 660), (2644, 132, 660),
    (2636, 132, 659), (128, 132, 32), (0, 132, 1), (8, 1, 2), (10 ** 6, 1, 5),
])
def test_dedup_grid_is_a_warp_per_slot_up_to_five_blocks_an_sm(P, n_sm, want):
    assert tki.dedup_grid_blocks(P, n_sm) == want
    assert tki.DEDUP_WARPS_PER_BLOCK * want >= min(P, 4 * 5 * n_sm)


@pytest.mark.parametrize("P,n_sm", [(-1, 132), (128, 0)])
def test_dedup_grid_refuses_what_no_card_has(P, n_sm):
    with pytest.raises(ValueError):
        tki.dedup_grid_blocks(P, n_sm)


def _small_operands():
    tiles = torch.zeros((3, 12, 128))
    cid = torch.zeros((256,), dtype=torch.int32)
    rays = torch.zeros((256, 16))
    return tiles, cid, rays


BAD_DEDUP = [
    ("tiles_rows", 0, lambda x: x[:, :11]),
    ("tiles_width", 0, lambda x: x[:, :, :48]),
    ("no_tiles", 0, lambda x: x[:0]),
    ("pairs_not_multiple_of_128", 1, lambda x: x[:200]),
    ("cid_column", 1, lambda x: x[:, None]),
    ("rays_rows", 2, lambda x: x[:-128]),
    ("rays_width", 2, lambda x: x[:, :8]),
    ("cid_device", 1, lambda x: x.to("meta")),
    ("rays_device", 2, lambda x: x.to("meta")),
]


@pytest.mark.parametrize("what,i,change", BAD_DEDUP,
                         ids=[b[0] for b in BAD_DEDUP])
def test_dedup_wrapper_refuses_bad_operands_before_any_launch(what, i, change):
    ops = list(_small_operands())
    ops[i] = change(ops[i])
    n0 = tki.pair_tile_isect_dedup.launches
    with pytest.raises(ValueError):
        tki.pair_tile_isect_dedup(*ops)
    assert tki.pair_tile_isect_dedup.launches == n0


def test_dedup_kernel_checks_refuse_host_tensors_and_misaligned_rows():
    """What the wrapper checks before a launch, on CPU tensors: they are
    not CUDA tensors; a view that starts 4 bytes into its storage is not
    16-byte aligned (the kernel reads tile and ray rows as float4)."""
    tiles, cid, rays = _small_operands()
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tki._launch(tki.pair_tile_isect_dedup, "pair_tile_isect_dedup_launch",
                    tiles, cid, rays, 3, 1)
    tki._check_aligned("k3", tiles=tiles, rays=rays)
    shifted = torch.zeros((256 * 16 + 1,))[1:].view(256, 16)
    with pytest.raises(ValueError, match="rays must be 16-byte aligned"):
        tki._check_aligned("k3", tiles=tiles, rays=shifted)
    # The plain version takes the same view (it has no alignment to keep).
    assert torch.equal(tki.pair_tile_isect_dedup(tiles, cid, shifted),
                       tki.pair_tile_isect_dedup(tiles, cid, rays))


def _gpu_cases():
    """(label, tiles, cid, rows) for the card: real cid-sorted pair lists at
    three tile widths, the 128-lane one also shuffled, cut to one block's
    128 pairs and with its liveness scattered; one id over a run longer
    than the grid's stride."""
    scene = jm.big_scene(4)
    for tile in (128, 64, 32):
        ct = convert.cluster_bvh_from_numpy(
            bvh_dict(jcl.build_cluster_bvh(scene, tile=tile)), "cpu")
        ro, rd, tmin, tmax, rayP, cidP, _, _ = _pair_list(ct, 1024, 5)
        cid, rows = _sorted_operands(ct, ro, rd, tmin, tmax, rayP, cidP)
        yield f"sorted_L{tile}", ct.tiles, cid, rows
        if tile != 128:
            continue
        perm = np.random.RandomState(1).permutation(len(cid))
        yield "shuffled", ct.tiles, cid[perm], rows[perm]
        yield "P128", ct.tiles, cid[:128], rows[:128]
        scattered = rows.copy()
        scattered[:, 8] = np.random.RandomState(2).rand(len(cid)) < 0.5
        yield "live_after_dead", ct.tiles, cid, scattered
        # The rows of the pairs that name the tile hit most often, repeated
        # over 8,192 slots: more than 2,640, the grid's stride on 132 SMs.
        out = tki.pair_tile_isect_dedup_ref(ct.tiles, T(cid), T(rows))
        hit_cid = cid[out[:, 0].numpy() < INF]
        c0 = int(np.bincount(hit_cid).argmax())
        n = 8192
        yield ("one_id_longer_than_stride", ct.tiles, np.full(n, c0, np.int32),
               np.resize(rows[cid == c0], (n, 16)))


@pytest.mark.gpu
def test_dedup_kernel_matches_plain_version_and_ray_major_kernel_on_the_card():
    """Needs an NVIDIA GPU and nvcc: the cluster-major kernel bit for bit
    against its plain version and against the ray-major kernel on the same
    rows, on the cases of ``_gpu_cases``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for label, tiles, c, r in _gpu_cases():
        dt, dc, dr = tiles.cuda(), T(c).cuda(), T(r).cuda()
        n0 = tki.pair_tile_isect_dedup.launches
        out = tki.pair_tile_isect_dedup(dt, dc, dr)
        assert tki.pair_tile_isect_dedup.launches == n0 + 1
        assert torch.equal(out, tki.pair_tile_isect_dedup_ref(dt, dc, dr)), \
            label
        assert torch.equal(out, tki.pair_tile_isect(dt, dc, dr)), label
        assert bool((out[:, 0] < INF).any()), label
    with pytest.raises(ValueError, match="aligned"):
        tki.pair_tile_isect_dedup(dt, dc, torch.zeros(
            dr.numel() + 1, device="cuda")[1:].view_as(dr))
    with pytest.raises(ValueError, match="different devices"):
        tki.pair_tile_isect_dedup(dt, dc.cpu(), dr)
