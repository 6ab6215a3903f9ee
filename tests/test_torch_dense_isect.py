"""The dense-sweep backend of the port (tpu_pt_torch.kernels.intersect) on
the CPU: its plain PyTorch versions against the Pallas kernels they replace
(tpu_pt.kernels.intersect, interpret mode) and against the port's brute
oracle.  The CUDA kernels themselves are held against these plain versions
on the card by chip_smoke.py (and by the ``gpu``-marked test below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh.native import _prim_rows as j_prim_rows
from tpu_pt.kernels import intersect as jki
from tpu_pt.scene import cornell as jc
from tpu_pt_torch import convert
from tpu_pt_torch.bvh.native import prim_rows as t_prim_rows
from tpu_pt_torch.core.intersect import INF
from tpu_pt_torch.kernels import intersect as tki
from tpu_pt_torch.render import brute as tbrute
from tpu_pt_torch.scene import cornell as tc

from torch_port_util import T, rays, scene_dict


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


@pytest.fixture(scope="module")
def setups():
    """variant -> (jax scene, jax PallasScene, port scene, port PallasScene);
    the port's containers are carried across by convert.py, so both sides
    hold the very same rows."""
    out = {}
    for var in ("spheres", "mesh"):
        sj = jc.cornell(var)
        pj = jki.PallasScene(sj)
        out[var] = (sj, pj, convert.scene_from_numpy(scene_dict(sj), "cpu"),
                    convert.pallas_scene_from_numpy(
                        dict(prims=np.asarray(pj.prims), n_prims=pj.n_prims),
                        "cpu"))
    return out


def _box_rays(n, seed):
    """Rays from inside the Cornell box in random directions: most hit (the
    box is open toward +z), many of them the spheres or the mesh."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform([-0.9, 0.1, -0.9], [0.9, 1.9, 0.9], (n, 3))
    rd = rs.normal(size=(n, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


@pytest.mark.parametrize("var", ["spheres", "mesh", "glossy", "empty"])
def test_prim_rows_and_pallas_scene_equal_the_jax_package(var):
    """Exact, as bit patterns: column 9 is an int32 id viewed as f32."""
    sj, st = jc.cornell(var), tc.cornell(var)
    pid = np.arange(sj.n_prims, dtype=np.int32)
    np.testing.assert_array_equal(_bits(j_prim_rows(sj, pid)),
                                  _bits(t_prim_rows(st, pid)))
    perm = np.random.RandomState(0).permutation(pid).astype(np.int32)
    np.testing.assert_array_equal(_bits(j_prim_rows(sj, perm)),
                                  _bits(t_prim_rows(st, perm)))
    pj, pt = jki.PallasScene(sj), tki.PallasScene(st)
    assert pt.n_prims == pj.n_prims == sj.n_prims
    assert pt.prims.shape[0] % tki.TBLK == 0 and pt.prims.shape[1] == 16
    np.testing.assert_array_equal(_bits(pj.prims), _bits(pt.prims))
    assert not pt.prims[pt.n_prims:].any()           # padding rows are zero
    moved = pt.to("cpu")
    assert torch.is_tensor(moved.prims) and moved.n_prims == pt.n_prims
    np.testing.assert_array_equal(_bits(moved.prims.numpy()), _bits(pt.prims))


@pytest.mark.parametrize("var,maker,seed", [
    ("spheres", rays, 3), ("mesh", rays, 3),
    ("spheres", _box_rays, 4), ("mesh", _box_rays, 5)])
def test_intersect_matches_pallas_and_brute(setups, var, maker, seed):
    sj, pj, st, pt = setups[var]
    n = 300                      # not a multiple of 128: the ragged block
    ro, rd = maker(n, seed)
    tmin = np.zeros((n, 1), np.float32)
    tmax = np.full((n, 1), 1e30, np.float32)
    h_j = jki.intersect(pj, sj, jnp.asarray(ro), jnp.asarray(rd),
                        jnp.asarray(tmin), jnp.asarray(tmax))
    h_t = tki.intersect(pt, st, T(ro), T(rd), T(tmin), T(tmax))
    assert h_t.t.shape == (n, 1) and h_t.prim.dtype == torch.int32
    assert h_t.hit.dtype == torch.bool and h_t.u.shape == (n, 1)
    # Hit mask exact; t to the tolerance of the JAX package's own test of
    # this kernel against its oracle (XLA picks the rounding order of the
    # cross and dot products, the port writes each component out).
    np.testing.assert_array_equal(np.asarray(h_j.hit), h_t.hit.numpy())
    m = np.asarray(h_j.hit)[:, 0]
    assert m.sum() > (200 if maker is _box_rays else 20)
    np.testing.assert_allclose(h_t.t.numpy()[m], np.asarray(h_j.t)[m],
                               rtol=1e-5, atol=1e-6)
    assert (np.asarray(h_j.prim) == h_t.prim.numpy())[m].mean() > 0.99
    same = m & (np.asarray(h_j.prim) == h_t.prim.numpy())
    # u, v cancel against small edges (see test_torch_pair_kernels.py).
    np.testing.assert_allclose(h_t.u.numpy()[same], np.asarray(h_j.u)[same],
                               atol=1e-4)
    np.testing.assert_allclose(h_t.v.numpy()[same], np.asarray(h_j.v)[same],
                               atol=1e-4)
    assert (h_t.t.numpy()[~m] == np.float32(INF)).all()

    # Against the port's own brute oracle (same eager arithmetic per
    # component up to the order of the dot products).
    h_b = tbrute.intersect(st, T(ro), T(rd), T(tmin), T(tmax))
    assert torch.equal(h_b.hit, h_t.hit)
    mt = h_b.hit[:, 0]
    np.testing.assert_allclose(h_t.t[mt].numpy(), h_b.t[mt].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert float((h_b.prim == h_t.prim)[mt].float().mean()) > 0.99


@pytest.mark.parametrize("var,maker,seed,t_max", [
    ("spheres", rays, 4, 2.0), ("mesh", rays, 4, 2.0),
    ("spheres", _box_rays, 6, 0.7), ("mesh", _box_rays, 7, 0.7)])
def test_occluded_matches_pallas_and_brute(setups, var, maker, seed, t_max):
    sj, pj, st, pt = setups[var]
    n = 300
    ro, rd = maker(n, seed)
    tmax = np.full((n, 1), t_max, np.float32)
    o_j = jki.occluded(pj, sj, jnp.asarray(ro), jnp.asarray(rd),
                       jnp.asarray(tmax))
    o_t = tki.occluded(pt, st, T(ro), T(rd), T(tmax))
    assert o_t.shape == (n, 1) and o_t.dtype == torch.bool
    np.testing.assert_array_equal(np.asarray(o_j), o_t.numpy())
    assert torch.equal(tbrute.occluded(st, T(ro), T(rd), T(tmax)), o_t)
    assert 10 < int(o_t.sum()) < n


def _ray_rows(ro, rd, t_min=0.0, t_max=1e30):
    n = len(ro)
    rows = np.zeros((n, 8), np.float32)
    rows[:, 0:3], rows[:, 4:7] = ro, rd
    rows[:, 3], rows[:, 7] = t_min, t_max
    return rows


def _jax_closest(rows, prims):
    """The Pallas closest-hit kernel on explicit rows (rays padded to 128
    with rays that never hit, as its wrapper pads them)."""
    n = len(rows)
    pad = np.zeros(((-n) % jki.RBLK, 8), np.float32)
    pad[:, 7] = -1.0
    out = jki._closest_call(jnp.asarray(np.concatenate([rows, pad])),
                            jnp.asarray(prims))
    return np.asarray(out)[:n]


def test_equal_t_keeps_the_lowest_slot_within_and_across_tiles():
    """Two identical triangles 128 rows apart (two tiles) and two in one
    tile: the lower slot wins, in the port as in the Pallas kernel."""
    prims = np.zeros((384, 16), np.float32)
    tri = np.array([-1, -1, 0, 2, 0, 0, 0, 2, 0], np.float32)
    for slot in (5, 133, 261, 300):
        prims[slot, 0:9] = tri
    far = tri.copy()
    far[2] = -1.0                                     # a farther triangle
    prims[2, 0:9] = far
    ro = np.array([[-0.5, -0.5, 3.0], [0.2, -0.7, 1.0], [5, 5, 5]], np.float32)
    rd = np.array([[0, 0, -1.0]] * 3, np.float32)
    rows = _ray_rows(ro, rd)
    t, u, v, slot = tki.dense_closest(T(rows), T(prims))
    assert slot.dtype == torch.int32 and slot.tolist()[:2] == [5, 5]
    assert t.tolist() == [3.0, 1.0, np.float32(INF)]
    out_j = _jax_closest(rows, prims)
    np.testing.assert_array_equal(out_j[:, 3].astype(np.int32), slot.numpy())
    np.testing.assert_array_equal(out_j[:, 0], t.numpy())
    # Without slot 5 the tie is between tiles 1 and 2 (133 < 261 < 300).
    prims[5] = 0
    slot2 = tki.dense_closest(T(rows), T(prims))[3]
    assert slot2.tolist()[:2] == [133, 133]
    np.testing.assert_array_equal(
        _jax_closest(rows, prims)[:, 3].astype(np.int32), slot2.numpy())


def test_sphere_rows_report_zero_u_v_from_the_triangle_arithmetic(setups):
    """A sphere row has e2 = 0, so det = 0 and inv_det = 0: u = v = 0 comes
    out of the triangle branch with no special case."""
    _, _, st, pt = setups["spheres"]
    ro, rd = _box_rays(400, 11)
    h = tki.intersect(pt, st, T(ro), T(rd), torch.zeros((400, 1)),
                      torch.full((400, 1), 1e30))
    sph = h.hit[:, 0] & (h.prim >= st.n_tris)
    assert int(sph.sum()) > 20
    assert bool((h.u[sph] == 0).all()) and bool((h.v[sph] == 0).all())
    tri = h.hit[:, 0] & ~sph
    assert bool((h.u[tri] + h.v[tri] <= 1).all()) and bool((h.u[tri] >= 0).all())


def test_dead_rays_padding_rows_and_ranges(setups):
    _, _, st, pt = setups["mesh"]
    n = 256
    ro, rd = _box_rays(n, 13)
    tmin = torch.zeros((n, 1))
    tmax = torch.full((n, 1), 1e30)
    full = tki.intersect(pt, st, T(ro), T(rd), tmin, tmax)
    dead = tmax.clone()
    dead[::2] = -1.0                                  # t_max < t_min
    h = tki.intersect(pt, st, T(ro), T(rd), tmin, dead)
    assert not h.hit[::2].any() and torch.equal(h.hit[1::2], full.hit[1::2])
    assert not tki.occluded(pt, st, T(ro), T(rd), dead)[::2].any()
    # A range that ends just before the nearest hit: miss; just after: hit.
    t0 = full.t.clamp_max(1e29)
    assert not tki.occluded(pt, st, T(ro), T(rd), t0 * 0.999)[full.hit].any()
    assert tki.occluded(pt, st, T(ro), T(rd), t0 * 1.001)[full.hit].all()
    # Only padding rows: nothing hits, slot clamps into range.
    empty = tki.PallasScene(prims=torch.zeros((128, 16)), n_prims=1)
    h0 = tki.intersect(empty, st, T(ro), T(rd), tmin, tmax)
    assert not h0.hit.any() and bool((h0.prim == 0).all())
    assert bool((h0.t == INF).all())


def test_tile_loop_equals_one_dense_pass(setups):
    """closest_ref walks 128-row tiles with a shrinking range; one (R, P)
    pass over all rows with a first-lowest argmin picks the same winner."""
    _, _, _, pt = setups["mesh"]
    assert pt.prims.shape[0] >= 3 * tki.TBLK
    ro, rd = _box_rays(200, 17)
    rows = T(_ray_rows(ro, rd))
    t, u, v, slot = tki.closest_ref(rows, pt.prims)
    _, t_all, u_all, v_all = tki._pair_test(
        pt.prims, rows[:, 0:3], rows[:, 4:7], rows[:, 3:4], rows[:, 7:8])
    t_best = t_all.min(dim=1, keepdim=True).values
    P = pt.prims.shape[0]
    first = torch.where(t_all == t_best, torch.arange(P)[None, :], P) \
        .min(dim=1, keepdim=True).values
    hit = t_best[:, 0] < INF
    assert torch.equal(t, t_best[:, 0])
    assert torch.equal(slot[hit].long(), first[hit, 0])
    assert torch.equal(u[hit], torch.gather(u_all, 1, first)[hit, 0])
    assert torch.equal(v[hit], torch.gather(v_all, 1, first)[hit, 0])
    occ = tki.anyhit_ref(rows, pt.prims)
    assert torch.equal(occ > 0.5, hit)


def test_bad_shapes_and_dtypes_raise(setups):
    _, _, _, pt = setups["spheres"]
    rows = torch.zeros((10, 8))
    with pytest.raises(ValueError):
        tki.dense_closest(rows[:, :7], pt.prims)          # ray rows too short
    with pytest.raises(ValueError):
        tki.dense_closest(rows, pt.prims[:100])           # P % 128 != 0
    with pytest.raises(ValueError):
        tki.dense_anyhit(rows, pt.prims[:, :12])          # prim rows != 16
    with pytest.raises(TypeError):
        tki.dense_closest(rows.double(), pt.prims)
    with pytest.raises(TypeError):
        tki.dense_anyhit(rows, pt.prims.double())


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(setups):
    _, _, _, pt = setups["spheres"]
    ro, rd = _box_rays(130, 19)
    rows = T(_ray_rows(ro, rd, t_max=3.0))
    n4, n5 = tki.dense_closest.launches, tki.dense_anyhit.launches
    for a, b in zip(tki.dense_closest(rows, pt.prims),
                    tki.closest_ref(rows, pt.prims)):
        assert torch.equal(a, b)
    assert torch.equal(tki.dense_anyhit(rows, pt.prims),
                       tki.anyhit_ref(rows, pt.prims))
    assert (tki.dense_closest.launches, tki.dense_anyhit.launches) == (n4, n5)


@pytest.mark.gpu
def test_dense_kernels_match_plain_versions_on_the_card():
    """Needs an NVIDIA GPU and nvcc: both dense kernels bit for bit against
    their plain versions (the library is compiled with -fmad=false), ragged
    ray count, sphere and padding rows, dead rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    for var in ("spheres", "mesh"):
        pt = tki.PallasScene(tc.cornell(var)).to("cuda")
        ro, rd = _box_rays(1000, 23)
        rows = _ray_rows(ro, rd, t_max=1e30)
        rows[::9, 7] = -1.0
        rows = T(rows).cuda()
        for a, b in zip(tki.dense_closest(rows, pt.prims),
                        tki.closest_ref(rows, pt.prims)):
            assert torch.equal(a, b)
        rows[:, 7] = torch.where(rows[:, 7] > 0, 0.8, -1.0)
        assert torch.equal(tki.dense_anyhit(rows, pt.prims),
                           tki.anyhit_ref(rows, pt.prims))
    with pytest.raises(ValueError):                       # strided view refused
        tki.dense_closest(torch.zeros((64, 16), device="cuda")[:, :8], pt.prims)
