"""The BVH path that needs no native builder: the port's Python SAH builder
(bvh/sah.py::build_bvh), core/aabb.py, the octant packing
(bvh/packed.py::pack_bvh), native.build_packed_any and the cluster build's
fallback, and the flat walk (bvh/flat.py, kernels/flat_walk.py, backend
"bvh"), against tpu_pt and against the port's brute-force oracle.

Tolerances: trees, tables and primitive ids exact (the same numpy
arithmetic in both packages); hit mask and occlusion exact, hit t rtol 1e-5
/ atol 1e-6 and prim agreement > 0.99 (tests/test_bvh.py:97-117); images
rtol 2e-4 / atol 2e-5 against the JAX package, 1e-3 against another
intersector.  The walk's two designs (the row walk over
``bvh/flat.py::row_tables``, the thread walk over the arrays) share one
plain version, held bit for bit to itself across the two forms it reads;
the kernels themselves run only on the card (the ``gpu`` case)."""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.bvh import flat as jflat
from tpu_pt.bvh import native as jnative
from tpu_pt.bvh import packed as jpk
from tpu_pt.bvh import sah as jsah
from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.core import aabb as jaabb
from tpu_pt.render.driver import render as jrender
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt.scene import types as jt
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import flat as tflat
from tpu_pt_torch.bvh import native as tnative
from tpu_pt_torch.bvh import packed as tpk
from tpu_pt_torch.bvh import sah as tsah
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.core import aabb as taabb
from tpu_pt_torch.kernels import flat_walk as tfw
from tpu_pt_torch.render import brute as tbrute
from tpu_pt_torch.render import driver as tdriver
from tpu_pt_torch.render.driver import render as trender
from tpu_pt_torch.render.wavefront import (
    render_wavefront_counts, render_wavefront_suspect_counts)
from tpu_pt_torch.scene import types as tt
from tpu_pt_torch.tools import flat_chains, walk_edges

from torch_port_util import (T, assert_hits_equal, camera_dict,
                             hold_apart_to_witness, hold_occluded_to_witness,
                             rays, scene_dict, witness_scene)

SCENES = ("cornell", "mesh", "coincident", "spheres_only")


def _jax_scene(name):
    if name == "cornell":
        return jc.cornell("spheres")
    v, f = jm.icosphere(subdiv=2 if name == "mesh" else 1)
    sph = {}
    if name == "coincident":      # the first 12 faces twice, higher ids
        f = np.concatenate([f, f[:12]])
    if name == "spheres_only":    # 27 spheres: sphere-only leaves
        g = np.stack(np.meshgrid(*[np.linspace(-1.5, 1.5, 3)] * 3), -1)
        sph = dict(sph_center=g.reshape(-1, 3).astype(np.float32),
                   sph_radius=[0.3 + 0.01 * i for i in range(27)],
                   sph_mat=np.zeros(27, np.int32))
        f = f[:2]
    return jt.make_scene(v, f, np.zeros(len(f), np.int32),
                         jt.make_materials([dict(albedo=(0.5,) * 3)]),
                         jt.make_lights([]), **sph)


@pytest.fixture(scope="module")
def setups():
    """name -> (JAX scene, JAX FlatBVH, port host scene, port FlatBVH)."""
    out = {}
    for name in SCENES:
        sj = _jax_scene(name)
        st = convert.scene_from_numpy(scene_dict(sj), "cpu")
        out[name] = (sj, jsah.build_bvh(sj), st, tsah.build_bvh(st))
    return out


def _assert_flat_equal(bj, bt):
    for f in jsah.FlatBVH._fields:
        x, y = np.asarray(getattr(bj, f)), getattr(bt, f)
        y = y.numpy() if torch.is_tensor(y) else y
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(y, x, err_msg=f)


def _check_invariants(scene, bvh):
    """tests/test_bvh.py::_check_invariants on the port's tree."""
    lo, hi = (x.numpy() for x in tsah.prim_bounds(scene))
    n = bvh.n_nodes
    skip, start, count = bvh.skip, bvh.prim_start, bvh.prim_count
    ids = bvh.prim_ids
    assert sorted(ids.tolist()) == list(range(scene.n_prims))
    leaf = count > 0
    covered = np.zeros(scene.n_prims, bool)
    for i in np.where(leaf)[0]:
        seg = ids[start[i]:start[i] + count[i]]
        assert not covered[seg].any()
        covered[seg] = True
        assert np.all(bvh.node_min[i] <= lo[seg].min(axis=0) + 1e-6)
        assert np.all(bvh.node_max[i] >= hi[seg].max(axis=0) - 1e-6)
    assert covered.all()
    assert np.all(skip > np.arange(n)) and np.all(skip <= n)
    for i in np.where(~leaf)[0]:
        left, right = i + 1, skip[i + 1]
        assert right < skip[i] if skip[i] < n else right <= n
        for ch in (left, right):
            assert np.all(bvh.node_min[i] <= bvh.node_min[ch] + 1e-6)
            assert np.all(bvh.node_max[i] >= bvh.node_max[ch] - 1e-6)


@pytest.mark.parametrize("name", SCENES)
def test_build_bvh_equals_jax_array_for_array(setups, name):
    sj, bj, st, bt = setups[name]
    assert bt.n_nodes == bj.n_nodes
    _assert_flat_equal(bj, bt)
    _check_invariants(st, bt)
    dev = bt.to("cpu")
    assert torch.is_tensor(dev.skip) and dev.skip.is_contiguous()
    d = {f: np.asarray(getattr(bj, f)) for f in jsah.FlatBVH._fields}
    _assert_flat_equal(bj, convert.flat_bvh_from_numpy(d, "cpu"))


@pytest.mark.parametrize("leaf", [1, 8, 64])
def test_build_bvh_equals_jax_at_other_leaf_sizes(leaf):
    """Larger leaves and the split's tie paths (a 5k-triangle mesh)."""
    sj = jm.big_scene(subdiv=3)
    st = convert.scene_from_numpy(scene_dict(sj), "cpu")
    _assert_flat_equal(jsah.build_bvh(sj, max_leaf=leaf),
                       tsah.build_bvh(st, max_leaf=leaf))


def test_sah_split_ties_and_degenerate_extent_equal_jax():
    """Coincident centroids (zero extent: halves) and bins one side of
    which is empty (stable argsort halves) split as in the JAX package."""
    rs = np.random.RandomState(0)
    lo = rs.uniform(-1, 1, (40, 3)).astype(np.float32)
    hi = lo + rs.uniform(0, 0.2, (40, 3)).astype(np.float32)
    cent = (lo + hi) * 0.5
    ids = np.arange(40, dtype=np.int32)
    same = np.repeat(cent[:1], 40, 0)                 # zero extent
    two = cent.copy()
    two[:20] = cent[0]                                # two distinct points
    two[20:] = cent[1]
    for c in (cent, same, two):
        for got, want in zip(tsah._sah_split(ids, lo, hi, c),
                             jsah._sah_split(ids, lo, hi, c)):
            np.testing.assert_array_equal(got, want)


def test_aabb_matches_jax():
    rs = np.random.RandomState(1)
    ro, rd = rays(512, 2)
    rd[::7, 0] = 0.0
    rd[::11, 1] = -0.0
    lo = rs.uniform(-1, 0, (512, 3)).astype(np.float32)
    hi = lo + rs.uniform(0, 1, (512, 3)).astype(np.float32)
    ro[::7, 0] = lo[::7, 0]                           # on a slab: 0 * inf
    with np.errstate(divide="ignore"):
        inv = (1.0 / rd).astype(np.float32)
    t_min = np.zeros((512, 1), np.float32)
    t_max = np.full((512, 1), 3.0, np.float32)
    hj, nj = jaabb.slab_test(*(jnp.asarray(x) for x in
                               (ro, inv, lo, hi, t_min, t_max)))
    ht, nt = taabb.slab_test(*(T(x) for x in (ro, inv, lo, hi, t_min, t_max)))
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert 0 < ht.numpy().sum() < 512
    uj = jaabb.union(lo, hi, lo - 1, hi - 2)
    ut = taabb.union(T(lo), T(hi), T(lo - 1), T(hi - 2))
    for a, b in zip(ut, uj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(taabb.surface_area(T(lo), T(hi)).numpy(),
                               np.asarray(jaabb.surface_area(lo, hi)),
                               rtol=1e-6)


def _edge_rays(bvh, n, seed):
    """Seeded rays with the walk's edge cases mixed in: every other ray aims
    at a random point of a random leaf box; axis-parallel directions
    (components +0 and -0); origins ON a node box's face with the direction
    inside that face's plane (0 * inf = NaN in the slab test); t_max -1
    (leaves at the root) and 0.5."""
    ro, rd = rays(n, seed)
    rs = np.random.RandomState(seed + 1)
    lo, hi = np.asarray(bvh.node_min), np.asarray(bvh.node_max)
    leaves = np.flatnonzero(np.asarray(bvh.prim_count) > 0)
    pick = leaves[rs.randint(0, len(leaves), n)]
    aim = rs.uniform(lo[pick], np.maximum(hi[pick], lo[pick])) - ro
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    rd[1::2] = aim[1::2]
    axes = np.eye(3, dtype=np.float32)
    for i in range(0, n, 7):
        rd[i] = axes[i % 3] * (1 if i % 2 else -1)
        if i % 4 == 0:
            rd[i, (i + 1) % 3] = -0.0
    for i in range(5, n, 13):
        b = rs.randint(0, len(lo))
        ro[i] = rs.uniform(lo[b], np.maximum(hi[b], lo[b]))
        ax = i % 3
        ro[i, ax] = lo[b, ax]
        rd[i, ax] = 0.0
        if np.linalg.norm(rd[i]) < 1e-3:             # was along that axis
            rd[i, (ax + 1) % 3] = 1.0
        rd[i] /= np.linalg.norm(rd[i])
    t_min = np.zeros((n, 1), np.float32)
    t_max = np.full((n, 1), 1e30, np.float32)
    t_max[8::19] = 0.5
    t_max[::17] = -1.0
    return ro.astype(np.float32), rd.astype(np.float32), t_min, t_max


@pytest.mark.parametrize("name", SCENES)
def test_flat_intersect_matches_jax_and_brute(setups, name):
    sj, bj, st, bt = setups[name]
    btd = bt.to("cpu")
    ro, rd, t_min, t_max = _edge_rays(bt, 1024, 3)
    hj = jflat.intersect(bj, sj, *(jnp.asarray(x)
                                   for x in (ro, rd, t_min, t_max)))
    ht = tflat.intersect(btd, st, T(ro), T(rd), T(t_min), T(t_max),
                         rows=tflat.row_tables(btd, st))
    hb = tbrute.intersect(st, T(ro), T(rd), T(t_min), T(t_max))
    # The row walk's tables (the default design), and the thread walk's
    # gather form: the same bits.
    h_thread = tflat.intersect(btd, st, T(ro), T(rd), T(t_min), T(t_max),
                               design="thread")
    for a, b in zip(ht, h_thread):
        assert torch.equal(a, b)
    m = ht.hit.numpy()[:, 0]
    assert 50 < m.sum() < len(m)
    assert not m[::17].any()                          # t_max = -1
    assert ht.prim.dtype == torch.int32
    # Against the JAX package: hit mask exact and t within rtol 1e-5 but on
    # the rows where its sphere solve parts from the port's, which must be
    # the float64 witness's (the JAX package the farther one).
    t_t, t_j = ht.t.numpy()[:, 0], np.asarray(hj.t)[:, 0]
    apart = ~np.isclose(t_t, t_j, rtol=1e-5, atol=1e-6)
    n, _ = hold_apart_to_witness(apart, t_t, t_j,
                                 witness_scene(st, ro, rd, t_min, t_max))
    assert n <= len(t_t) // 100
    for ref, rows in ((hj, ~apart), (hb, slice(None))):
        np.testing.assert_array_equal(ht.hit.numpy()[rows],
                                      np.asarray(ref.hit)[rows])
        mm = m & ~apart if ref is hj else m
        np.testing.assert_allclose(ht.t.numpy()[mm], np.asarray(ref.t)[mm],
                                   rtol=1e-5, atol=1e-6)
        assert (ht.prim.numpy() == np.asarray(ref.prim))[m].mean() > 0.99


@pytest.mark.parametrize("name", SCENES)
def test_flat_occluded_matches_jax_and_brute(setups, name):
    sj, bj, st, bt = setups[name]
    ro, rd, _, t_max = _edge_rays(bt, 768, 4)
    t_max = np.where(t_max > 1.0, 2.0, t_max).astype(np.float32)
    oj = jflat.occluded(bj, sj, jnp.asarray(ro), jnp.asarray(rd),
                        jnp.asarray(t_max))
    ot = tflat.occluded(bt.to("cpu"), st, T(ro), T(rd), T(t_max),
                        rows=tflat.row_tables(bt.to("cpu"), st))
    assert torch.equal(ot, tflat.occluded(bt.to("cpu"), st, T(ro), T(rd),
                                          T(t_max), design="thread"))
    assert ot.dtype == torch.bool and tuple(ot.shape) == (768, 1)
    # Exact but on the rows where the sphere solves part (the witness's).
    assert hold_occluded_to_witness(ot.numpy(), np.asarray(oj), st, ro, rd,
                                    t_max) <= 768 // 100
    np.testing.assert_array_equal(
        ot.numpy(), tbrute.occluded(st, T(ro), T(rd), T(t_max)).numpy())
    assert 0 < int(ot.sum()) < 768


def test_coincident_triangles_take_the_lowest_id(setups):
    _, _, st, bt = setups["coincident"]
    v, f = np.asarray(st.vertices), np.asarray(st.tri_idx)
    c = v[f[:12]].mean(axis=1)
    ro = (c * 3.0).astype(np.float32)
    rd = (-c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    h = tflat.intersect(bt.to("cpu"), st, T(ro), T(rd), 0.0, 1e30)
    assert bool(h.hit.all())
    np.testing.assert_array_equal(h.prim.numpy(), np.arange(12))


def test_flat_walk_on_coplanar_faces_matches_brute_force():
    """The packed walk's coplanar case (``tests/test_torch_packed.py::
    test_walk_on_coplanar_faces_matches_brute_force``, where the widening
    is argued) for the flat walk: on the same 20,000 rays aimed up at the
    reduced atrium's crossing beams, the plain cull kept another primitive
    than brute force on 3, all at equal t.  Both forms of the plain walk
    (the row tables and the arrays) equal the port's brute force bitwise,
    the JAX brute force in hit and prim exactly and in t to 1e-6, and the
    JAX flat walk wherever that agrees with its brute force; any hit with
    t_max at brute force's t is occluded exactly where brute force hits.
    Prints how many rays the JAX flat walk keeps apart."""
    from torch_port_util import atrium_upward, atrium_upward_jax_brute

    sj, st, args, h_b = atrium_upward()
    jb_hit, jb_t, jb_prim = atrium_upward_jax_brute()
    bt = tsah.build_bvh(st).to("cpu")
    rows = tflat.row_tables(bt, st)
    R = args[0].shape[0]
    for form in (rows, None):
        h_f = tflat.intersect(bt, st, *args, rows=form)
        assert_hits_equal(h_f, h_b, "rows" if form else "arrays")
        assert torch.equal(tflat.occluded(bt, st, args[0], args[1], h_b.t,
                                          rows=form), h_b.hit)
    np.testing.assert_array_equal(h_f.hit.numpy(), jb_hit)
    m = jb_hit[:, 0]
    np.testing.assert_array_equal(h_f.prim.numpy()[m], jb_prim[m])
    np.testing.assert_allclose(h_f.t.numpy(), jb_t, rtol=1e-6, atol=1e-6)
    h_j = jflat.intersect(jsah.build_bvh(sj), sj,
                          *(jnp.asarray(x.numpy()) for x in args))
    j_hit, j_prim = np.asarray(h_j.hit), np.asarray(h_j.prim)
    agree = (j_hit == jb_hit)[:, 0] & (~m | (j_prim == jb_prim))
    np.testing.assert_array_equal(h_f.prim.numpy()[agree & m],
                                  j_prim[agree & m])
    np.testing.assert_allclose(h_f.t.numpy()[agree], np.asarray(h_j.t)[agree],
                               rtol=1e-6, atol=1e-6)
    print(f"coplanar faces: the JAX flat walk keeps {int((~agree).sum())} of "
          f"{R} rays apart from the JAX brute force; the port's walk 0")


def _grid(p0, ex, ey, n):
    """An n x n grid of quads (two triangles each) from corner p0 along
    edges ex, ey: (vertices (V, 3) f32, triangles (T, 3))."""
    p0, ex, ey = (np.asarray(x, np.float64) for x in (p0, ex, ey))
    i, j = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    v = p0 + i[..., None] / n * ex + j[..., None] / n * ey
    k = (i * (n + 1) + j)[:-1, :-1].reshape(-1)
    f = np.concatenate([np.stack([k, k + n + 1, k + n + 2], 1),
                        np.stack([k, k + n + 2, k + 1], 1)])
    return v.reshape(-1, 3).astype(np.float32), f


def _box(lo, hi, n):
    """An axis-aligned box, each face an n x n grid: six (v, f) parts."""
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    parts = []
    for ax in range(3):
        ea, eb = np.zeros(3), np.zeros(3)
        ea[(ax + 1) % 3] = (hi - lo)[(ax + 1) % 3]
        eb[(ax + 2) % 3] = (hi - lo)[(ax + 2) % 3]
        for side in (lo, hi):
            p0 = lo.copy()
            p0[ax] = side[ax]
            parts.append(_grid(p0, ea, eb, n))
    return parts


def _aimed(rs, n, o_lo, o_hi, at_lo, at_hi):
    """n rays from uniform origins in [o_lo, o_hi] towards uniform points of
    [at_lo, at_hi]."""
    ro = rs.uniform(o_lo, o_hi, (n, 3))
    rd = rs.uniform(at_lo, at_hi, (n, 3)) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def _coplanar_case(name, n=4096):
    """(port host scene, ro, rd) of one small coplanar construction.  Faces
    are grids, so that the BVHs (leaves of at most 4) split them over many
    leaves, and every ray hits."""
    rs = np.random.RandomState(7)
    if name == "crossing_beams":
        # Two beams crossing at right angles: their bottom faces overlap
        # in the crossing square at y = 1, hit from below at equal t.
        parts = _box((-2, 1, -.25), (2, 1.25, .25), 6) \
            + _box((-.25, 1, -2), (.25, 1.25, 2), 6)
        ro, rd = _aimed(rs, n, (-.6, 0, -.6), (.6, .8, .6), (-.25, 1, -.25),
                        (.25, 1, .25))
    elif name.startswith("coincident_quads"):
        # A 4 x 4 grid of quads on the top face of a box (the face of its
        # node box), its ids below or above the box's; hit from above.
        slab = _box((-1, 0, -1), (1, 1, 1), 6)
        quads = [_grid((-1, 1, -1), (0, 0, 2), (2, 0, 0), 4)]
        parts = quads + slab if name.endswith("lower_ids") else slab + quads
        ro, rd = _aimed(rs, n, (-1.5, 1.5, -1.5), (1.5, 3, 1.5), (-1, 1, -1),
                        (1, 1, 1))
    elif name == "axis_parallel_in_box_plane":
        # Two overlapping grids at y = 1 (8 x 8 and 6 x 6) over a box; rays
        # along +y (every fourth with a -0 component) whose origin lies on
        # a grid line, so in the plane of leaf boxes' faces (0 * inf = NaN
        # in that slab).
        parts = [_grid((-1, 1, -1), (0, 0, 2), (2, 0, 0), 8),
                 _grid((-1, 1, -1), (0, 0, 2), (2, 0, 0), 6)] \
            + _box((-1, 0, -1), (1, 1, 1), 3)
        ro = rs.uniform((-1, .05, -1), (1, .95, 1), (n, 3)).astype(np.float32)
        lines = np.concatenate([np.linspace(-1, 1, 9),
                                np.linspace(-1, 1, 7)]).astype(np.float32)
        ro[np.arange(n), np.where(np.arange(n) % 2, 2, 0)] = \
            lines[rs.randint(0, len(lines), n)]
        rd = np.zeros((n, 3), np.float32)
        rd[:, 1] = 1.0
        rd[::4, 0] = -0.0
    else:
        # one_ulp_inside_far_face: a 5 x 5 grid at y = 1 - 2^-24, one ulp
        # inside the top face of the box around it; rays from inside the
        # box upward reach it a ulp before the box's own top face.
        v, f = _grid((-1, 0, -1), (0, 0, 2), (2, 0, 0), 5)
        v[:, 1] = np.nextafter(np.float32(1), np.float32(0))
        parts = _box((-1, 0, -1), (1, 1, 1), 6) + [(v, f)]
        ro, rd = _aimed(rs, n, (-.9, .1, -.9), (.9, .7, .9), (-1, 1, -1),
                        (1, 1, 1))
    base = np.cumsum([0] + [len(v) for v, _ in parts])
    v = np.concatenate([v for v, _ in parts])
    f = np.concatenate([f + b for (_, f), b in zip(parts, base)])
    scene = tt.make_scene(v, f.astype(np.int32), np.zeros(len(f), np.int32),
                          tt.make_materials([dict(albedo=(0.5,) * 3)]),
                          tt.make_lights([]))
    return scene, ro, rd


# Each case fails with the plain cull (t_near <= min(t_far, best t)): in
# both walks on the closest hit (crossing beams, axis-parallel rays, one
# ulp inside: 50-480 of the 4,096 rays) and on the any hit at t_max = the
# nearest t (all five: about 1,000-1,500 rays).  Why the widening is
# enough: above tests/test_torch_packed.py::
# test_walk_on_coplanar_faces_matches_brute_force.
@pytest.mark.parametrize("walk", ["packed", "flat"])
@pytest.mark.parametrize("case", [
    "crossing_beams", "coincident_quads_lower_ids",
    "coincident_quads_higher_ids", "axis_parallel_in_box_plane",
    "one_ulp_inside_far_face"])
def test_walks_equal_brute_force_on_coplanar_constructions(case, walk):
    """Both forms of each plain walk (the packed walk's two designs; the
    flat walk's row tables and arrays) give brute force's (hit, prim, t,
    u, v) bit for bit on every ray of a small coplanar construction, and
    any hit, with t_max at brute force's nearest t and one ulp below it,
    brute force's occluded bit."""
    sh, ro, rd = _coplanar_case(case)
    st = sh.to("cpu")
    R = ro.shape[0]
    args = (T(ro), T(rd), torch.zeros((R, 1)), torch.full((R, 1), 1e30))
    h_b = tbrute.intersect(st, *args)
    assert bool(h_b.hit.all())
    if walk == "packed":
        pk = tnative.build_packed(sh).to("cpu")
        forms = {d: dict(design=d) for d in ("window", "thread")}
        closest = lambda kw: tpk.intersect(pk, st, *args, **kw)
        anyhit = lambda t_max, kw: tpk.occluded(pk, st, *args[:2], t_max,
                                                **kw)
    else:
        fb = tsah.build_bvh(sh).to("cpu")
        forms = {"rows": dict(rows=tflat.row_tables(fb, st)), "arrays": {}}
        closest = lambda kw: tflat.intersect(fb, st, *args, **kw)
        anyhit = lambda t_max, kw: tflat.occluded(fb, st, *args[:2], t_max,
                                                  **kw)
    below = torch.nextafter(h_b.t, torch.zeros_like(h_b.t))
    for form, kw in forms.items():
        assert_hits_equal(closest(kw), h_b, form)
        for t_max in (h_b.t, below):
            assert torch.equal(anyhit(t_max, kw),
                               tbrute.occluded(st, *args[:2], t_max)), form


@functools.lru_cache(maxsize=None)
def _skew_case():
    """``tools/walk_edges.py``'s skew-face scene and 4,096 rays aimed where
    its faces join, with the port's brute force of each; made once a
    process."""
    sh = walk_edges.skew_scene()
    ro, rd = walk_edges.edge_rays(sh, 4096)
    return sh, ro, rd, walk_edges.brute(sh.to("cpu"), T(ro), T(rd))


# The cull's bound is argued only for faces in an axis plane (above
# tests/test_torch_packed.py::test_walk_on_coplanar_faces_matches_brute_
# force).  A ray that meets skew faces where they join may hit one that it
# misses by a rounding and pass just outside the box holding it; on these
# 4,096 rays the cull of 2^-20 lost 2 any hits at t_max = brute force's t
# in both walks.  The widening it needs has no bound (``tools/
# walk_edges.py``); 2^-14 covers these rays 8x over.
@pytest.mark.parametrize("walk", ["packed", "flat"])
def test_walks_equal_brute_force_on_skew_faces(walk):
    """Both forms of each plain walk give brute force's (hit, prim, t, u, v)
    bit for bit on every ray of the skew-face case, and any hit, with t_max
    at brute force's nearest t and one ulp below it, brute force's occluded
    bit.  Prints the counts of rays that differ (all 0)."""
    sh, ro, rd, h_b = _skew_case()
    assert sh.n_tris == walk_edges.N_TRIS
    assert int(h_b.hit.sum()) > ro.shape[0] // 2
    got = walk_edges.count(sh, ro, rd, h_b, walks=(walk,))
    print(f"skew faces, rays that differ from brute force (closest, any "
          f"hit at t, a ulp below): {got}")
    assert len(got) == 2 and all(v == [0, 0, 0] for v in got.values()), got


# The rays of walk_edges.edge_rays(skew_scene(), 200000) whose flat-BVH
# ancestors need a widening past 2^-18 (``python -m tpu_pt_torch.tools.
# walk_edges --rays 200000 --need``: the tail of 35 rays, largest 9.727e-4
# for ray 149196), and those of them that 2^-14 leaves apart from brute
# force in every form of both walks: closest hit, any hit at t_max = brute
# force's t, a ulp below it.  Of all 200,000 rays no others differ.
SKEW_TAIL = [1797, 6801, 17535, 20331, 20937, 29088, 32088, 32541, 38073,
             40395, 53448, 60357, 66768, 67032, 71892, 91032, 96351, 98181,
             98679, 102036, 106167, 107823, 109833, 114240, 130347, 139596,
             139764, 149196, 156072, 167655, 189123, 189954, 191076, 191340,
             194268]
SKEW_APART = [[149196], [139596, 149196, 191340], []]


@pytest.mark.parametrize("walk", ["packed", "flat"])
def test_walks_keep_the_known_skew_residual(walk):
    """The open end of the cull's bound (``ROADMAP.md``'s standing
    contract): on the 200,000 skew rays' tail every form of the walk gives
    brute force's answer except on exactly ``SKEW_APART``; a narrower cull
    or another walk order changes the list."""
    sh = walk_edges.skew_scene()
    ro, rd = walk_edges.edge_rays(sh, 200000)
    got = walk_edges.differ(sh, ro[SKEW_TAIL], rd[SKEW_TAIL],
                            walks=(walk,))
    assert len(got) == 2
    for form, ids in got.items():
        assert [[SKEW_TAIL[i] for i in x] for x in ids] == SKEW_APART, form


def test_walk_stats_dead_rays_and_refusals(setups):
    """A ray with t_max < t_min fetches the root alone and reports (t_max,
    prim 0, 0, 0); the wrapper's CPU path is the plain version; the any-hit
    form tests no primitive after its first hit; bad operands raise."""
    _, _, st, bt = setups["cornell"]
    b = bt.to("cpu")
    ro, rd, t_min, t_max = _edge_rays(bt, 512, 8)
    args = (b.node_min, b.node_max, b.skip, b.prim_start, b.prim_count,
            b.prim_ids, st.tri_idx, st.vertices, st.sph_center, st.sph_radius,
            T(ro), T(rd), T(t_min[:, 0]), T(t_max[:, 0]), tsah.MAX_LEAF)
    stats = {}
    t, g, u, v = tfw.flat_walk_ref(*args, stats=stats)
    dead = t_max[:, 0] < 0
    assert (stats["steps"].numpy()[dead] == 1).all()
    assert (t.numpy()[dead] == -1.0).all() and (g.numpy()[dead] == 0).all()
    assert stats["iterations"] == int(stats["steps"].max())
    assert stats["prims_tri"] > 0 and stats["prims_sph"] > 0
    for a, b_ in zip(tfw.flat_walk(*args), (t, g, u, v)):
        assert torch.equal(a, b_)
    s_any = {}
    occ = tfw.flat_walk_ref(*args, any_hit=True, stats=s_any)
    assert torch.equal(occ, tfw.flat_walk(*args, any_hit=True))
    assert s_any["prims_tri"] + s_any["prims_sph"] \
        < stats["prims_tri"] + stats["prims_sph"]
    assert torch.equal(occ, t < T(t_max[:, 0]))
    with pytest.raises(TypeError, match="ro"):
        tfw.flat_walk(*args[:10], T(ro).double(), *args[11:])
    with pytest.raises(TypeError, match="skip"):
        tfw.flat_walk(*args[:2], b.skip.long(), *args[3:])
    with pytest.raises(ValueError, match="t_max"):
        tfw.flat_walk(*args[:13], torch.ones((512, 1)), *args[14:])
    with pytest.raises(ValueError, match="requires grad"):
        tfw.flat_walk(*args[:10], T(ro).requires_grad_(), *args[11:])


@pytest.mark.parametrize("name", ["cornell", "mesh", "spheres_only"])
def test_pack_bvh_equals_jax(setups, name):
    """Octant tables, primitive rows and gids of pack_bvh equal the JAX
    package's bit for bit, and the packed walk over them agrees with the
    flat walk."""
    sj, bj, st, bt = setups[name]
    pj = jpk.pack_bvh(bj, sj)
    pt = tpk.pack_bvh(bt, st)
    assert (pt.n_nodes, pt.n_tables, pt.max_leaf) == \
        (pj.n_nodes, pj.n_tables, pj.max_leaf)
    np.testing.assert_array_equal(pt.table.view(np.uint32),
                                  np.asarray(pj.table).view(np.uint32))
    np.testing.assert_array_equal(pt.prim_gid, np.asarray(pj.prim_gid))
    np.testing.assert_array_equal(
        tpk._subtree_sizes(bt.skip, bt.prim_count),
        jpk._subtree_sizes(np.asarray(bj.skip), np.asarray(bj.prim_count)))
    ro, rd = rays(512, 5)
    hp = tpk.intersect(pt.to("cpu"), st, T(ro), T(rd), 0.0, 1e30)
    hf = tflat.intersect(bt.to("cpu"), st, T(ro), T(rd), 0.0, 1e30)
    assert torch.equal(hp.hit, hf.hit)


def _no_native(monkeypatch):
    """The native library unavailable in both packages (nothing in tpu_pt
    is edited: its loader is monkeypatched)."""
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "lib_path",
                        lambda: "/nonexistent/libbvh_missing.so")

    def no_gxx(path):
        raise RuntimeError("g++ failed building native/bvh_builder.cpp:\n"
                           "g++: command not found")

    monkeypatch.setattr(tnative, "_build", no_gxx)


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_builds_without_the_native_library_equal_jax_fallbacks(
        name, monkeypatch):
    """Without g++ the port builds what the JAX package builds, with its
    Python SAH builder: the cluster BVH and build_packed_any, array for
    array, each with one warning naming the builder and the g++ error."""
    _no_native(monkeypatch)
    sj = _jax_scene(name)
    st = convert.scene_from_numpy(scene_dict(sj), "cpu")
    assert not tnative.available() and "g++" in tnative.load_error
    assert tnative.build_leaves(st, 8) is None
    assert tnative.build_packed(st) is None
    with pytest.warns(tnative.BuilderFallbackWarning,
                      match="Python SAH builder.*g\\+\\+ failed") as rec:
        ct = tcl.build_cluster_bvh(st, tile=8, dense_start=4)
    assert len(rec) == 1 and "cluster" in str(rec[0].message)
    cj = jcl.build_cluster_bvh(sj, tile=8, dense_start=4)
    assert ct.frontiers == cj.frontiers and ct.k_leaf == cj.k_leaf
    assert ct.pair_mults == cj.pair_mults
    for a, b in zip(ct.levels, cj.levels):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(ct.tiles, np.asarray(cj.tiles))
    np.testing.assert_array_equal(ct.tile_gid, np.asarray(cj.tile_gid))
    with pytest.warns(tnative.BuilderFallbackWarning, match="packed") as rec:
        pt = tnative.build_packed_any(st)
    assert len(rec) == 1
    pj = jnative.build_packed_any(sj)
    np.testing.assert_array_equal(pt.table.view(np.uint32),
                                  np.asarray(pj.table).view(np.uint32))
    np.testing.assert_array_equal(pt.prim_gid, np.asarray(pj.prim_gid))
    with pytest.warns(tnative.BuilderFallbackWarning):
        fb = tcl.attach_fallback(ct, st).fallback
    np.testing.assert_array_equal(fb.table, pt.table)


def test_native_build_warns_nothing():
    st = convert.scene_from_numpy(scene_dict(_jax_scene("cornell")), "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tcl.build_cluster_bvh(st, tile=8)
        tnative.build_packed_any(st)


def test_oracle_render_bvh_matches_jax_and_brute(setups):
    """The oracle renderer on backend "bvh" (tests/test_bvh.py:120-133
    analogue): against the JAX package's render on the same tree, and
    against the port's brute backend."""
    sj, bj, st, bt = setups["cornell"]
    kw = dict(width=16, height=16, spp=2, max_depth=3)
    camj = jc.camera(16, 16)
    camt = convert.camera_from_numpy(camera_dict(camj), "cpu")
    img_j = jrender(sj, camj, JConfig(**kw), jax.random.key(2),
                    backend="bvh", bvh=bj)
    img_t = trender(st, camt, TConfig(**kw), (0, 2), backend="bvh", bvh=bt,
                    device="cpu")
    assert np.isfinite(img_t.numpy()).all() and img_t.numpy().mean() > 0.05
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=2e-4,
                               atol=2e-5)
    img_b = trender(st, camt, TConfig(**kw), (0, 2), backend="brute",
                    device="cpu")
    np.testing.assert_allclose(img_t.numpy(), img_b.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_wavefront_bvh_matches_brute(setups):
    """The wavefront renderer runs backend "bvh": exact, so no overflow,
    and its image is the brute backend's within 2e-4 / 2e-5."""
    _, _, st, bt = setups["cornell"]
    cfg = TConfig(width=12, height=12, spp=2, max_depth=2)
    cam = convert.camera_from_numpy(camera_dict(jc.camera(12, 12)), "cpu")
    img, nc, ns, novf, steps = render_wavefront_counts(
        st, cam, cfg, (0, 4), bt, queue=128, backend="bvh", device="cpu")
    img_b, nc_b, ns_b, _, _ = render_wavefront_counts(
        st, cam, cfg, (0, 4), None, queue=128, backend="brute", device="cpu")
    assert novf == 0 and (nc, ns) == (nc_b, ns_b) and steps > 0
    np.testing.assert_allclose(img.numpy(), img_b.numpy(), rtol=2e-4,
                               atol=2e-5)
    _, _, _, _, _, sus = render_wavefront_suspect_counts(
        st, cam, cfg, (0, 4), bt, queue=128, backend="bvh", device="cpu")
    assert not bool(sus.any())                        # exact: never suspect


@pytest.mark.parametrize("name", SCENES)
def test_build_bvh_tables_skip_forward_and_leaves_skip_to_the_next_node(
        setups, name):
    """The row walk's two facts about a preorder table: every skip points
    forward inside the table, and a leaf's skip is its own index + 1."""
    _, _, _, bt = setups[name]
    n = bt.n_nodes
    idx = np.arange(n)
    assert np.all(bt.skip > idx) and np.all(bt.skip <= n)
    leaf = bt.prim_count > 0
    assert leaf.any() and np.all(bt.skip[leaf] == idx[leaf] + 1)
    tflat.check_preorder(bt.skip, bt.prim_count)          # does not raise


def test_row_tables_raise_on_a_table_the_row_walk_cannot_take(setups):
    _, _, st, bt = setups["cornell"]
    inner = int(np.flatnonzero(bt.prim_count == 0)[1])
    leaf = int(np.flatnonzero(bt.prim_count > 0)[0])
    for i, value, match in ((inner, inner, "is not in"),
                            (inner, bt.n_nodes + 1, "is not in"),
                            (leaf, leaf + 2, "not its index"),
                            (leaf, bt.n_nodes, "not its index")):
        skip = bt.skip.copy()
        skip[i] = value
        with pytest.raises(ValueError, match=match):
            tflat.row_tables(bt._replace(skip=skip), st)


@pytest.mark.parametrize("name", SCENES)
def test_row_tables_hold_the_arrays_bits(setups, name):
    """Node rows are the box, link (skip or prim_start) and count bits;
    primitive rows are v0, v1 - v0, v2 - v0 (one f32 rounding each), the
    material bits and type 0, or a sphere's centre, radius, material bits
    and type 1, in prim_ids order with the ids beside them."""
    _, _, st, bt = setups[name]
    rows = tflat.row_tables(bt.to("cpu"), st)
    nr = rows.node_rows.numpy()
    assert nr.shape == (bt.n_nodes, 8) and nr.dtype == np.float32
    bits = nr.view(np.int32)
    np.testing.assert_array_equal(bits[:, 0:3], bt.node_min.view(np.int32))
    np.testing.assert_array_equal(bits[:, 3:6], bt.node_max.view(np.int32))
    leaf = bt.prim_count > 0
    np.testing.assert_array_equal(
        bits[:, 6], np.where(leaf, bt.prim_start, bt.skip))
    np.testing.assert_array_equal(bits[:, 7], bt.prim_count)
    v, ti = np.asarray(st.vertices), np.asarray(st.tri_idx)
    T_ = ti.shape[0]
    g = bt.prim_ids
    np.testing.assert_array_equal(rows.prim_gid.numpy(), g)
    pr = rows.prim_rows.numpy()
    assert pr.shape == (len(g), 16)
    tri = g < T_
    v0 = v[ti[g[tri], 0]]
    want = np.concatenate([v0, v[ti[g[tri], 1]] - v0, v[ti[g[tri], 2]] - v0],
                          axis=1)
    np.testing.assert_array_equal(pr[tri, 0:9].view(np.int32),
                                  want.view(np.int32))
    np.testing.assert_array_equal(pr[tri, 9].view(np.int32),
                                  np.asarray(st.tri_mat)[g[tri]])
    np.testing.assert_array_equal(pr[tri, 10], 0.0)
    s_id = g[~tri] - T_
    np.testing.assert_array_equal(pr[~tri, 0:3],
                                  np.asarray(st.sph_center)[s_id])
    np.testing.assert_array_equal(pr[~tri, 3],
                                  np.asarray(st.sph_radius)[s_id])
    np.testing.assert_array_equal(pr[~tri, 10], 1.0)
    if name in ("cornell", "spheres_only"):
        assert (~tri).any()


def _walk_args(b, st, ro, rd, t_min, t_max):
    return (b.node_min, b.node_max, b.skip, b.prim_start, b.prim_count,
            b.prim_ids, st.tri_idx, st.vertices, st.sph_center, st.sph_radius,
            T(ro), T(rd), T(t_min[:, 0]), T(t_max[:, 0]), tsah.MAX_LEAF)


@pytest.mark.parametrize("name", SCENES)
def test_row_form_of_the_plain_walk_equals_the_gather_form(setups, name):
    """The plain walk over the row tables gives the gather form's bits and
    counts (the same nodes, leaves and primitives), closest and any hit, on
    the edge rays.  (Against the JAX package: the two tests above, whose
    port side walks the row tables.)"""
    _, _, st, bt = setups[name]
    b = bt.to("cpu")
    rows = tflat.row_tables(b, st)
    ro, rd, t_min, t_max = _edge_rays(bt, 512, 12)
    args = _walk_args(b, st, ro, rd, t_min, t_max)
    for any_hit in (False, True):
        s_g, s_r = {}, {}
        out_g = tfw.flat_walk_ref(*args, any_hit=any_hit, stats=s_g)
        out_r = tfw.flat_walk_ref(*args, any_hit=any_hit, stats=s_r,
                                  rows=rows)
        for x, y in zip((out_g,) if any_hit else out_g,
                        (out_r,) if any_hit else out_r):
            assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                               else x, y.view(torch.int32)
                               if y.is_floating_point() else y)
        for k in ("steps", "leaves", "prims", "node_seen", "prim_seen"):
            assert torch.equal(s_g[k], s_r[k]), k
        assert (s_g["prims_tri"], s_g["prims_sph"], s_g["iterations"]) == \
            (s_r["prims_tri"], s_r["prims_sph"], s_r["iterations"])
        assert int(s_r["leaves"].sum()) > 0
        assert torch.equal(s_r["prims"].sum(),
                           torch.tensor(s_r["prims_tri"] + s_r["prims_sph"]))


def test_row_walk_takes_the_lowest_id_of_coincident_triangles(setups):
    _, _, st, bt = setups["coincident"]
    v, f = np.asarray(st.vertices), np.asarray(st.tri_idx)
    c = v[f[:12]].mean(axis=1)
    ro = (c * 3.0).astype(np.float32)
    rd = (-c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    b = bt.to("cpu")
    h = tflat.intersect(b, st, T(ro), T(rd), 0.0, 1e30,
                        rows=tflat.row_tables(b, st))
    assert bool(h.hit.all())
    np.testing.assert_array_equal(h.prim.numpy(), np.arange(12))


def test_walk_design_is_validated_and_both_run_the_plain_walk_on_the_cpu(
        setups):
    """design= is checked by every entry (the wrapper, flat.intersect /
    occluded / intersectors, render.driver's closures); on CPU tensors both
    designs run the plain version, launch nothing, and the counts wrapper
    returns its statistics."""
    _, _, st, bt = setups["cornell"]
    b = bt.to("cpu")
    rows = tflat.row_tables(b, st)
    ro, rd, t_min, t_max = _edge_rays(bt, 256, 14)
    args = _walk_args(b, st, ro, rd, t_min, t_max)
    with pytest.raises(ValueError, match="unknown design"):
        tfw.flat_walk(*args, design="window")
    for call in (lambda: tflat.intersect(b, st, T(ro), T(rd), 0.0, 1e30,
                                         design="warp"),
                 lambda: tflat.occluded(b, st, T(ro), T(rd), 1.0,
                                        design="warp"),
                 lambda: tflat.intersectors(b, design="warp"),
                 lambda: tdriver._intersectors("bvh", b, design="warp")):
        with pytest.raises(ValueError, match="unknown design"):
            call()
    n0 = (tfw.flat_walk.launches, tfw.flat_walk.thread_launches,
          tfw.flat_walk_counts.launches)
    want = tfw.flat_walk_ref(*args)
    for design in tfw.DESIGNS:
        for r in (rows, None):
            for x, y in zip(tfw.flat_walk(*args, design=design, rows=r),
                            want):
                assert torch.equal(x, y), design
    stats = {}
    occ = tfw.flat_walk_ref(*args, any_hit=True, stats=stats)
    got = tfw.flat_walk_counts(*args, any_hit=True, rows=rows)
    assert torch.equal(got["out"], occ)
    for k in ("steps", "leaves", "prims", "node_seen", "prim_seen"):
        assert torch.equal(got[k], stats[k]), k
    assert (tfw.flat_walk.launches, tfw.flat_walk.thread_launches,
            tfw.flat_walk_counts.launches) == n0
    with pytest.raises(ValueError, match="node_rows"):
        tfw.flat_walk(*args, rows=rows._replace(
            node_rows=rows.node_rows[:, :6]))
    with pytest.raises(TypeError, match="prim_gid"):
        tfw.flat_walk(*args, rows=rows._replace(
            prim_gid=rows.prim_gid.long()))


def test_intersectors_build_the_row_tables_once_per_scene(setups,
                                                          monkeypatch):
    """A renderer hands every call a detached view of one scene: the row
    tables are built at the first call only, and again for other arrays or
    arrays changed in place."""
    _, _, st, bt = setups["cornell"]
    b = bt.to("cpu")
    built = []
    real = tflat.row_tables
    monkeypatch.setattr(tflat, "row_tables",
                        lambda *a: built.append(1) or real(*a))
    isect, occl = tdriver._intersectors("bvh", b)
    ro, rd = rays(64, 15)
    for _ in range(3):
        isect(st.detach(), T(ro), T(rd), 0.0, 1e30)
        occl(st.detach(), T(ro), T(rd), 1.0)
    assert len(built) == 1
    moved = st._replace(vertices=st.vertices + 0.0)
    h = isect(moved, T(ro), T(rd), 0.0, 1e30)
    assert len(built) == 2
    moved.vertices.mul_(1.0)                # same memory, a new version
    isect(moved.detach(), T(ro), T(rd), 0.0, 1e30)
    assert len(built) == 3
    isect_t, _ = tdriver._intersectors("bvh", b, design="thread")
    isect_p, _ = tdriver._intersectors("bvh", b, use_kernels=False)
    for other in (isect_t, isect_p):
        assert torch.equal(other(st, T(ro), T(rd), 0.0, 1e30).t, h.t)
    assert len(built) == 3


def test_flat_chains_counts_a_small_render():
    """tools/flat_chains at 8² spp 2 on the Cornell box with a coarse
    mesh: ten batches (closest and shadow per depth), a row walk's chain
    never longer than the thread walk's, and the lane efficiency of a warp
    of equal rays is 1."""
    lines = flat_chains.main(["--device", "cpu", "--size", "8", "--spp",
                              "2", "--mesh-subdiv", "1"])
    assert [ln["batch"] for ln in lines] == [
        f"{kind}_{d}" for d in range(5) for kind in ("closest", "shadow")]
    for ln in lines:
        assert ln["rays"] == 128 and 0 < ln["lane_efficiency"] <= 1
        assert ln["chain_rows"]["max"] <= ln["chain_thread"]["max"]
        assert ln["steps"]["max"] <= ln["chain_rows"]["max"]
    assert flat_chains.lane_efficiency(torch.full((64,), 7)) == 1.0
    steps = torch.zeros(32, dtype=torch.long)
    steps[0] = 10
    assert flat_chains.lane_efficiency(steps) == 10 / 320


@pytest.mark.gpu
def test_flat_walk_matches_plain_version_on_the_card(setups):
    """Needs an NVIDIA GPU and nvcc: both designs of the flat walk kernel
    bit for bit against their plain version and against each other,
    closest and any hit, on the edge rays of every test scene and on a
    batch where nothing walks, with each design's launches counted; and the
    row walk's STATS form against the plain walk's statistics."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n0 = tfw.flat_walk.launches
    t0 = tfw.flat_walk.thread_launches
    c0 = tfw.flat_walk_counts.launches
    for name in SCENES:
        _, _, st, bt = setups[name]
        b, s = bt.to("cuda"), st.to("cuda")
        rows = tflat.row_tables(b, s)
        ro, rd, t_min, t_max = _edge_rays(bt, 3000, 10)
        for dead in (False, True):
            if dead:
                t_max = np.full_like(t_max, -1.0)
            args = (b.node_min, b.node_max, b.skip, b.prim_start,
                    b.prim_count, b.prim_ids, s.tri_idx, s.vertices,
                    s.sph_center, s.sph_radius, T(ro).cuda(), T(rd).cuda(),
                    T(t_min[:, 0]).cuda(), T(t_max[:, 0]).cuda(),
                    tsah.MAX_LEAF)
            for any_hit in (False, True):
                want = tfw.flat_walk_ref(*args, any_hit=any_hit)
                for design in tfw.DESIGNS:
                    got = tfw.flat_walk(*args, any_hit=any_hit,
                                        design=design, rows=rows)
                    for x, y in zip((got,) if any_hit else got,
                                    (want,) if any_hit else want):
                        assert torch.equal(x, y), (name, design, any_hit)
            stats = {}
            tfw.flat_walk_ref(*args, stats=stats)
            got = tfw.flat_walk_counts(*args, rows=rows)
            for k in ("steps", "leaves", "prims", "node_seen", "prim_seen"):
                assert torch.equal(got[k], stats[k]), (name, k)
        with pytest.raises(ValueError, match="row tables"):
            tfw.flat_walk(*args)
        with pytest.raises(ValueError, match="row tables"):
            tflat.intersect(b, s, T(ro).cuda(), T(rd).cuda(), 0.0, 1e30)
    assert tfw.flat_walk.launches == n0 + 4 * len(SCENES)
    assert tfw.flat_walk.thread_launches == t0 + 4 * len(SCENES)
    assert tfw.flat_walk_counts.launches == c0 + 2 * len(SCENES)
    attrs = tfw.rows_kernel_attrs(False)
    assert attrs["registers"] > 0 and attrs["blocks_per_sm"] > 0
