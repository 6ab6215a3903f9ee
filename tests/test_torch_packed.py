"""The packed BVH of the port (bvh/packed.py, bvh/native.py::build_packed,
kernels/packed_walk.py, backend "packed") against tpu_pt.bvh.packed and
tpu_pt.bvh.native, and against the port's brute-force oracle; the window
design of the walk kernel through a per-ray emulation of it, against the
plain walk bit for bit.

Tolerances: tables, primitive ids per slot and hit masks exact (both
packages build with the same C++ source); hit t rtol/atol 1e-6 with prim
agreement > 0.99 (tests/test_cluster.py:168-173); images rtol 2e-4 / atol
2e-5.  The kernel itself runs only on the card (the ``gpu`` case)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import native as jnative
from tpu_pt.bvh import packed as jpk
from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.render.driver import render as jrender
from tpu_pt.render.wavefront import render_wavefront as jrender_wavefront
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt.scene import types as jt
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import native as tnative
from tpu_pt_torch.bvh import packed as tpk
from tpu_pt_torch.bvh import sah as tsah
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.kernels import packed_walk as tpw
from tpu_pt_torch.render import brute as tbrute
from tpu_pt_torch.render.driver import render as trender
from tpu_pt_torch.render.wavefront import render_wavefront as trender_wavefront
from tpu_pt_torch.tools.sphere_edges import as_float64, solve64

from torch_port_util import (T, camera_dict, hold_apart_to_witness,
                             hold_occluded_to_witness, rays, scene_dict,
                             witness_scene)


def _coincident_scene(mod_t, mod_m):
    """An icosphere whose first 12 faces are there twice (the copies have
    the higher primitive ids): coincident triangles, hit at the same t."""
    v, f = mod_m.icosphere(subdiv=1)
    f = np.concatenate([f, f[:12]])
    return mod_t.make_scene(v, f, np.zeros(len(f), np.int32),
                            mod_t.make_materials([dict(albedo=(0.5,) * 3)]),
                            mod_t.make_lights([]))


def _scenes(name):
    """(JAX scene, port host scene) holding the very same arrays."""
    if name == "coincident":
        sj = _coincident_scene(jt, jm)
    else:
        sj = jc.cornell(name)
    return sj, convert.scene_from_numpy(scene_dict(sj), "cpu")


def packed_dict(pk) -> dict:
    return dict(table=np.asarray(pk.table), prim_gid=np.asarray(pk.prim_gid),
                max_leaf=pk.max_leaf, n_tables=pk.n_tables,
                n_nodes=pk.n_nodes)


@pytest.fixture(scope="module")
def setups():
    """name -> (jax scene, jax packed, port scene, port packed from the
    JAX tables)."""
    out = {}
    for name in ("mesh", "spheres", "coincident"):
        sj, st = _scenes(name)
        pj = jnative.build_packed(sj)
        out[name] = (sj, pj, st,
                     convert.packed_bvh_from_numpy(packed_dict(pj), "cpu"))
    return out


def _edge_rays(packed, n, seed):
    """Seeded rays with the walk's edge cases mixed in: axis-parallel
    directions (components +0 and -0), origins ON a node box's face with the
    direction inside that face's plane (0 * inf = NaN in the slab test),
    t_max = -1 (must leave at the root) and short t_max."""
    ro, rd = rays(n, seed)
    rs = np.random.RandomState(seed + 1)
    boxes = packed.node_rows()[0]
    # Every other ray aims at a random point of a random leaf box (not its
    # centre: that lies on the diagonal of a quad's two triangles).
    leaves = boxes[boxes[:, 7].view(np.int32) >= 0]
    pick = leaves[rs.randint(0, len(leaves), n)]
    aim = rs.uniform(pick[:, 0:3], np.maximum(pick[:, 3:6], pick[:, 0:3])) - ro
    aim /= np.linalg.norm(aim, axis=1, keepdims=True)
    rd[1::2] = aim[1::2]
    axes = np.eye(3, dtype=np.float32)
    for i in range(0, n, 7):
        rd[i] = axes[i % 3] * (1 if i % 2 else -1)
        if i % 4 == 0:
            rd[i, (i + 1) % 3] = -0.0
    for i in range(5, n, 13):
        b = boxes[rs.randint(0, len(boxes))]
        ro[i] = rs.uniform(b[0:3], np.maximum(b[3:6], b[0:3]))
        ax = i % 3
        ro[i, ax] = b[ax]                          # on the min face
        rd[i, ax] = 0.0                            # inside its plane
        rd[i] /= max(np.linalg.norm(rd[i]), 1e-6)
    t_min = np.zeros((n, 1), np.float32)
    t_max = np.full((n, 1), 1e30, np.float32)
    t_max[8::19] = 0.5
    t_max[::17] = -1.0
    return ro, rd, t_min, t_max


@pytest.mark.parametrize("name", ["mesh", "spheres"])
def test_native_build_packed_equals_jax_bitwise(name):
    """The port's own build of the C++ source gives the JAX package's
    tables bit for bit (the skip / meta columns are integers viewed as f32,
    so the check compares bit patterns)."""
    sj, st = _scenes(name)
    pj = jnative.build_packed(sj)
    pt = tnative.build_packed(st)
    assert (pt.n_nodes, pt.n_tables, pt.max_leaf) == \
        (pj.n_nodes, pj.n_tables, pj.max_leaf)
    np.testing.assert_array_equal(pt.table.view(np.uint32),
                                  np.asarray(pj.table).view(np.uint32))
    np.testing.assert_array_equal(pt.prim_gid, np.asarray(pj.prim_gid))
    assert pt.prim_gid.dtype == np.int32 and pt.table.dtype == np.float32
    assert pt.prim_base == pj.prim_base and pt.n_prims == pj.n_prims
    np.testing.assert_array_equal(pt.node_rows().view(np.uint32),
                                  pj.node_rows().view(np.uint32))
    dev = pt.to("cpu")
    assert torch.is_tensor(dev.table) and dev.table.is_contiguous()
    np.testing.assert_array_equal(dev.node_rows().view(np.uint32),
                                  pj.node_rows().view(np.uint32))
    assert dev.to("cpu").table is dev.table          # already there: no copy


@pytest.mark.parametrize("name", ["mesh", "spheres", "coincident"])
def test_intersect_matches_jax(setups, name):
    sj, pj, st, pt = setups[name]
    ro, rd, t_min, t_max = _edge_rays(pt, 2048, 3)
    hj = jpk.intersect(pj, sj, jnp.asarray(ro), jnp.asarray(rd),
                       jnp.asarray(t_min), jnp.asarray(t_max))
    ht = tpk.intersect(pt, st, T(ro), T(rd), T(t_min), T(t_max))
    # Hit mask exact and t within 1e-6 but on the rows where the JAX
    # package's sphere solve parts from the port's: there the port must be
    # the float64 witness's and the JAX package the farther one.
    t_t, t_j = ht.t.numpy()[:, 0], np.asarray(hj.t)[:, 0]
    apart = ~np.isclose(t_t, t_j, rtol=1e-6, atol=1e-6)
    n, _ = hold_apart_to_witness(apart, t_t, t_j,
                                 witness_scene(st, ro, rd, t_min, t_max))
    assert n <= len(t_t) // 100
    m = ht.hit.numpy()[:, 0]
    np.testing.assert_array_equal(m[~apart], np.asarray(hj.hit)[~apart, 0])
    assert 50 < m.sum() < len(m)
    np.testing.assert_allclose(t_t[m & ~apart], t_j[m & ~apart], rtol=1e-6,
                               atol=1e-6)
    assert (ht.prim.numpy() == np.asarray(hj.prim))[m].mean() > 0.99
    assert ht.prim.dtype == torch.int32
    assert not ht.hit.numpy()[::17].any()             # t_max = -1


@pytest.mark.parametrize("name", ["mesh", "spheres", "coincident"])
def test_occluded_matches_jax(setups, name):
    sj, pj, st, pt = setups[name]
    ro, rd, _, t_max = _edge_rays(pt, 768, 4)
    t_max = np.where(t_max > 1.0, 2.0, t_max).astype(np.float32)
    oj = jpk.occluded(pj, sj, jnp.asarray(ro), jnp.asarray(rd),
                      jnp.asarray(t_max))
    ot = tpk.occluded(pt, st, T(ro), T(rd), T(t_max))
    assert ot.dtype == torch.bool and tuple(ot.shape) == (768, 1)
    # Exact but on the rows where the sphere solves part (the witness's).
    assert hold_occluded_to_witness(ot.numpy(), np.asarray(oj), st, ro, rd,
                                    t_max) <= 768 // 100
    assert 0 < int(ot.sum()) < 768


def test_prim_row_test_and_octant_match_jax():
    """The row test on mixed triangle / sphere / padding rows and random
    ranges: hit mask exact, t within 1e-6, but on sphere rows where the JAX
    package's solve parts from the port's, which must be the float64
    witness's; the octant index exact."""
    rs = np.random.RandomState(5)
    R = 2048
    rows = np.zeros((R, 16), np.float32)
    rows[:, 0:9] = rs.uniform(-1, 1, (R, 9))
    sph = rs.rand(R) < 0.3
    rows[sph, 3] = rs.uniform(0.2, 1.0, sph.sum())
    rows[sph, 4:9] = 0.0
    rows[sph, 10] = 1.0
    rows[::23] = 0.0                                  # padding rows
    ro, rd = rays(R, 6)
    # Most rays aim near the row's triangle centroid or sphere centre.
    aim = rows[:, 0:3] + np.where(sph[:, None], 0.0,
                                  (rows[:, 3:6] + rows[:, 6:9]) / 3)
    aim += rs.normal(0, 0.2, (R, 3))
    to = aim - ro
    rd = np.where(rs.rand(R, 1) < 0.8,
                  to / np.linalg.norm(to, axis=1, keepdims=True),
                  rd).astype(np.float32)
    t_min = np.zeros((R, 1), np.float32)
    t_max = rs.uniform(0.5, 8, (R, 1)).astype(np.float32)
    active = (rs.rand(R, 1) < 0.9)
    a = jpk._prim_row_test(jnp.asarray(rows), jnp.asarray(active),
                           jnp.asarray(ro), jnp.asarray(rd),
                           jnp.asarray(t_min), jnp.asarray(t_max))
    b = tpk._prim_row_test(T(rows), T(active), T(ro), T(rd), T(t_min),
                           T(t_max))
    h = b[0].numpy()[:, 0]
    t_t, t_j = b[1].numpy()[:, 0], np.asarray(a[1])[:, 0]
    apart = ~np.isclose(t_t, t_j, rtol=1e-6, atol=1e-6)
    t_w = np.where(sph & active[:, 0], solve64(
        ro, rd, rows[:, 0:3], rows[:, 3], t_min[:, 0], t_max[:, 0]),
        np.where(h, t_t, np.inf))
    n, _ = hold_apart_to_witness(apart, t_t, t_j, t_w)
    assert n <= R // 100 and not (apart & ~sph).any()
    np.testing.assert_array_equal(h[~apart], np.asarray(a[0])[~apart, 0])
    assert 100 < h.sum() < R and (h & sph).any()
    np.testing.assert_allclose(t_t[h & ~apart], t_j[h & ~apart], rtol=1e-6,
                               atol=1e-6)
    for x, y in zip(b[2:], a[2:]):    # u, v: as for the pair kernels (PR 1)
        np.testing.assert_allclose(x.numpy()[h], np.asarray(y)[h], rtol=1e-4,
                                   atol=1e-5)
    assert (b[2].numpy()[sph] == 0).all()             # u = 0 on spheres
    rd[::5, 0] = -0.0
    np.testing.assert_array_equal(tpk._octant_of(T(rd)).numpy(),
                                  np.asarray(jpk._octant_of(jnp.asarray(rd))))


@pytest.mark.parametrize("name", ["mesh", "spheres", "coincident"])
def test_packed_matches_the_ports_brute_oracle(name):
    """The port's own tables (its native build) against its brute backend
    (tests/test_packed.py:36-57): hit mask and occlusion exact, t to 1e-5 /
    1e-6, prim on > 0.99 of hits."""
    _, st = _scenes(name)
    pt = tnative.build_packed(st).to("cpu")
    ro, rd = rays(1024, 7)
    t_min = torch.zeros((1024, 1))
    t_max = torch.full((1024, 1), 1e30)
    hb = tbrute.intersect(st, T(ro), T(rd), t_min, t_max)
    hp = tpk.intersect(pt, st, T(ro), T(rd), t_min, t_max)
    assert torch.equal(hb.hit, hp.hit)
    m = hb.hit[:, 0]
    torch.testing.assert_close(hp.t[m], hb.t[m], rtol=1e-5, atol=1e-6)
    assert float((hb.prim == hp.prim)[m].float().mean()) > 0.99
    t2 = torch.full((1024, 1), 2.0)
    assert torch.equal(tbrute.occluded(st, T(ro), T(rd), t2),
                       tpk.occluded(pt, st, T(ro), T(rd), t2))


def test_coincident_triangles_take_the_lowest_gid(setups):
    """Rays at the centroids of the doubled faces hit both copies at one t:
    the walk names the lower id, as every backend of both packages does."""
    sj, _, st, pt = setups["coincident"]
    v, f = np.asarray(st.vertices), np.asarray(st.tri_idx)
    c = v[f[:12]].mean(axis=1)
    ro = (c * 3.0).astype(np.float32)
    rd = (-c / np.linalg.norm(c, axis=1, keepdims=True)).astype(np.float32)
    h = tpk.intersect(pt, st, T(ro), T(rd), torch.zeros((12, 1)),
                      torch.full((12, 1), 1e30))
    assert bool(h.hit.all())
    np.testing.assert_array_equal(h.prim.numpy(), np.arange(12))


def test_walk_stats_dead_rays_and_plain_path(setups):
    """A ray with t_max < t_min fetches the root and nothing else and
    reports (t_max, slot 0, 0, 0); the wrapper's CPU path is the plain
    version; the any-hit form tests no row after its first hit."""
    _, _, _, pt = setups["mesh"]
    ro, rd, t_min, t_max = _edge_rays(pt, 512, 8)
    args = (pt.table, pt.prim_gid, T(ro), T(rd), T(t_min[:, 0]),
            T(t_max[:, 0]), pt.n_nodes, pt.n_tables, pt.max_leaf)
    stats = {}
    t, slot, u, v = tpw.packed_walk_ref(*args, stats=stats)
    dead = t_max[:, 0] < 0
    assert (stats["steps"].numpy()[dead] == 1).all()
    assert (t.numpy()[dead] == -1.0).all() and (slot.numpy()[dead] == 0).all()
    assert stats["iterations"] == int(stats["steps"].max())
    assert stats["rows_tri"] > 0
    for a, b in zip(tpw.packed_walk(*args), (t, slot, u, v)):
        assert torch.equal(a, b)
    s_any = {}
    occ = tpw.packed_walk_ref(*args, any_hit=True, stats=s_any)
    assert torch.equal(occ, tpw.packed_walk(*args, any_hit=True))
    assert s_any["rows_tri"] < stats["rows_tri"]
    assert torch.equal(occ, (t < T(t_max[:, 0])))


def test_walk_refuses_bad_operands(setups):
    _, _, _, pt = setups["spheres"]
    ro, rd = rays(8, 9)
    ok = (pt.table, pt.prim_gid, T(ro), T(rd), torch.zeros(8),
          torch.ones(8), pt.n_nodes, pt.n_tables, pt.max_leaf)
    tpw.packed_walk(*ok)
    with pytest.raises(TypeError, match="ro"):
        tpw.packed_walk(*ok[:2], T(ro).double(), *ok[3:])
    with pytest.raises(TypeError, match="prim_gid"):
        tpw.packed_walk(ok[0], ok[1].long(), *ok[2:])
    with pytest.raises(ValueError, match="t_max"):
        tpw.packed_walk(*ok[:5], torch.ones((8, 1)), *ok[6:])
    with pytest.raises(ValueError, match="does not hold"):
        tpw.packed_walk(*ok[:6], pt.n_nodes + 1, *ok[7:])
    with pytest.raises(ValueError, match="CUDA"):
        from tpu_pt_torch.kernels import _build
        _build.check_cuda_input("table", pt.table, torch.float32)


def test_oracle_render_packed_matches_jax(setups):
    """The oracle renderer on backend "packed" (tests/test_packed.py:74-88
    analogue): against the JAX package's render of the same tables, and
    against the port's brute backend.  Pixels where the JAX package's
    sphere solve parts the two past rtol 2e-4 / atol 2e-5 are held to the
    port's float64 render instead (within 2e-5, the JAX package farther)."""
    sj, pj, st, pt = setups["spheres"]
    kw = dict(width=24, height=24, spp=4, max_depth=3)
    camj = jc.camera(24, 24)
    camt = convert.camera_from_numpy(camera_dict(camj), "cpu")
    img_j = jrender(sj, camj, JConfig(**kw), jax.random.key(2),
                    backend="packed", bvh=pj)
    img_t = trender(st, camt, TConfig(**kw), (0, 2), backend="packed",
                    bvh=pt, device="cpu")
    assert np.isfinite(img_t.numpy()).all() and img_t.numpy().mean() > 0.05
    img_w = trender(as_float64(st), as_float64(camt), TConfig(**kw), (0, 2),
                    backend="brute", device="cpu").numpy()
    a, j = img_t.numpy(), np.asarray(img_j)
    apart = ~np.isclose(a, j, rtol=2e-4, atol=2e-5)
    err, err_j = np.abs(a - img_w)[apart], np.abs(j - img_w)[apart]
    print(f"held to the float64 render: {int(apart.sum())} of {a.size} "
          f"values, largest |port - jax| {np.abs(a - j).max():.3g}, "
          f"|port - float64| {err.max(initial=0):.3g}, |jax - float64| "
          f"{err_j.max(initial=0):.3g}")
    assert apart.sum() <= a.size // 100
    assert (err <= 2e-5).all() and (err_j > err).all()
    img_b = trender(st, camt, TConfig(**kw), (0, 2), backend="brute",
                    device="cpu")
    np.testing.assert_allclose(img_t.numpy(), img_b.numpy(), rtol=1e-3,
                               atol=1e-3)


def test_wavefront_packed_matches_jax(setups):
    """The wavefront renderer on backend "packed" (tests/test_packed.py:
    91-100 analogue) against the JAX package's."""
    sj, pj, st, pt = setups["spheres"]
    kw = dict(width=16, height=16, spp=4, max_depth=2)
    camj = jc.camera(16, 16)
    camt = convert.camera_from_numpy(camera_dict(camj), "cpu")
    img_j = jrender_wavefront(sj, camj, JConfig(**kw), jax.random.key(3), pj,
                              queue=512, backend="packed")
    img_t = trender_wavefront(st, camt, TConfig(**kw), (0, 3), pt, queue=512,
                              backend="packed", device="cpu")
    assert np.isfinite(img_t.numpy()).all() and img_t.numpy().mean() > 0.05
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("builder", ["native", "pack_bvh"])
@pytest.mark.parametrize("name", ["mesh", "spheres", "coincident"])
def test_octant_tables_skip_forward_past_the_subtree(name, builder):
    """Every octant table is in preorder with skip just past the node's
    subtree: cursor < skip <= n for every node, an inner node's first child
    right after it, and its subtree [i, skip) closed (every skip inside it
    lands inside it or at its end).  The window design rests on this: the
    cursor only moves forward."""
    _, st = _scenes(name)
    pt = tnative.build_packed(st) if builder == "native" else \
        tpk.pack_bvh(tsah.build_bvh(st), st)
    n = pt.n_nodes
    rows = pt.node_rows()
    assert rows.shape[0] == 8
    i = np.arange(n)
    for k in range(pt.n_tables):
        skip = rows[k, :, 6].view(np.int32).astype(np.int64)
        meta = rows[k, :, 7].view(np.int32)
        assert (i < skip).all() and (skip <= n).all(), (k, name, builder)
        assert skip[0] == n
        inner = np.flatnonzero(meta < 0)
        # The left child's subtree ends where the right child starts, and
        # the right child's ends where the parent's does.
        right = skip[inner + 1]
        assert (right < skip[inner]).all() and (skip[right] == skip[inner]).all()
        assert ((meta >= 0) == (skip == i + 1)).all()


def _emulate_window_walk(pt, ro, rd, t_min, t_max, any_hit):
    """The window design of csrc/packed_walk.cu, one ray at a time: a
    window of WINDOW node rows loaded at the cursor, each row's slab entry
    and exit computed as one lane does, the walk resolved inside the window
    in order under the current best t (the bound widened as
    ``packed_walk.widen_up`` widens it), a leaf's rows tested together
    under the best t at the leaf (the port's row test) and reduced by (t,
    gid, row).  Returns the walk's outputs and, per ray, the windows it loaded,
    the nodes it resolved and the leaves it entered."""
    W = tpw.WINDOW
    table = pt.table.numpy()
    gid = pt.prim_gid.numpy()
    n, base_p = pt.n_nodes, pt.prim_base
    n_prims = gid.shape[0]
    R = ro.shape[0]
    out_t = t_max.copy()
    out_slot = np.zeros(R, np.int32)
    out_u = np.zeros(R, np.float32)
    out_v = np.zeros(R, np.float32)
    occ = np.zeros(R, bool)
    windows = np.zeros(R, np.int64)
    steps = np.zeros(R, np.int64)
    leaves = np.zeros(R, np.int64)
    one = np.float32(1.0)
    widen_up = np.float32(tpw._WIDEN_UP)
    widen_down = np.float32(tpw._WIDEN_DOWN)
    for r in range(R):
        o, d = ro[r], rd[r]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = one / d
        octant = int(d[0] < 0) + 2 * int(d[1] < 0) + 4 * int(d[2] < 0)
        nodes = table[(octant % pt.n_tables) * n:][:n]
        best_t, best_g = np.float32(t_max[r]), 2**31 - 1
        cursor = 0
        while cursor < n and not occ[r]:
            base = cursor
            windows[r] += 1
            w = nodes[base:base + W]
            with np.errstate(invalid="ignore", over="ignore"):
                lo = (w[:, 0:3] - o) * inv
                hi = (w[:, 3:6] - o) * inv
            near = np.minimum(lo, hi)
            far = np.maximum(lo, hi)
            near[np.isnan(near)] = -np.inf
            far[np.isnan(far)] = np.inf
            t_near = np.maximum(np.maximum(np.maximum(near[:, 0], near[:, 1]),
                                           near[:, 2]), t_min[r])
            t_far_slab = np.minimum(np.minimum(far[:, 0], far[:, 1]),
                                    far[:, 2])
            skip = w[:, 6].view(np.int32)
            meta = w[:, 7].view(np.int32)
            while cursor < n and cursor - base < W:
                j = cursor - base
                steps[r] += 1
                bound = np.fmin(t_far_slab[j], best_t)
                hit_bb = t_near[j] <= bound * (widen_down if bound < 0
                                               else widen_up)
                if hit_bb and meta[j] >= 0:
                    leaves[r] += 1
                    start = int(meta[j]) & ((1 << 26) - 1)
                    cnt = min(int(meta[j]) >> 26 & 63, pt.max_leaf)
                    slots = np.clip(start + np.arange(cnt), 0, n_prims - 1)
                    h, t, u, v = tpk._prim_row_test(
                        torch.from_numpy(table[base_p + slots]),
                        torch.ones((cnt, 1), dtype=torch.bool),
                        torch.from_numpy(np.tile(o, (cnt, 1))),
                        torch.from_numpy(np.tile(d, (cnt, 1))),
                        torch.full((cnt, 1), float(t_min[r])),
                        torch.full((cnt, 1), float(best_t)))
                    h, t = h.numpy()[:, 0], t.numpy()[:, 0]
                    g = gid[slots]
                    cand = h & ((t < best_t) | ((t == best_t) & (g < best_g)))
                    if any_hit and cand.any():
                        occ[r] = True
                        break
                    if cand.any():
                        k = np.flatnonzero(cand)
                        k = k[np.lexsort((k, g[k], t[k]))[0]]
                        best_t, best_g = t[k], int(g[k])
                        out_slot[r] = slots[k]
                        out_u[r], out_v[r] = u.numpy()[k, 0], v.numpy()[k, 0]
                cursor = cursor + 1 if (hit_bb and meta[j] < 0) else \
                    int(skip[j])
        out_t[r] = best_t
    return (occ if any_hit else (out_t, out_slot, out_u, out_v)), \
        windows, steps, leaves


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("name", ["spheres", "coincident"])
def test_window_walk_emulation_equals_the_plain_walk(setups, name, any_hit):
    """The window design's claim, on edge rays: resolving the walk inside a
    window of node rows under the current best t, and reducing a leaf's
    rows tested together under the best t at the leaf, gives the plain
    walk's outputs bit for bit, through the nodes and leaves the plain walk
    steps through, no more; a ray loads no more windows than the walk has
    node steps, and as many as the plain walk's count of them."""
    _, _, st, _ = setups[name]
    pt = tnative.build_packed(st).to("cpu")
    ro, rd, t_min, t_max = _edge_rays(pt, 300, 12)
    t_min, t_max = t_min[:, 0], t_max[:, 0]
    stats = {}
    want = tpw.packed_walk_ref(pt.table, pt.prim_gid, T(ro), T(rd), T(t_min),
                               T(t_max), pt.n_nodes, pt.n_tables, pt.max_leaf,
                               any_hit=any_hit, stats=stats)
    got, windows, steps_w, leaves_w = _emulate_window_walk(
        pt, ro, rd, t_min, t_max, any_hit)
    for a, b in zip((got,) if any_hit else got, (want,) if any_hit else want):
        b = b.numpy()
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32) if a.dtype ==
                                      np.float32 else a,
                                      b.view(np.int32) if b.dtype ==
                                      np.float32 else b)
    hits = got.sum() if any_hit else (got[0] < t_max).sum()
    assert 20 < hits < 300
    steps = stats["steps"].numpy()
    np.testing.assert_array_equal(windows, stats["windows"].numpy())
    np.testing.assert_array_equal(steps_w, steps)
    np.testing.assert_array_equal(leaves_w, stats["leaves"].numpy())
    assert (windows <= steps).all() and (windows >= 1).all()
    assert windows.sum() < steps.sum()
    assert (stats["leaves"].numpy() <= steps).all()


def test_walk_design_is_validated_and_both_run_the_plain_walk_on_the_cpu(
        setups):
    _, _, st, pt = setups["spheres"]
    ro, rd, t_min, t_max = _edge_rays(pt, 256, 13)
    args = (pt.table, pt.prim_gid, T(ro), T(rd), T(t_min[:, 0]),
            T(t_max[:, 0]), pt.n_nodes, pt.n_tables, pt.max_leaf)
    n0 = (tpw.packed_walk.launches, tpw.packed_walk.thread_launches)
    want = tpw.packed_walk_ref(*args)
    for design in tpw.DESIGNS:
        for a, b in zip(tpw.packed_walk(*args, design=design), want):
            assert torch.equal(a, b), design
        assert torch.equal(tpw.packed_walk(*args, any_hit=True, design=design),
                           tpw.packed_walk_ref(*args, any_hit=True))
        h = tpk.intersect(pt, st, T(ro), T(rd), T(t_min), T(t_max),
                          design=design)
        assert torch.equal(h.t, tpk.intersect(pt, st, T(ro), T(rd), T(t_min),
                                              T(t_max)).t)
        tpk.occluded(pt, st, T(ro), T(rd), T(t_max), design=design)
    assert (tpw.packed_walk.launches, tpw.packed_walk.thread_launches) == n0
    for bad in ("warp", "Window", None):
        with pytest.raises(ValueError, match="design"):
            tpw.packed_walk(*args, design=bad)
        with pytest.raises(ValueError, match="design"):
            tpk.occluded(pt, st, T(ro), T(rd), T(t_max), design=bad)


@pytest.mark.gpu
def test_packed_walk_matches_plain_version_on_the_card():
    """Needs an NVIDIA GPU and nvcc: the walk kernel in both designs bit for
    bit against its plain version and against each other, closest and any
    hit, on the edge rays of three scenes; a batch where every ray leaves
    at the root; the wrapper's refusals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n0 = (tpw.packed_walk.launches, tpw.packed_walk.thread_launches)
    for name in ("mesh", "spheres", "coincident"):
        _, st = _scenes(name)
        pt = tnative.build_packed(st).to("cuda")
        ro, rd, t_min, t_max = _edge_rays(pt, 3000, 10)
        for dead in (False, True):
            if dead:
                t_max = np.full_like(t_max, -1.0)
            args = (pt.table, pt.prim_gid, T(ro).cuda(), T(rd).cuda(),
                    T(t_min[:, 0]).cuda(), T(t_max[:, 0]).cuda(), pt.n_nodes,
                    pt.n_tables, pt.max_leaf)
            want = tpw.packed_walk_ref(*args)
            occ = tpw.packed_walk_ref(*args, any_hit=True)
            for design in tpw.DESIGNS:
                for a, b in zip(tpw.packed_walk(*args, design=design), want):
                    assert torch.equal(a.view(torch.int32) if a.is_floating_point()
                                       else a, b.view(torch.int32)
                                       if b.is_floating_point() else b), \
                        (name, design)
                assert torch.equal(tpw.packed_walk(*args, any_hit=True,
                                                   design=design), occ), \
                    (name, design)
    assert (tpw.packed_walk.launches - n0[0],
            tpw.packed_walk.thread_launches - n0[1]) == (12, 12)
    with pytest.raises(ValueError):                   # strided view refused
        tpw.packed_walk(args[0], args[1],
                        torch.zeros((3000, 6), device="cuda")[:, :3],
                        *args[3:])


# Why the walks' cull is widened by at least 2^-20, and why that is enough
# here (``kernels/packed_walk.py::widen_up``, which widens by 2^-14 for
# the skew faces of tests/test_torch_flat.py::
# test_walks_equal_brute_force_on_skew_faces).  A node is entered iff its slab
# entry t_near <= widen_up(min(slab exit, best t)).  A walk equals brute
# force iff it tests the leaf of brute force's winner P*: P*, the (t,
# lowest id) minimum over every primitive, then takes over and is never
# replaced.  It reaches that leaf unless an ancestor's computed t_near
# exceeds the bound.  Ize 2013 ("Robust BVH Ray Traversal", JCGT 2(2)):
# (b - o) * (1 / d) rounds three times, so each slab t is within gamma_3
# of exact, and t_near <= t_far (1 + 2 gamma_3) for every box the exact
# ray meets.  Against best t >= t(P*), P*'s own rounding adds to that: on
# a face in an axis plane with an edge along an axis (every coplanar face
# below, and the atrium's beams and coffers) Möller–Trumbore's other
# products are exact zeros and t rounds seven times, so t_near <= t(P*)
# (1 + gamma_3) / (1 - gamma_7), about t (1 + 10 u) (u = 2^-24), while
# the bound is at least t (1 + 2^-20)(1 - u) = t (1 + 15 u).  Ize's own
# 2 gamma_3 (6 u) covers the slab t alone.  A power of two w makes |x| w
# exact, so x (1 ± w) rounds once, the same on the card and here.  (Not
# covered by this argument: a skew face hit within rounding of its box's
# edge, which the exact ray may miss; ``tools/walk_edges.py`` counts it.)
def test_walk_on_coplanar_faces_matches_brute_force():
    """The atrium's crossing ceiling beams put coplanar faces of different
    ids at the same t, in different leaves.  Culling a box whose slab
    entry rounds above best t (the plain ``t_near <= min(t_far, best t)``
    that the JAX package's walk keeps) gives another primitive than brute
    force on 6 of these rays: 5 at equal t, 1 a ulp farther.  The widened
    cull keeps brute force's nearest on every ray: bitwise the port's brute
    force (t on every ray; prim, u, v where it hits), the JAX package's
    brute force in hit and prim exactly and in t to 1e-6, and the JAX walk
    on every ray where that walk agrees with its brute force; the cluster
    traversal, which tests every candidate, too.  Any hit with t_max at
    brute force's t (the nearest hit on the bound): occluded exactly where
    brute force says so.  Prints how many rays the JAX walk keeps apart
    from the JAX brute force."""
    from torch_port_util import (assert_hits_equal, atrium_upward,
                                 atrium_upward_jax_brute)

    from tpu_pt_torch.bvh import cluster as tcl

    sj, st, args, h_b = atrium_upward()
    jb_hit, jb_t, jb_prim = atrium_upward_jax_brute()
    pj = jnative.build_packed(sj)
    pt = convert.packed_bvh_from_numpy(packed_dict(pj), "cpu")
    R = args[0].shape[0]
    assert int(h_b.hit.sum()) > R // 2
    for design in tpw.DESIGNS:          # both run the plain walk here
        h_w = tpk.intersect(pt, st, *args, design=design)
        assert_hits_equal(h_w, h_b, design)
    np.testing.assert_array_equal(h_w.hit.numpy(), jb_hit)
    m = jb_hit[:, 0]
    np.testing.assert_array_equal(h_w.prim.numpy()[m], jb_prim[m])
    np.testing.assert_allclose(h_w.t.numpy(), jb_t, rtol=1e-6, atol=1e-6)
    h_j = jpk.intersect(pj, sj, *(jnp.asarray(x.numpy()) for x in args))
    j_hit, j_prim = np.asarray(h_j.hit), np.asarray(h_j.prim)
    agree = (j_hit == jb_hit)[:, 0] & (~m | (j_prim == jb_prim))
    np.testing.assert_array_equal(h_w.prim.numpy()[agree & m],
                                  j_prim[agree & m])
    np.testing.assert_allclose(h_w.t.numpy()[agree], np.asarray(h_j.t)[agree],
                               rtol=1e-6, atol=1e-6)
    cb = tcl.build_cluster_bvh(st).to("cpu")
    h_c = tcl.intersect(cb, st, *args)
    assert_hits_equal(h_c, h_b, "cluster")
    # Any hit at t_max = brute force's t: brute force's occluded bit there
    # is its hit bit (the same test of the same pairs, bounded by its own
    # minimum), checked on the first 1,000 rays.
    ro, rd = args[0], args[1]
    assert torch.equal(tbrute.occluded(st, ro[:1000], rd[:1000],
                                       h_b.t[:1000]), h_b.hit[:1000])
    for design in tpw.DESIGNS:
        assert torch.equal(tpk.occluded(pt, st, ro, rd, h_b.t, design=design),
                           h_b.hit), design
    print(f"coplanar faces: the JAX walk keeps {int((~agree).sum())} of {R} "
          f"rays apart from the JAX brute force; the port's walk 0")
