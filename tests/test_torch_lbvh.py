"""The device LBVH of the port (bvh/lbvh.py) against tpu_pt.bvh.lbvh, the
port's brute-force oracle and the JAX package's packed walk.

Tolerances: Morton codes, the permutation and the node table (its bits:
skip and meta are integers in f32 words) exact; hit masks, primitive ids
and occlusion exact, hit t rtol 1e-5 / atol 1e-6 (tests/test_lbvh.py:74-91);
the image against the oracle rtol / atol 1e-3 (tests/test_lbvh.py:94-106).
The builds on the card run only there (the ``gpu`` case)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import lbvh as jl
from tpu_pt.bvh import packed as jpk
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt.scene import types as jt
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import lbvh as tl
from tpu_pt_torch.bvh import packed as tpk
from tpu_pt_torch.config import RenderConfig
from tpu_pt_torch.render import brute as tbrute
from tpu_pt_torch.render.driver import render as trender
from tpu_pt_torch.scene import cornell as tc

from torch_port_util import T, rays, scene_dict


def _mesh(f_repeat=False):
    """icosphere(2); with ``f_repeat`` its faces twice and seven a third
    time (coincident triangles: duplicate Morton codes, and an index
    tie-break that decides the order)."""
    v, f = jm.icosphere(subdiv=2)
    if f_repeat:
        f = np.concatenate([f, f, f[:7]])
    return jt.make_scene(v, f, np.zeros(len(f), np.int32),
                         jt.make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
                         jt.make_lights([]))


SCENES = {"cornell": lambda: jc.cornell("spheres"), "mesh": _mesh,
          "repeated": lambda: _mesh(True)}


@pytest.fixture(scope="module")
def builds():
    """name -> (JAX scene, port host scene, JAX LBVH, port LBVH on the
    CPU)."""
    out = {}
    for name, make in SCENES.items():
        sj = make()
        st = convert.scene_from_numpy(scene_dict(sj), "cpu")
        out[name] = (sj, st, jl.build_lbvh(sj), tl.build_lbvh(st, "cpu"))
    return out


def _morton_inputs(kind):
    rs = np.random.RandomState(3)
    lo = np.array([-2.0, 0.5, -1.0], np.float32)
    hi = np.array([3.0, 4.0, 1.5], np.float32)
    cent = rs.uniform(lo, hi, (512, 3)).astype(np.float32)
    if kind == "faces":
        # Every coordinate on the scene box's lower or upper face (x = 1
        # clips to 1 - 1e-7), and boxes of zero extent on an axis.
        side = rs.randint(0, 2, (512, 3)).astype(bool)
        cent = np.where(side, hi, lo).astype(np.float32)
        cent[::5, 1] = rs.uniform(lo[1], hi[1], cent[::5].shape[0])
        hi = hi.copy()
        hi[2] = lo[2]
        cent[:, 2] = lo[2]
    elif kind == "equal":
        cent[:] = cent[rs.randint(0, 7, 512)]
    return cent, lo, hi


@pytest.mark.parametrize("kind", ["random", "faces", "equal"])
def test_morton_codes_equal_jax(kind):
    cent, lo, hi = _morton_inputs(kind)
    want = np.asarray(jax.jit(jl.morton_codes)(
        jnp.asarray(cent), jnp.asarray(lo), jnp.asarray(hi)))
    got = tl.morton_codes(T(cent), T(lo), T(hi))
    assert got.dtype == torch.int64 and int(got.max()) < 1 << 30
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if kind == "equal":
        assert len(np.unique(want)) <= 7


def test_clz_and_prefix_equal_jax_at_the_32_bit_edges():
    x = np.array([0, 1, 2, 3, 255, 256, 65535, 65536, 2 ** 29, 2 ** 30 - 1,
                  2 ** 31 - 1, 2 ** 31, 2 ** 32 - 2, 2 ** 32 - 1], np.uint32)
    np.testing.assert_array_equal(
        tl._clz32(T(x.astype(np.int64))).numpy(),
        np.asarray(jl._clz32(jnp.asarray(x))))
    rs = np.random.RandomState(4)
    a = rs.randint(0, 2 ** 30, 300).astype(np.uint32)
    b = a.copy()
    b[::2] = rs.randint(0, 2 ** 30, 150)
    ia = rs.randint(0, 2 ** 31 - 1, 300).astype(np.int32)
    ib = rs.randint(0, 2 ** 31 - 1, 300).astype(np.int32)
    want = np.asarray(jl._prefix64(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(ia), jnp.asarray(ib)))
    got = tl._prefix64(T(a.astype(np.int64)), T(b.astype(np.int64)),
                       T(ia.astype(np.int64)), T(ib.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(SCENES))
def test_lbvh_equals_jax_bitwise(builds, name):
    """The permutation, the node table and the whole packed table (the
    primitive rows too) are the JAX package's bit for bit."""
    sj, _, lj, lt = builds[name]
    assert (lt.n_nodes, lt.n_tables, lt.max_leaf) == \
        (lj.n_nodes, lj.n_tables, lj.max_leaf) == (2 * sj.n_prims - 1, 1, 1)
    assert lt.prim_gid.dtype == torch.int32
    np.testing.assert_array_equal(lt.prim_gid.numpy(),
                                  np.asarray(lj.prim_gid))
    np.testing.assert_array_equal(lt.table.numpy().view(np.uint32),
                                  np.asarray(lj.table).view(np.uint32))
    if name == "repeated":
        lo, hi = tl.prim_bounds(builds[name][1].to("cpu"))
        codes = tl.morton_codes((lo + hi) * 0.5, lo.amin(0), hi.amax(0))
        assert len(torch.unique(codes)) < codes.shape[0]   # duplicates


@pytest.mark.parametrize("name", list(SCENES))
def test_lbvh_round_forms_agree(builds, name):
    """Stopping each Karras search when no lane moves (a host read a
    round) and running the fixed ``_rounds(P)`` give the same arrays."""
    _, st, _, lt = builds[name]
    lo, hi = tl.prim_bounds(st.to("cpu"))
    a = tl.build_lbvh_arrays(lo, hi, check_each_round=True)
    b = tl.build_lbvh_arrays(lo, hi)
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1]) and torch.equal(b[1], lt.prim_gid)


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_lbvh_structure_invariants(builds, name):
    """tests/test_lbvh.py:48-69 on the port's build."""
    sj, _, _, lb = builds[name]
    p = sj.n_prims
    assert lb.n_nodes == 2 * p - 1
    nodes = lb.node_rows()[0]
    meta = nodes[:, 7].view(np.int32)
    skip = nodes[:, 6].view(np.int32)
    leaf = meta >= 0
    assert leaf.sum() == p
    starts = meta[leaf] & ((1 << 26) - 1)
    assert sorted(starts.tolist()) == list(range(p))
    assert (meta[leaf] >> 26 == 1).all()
    assert sorted(lb.prim_gid.tolist()) == list(range(p))
    ids = np.arange(2 * p - 1)
    assert (skip > ids).all() and (skip <= 2 * p - 1).all()
    assert (skip[leaf] == ids[leaf] + 1).all()
    assert (nodes[0, 0:3] <= nodes[:, 0:3] + 1e-5).all()
    assert (nodes[0, 3:6] >= nodes[:, 3:6] - 1e-5).all()


def _aimed_rays(lb, n, seed):
    """Random rays, every other one aimed at a random point of a random
    leaf box (not its centre, which lies on a quad's diagonal)."""
    ro, rd = rays(n, seed)
    rs = np.random.RandomState(seed + 1)
    boxes = lb.node_rows()[0]
    leaves = boxes[boxes[:, 7].view(np.int32) >= 0]
    pick = leaves[rs.randint(0, len(leaves), n)]
    aim = rs.uniform(pick[:, 0:3], np.maximum(pick[:, 3:6], pick[:, 0:3])) - ro
    rd[1::2] = (aim / np.linalg.norm(aim, axis=1, keepdims=True))[1::2]
    return ro, rd.astype(np.float32)


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_lbvh_walk_matches_brute_and_jax(builds, name):
    """The port's packed walk on the port's LBVH against the port's brute
    oracle and against the JAX packed walk on the JAX LBVH."""
    sj, st, lj, lt = builds[name]
    ro, rd = _aimed_rays(lt, 1024, 5)
    R = ro.shape[0]
    tmin, tmax = np.zeros((R, 1), np.float32), np.full((R, 1), 1e30, np.float32)
    h_t = tpk.intersect(lt, st.to("cpu"), T(ro), T(rd), T(tmin), T(tmax))
    h_b = tbrute.intersect(st.to("cpu"), T(ro), T(rd), T(tmin), T(tmax))
    h_j = jpk.intersect(lj, sj, jnp.asarray(ro), jnp.asarray(rd),
                        jnp.asarray(tmin), jnp.asarray(tmax))
    assert int(h_t.hit.sum()) > R // 4
    for ref in (h_b, h_j):
        hit = np.asarray(ref.hit)
        np.testing.assert_array_equal(h_t.hit.numpy(), hit)
        m = hit[:, 0]
        np.testing.assert_allclose(h_t.t.numpy()[m], np.asarray(ref.t)[m],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(h_t.prim.numpy()[m],
                                      np.asarray(ref.prim)[m])
    short = np.full((R, 1), 2.0, np.float32)
    o_t = tpk.occluded(lt, st.to("cpu"), T(ro), T(rd), T(short))
    np.testing.assert_array_equal(
        o_t.numpy(), tbrute.occluded(st.to("cpu"), T(ro), T(rd),
                                     T(short)).numpy())
    np.testing.assert_array_equal(
        o_t.numpy(), np.asarray(jpk.occluded(lj, sj, jnp.asarray(ro),
                                             jnp.asarray(rd),
                                             jnp.asarray(short))))


def test_lbvh_walk_on_coplanar_faces_matches_brute_force():
    """The packed walk on the port's LBVH (one primitive a leaf, so every
    coplanar face its own box) of the reduced atrium, on the coplanar
    case's 20,000 upward rays (``tests/test_torch_packed.py::
    test_walk_on_coplanar_faces_matches_brute_force``): the port's brute
    force bit for bit, and any hit at t_max = brute force's t occluded
    exactly where brute force hits."""
    from torch_port_util import assert_hits_equal, atrium_upward

    _, st, args, h_b = atrium_upward()
    lb = tl.build_lbvh(st, device="cpu")
    assert lb.max_leaf == 1
    for design in ("window", "thread"):    # both run the plain walk here
        assert_hits_equal(tpk.intersect(lb, st, *args, design=design), h_b,
                          design)
        assert torch.equal(tpk.occluded(lb, st, args[0], args[1], h_b.t,
                                        design=design), h_b.hit), design


def test_lbvh_render_matches_oracle():
    """tests/test_lbvh.py:94-106: 16², spp 2, depth 2 through the packed
    backend on the LBVH against the brute oracle."""
    scene = tc.cornell("spheres")
    lb = tl.build_lbvh(scene, device="cpu")
    cam = tc.camera(16, 16)
    cfg = RenderConfig(width=16, height=16, spp=2, max_depth=2)
    ref = trender(scene, cam, cfg, (0, 6), backend="brute", device="cpu")
    img = trender(scene, cam, cfg, (0, 6), backend="packed", bvh=lb,
                  device="cpu")
    assert float(img.mean()) > 0.01
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_device_builds_on_the_card_equal_the_cpu_builds():
    """Needs an NVIDIA GPU: ``build_lbvh`` (and its arrays in both round
    forms) and ``build_cluster_device`` (tiles 128 and 64) on the card give
    the CPU builds' tensors bit for bit, and a traversal of the card's
    cluster build through the fused and the split pair stage the same
    bits.  On big_scene(4), whose triangles all get Morton code 0 (the
    placeholder sphere at 1e8 stretches the box), and on inputs whose codes
    are real: the same mesh without that sphere, the Cornell box with
    spheres, and 2^18 random boxes (the arrays only)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    big = jm.big_scene(4)
    bare = big._replace(sph_center=big.sph_center[:0],
                        sph_radius=big.sph_radius[:0],
                        sph_mat=big.sph_mat[:0])
    ro, rd = rays(2048, 7)
    for scene in (big, bare, jc.cornell("spheres")):
        st = convert.scene_from_numpy(scene_dict(scene), "cpu")
        cpu = tl.build_lbvh(st, "cpu")
        gpu = tl.build_lbvh(st)
        assert gpu.table.device.type == "cuda"
        assert torch.equal(gpu.table.cpu().view(torch.int32),
                           cpu.table.view(torch.int32))
        assert torch.equal(gpu.prim_gid.cpu(), cpu.prim_gid)
        lo, hi = tl.prim_bounds(st.to("cuda"))
        nodes, perm = tl.build_lbvh_arrays(lo, hi, check_each_round=True)
        assert torch.equal(nodes[0].cpu().view(torch.int32),
                           cpu.table[:cpu.n_nodes, :8].view(torch.int32))
        assert torch.equal(perm.cpu(), cpu.prim_gid)
        for tile in (128, 64):
            c = tcl.build_cluster_device(st, tile=tile, device="cpu")
            g = tcl.build_cluster_device(st, tile=tile)
            for a, b in zip((*g.levels, *g.levels16, g.tiles, g.tile_gid),
                            (*c.levels, *c.levels16, c.tiles, c.tile_gid)):
                assert a.device.type == "cuda"
                assert torch.equal(a.cpu().view(torch.int16),
                                   b.view(torch.int16))
            assert (g.frontiers, g.k_leaf, g.pair_budget, g.pair_mults) == \
                (c.frontiers, c.k_leaf, c.pair_budget, c.pair_mults)
            sc = st.to("cuda")
            args = (sc, T(ro).cuda(), T(rd).cuda(),
                    torch.zeros((2048, 1), device="cuda"), 1e30)
            hits = [tcl.intersect(g, *args, pair_stage=s)
                    for s in ("fused", "split")]
            for f in ("hit", "t", "prim", "u", "v"):
                assert torch.equal(getattr(hits[0], f),
                                   getattr(hits[1], f)), f
    codes = tl.morton_codes((lo + hi) * 0.5, lo.amin(0), hi.amax(0))
    assert len(torch.unique(codes)) > 1        # the Cornell box: real codes
    rs = np.random.RandomState(11)
    lo = rs.uniform(-1.0, 1.0, (1 << 18, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.0, 0.01, lo.shape).astype(np.float32)
    nodes_c, perm_c = tl.build_lbvh_arrays(T(lo), T(hi))
    nodes, perm = tl.build_lbvh_arrays(T(lo).cuda(), T(hi).cuda())
    assert torch.equal(nodes.cpu().view(torch.int32),
                       nodes_c.view(torch.int32))
    assert torch.equal(perm.cpu(), perm_c)
