"""Host cluster-BVH build of the PyTorch port vs tpu_pt.bvh.cluster: every
array and every static field equal (same native SAH builder source, same
numpy post-processing)."""

import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt.scene import types as jt
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import native as tnative
from tpu_pt_torch.bvh import sah as tsah
from tpu_pt_torch.scene import cornell as tc
from tpu_pt_torch.scene import meshes as tm
from tpu_pt_torch.scene import types as tt

from torch_port_util import bvh_dict


def _mesh_scene(mod_meshes, mod_types):
    v, f = mod_meshes.icosphere(subdiv=3)
    return mod_types.make_scene(
        v, f, np.zeros(len(f), np.int32),
        mod_types.make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
        mod_types.make_lights([]))


CASES = {
    "cornell": (lambda: jc.cornell("spheres"), lambda: tc.cornell("spheres"), {}),
    "mesh": (lambda: _mesh_scene(jm, jt), lambda: _mesh_scene(tm, tt),
             dict(tile=32)),
    "big64": (lambda: jm.big_scene(4), lambda: tm.big_scene(4), dict(tile=64)),
    "big128": (lambda: jm.big_scene(4), lambda: tm.big_scene(4), dict(tile=128)),
    "deep": (lambda: jm.big_scene(4), lambda: tm.big_scene(4),
             dict(tile=32, dense_start=8)),      # a 4-level pyramid
}


@pytest.mark.parametrize("name", list(CASES))
def test_build_equal(name):
    mk_j, mk_t, kw = CASES[name]
    cj = jcl.build_cluster_bvh(mk_j(), **kw)
    ct = tcl.build_cluster_bvh(mk_t(), **kw)
    np.testing.assert_array_equal(np.asarray(cj.tiles), ct.tiles)
    np.testing.assert_array_equal(np.asarray(cj.tile_gid), ct.tile_gid)
    assert len(cj.levels) == len(ct.levels)
    for a, b in zip(cj.levels, ct.levels):
        np.testing.assert_array_equal(np.asarray(a), b)
    for a, b in zip(cj.levels16, ct.levels16):
        assert b.dtype == np.uint16
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16), b)
    assert cj.frontiers == ct.frontiers
    assert cj.k_leaf == ct.k_leaf
    assert cj.pair_budget == ct.pair_budget
    assert cj.pair_mults == ct.pair_mults and len(ct.pair_mults) == 4
    assert cj.n_clusters == ct.n_clusters


def test_levels16_round_outward_and_view_as_bfloat16():
    ct = tcl.build_cluster_bvh(tm.big_scene(4), tile=64)
    dev = ct.to("cpu")
    for lv, lv16 in zip(dev.levels, dev.levels16):
        assert lv16.dtype == torch.bfloat16
        f = lv16.float()
        real = lv[:, 0] <= lv[:, 3]
        assert bool((f[real, 0:3] <= lv[real, 0:3]).all())
        assert bool((f[real, 3:6] >= lv[real, 3:6]).all())
    # The derived descent tables.
    assert dev.top_soa.shape == (8, dev.levels[0].shape[0])
    for l in range(1, len(dev.levels)):
        assert dev.child16[l].shape == (dev.levels[l].shape[0] // 8, 64)
    assert dev.to("cpu") is dev      # already there: no second upload


def test_pair_mults_fourth_entry_derived():
    s = tc.cornell("spheres")
    assert tcl.build_cluster_bvh(s, pair_mults=(8, 8, 6)).pair_mults == (8, 8, 6, 4)
    assert tcl.build_cluster_bvh(s, pair_mults=(1, 1, 1)).pair_mults == (1, 1, 1, 2)
    assert tcl.build_cluster_bvh(s, pair_mults=(8, 8, 6, 5)).pair_mults == (8, 8, 6, 5)


def test_convert_cluster_bvh_from_numpy():
    cj = jcl.build_cluster_bvh(jm.big_scene(4), tile=64)
    ct = tcl.build_cluster_bvh(tm.big_scene(4), tile=64).to("cpu")
    cc = convert.cluster_bvh_from_numpy(bvh_dict(cj), device="cpu")
    assert torch.equal(cc.tiles, ct.tiles) and torch.equal(cc.tile_gid, ct.tile_gid)
    for a, b in zip(cc.levels16, ct.levels16):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(cc.child16[1:], ct.child16[1:]):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert (cc.frontiers, cc.k_leaf, cc.pair_budget, cc.pair_mults) == \
        (ct.frontiers, ct.k_leaf, ct.pair_budget, ct.pair_mults)
    # levels16 left out: derived from the f32 levels, same bits.
    d = bvh_dict(cj)
    del d["levels16"]
    cd = convert.cluster_bvh_from_numpy(d, device="cpu")
    for a, b in zip(cd.levels16, ct.levels16):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_prim_bounds_and_native_leaves():
    from tpu_pt.bvh import native as jnative
    from tpu_pt.bvh import sah as jsah

    sj, st = jc.cornell("spheres"), tc.cornell("spheres")
    for a, b in zip(jsah.prim_bounds(sj), tsah.prim_bounds(st)):
        np.testing.assert_array_equal(np.asarray(a), b)
    lj = jnative.build_leaves(sj, max_leaf=8)
    lt = tnative.build_leaves(st, max_leaf=8)
    assert lj is not None
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(a, b)
    # The port builds its own copy of the library, in its own build directory.
    assert tnative.lib_path().startswith(tnative.BUILD_DIR)


def test_build_invariants():
    scene = tm.big_scene(4)
    cb = tcl.build_cluster_bvh(scene, tile=64)
    real = (np.abs(cb.tiles).sum(axis=1) > 0).reshape(-1)
    ids = cb.tile_gid.reshape(-1)[real]
    assert sorted(ids.tolist()) == list(range(scene.n_prims))
    for l in range(len(cb.levels) - 1):
        assert cb.levels[l + 1].shape[0] == 8 * cb.levels[l].shape[0]
