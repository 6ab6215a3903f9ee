"""The product surface of the port against the JAX package: the progressive
renderer (tpu_pt_torch.render.progressive: its checkpoint key, chunking,
resume and the fallback retry), the BVH heatmap (render.debug) and the
metrics (render.metrics).

Tolerances: chunked against one-shot rtol 1e-5 (the JAX package's own,
tests/test_progressive.py); a resumed render bitwise; the port's
progressive render against the JAX package's rtol 2e-4 / atol 2e-5 (the
cross-package tolerance of tests/test_torch_wavefront.py); heatmap counts
and queue occupancy exactly."""

import os

import jax
import numpy as np
import pytest

from tpu_pt.bvh import cluster as jcl
from tpu_pt.bvh import native as jnative
from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.render import debug as jdebug
from tpu_pt.render import metrics as jmetrics
from tpu_pt.render import progressive as jprog
from tpu_pt.scene import cornell as jc
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import native as tnative
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.render import debug as tdebug
from tpu_pt_torch.render import metrics as tmetrics
from tpu_pt_torch.render import progressive as tprog
from tpu_pt_torch.render.wavefront import render_wavefront
from tpu_pt_torch.scene import cornell as tc
from tpu_pt_torch.scene import meshes as tm
from tpu_pt_torch.scene.types import (LIGHT_POINT, make_lights,
                                      make_materials, make_scene)

import torch_port_util  # noqa: F401  (torch threads per xdist worker)


@pytest.fixture(scope="module")
def spheres():
    """Both packages' Cornell spheres and packed BVHs (equal tables)."""
    sj, st = jc.cornell("spheres"), tc.cornell("spheres")
    pj, pt = jnative.build_packed_any(sj), tnative.build_packed_any(st)
    np.testing.assert_array_equal(np.asarray(pj.table), pt.table)
    return sj, st, pj, pt


def test_state_key_equals_jax(spheres):
    sj, st, pj, pt = spheres
    cj, ct = jcl.build_cluster_bvh(sj), tcl.build_cluster_bvh(st)
    kw = dict(width=12, height=10, spp=3, max_depth=2)
    keys = set()
    for s in (0, 5, 2**31 + 7):
        for bj, bt, backend in ((pj, pt, "packed"), (cj, ct, "cluster")):
            for cfg_kw in (kw, dict(kw, debug_checks=True, eps=2e-4)):
                k = jprog._state_key(JConfig(**cfg_kw), jax.random.key(s),
                                     bj, backend)
                assert tprog._state_key(TConfig(**cfg_kw), (0, s), bt,
                                        backend) == k
                keys.add(k)
        # The device copy of a BVH gives the same key.
        assert tprog._state_key(TConfig(**kw), (0, s), ct.to("cpu"),
                                "cluster") == \
            tprog._state_key(TConfig(**kw), (0, s), ct, "cluster")
    assert len(keys) == 12


def _setup(w, spp, depth):
    cfg = TConfig(width=w, height=w, spp=spp, max_depth=depth)
    return cfg, tc.camera(w, w)


def test_chunked_equals_oneshot(spheres):
    _, st, _, pt = spheres
    cfg, cam = _setup(12, 6, 2)
    oneshot = render_wavefront(st, cam, cfg, (0, 0), pt, queue=256,
                               backend="packed", device="cpu").numpy()
    chunked = tprog.render_progressive(st, cam, cfg, (0, 0), pt, chunk_spp=2,
                                       queue=256, device="cpu")
    np.testing.assert_allclose(chunked, oneshot, rtol=1e-5, atol=1e-7)


def test_resume_is_bitwise_and_config_change_invalidates(spheres, tmp_path):
    _, st, _, pt = spheres
    cfg, cam = _setup(10, 4, 1)
    ckpt = str(tmp_path / "render.npz")
    kw = dict(chunk_spp=2, queue=256, device="cpu")

    class Stop(Exception):
        pass

    def stop_after_half(spp_done, img):
        if spp_done >= 2:
            raise Stop()

    with pytest.raises(Stop):
        tprog.render_progressive(st, cam, cfg, (0, 1), pt, checkpoint=ckpt,
                                 on_chunk=stop_after_half, **kw)
    assert int(np.load(ckpt)["spp_done"]) == 2
    seen = []
    resumed = tprog.render_progressive(
        st, cam, cfg, (0, 1), pt, checkpoint=ckpt,
        on_chunk=lambda s, i: seen.append(s), **kw)
    assert seen == [4]   # only the second chunk was rendered
    full = tprog.render_progressive(st, cam, cfg, (0, 1), pt, **kw)
    np.testing.assert_array_equal(resumed, full)
    assert not os.path.exists(ckpt + ".tmp.npz")

    # Another config: the checkpoint is ignored, not resumed.
    cfg2 = cfg.replace(max_depth=2)
    img2 = tprog.render_progressive(st, cam, cfg2, (0, 1), pt,
                                    checkpoint=ckpt, **kw)
    ref2 = tprog.render_progressive(st, cam, cfg2, (0, 1), pt, **kw)
    np.testing.assert_array_equal(img2, ref2)


def test_fallback_retry_resumes_clean_checkpoint(tmp_path, monkeypatch):
    """(1) Chunk 1 clean, chunk 2 overflowing: ``stop_on_overflow`` keeps
    the exact checkpoint of chunk 1 (spp_done 2, exact), the
    fallback-attached retry renders only chunk 2 and gives the bits of the
    uninterrupted chunked render on the fallback-attached BVH.  (2) Chunk 1
    overflowing (caps far too small): no checkpoint is written, and the
    retry renders from the start to the same bits as that chunking, and
    the one-shot render to 1e-6."""
    v, f = tm.icosphere(subdiv=3)
    scene = make_scene(v, f, np.zeros(len(f), np.int32),
                       make_materials([dict(albedo=(0.6, 0.6, 0.6),
                                            emission=(1.0, 1.0, 1.0))]),
                       make_lights([dict(kind=LIGHT_POINT,
                                         position=(0, 2, 0),
                                         radiance=(5.0, 5.0, 5.0))]))
    cam = tc.camera(10, 10)
    cfg = TConfig(width=10, height=10, spp=4, max_depth=1)
    kw = dict(chunk_spp=2, queue=128, backend="cluster", device="cpu")

    # (1) The default caps truncate nothing here; chunk 2 is made to report
    # an overflow where no fallback is attached.
    cb = tcl.build_cluster_bvh(scene, tile=32)
    cb_exact = tcl.attach_fallback(cb, scene)
    real = tprog.wavefront_accum

    def overflow_in_chunk_2(scene, cam, cfg, key, bvh, *a, **k):
        part, (nc, ns, novf, it) = real(scene, cam, cfg, key, bvh, *a, **k)
        assert int(novf) == 0
        if k["spp_lo"] >= 2 and bvh.fallback is None:
            novf = 7
        return part, (nc, ns, novf, it)

    monkeypatch.setattr(tprog, "wavefront_accum", overflow_in_chunk_2)
    ckpt = str(tmp_path / "clean.npz")
    chunks = []
    img, novf = tprog.render_progressive(
        scene, cam, cfg, (0, 3), cb, checkpoint=ckpt, return_counts=True,
        stop_on_overflow=True, on_chunk=lambda s, i: chunks.append(s), **kw)
    assert novf == 7 and chunks == [2]
    data = np.load(ckpt)
    assert int(data["spp_done"]) == 2 and bool(data["exact"])
    assert int(data["n_ovf"]) == 0
    chunks = []
    img2, novf2 = tprog.render_progressive(
        scene, cam, cfg, (0, 3), cb_exact, checkpoint=ckpt,
        return_counts=True, stop_on_overflow=True, overflow_is_exact=True,
        on_chunk=lambda s, i: chunks.append(s), **kw)
    assert chunks == [4] and novf2 == 0   # only the second chunk rendered
    assert int(np.load(ckpt)["spp_done"]) == 4
    ref_chunked = tprog.render_progressive(scene, cam, cfg, (0, 3), cb_exact,
                                           **kw)
    np.testing.assert_array_equal(img2, ref_chunked)
    monkeypatch.undo()

    # (2) Caps so small that the first chunk already truncates.
    n_lv = len(cb.levels)
    cb_bad = tcl.build_cluster_bvh(scene, tile=32, frontiers=(2,) * n_lv,
                                   k_leaf=2, pair_mults=(1, 1, 1))
    ckpt = str(tmp_path / "r.npz")
    chunks = []
    img, novf = tprog.render_progressive(
        scene, cam, cfg, (0, 3), cb_bad, checkpoint=ckpt, return_counts=True,
        stop_on_overflow=True, on_chunk=lambda s, i: chunks.append(s), **kw)
    assert novf > 0 and chunks == []
    assert not os.path.exists(ckpt)

    cb_exact = tcl.attach_fallback(cb_bad, scene)
    img2, novf2 = tprog.render_progressive(
        scene, cam, cfg, (0, 3), cb_exact, checkpoint=ckpt,
        return_counts=True, stop_on_overflow=True, overflow_is_exact=True,
        on_chunk=lambda s, i: chunks.append(s), **kw)
    assert chunks == [2, 4] and novf2 > 0
    ref_chunked = tprog.render_progressive(scene, cam, cfg, (0, 3), cb_exact,
                                           **kw)
    np.testing.assert_array_equal(img2, ref_chunked)
    ref = render_wavefront(scene, cam, cfg, (0, 3), cb_exact, queue=128,
                           backend="cluster", device="cpu").numpy()
    np.testing.assert_allclose(img2, ref, rtol=1e-6, atol=1e-7)


def test_progressive_equals_jax(spheres):
    sj, st, pj, pt = spheres
    kw = dict(width=12, height=12, spp=4, max_depth=2)
    img_j = jprog.render_progressive(sj, jc.camera(12, 12), JConfig(**kw),
                                     jax.random.key(4), pj, chunk_spp=2,
                                     queue=128, backend="packed")
    img_t = tprog.render_progressive(st, tc.camera(12, 12), TConfig(**kw),
                                     (0, 4), pt, chunk_spp=2, queue=128,
                                     backend="packed", device="cpu")
    np.testing.assert_allclose(img_t, np.asarray(img_j), rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("variant", ["spheres", "mesh"])
def test_heatmap_counts_equal_jax(variant):
    sj, st = jc.cornell(variant), tc.cornell(variant)
    pj, pt = jnative.build_packed_any(sj), tnative.build_packed_any(st)
    hj = jdebug.bvh_heatmap(pj, jc.camera(16, 16), 16, 16)
    ht = tdebug.bvh_heatmap(pt.to("cpu"), tc.camera(16, 16).to("cpu"), 16,
                            16)
    for k in ("visits", "leaf_tests"):
        assert ht[k].dtype == np.int32
        np.testing.assert_array_equal(ht[k], hj[k], err_msg=k)
    for k in ("mean_visits", "max_visits", "mean_leaf_tests"):
        assert ht[k] == hj[k], k
    if variant == "mesh":   # the walk's cost varies over the image
        assert ht["max_visits"] > ht["mean_visits"] > 1
    np.testing.assert_array_equal(tdebug.heatmap_image(ht["visits"]),
                                  jdebug.heatmap_image(hj["visits"]))


def test_metrics_equal_jax(spheres):
    sj, st, pj, pt = spheres
    assert tmetrics.scene_stats(st) == jmetrics.scene_stats(sj)
    assert tmetrics.scene_stats(st.to("cpu")) == jmetrics.scene_stats(sj)
    assert tmetrics.bvh_stats(pt) == jmetrics.bvh_stats(pj)
    assert tmetrics.bvh_stats(pt.to("cpu")) == jmetrics.bvh_stats(pj)
    rep = tmetrics.RenderReport(cfg=TConfig(width=8, height=8, spp=1))
    with rep.phase("build"):
        pass
    out = rep.to_json(extra_field=1)
    assert '"width": 8' in out and '"build"' in out and '"extra_field": 1' in out


def test_queue_occupancy_drains_as_jax():
    sj, st = jc.cornell("empty"), tc.cornell("empty")
    pj, pt = jnative.build_packed_any(sj), tnative.build_packed_any(st)
    kw = dict(width=8, height=8, spp=2, max_depth=2)
    occ_t = tmetrics.queue_occupancy(st, tc.camera(8, 8), TConfig(**kw),
                                     (0, 0), pt, queue=64, device="cpu")
    assert occ_t["occupancy"][0] > 0 and occ_t["occupancy"][-1] == 0
    assert 0 < occ_t["mean_occupancy"] <= 1.0
    occ_j = jmetrics.queue_occupancy(sj, jc.camera(8, 8), JConfig(**kw),
                                     jax.random.key(0), pj, queue=64)
    assert occ_t == occ_j
