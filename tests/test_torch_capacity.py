"""Capacity tooling of the port (bvh/cluster.py: level_hit_counts,
autotune_frontiers, autotune_for_render, autotune_for_camera; the
ray_probe hook of render/wavefront.py::_step) against tpu_pt.

Tolerances: counts, caps and pair multipliers exact (the caps are reckoned
in the same float64 numpy arithmetic, and a cap that is off by one is
another BVH); the probe's ray batches rtol/atol 1e-5 (the same shading,
rounded once per operation here, fused by XLA there), their t_max sign
(live or dead lane) exact; hit masks against brute exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.render import driver as jdriver
from tpu_pt.render import wavefront as jwf
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import native as tnative
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.render import brute as tbrute
from tpu_pt_torch.render import driver as tdriver
from tpu_pt_torch.render import wavefront as twf

from torch_port_util import T, camera_dict, rays, scene_dict

RENDER = dict(spp=1, max_depth=4, rr_start=2, rr_prob=0.7)


@pytest.fixture(scope="module")
def big():
    """A 20k-triangle displaced sphere (big_scene(5)): (JAX scene, port
    host scene)."""
    sj = jm.big_scene(subdiv=5)
    return sj, convert.scene_from_numpy(scene_dict(sj), "cpu")


def _cams(w, h):
    camj = jm.big_camera(w, h)
    return camj, convert.camera_from_numpy(camera_dict(camj), "cpu")


@pytest.mark.parametrize("tile,dense_start", [(64, 512), (64, 8), (32, 8)])
def test_level_hit_counts_equal_jax(big, tile, dense_start):
    sj, st = big
    cj = jcl.build_cluster_bvh(sj, tile=tile, dense_start=dense_start)
    ct = tcl.build_cluster_bvh(st, tile=tile, dense_start=dense_start)
    ro, rd = rays(512, 17)
    rd[::9, 1] = 0.0                                  # axis-parallel in y
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    want = np.asarray(jcl.level_hit_counts(jax.tree.map(jnp.asarray, cj),
                                           jnp.asarray(ro), jnp.asarray(rd)))
    got = tcl.level_hit_counts(ct.to("cpu"), T(ro), T(rd))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.shape[1] == len(ct.levels) and want[:, -1].max() > 0


def test_ray_probe_batches_of_one_step_equal_jax():
    """One step of each package from the same fresh queue on the Cornell
    box: the probe holds the closest-hit batch and one shadow batch per
    light sample, in the reference's order, and the step's results do not
    depend on the hook."""
    sj = jc.cornell("spheres")
    st = convert.scene_from_numpy(scene_dict(sj), "cpu")
    camj = jc.camera(16, 16)
    camt = convert.camera_from_numpy(camera_dict(camj), "cpu")
    kw = dict(width=16, height=16, **RENDER)
    cj, ct = JConfig(**kw), TConfig(**kw)
    cbj = jax.tree.map(jnp.asarray, jcl.build_cluster_bvh(sj, tile=32))
    cbt = tcl.build_cluster_bvh(st, tile=32).to("cpu")
    ifj, ofj = jdriver._intersectors_counted("cluster", cbj)
    ift, oft = tdriver._intersectors_counted("cluster", cbt)
    sjd = jax.device_put(sj)

    @jax.jit
    def jstep(q):
        probes = []
        q, _ = jwf._step(sjd, camj, cj, jax.random.key(7), ifj, ofj, q, 0,
                         256, jnp.int32(0), 1, ray_probe=probes)
        return q, probes

    _, pj = jstep(jwf.init_queue(128, 256))
    q0 = twf.init_queue(128, 256, "cpu")
    quiet, _ = twf._step(st, camt, ct, (0, 7), ift, oft, q0, 0, 256, 0, 1)
    pt = []
    probed, _ = twf._step(st, camt, ct, (0, 7), ift, oft, q0, 0, 256, 0, 1,
                          ray_probe=pt)
    for a, b in zip(quiet, probed):
        assert torch.equal(a, b)
    assert len(pt) == len(pj) == 1 + st.lights.count
    # A shadow ray leaves its hit point moved by cfg.eps along the normal,
    # so one from a sphere starts at r + eps or r - eps from its centre.
    # Where the packages' origins part past 1e-5 (the JAX package's sphere
    # solve cancels), the port's must lie on that shell within 1e-6 and
    # closer to it than the JAX package's; those rows leave the comparison.
    centre = st.sph_center.numpy().astype(np.float64)
    radius = st.sph_radius.numpy().astype(np.float64)

    def off_shell(o):
        d = np.linalg.norm(o.astype(np.float64)[:, None] - centre, axis=-1)
        return np.min(np.abs(np.abs(d - radius) - ct.eps), axis=1)

    for k, ((ro_t, rd_t, tm_t), (ro_j, rd_j, tm_j)) in enumerate(zip(pt, pj)):
        assert tuple(tm_t.shape) == (128, 1)
        np.testing.assert_array_equal(tm_t.numpy() < 0, np.asarray(tm_j) < 0)
        ro_t, ro_j = ro_t.numpy(), np.asarray(ro_j)
        apart = ~np.isclose(ro_t, ro_j, rtol=1e-5, atol=1e-5).all(1)
        assert (k > 0 or not apart.any()) and apart.sum() <= 2
        if apart.any():
            s_t, s_j = off_shell(ro_t[apart]), off_shell(ro_j[apart])
            print(f"batch {k}: {int(apart.sum())} origins held to the "
                  f"sphere shell, off it by {s_t.max():.3g} (JAX package "
                  f"{s_j.max():.3g})")
            assert (s_t <= 1e-6).all() and (s_t < s_j).all(), (s_t, s_j)
        for a, b in ((ro_t, ro_j), (rd_t.numpy(), rd_j), (tm_t.numpy(), tm_j)):
            np.testing.assert_allclose(a[~apart], np.asarray(b)[~apart],
                                       rtol=1e-5, atol=1e-5)
    assert (pt[0][2].numpy() > 0).all()               # a full first wave
    assert 0 < (pt[1][2].numpy() > 0).sum() < 128     # some shadow rays


@pytest.mark.parametrize("slack", [1.5, 1.2])
def test_autotune_frontiers_equal_jax(big, slack):
    sj, st = big
    ro, rd = rays(512, 17)
    cj = jcl.autotune_frontiers(sj, jnp.asarray(ro), jnp.asarray(rd),
                                slack=slack, tile=64, dense_start=8)
    ct = tcl.autotune_frontiers(st, T(ro), T(rd), slack=slack, tile=64,
                                dense_start=8)
    assert ct.frontiers == cj.frontiers and ct.k_leaf == cj.k_leaf
    assert ct.pair_mults == cj.pair_mults
    assert ct.pair_budget == cj.pair_budget
    assert len(ct.levels) == 3


def test_autotuned_caps_cover_measured_counts_and_hits_equal_brute(big):
    """tests/test_cluster.py:214 on the port: every cap covers the measured
    per-level need of the same rays, and the tuned BVH's hits are
    brute's."""
    _, st = big
    ro, rd = rays(1024, 17)
    cb = tcl.autotune_frontiers(st, T(ro), T(rd), tile=64).to("cpu")
    counts = tcl.level_hit_counts(cb, T(ro), T(rd)).numpy()
    for l in range(len(cb.levels)):
        assert cb.frontiers[l] >= counts[:, l].max()
    t_min = torch.zeros((1024, 1))
    t_max = torch.full((1024, 1), 1e30)
    h_ref = tbrute.intersect(st.to("cpu"), T(ro), T(rd), t_min, t_max)
    h_cl = tcl.intersect(cb, st, T(ro), T(rd), t_min, t_max)
    assert torch.equal(h_ref.hit, h_cl.hit)


def test_autotune_for_render_equals_jax(big):
    """The wavefront probe gives the reference's caps and pair multipliers
    exactly, at 1100 x 700, which both packages scale down to a 512²
    equivalent before probing (the probe's cost follows the queue, not the
    image)."""
    sj, st = big
    camj, camt = _cams(1100, 700)
    kw = dict(width=1100, height=700, **RENDER)
    opts = dict(queue=256, segments=2, warm_steps=2, probe_steps=3, tile=64,
                dense_start=8, exact_fallback=False)
    cj = jcl.autotune_for_render(sj, camj, JConfig(**kw), **opts)
    ct = tcl.autotune_for_render(st, camt, TConfig(**kw), device="cpu",
                                 **opts)
    assert ct.frontiers == cj.frontiers and ct.k_leaf == cj.k_leaf
    assert ct.pair_mults == cj.pair_mults and len(ct.pair_mults) == 4
    assert ct.fallback is None
    defaults = tcl.build_cluster_bvh(st, tile=64, dense_start=8)
    assert ct.frontiers != defaults.frontiers


def test_autotune_for_render_attaches_the_fallback(big, monkeypatch):
    """With ``exact_fallback`` (the default) the tuned BVH carries the
    packed walk of the scene, the native build's tables; the probe itself
    is replaced by a stub that reports fixed needs, so that the caps follow
    from them: ceil(need x slack) + 2 and ceil(pairs x 1.05 / Q)."""
    _, st = big
    _, camt = _cams(16, 16)
    cfg = TConfig(width=16, height=16, **RENDER)
    calls = []

    def probe(probe_cb, scene, cam, cfg_, key, ifn, ofn, Q, pix_lo, n):
        calls.append((pix_lo, n, key, Q))
        return np.array([5, 10, 7]), np.array([300, 200])

    monkeypatch.setattr(tcl, "_probe_segment", probe)
    cb = tcl.autotune_for_render(st, camt, cfg, queue=128, segments=2,
                                 warm_steps=1, probe_steps=2, tile=64,
                                 dense_start=8, slack=1.3, device="cpu")
    assert calls == [(0, 3, (0, 7), 128), (128, 3, (0, 7), 128)]
    assert [lv.shape[0] for lv in cb.levels] == [8, 64, 512]
    assert cb.frontiers == (8, 15, 12) and cb.k_leaf == 12
    assert cb.pair_mults == (8, 8, 3, 2)
    assert cb.fallback is not None
    np.testing.assert_array_equal(cb.fallback.table,
                                  tnative.build_packed(st).table)


def test_autotune_for_camera_is_the_standard_render_probe(monkeypatch):
    """autotune_for_camera hands the standard render workload (spp 1,
    depth 4, RR 2 / 0.7) and its knobs to autotune_for_render."""
    seen = {}

    def spy(scene, cam, cfg, **kw):
        seen.update(cfg=cfg, **kw)
        return "tuned"

    monkeypatch.setattr(tcl, "autotune_for_render", spy)
    st = jc.cornell("spheres")
    out = tcl.autotune_for_camera(st, None, 640, 480, slack=1.4,
                                  pair_budget=3, queue=512, device="cpu")
    assert out == "tuned"
    assert seen["cfg"] == TConfig(width=640, height=480, **RENDER)
    assert (seen["slack"], seen["pair_budget"], seen["queue"],
            seen["device"]) == (1.4, 3, 512, "cpu")
