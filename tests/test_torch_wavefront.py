"""The slice as a whole: tpu_pt_torch.render.wavefront vs tpu_pt.render.
wavefront on the same scene, camera, config and key words.

Image tolerance rtol 2e-4, atol 2e-5 (the JAX package's own cluster-vs-oracle
tolerance).  Counts are equal; where one ulp of t flips a grazing hit in one
package only, a count may move, so each count is asserted equal OR within
0.1 % (and the test then still holds the image to the tolerance above)."""

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
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc
from tpu_pt_torch.scene import meshes as tm

from torch_port_util import assert_tree_equal, camera_dict


def _close_count(a, b, what):
    a, b = int(a), int(b)
    if a != b:   # one ulp of t flipped a grazing hit in one package
        assert abs(a - b) <= 1e-3 * max(a, b), f"{what}: {a} vs {b}"


def _render_both(which, kw, queue, key_i=3, backend="cluster"):
    if which == "cornell":
        sj, st = jc.cornell("spheres"), tc.cornell("spheres")
        camj, camt = (m.camera(kw["width"], kw["height"]) for m in (jc, tc))
        bkw = {}
    else:
        sj, st = jm.big_scene(4), tm.big_scene(4)
        camj, camt = (m.big_camera(kw["width"], kw["height"]) for m in (jm, tm))
        bkw = dict(tile=64)
    cj = ct = None
    if backend == "cluster":
        cj = jcl.build_cluster_bvh(sj, **bkw)
        ct = tcl.build_cluster_bvh(st, **bkw)
    out_j = jwf.render_wavefront_counts(sj, camj, JConfig(**kw),
                                        jax.random.key(key_i), cj,
                                        queue=queue, backend=backend)
    out_t = twf.render_wavefront_counts(st, camt, TConfig(**kw), (0, key_i),
                                        ct, queue=queue, backend=backend,
                                        device="cpu")
    return out_j, out_t


def _check(out_j, out_t, shape):
    img_j, nc_j, ns_j, novf_j, it_j = out_j
    img_t, nc_t, ns_t, novf_t, it_t = out_t
    img_j = np.asarray(img_j)
    assert img_t.device.type == "cpu" and tuple(img_t.shape) == shape
    assert np.isfinite(img_t.numpy()).all() and img_t.numpy().mean() > 0.01
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=2e-4, atol=2e-5)
    _close_count(nc_t, float(nc_j), "n_closest")
    _close_count(ns_t, float(ns_j), "n_shadow")
    assert int(novf_t) == int(novf_j) == 0
    assert abs(int(it_t) - int(it_j)) <= 1
    assert all(isinstance(x, int) for x in (nc_t, ns_t, novf_t, it_t))


def test_cornell_spheres_matches_jax():
    """Sphere primitives, mirror and glass lobes, spp 4 (several samples per
    pixel share accumulator rows)."""
    kw = dict(width=24, height=24, spp=4, max_depth=3)
    _check(*_render_both("cornell", kw, queue=512), (24, 24, 3))


def test_big_scene_matches_jax():
    """The headline scene's small sibling with the headline's settings:
    spp 1, depth 4, russian roulette from depth 2 at 0.7."""
    kw = dict(width=32, height=32, spp=1, max_depth=4, rr_start=2, rr_prob=0.7)
    out_j, out_t = _render_both("big", kw, queue=1024)
    _check(out_j, out_t, (32, 32, 3))
    assert out_t[4] < twf.n_steps(TConfig(**kw), 1024)   # the loop left early


def test_big_scene_matches_jax_with_the_four_way_split_live(monkeypatch):
    """Both packages run every traversal as 4 strided sub-batches (the split
    normally needs a queue of 4096; here it is forced at queue 512)."""
    monkeypatch.setattr(jcl, "_split_batches", lambda Q, s: max(1, int(s)))
    monkeypatch.setattr(tcl, "_split_batches", lambda Q, s: max(1, int(s)))
    kw = dict(width=32, height=32, spp=1, max_depth=4, rr_start=2, rr_prob=0.7)
    _check(*_render_both("big", kw, queue=512, key_i=5), (32, 32, 3))


def test_brute_backend_matches_jax():
    kw = dict(width=12, height=12, spp=2, max_depth=2)
    _check(*_render_both("cornell", kw, queue=128, backend="brute"),
           (12, 12, 3))


def test_direct_only_matches_jax():
    kw = dict(width=16, height=16, spp=2, max_depth=3, direct_only=True)
    _check(*_render_both("cornell", kw, queue=256), (16, 16, 3))


def test_render_wavefront_image_equals_counts_image():
    st, ct = tc.cornell("spheres"), tcl.build_cluster_bvh(tc.cornell("spheres"))
    cfg = TConfig(width=16, height=16, spp=2, max_depth=2)
    cam = tc.camera(16, 16)
    a = twf.render_wavefront(st, cam, cfg, (0, 1), ct, queue=256, device="cpu")
    b = twf.render_wavefront_counts(st, cam, cfg, (0, 1), ct, queue=256,
                                    device="cpu")[0]
    c = twf.render_wavefront(st, cam, cfg, (0, 1), ct, queue=256, device="cpu",
                             use_kernels=False)
    assert torch.equal(a, b) and torch.equal(a, c)
    # Queue width does not change which random numbers a sample sees.
    d = twf.render_wavefront(st, cam, cfg, (0, 1), ct, queue=100, device="cpu")
    np.testing.assert_allclose(a.numpy(), d.numpy(), rtol=1e-5, atol=1e-6)


def test_overflow_surfaced_out_of_contract():
    """Static caps too small for the scene must be REPORTED by the render."""
    v, f = tm.icosphere(subdiv=3)
    from tpu_pt_torch.scene.types import make_lights, make_materials, make_scene

    scene = make_scene(v, f, np.zeros(len(f), np.int32),
                       make_materials([dict(albedo=(0.5, 0.5, 0.5))]),
                       make_lights([]))
    cam = tc.camera(16, 16)
    cfg = TConfig(width=16, height=16, spp=2, max_depth=2)
    good = tcl.build_cluster_bvh(scene, tile=32)
    assert twf.render_wavefront_counts(scene, cam, cfg, (0, 5), good,
                                       queue=256, device="cpu")[3] == 0
    bad = tcl.build_cluster_bvh(scene, tile=32,
                                frontiers=(1,) * len(good.levels), k_leaf=1,
                                pair_mults=(1, 1, 1))
    assert twf.render_wavefront_counts(scene, cam, cfg, (0, 5), bad,
                                       queue=256, device="cpu")[3] > 0


def test_queue_bookkeeping_matches_jax():
    """init_queue, n_steps and one respawn: the same lanes get the same
    samples and the same camera rays."""
    kw = dict(width=16, height=8, spp=3, max_depth=4)
    cj, ctc = JConfig(**kw), TConfig(**kw)
    for q in (64, 4096):
        assert jwf.n_steps(cj, q) == twf.n_steps(ctc, q)
    assert jwf.WIDE_PREFIX_STEPS == twf.WIDE_PREFIX_STEPS
    camj = jc.camera(16, 8)
    camt = convert.camera_from_numpy(camera_dict(camj), "cpu")
    sj = jwf.init_queue(64, cj.n_pixels)
    st = twf.init_queue(64, ctc.n_pixels, "cpu")
    # Kill a pattern of lanes after a first fill, then refill.
    sj = jwf._respawn(camj, cj, jax.random.key(2), sj, 0, cj.n_pixels, 0, 3)
    st = twf._respawn(camt, ctc, (0, 2), st, 0, ctc.n_pixels, 0, 3)
    alive = (np.arange(64) % 3 != 0)[:, None]
    sj = sj._replace(alive=jnp.asarray(alive))
    st = st._replace(alive=torch.from_numpy(alive))
    sj = jwf._respawn(camj, cj, jax.random.key(2), sj, 0, cj.n_pixels, 0, 3)
    st = twf._respawn(camt, ctc, (0, 2), st, 0, ctc.n_pixels, 0, 3)
    for f in ("ray_id", "depth", "include_le", "alive", "next_sample"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, f)),
                                      getattr(st, f).numpy(), err_msg=f)
    np.testing.assert_allclose(np.asarray(sj.rd), st.rd.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(sj.ro), st.ro.numpy())
    np.testing.assert_array_equal(np.asarray(sj.beta), st.beta.numpy())


def _debug_calls():
    """Every rendering entry point that takes a RenderConfig, called on a
    tiny Cornell render with the given config (on the CPU)."""
    from tpu_pt_torch.diff import adjoint, params
    from tpu_pt_torch.render import driver

    scene = tc.cornell("spheres")
    cb = tcl.build_cluster_bvh(scene)
    cam = tc.camera(4, 4)
    p = {k: np.asarray(v) for k, v in params.split(scene)[0].items()}
    target = np.zeros((16, 3), np.float32)
    img = torch.zeros((4, 4, 3))
    sus = torch.ones((16,), dtype=torch.int32)
    kw = dict(queue=16, device="cpu")
    sc, camc, cbc = scene.to("cpu"), cam.to("cpu"), cb.to("cpu")
    return {
        "render_wavefront": lambda cfg: twf.render_wavefront(
            scene, cam, cfg, (0, 1), cb, **kw),
        "render_wavefront_counts": lambda cfg: twf.render_wavefront_counts(
            scene, cam, cfg, (0, 1), cb, **kw),
        "render_wavefront_suspect_counts": lambda cfg:
            twf.render_wavefront_suspect_counts(scene, cam, cfg, (0, 1), cb,
                                                **kw),
        "repair_suspect_pixels": lambda cfg: twf.repair_suspect_pixels(
            scene, cam, cfg, (0, 1), cb, img, sus, **kw),
        "wavefront_accum": lambda cfg: twf.wavefront_accum(
            sc, camc, cfg, (0, 1), cbc, 16, "cluster", 0, 16),
        "driver.render": lambda cfg: driver.render(scene, cam, cfg, (0, 1),
                                                   device="cpu"),
        "render_flat": lambda cfg: adjoint.render_flat(scene, cam, cfg,
                                                       (0, 1), device="cpu"),
        "render_grad": lambda cfg: adjoint.render_grad(
            p, scene, cam, cfg, (0, 1), target, device="cpu"),
        "loss_and_grad": lambda cfg: adjoint.loss_and_grad(
            p, scene, cam, cfg, (0, 1), target, device="cpu"),
        "wavefront_loss": lambda cfg: adjoint.wavefront_loss(
            convert.params_from_numpy(p, "cpu"), sc, camc, cfg, (0, 1),
            torch.from_numpy(target), cbc, queue=16),
        "loss_and_grad_wavefront": lambda cfg:
            adjoint.loss_and_grad_wavefront(p, scene, cam, cfg, (0, 1),
                                            target, cb, **kw),
    }


ENTRY_POINTS = ("render_wavefront", "render_wavefront_counts",
                "render_wavefront_suspect_counts", "repair_suspect_pixels",
                "wavefront_accum", "driver.render", "render_flat",
                "render_grad", "loss_and_grad", "wavefront_loss",
                "loss_and_grad_wavefront")


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_debug_checks_raise_at_every_rendering_entry_point(entry):
    """The sanitizer is not ported: ``debug_checks=True`` raises, naming
    where it is planned, and ``False`` renders as before."""
    calls = _debug_calls()
    assert tuple(calls) == ENTRY_POINTS
    call = calls[entry]
    cfg = TConfig(width=4, height=4, spp=1, max_depth=1)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        call(cfg.replace(debug_checks=True))
    out = call(cfg)
    first = out[0] if isinstance(out, tuple) else out
    assert bool(torch.isfinite(first).all())
    assert TConfig.from_json(cfg.replace(debug_checks=True).to_json()) \
        .debug_checks is True
