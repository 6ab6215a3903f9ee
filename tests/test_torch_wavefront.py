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
    kw = dict(backend="cluster", device="cpu")
    a = twf.render_wavefront(st, cam, cfg, (0, 1), ct, queue=256, **kw)
    b = twf.render_wavefront_counts(st, cam, cfg, (0, 1), ct, queue=256,
                                    **kw)[0]
    c = twf.render_wavefront(st, cam, cfg, (0, 1), ct, queue=256, **kw,
                             use_kernels=False)
    assert torch.equal(a, b) and torch.equal(a, c)
    # Queue width does not change which random numbers a sample sees.
    d = twf.render_wavefront(st, cam, cfg, (0, 1), ct, queue=100, **kw)
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
                                       queue=256, backend="cluster",
                                       device="cpu")[3] == 0
    bad = tcl.build_cluster_bvh(scene, tile=32,
                                frontiers=(1,) * len(good.levels), k_leaf=1,
                                pair_mults=(1, 1, 1))
    assert twf.render_wavefront_counts(scene, cam, cfg, (0, 5), bad,
                                       queue=256, backend="cluster",
                                       device="cpu")[3] > 0


DEFAULT_ENTRY_POINTS = ("render_wavefront", "render_wavefront_checked",
                        "render_wavefront_counts",
                        "render_wavefront_suspect_counts")


def _default_setup():
    """The Cornell spheres at 12 x 12, spp 2, depth 2, queue 64, key 4, and
    each package's flat SAH BVH of it (built from the same arrays)."""
    from tpu_pt.bvh.sah import build_bvh as jbuild_bvh
    from tpu_pt_torch.bvh.sah import build_bvh as tbuild_bvh

    kw = dict(width=12, height=12, spp=2, max_depth=2)
    sj, st = jc.cornell("spheres"), tc.cornell("spheres")
    return (kw, (sj, jc.camera(12, 12), JConfig(**kw), jax.random.key(4),
                 jbuild_bvh(sj)),
            (st, tc.camera(12, 12), TConfig(**kw), (0, 4), tbuild_bvh(st)))


@pytest.mark.parametrize("entry", DEFAULT_ENTRY_POINTS)
def test_default_backend_is_the_flat_bvh_as_in_jax(entry):
    """Each of the four entry points called without ``backend`` on a
    ``FlatBVH`` (both packages default to ``"bvh"``): the image to the
    image tolerance of the JAX package's default call, counts equal or
    within 0.1 %, overflow 0, and no pixel suspect."""
    _, (sj, camj, cfgj, keyj, bj), (st, camt, cfgt, keyt, bt) = \
        _default_setup()
    out_j = getattr(jwf, entry)(sj, camj, cfgj, keyj, bj, queue=64)
    out_t = getattr(twf, entry)(st, camt, cfgt, keyt, bt, queue=64,
                                device="cpu")
    if entry in ("render_wavefront", "render_wavefront_checked"):
        out_j, out_t = (out_j, 0.0, 0.0, 0, 0), (out_t, 0, 0, 0, 0)
    _check(out_j[:5], out_t[:5], (12, 12, 3))
    if entry == "render_wavefront_suspect_counts":
        assert not out_t[5].any() and not np.asarray(out_j[5]).any()


def test_default_backend_refuses_a_cluster_bvh():
    """Without ``backend``, a ``ClusterBVH`` is the wrong tree for the
    default ``"bvh"``: each of the four port entry points raises
    ``ValueError`` naming the tree it wants, where the JAX package's call
    fails as well (an ``AttributeError``: its flat walk finds no node count
    on the tree)."""
    kw, (sj, camj, cfgj, keyj, _), (st, camt, cfgt, keyt, _) = \
        _default_setup()
    cj, ct = jcl.build_cluster_bvh(sj), tcl.build_cluster_bvh(st)
    with pytest.raises(AttributeError, match="ClusterBVH"):
        jwf.render_wavefront_counts(sj, camj, cfgj, keyj, cj, queue=64)
    for entry in DEFAULT_ENTRY_POINTS:
        with pytest.raises(ValueError, match="requires a FlatBVH, not "
                                             "ClusterBVH"):
            getattr(twf, entry)(st, camt, cfgt, keyt, ct, queue=64,
                                device="cpu")


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
    kw = dict(queue=16, backend="cluster", device="cpu")
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


def _jax_debug_calls():
    """The JAX package's counterpart of each entry point, on the same
    render.  ``wavefront_loss`` is the forward half of
    ``loss_and_grad_wavefront``: its counterpart is that function."""
    from tpu_pt.diff import adjoint, params
    from tpu_pt.render import driver

    scene = jax.tree.map(jnp.asarray, jc.cornell("spheres"))
    cb = jcl.build_cluster_bvh(jc.cornell("spheres"))
    cam = jc.camera(4, 4)
    key = jax.random.key(1)
    p = params.split(scene)[0]
    target = jnp.zeros((16, 3), jnp.float32)
    img = jnp.zeros((4, 4, 3), jnp.float32)
    sus = np.ones((16,), np.int32)
    kw = dict(queue=16, backend="cluster")
    accum = jax.jit(jwf.wavefront_accum, static_argnames=(
        "cfg", "queue", "backend", "n_pix_local"))

    def loss_and_grad_wavefront(cfg):
        return adjoint.loss_and_grad_wavefront(p, scene, cam, cfg, key,
                                               target, cb, queue=16)

    return {
        "render_wavefront": lambda cfg: jwf.render_wavefront(
            scene, cam, cfg, key, cb, **kw),
        "render_wavefront_counts": lambda cfg: jwf.render_wavefront_counts(
            scene, cam, cfg, key, cb, **kw),
        "render_wavefront_suspect_counts": lambda cfg:
            jwf.render_wavefront_suspect_counts(scene, cam, cfg, key, cb,
                                                **kw),
        "repair_suspect_pixels": lambda cfg: jwf.repair_suspect_pixels(
            scene, cam, cfg, key, cb, img, sus, **kw),
        "wavefront_accum": lambda cfg: accum(
            scene, cam, cfg, key, cb, queue=16, backend="cluster", pix_lo=0,
            n_pix_local=16),
        "driver.render": lambda cfg: driver.render(scene, cam, cfg, key),
        "render_flat": lambda cfg: adjoint.render_flat(scene, cam, cfg, key),
        "render_grad": lambda cfg: adjoint.render_grad(p, scene, cam, cfg,
                                                       key, target),
        "loss_and_grad": lambda cfg: adjoint.loss_and_grad(p, scene, cam,
                                                           cfg, key, target),
        "wavefront_loss": loss_and_grad_wavefront,
        "loss_and_grad_wavefront": loss_and_grad_wavefront,
    }


ENTRY_POINTS = ("render_wavefront", "render_wavefront_counts",
                "render_wavefront_suspect_counts", "repair_suspect_pixels",
                "wavefront_accum", "driver.render", "render_flat",
                "render_grad", "loss_and_grad", "wavefront_loss",
                "loss_and_grad_wavefront")
# The JAX package's forward wavefront renders stage its checks under jit
# without checkify, which raises ValueError; its oracle renders never read
# the flag, and under loss_and_grad_wavefront's gradient no check runs.
RAISE_ON_FLAG = ENTRY_POINTS[:5]


def _leaves(out):
    """The tensors / arrays of an entry point's output, flattened."""
    if isinstance(out, dict):
        return [x for k in sorted(out) for x in _leaves(out[k])]
    if isinstance(out, (tuple, list)):
        return [x for y in out for x in _leaves(y)]
    return [out] if hasattr(out, "shape") else []


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_debug_checks_raise_at_every_rendering_entry_point(entry):
    """``debug_checks=True`` at every rendering entry point, as the JAX
    package treats it there (each case runs the JAX entry point with the
    flag): the forward wavefront renders raise ValueError and name
    ``render_wavefront_checked``; the oracle renders and the gradient of
    the wavefront render as without the flag, bit for bit."""
    calls = _debug_calls()
    assert tuple(calls) == ENTRY_POINTS
    call, call_j = calls[entry], _jax_debug_calls()[entry]
    cfg = TConfig(width=4, height=4, spp=1, max_depth=1)
    cfg_j = JConfig(width=4, height=4, spp=1, max_depth=1, debug_checks=True)
    out = call(cfg)
    if entry in RAISE_ON_FLAG:
        with pytest.raises(ValueError, match="checkify"):
            call_j(cfg_j)   # raises while tracing, before any compile
        with pytest.raises(ValueError, match="render_wavefront_checked"):
            call(cfg.replace(debug_checks=True))
    else:
        # Traced, not compiled (the JAX package's checks act when traced),
        # but for driver.render, whose chunk loop runs on the host.
        out_j = call_j(cfg_j) if entry == "driver.render" else \
            jax.eval_shape(lambda: call_j(cfg_j))
        assert _leaves(out_j)
        flagged = call(cfg.replace(debug_checks=True))
        for a, b in zip(_leaves(out), _leaves(flagged), strict=True):
            assert torch.equal(a, b), entry
    first = out[0] if isinstance(out, tuple) else out
    assert bool(torch.isfinite(first).all())
    assert TConfig.from_json(cfg.replace(debug_checks=True).to_json()) \
        .debug_checks is True


def _sanitizer_setup(**cfg_kw):
    scene = tc.cornell("spheres")
    cb = tcl.build_cluster_bvh(scene)
    cfg = TConfig(**{**dict(width=8, height=8, spp=2, max_depth=2),
                     **cfg_kw})
    return scene, tc.camera(cfg.width, cfg.height), cfg, cb


def test_render_wavefront_checked_is_the_render_on_a_sound_scene():
    scene, cam, cfg, cb = _sanitizer_setup()
    kw = dict(queue=64, device="cpu")
    img = twf.render_wavefront_checked(scene, cam, cfg, (0, 2), cb,
                                       backend="cluster", **kw)
    slow = twf.render_wavefront(scene, cam, cfg, (0, 2), cb, fast=False,
                                backend="cluster", **kw)
    fast = twf.render_wavefront(scene, cam, cfg, (0, 2), cb,
                                backend="cluster", **kw)
    assert torch.equal(img, slow) and torch.equal(img, fast)
    assert not img.requires_grad and float(img.mean()) > 0
    # The packed walk, as the JAX package's own test renders it.
    from tpu_pt_torch.bvh.native import build_packed_any

    pk = build_packed_any(scene)
    img = twf.render_wavefront_checked(scene, cam, cfg, (0, 2), pk,
                                       backend="packed", **kw)
    assert torch.equal(img, twf.render_wavefront(
        scene, cam, cfg, (0, 2), pk, backend="packed", **kw))


def _broken_intersector(monkeypatch, how):
    """Make the sanitizer's traversals return a broken closest hit."""
    real = twf._intersectors_counted

    def broken(*a, **k):
        isect, occl = real(*a, **k)

        def isect_b(scene, ro, rd, t_min, t_max):
            hit, novf = isect(scene, ro, rd, t_min, t_max)
            h = hit.hit
            if how == "t":
                hit = hit._replace(t=torch.where(h, -hit.t, hit.t))
            elif how == "t_max":
                hit = hit._replace(t=torch.where(h, 2.0 * t_max, hit.t))
            else:
                hit = hit._replace(u=torch.where(h, hit.u + 2.0, hit.u))
            return hit, novf

        return isect_b, occl

    monkeypatch.setattr(twf, "_intersectors_counted", broken)


def _nan_scene(scene, field):
    arr = getattr(scene, field).copy()
    arr.reshape(-1)[0] = np.nan if field != "sph_radius" else np.inf
    return scene._replace(**{field: arr})


@pytest.mark.parametrize("case", [
    "vertices", "normals", "sph_center", "sph_radius", "t", "t_max",
    "barycentrics", "throughput", "shading"])
def test_render_wavefront_checked_raises_the_jax_message(case, monkeypatch):
    """Each check on a scene or ray batch made to break it, with the JAX
    package's words (held against its source; the NaN-vertex case also
    against its raise)."""
    import inspect

    scene, cam, cfg, cb = _sanitizer_setup()
    message = {
        "t": "traversal: hit.t must be positive finite where hit",
        "t_max": "traversal: hit.t beyond t_max",
        "barycentrics": "traversal: barycentrics outside the triangle",
        "throughput": "wavefront: non-finite path throughput",
        "shading": "shading: non-finite radiance contribution",
    }.get(case, f"scene.{case} has non-finite values")
    jax_source = inspect.getsource(jwf)
    assert f'"{message}"' in jax_source or \
        '"scene.{name} has non-finite values"' in jax_source
    if case in ("vertices", "normals", "sph_center", "sph_radius"):
        scene = _nan_scene(scene, case)
    elif case in ("t", "t_max", "barycentrics"):
        _broken_intersector(monkeypatch, case)
    elif case == "throughput":
        # An infinite albedo, no light to sample: the first bounce's
        # contribution stays finite, its throughput does not.
        mats = scene.materials._replace(
            albedo=np.full_like(scene.materials.albedo, np.inf))
        scene = scene._replace(materials=mats, lights=scene.lights._replace(
            radiance=np.zeros_like(scene.lights.radiance)))
    else:
        mats = scene.materials._replace(
            emission=np.full_like(scene.materials.emission, np.inf))
        scene = scene._replace(materials=mats)
    with pytest.raises(twf.CheckError) as err:
        twf.render_wavefront_checked(scene, cam, cfg, (0, 2), cb, queue=64,
                                     backend="cluster", device="cpu")
    assert str(err.value) == message
    assert isinstance(err.value, ValueError)
    if case == "vertices":
        from jax.experimental import checkify

        bad = jc.cornell("spheres")
        bad = bad._replace(vertices=jnp.asarray(bad.vertices).at[0].set(
            jnp.nan))
        with pytest.raises(checkify.JaxRuntimeError, match=message):
            jwf.render_wavefront_checked(
                bad, jc.camera(8, 8), JConfig(width=8, height=8, spp=2,
                                             max_depth=2),
                jax.random.key(2), jcl.build_cluster_bvh(bad), queue=64,
                backend="cluster")
