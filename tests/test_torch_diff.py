"""The differentiable path of the port (tpu_pt_torch.diff, the
differentiable wavefront loop, the order-fixed radiance accumulate) against
tpu_pt.diff and within the port.

The scenes are the JAX package's own gradient scenes (tests/test_diff.py):
a diffuse or GGX quad under an area light seen from above, whose hit points
move smoothly with every small perturbation (no silhouette crosses a
sample), and the Cornell boxes.  Each is built here by the same code in both
packages.  Tolerances: images rtol 2e-4 / atol 2e-5 (tests/test_cluster.py:
117), losses rtol 1e-5, gradients rtol 1e-3 / atol 1e-6 (the JAX package's
own queue-invariance tolerance, tests/test_diff.py:179-183); the
finite-difference checks at the JAX package's eps and tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.core.camera import Camera as JCamera
from tpu_pt.diff import adjoint as jadj
from tpu_pt.diff import params as jparams
from tpu_pt.render import wavefront as jwf
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import types as jtypes
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import native as tnative
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.core.camera import Camera as TCamera
from tpu_pt_torch.diff import adjoint as tadj
from tpu_pt_torch.diff import params as tparams
from tpu_pt_torch.kernels import _build
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc
from tpu_pt_torch.scene import types as ttypes

from torch_port_util import bvh_dict, chunks_seen

GGX = dict(kind=jtypes.MAT_GGX, albedo=(0.8, 0.6, 0.4), roughness=0.35)


def _plane_scene(types, mat_row=None):
    """A big diffuse quad at y=0 under an area light; camera above, looking
    down.  Every camera ray hits the quad for any small perturbation.
    ``types`` is either package's scene.types module."""
    g = 4.0
    verts = [(-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)]
    tris = [(0, 1, 2), (0, 2, 3)]
    mats = [0, 0]
    materials = types.make_materials([
        mat_row or dict(kind=types.MAT_DIFFUSE, albedo=(0.6, 0.4, 0.3)),
    ])
    lights = types.make_lights([
        dict(kind=types.LIGHT_AREA, position=(-0.5, 3.0, -0.5),
             edge_x=(1, 0, 0), edge_y=(0, 0, 1), normal=(0, -1, 0),
             radiance=(8.0, 8.0, 8.0)),
    ])
    return types.make_scene(np.asarray(verts, np.float32),
                            np.asarray(tris, np.int32),
                            np.asarray(mats, np.int32), materials, lights)


def _setup(spp=2, w=4, h=4, mat_row=None, **kw):
    """tests/test_diff.py::_setup in both packages: (JAX scene, camera,
    config, key), (port scene, camera, config, key)."""
    kw.setdefault("direct_only", True)
    out = []
    for types, cam_cls, cfg_cls, key in (
            (jtypes, JCamera, JConfig, jax.random.key(0)),
            (ttypes, TCamera, TConfig, (0, 0))):
        cam = cam_cls.look_at(eye=(0.0, 2.0, 0.01), target=(0, 0, 0),
                              hfov=30, aspect=1.0, up=(0, 0, -1))
        out.append((_plane_scene(types, mat_row), cam,
                    cfg_cls(width=w, height=h, spp=spp, **kw), key))
    return out


def _w_mat(n_pixels):
    """The cotangent image of tests/test_diff.py, as numpy."""
    return np.asarray(jax.random.uniform(jax.random.key(9), (n_pixels, 3)))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_grads_close(g_t, g_j, rtol=1e-3, atol=1e-6):
    assert set(g_t) == set(tparams.KEYS) == set(g_j)
    for k in tparams.KEYS:
        assert np.isfinite(_np(g_t[k])).all(), k
        np.testing.assert_allclose(_np(g_t[k]), _np(g_j[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


FLAT_CASES = {
    "direct": dict(spp=2, w=4, h=4),
    "ggx": dict(spp=2, w=4, h=4, mat_row=GGX),
    "indirect": dict(spp=2, w=6, h=6, direct_only=False, max_depth=2,
                     rr_start=5),
}


@pytest.fixture(scope="module")
def flat_jax():
    """Per case: the JAX package's image (its ``render_flat``, inside the
    jitted ``render_grad``), render_grad grads against the ``w_mat``
    cotangent, and loss_and_grad against a target at half the image;
    computed once (the jit compiles dominate)."""
    out = {}
    for name, kw in FLAT_CASES.items():
        (sj, camj, cfgj, keyj), _ = _setup(**kw)
        params, _ = jparams.split(sj)
        w_mat = _w_mat(cfgj.n_pixels)
        img, grads = jadj.render_grad(params, sj, camj, cfgj, keyj,
                                      jnp.asarray(w_mat))
        target = 0.5 * np.asarray(img)
        loss, lgrads = jadj.loss_and_grad(params, sj, camj, cfgj, keyj,
                                          jnp.asarray(target))
        out[name] = dict(img=np.asarray(img), grads=grads, w_mat=w_mat,
                         target=target, loss=float(loss), lgrads=lgrads)
    return out


def test_split_merge_round_trip_and_params_from_numpy():
    (sj, *_), (st, *_) = _setup(mat_row=GGX)
    st = st.to("cpu")
    params, same = tparams.split(st)
    assert same is st and tuple(params) == tparams.KEYS
    assert tparams.merge(params, st) == st
    moved = {k: v + 1.0 for k, v in params.items()}
    merged = tparams.merge(moved, st)
    assert tparams.split(merged)[0] == moved
    assert merged.tri_idx is st.tri_idx and merged.lights.kind is \
        st.lights.kind
    pj, _ = jparams.split(sj)
    leaves = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in pj.items()}, "cpu")
    assert tuple(leaves) == tparams.KEYS
    for k in tparams.KEYS:
        x = leaves[k]
        assert x.is_leaf and x.requires_grad and x.dtype == torch.float32
        assert torch.equal(x.detach(), params[k]), k
        np.testing.assert_array_equal(x.detach().numpy(), np.asarray(pj[k]))


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_render_flat_matches_jax(flat_jax, case):
    _, (st, camt, cfgt, keyt) = _setup(**FLAT_CASES[case])
    img = tadj.render_flat(st, camt, cfgt, keyt, device="cpu")
    assert tuple(img.shape) == (cfgt.n_pixels, 3) and img.device.type == "cpu"
    assert float(img.mean()) > 0.01
    np.testing.assert_allclose(img.numpy(), flat_jax[case]["img"], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.parametrize("case", sorted(FLAT_CASES))
def test_render_grad_and_loss_and_grad_match_jax(flat_jax, case):
    """All five gradients of render_grad (the ``w_mat`` cotangent) and of
    loss_and_grad, and the loss; then one descent step on albedo lowers the
    port's loss (tests/test_diff.py:186-205)."""
    ref = flat_jax[case]
    (sj, *_), (st, camt, cfgt, keyt) = _setup(**FLAT_CASES[case])
    params = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jparams.split(sj)[0].items()}, "cpu")
    img, grads = tadj.render_grad(params, st, camt, cfgt, keyt, ref["w_mat"],
                                  device="cpu")
    np.testing.assert_allclose(img.numpy(), ref["img"], rtol=2e-4,
                               atol=2e-5)
    _assert_grads_close(grads, ref["grads"])
    loss, lgrads = tadj.loss_and_grad(params, st, camt, cfgt, keyt,
                                      ref["target"], device="cpu")
    assert loss.dim() == 0 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    _assert_grads_close(lgrads, ref["lgrads"])
    stepped = dict(params, albedo=params["albedo"] - 2.0 * lgrads["albedo"])
    loss1, _ = tadj.loss_and_grad(stepped, st, camt, cfgt, keyt,
                                  ref["target"], device="cpu")
    assert float(loss1) < float(loss)


def test_render_grad_matches_jax_through_glossy_bounces():
    """Cornell ``glossy`` (GGX walls), depth 3: the BSDF's sampling
    decisions (the detached alpha, half-vector direction and pdf of the GGX
    lobe, the detached sampled direction) shape every gradient after the
    first bounce; the quad scenes above have nothing to bounce to."""
    kw = dict(width=6, height=6, spp=2, max_depth=3)
    sj = jc.cornell("glossy")
    pj = {k: np.asarray(v) for k, v in jparams.split(sj)[0].items()}
    w_mat = _w_mat(36)
    img_j, g_j = jadj.render_grad(pj, sj, jc.camera(6, 6), JConfig(**kw),
                                  jax.random.key(3), jnp.asarray(w_mat))
    img, grads = tadj.render_grad(
        convert.params_from_numpy(pj, "cpu"), tc.cornell("glossy"),
        tc.camera(6, 6), TConfig(**kw), (0, 3), w_mat, device="cpu")
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=2e-4,
                               atol=2e-5)
    _assert_grads_close(grads, g_j)
    assert float(grads["roughness"].abs().sum()) > 0


def _scalar(params, scene, cam, cfg, key, w_mat):
    img = tadj.render_flat(tparams.merge(params, scene), cam, cfg, key,
                           device="cpu")
    return float(torch.sum(img * torch.tensor(w_mat)))


FD_CASES = {
    # name: (param, index, eps, rtol, atol, _setup keywords); the values of
    # tests/test_diff.py:57-131.
    "albedo": ("albedo", (0, 0), 1e-2, 2e-2, 1e-5, {}),
    "light_radiance": ("light_radiance", (0, 1), 1e-2, 2e-2, 1e-5, {}),
    "vertex": ("vertices", (2, 1), 5e-3, 8e-2, 5e-3, {}),
    "emission_cornell": ("emission", (3, 0), 0.5, 2e-2, 0.0, None),
    "roughness": ("roughness", (0,), 1e-2, 2e-2, 1e-5, dict(mat_row=GGX)),
    "ggx_albedo": ("albedo", (0, 1), 1e-2, 2e-2, 1e-5, dict(mat_row=GGX)),
    "indirect_albedo": ("albedo", (0, 1), 1e-2, 5e-2, 1e-5,
                        dict(spp=2, direct_only=False, max_depth=2,
                             rr_start=5)),
}


@pytest.mark.parametrize("case", sorted(FD_CASES))
def test_finite_difference(case):
    """The JAX package's seven finite-difference checks, on the port."""
    name, idx, eps, rtol, atol, kw = FD_CASES[case]
    if kw is None:   # the emissive Cornell box, seen directly
        scene = tc.cornell("empty")
        cam = tc.camera(8, 8)
        cfg = TConfig(width=8, height=8, spp=2, direct_only=True)
        key = (0, 1)
        w_mat = np.ones((cfg.n_pixels, 3), np.float32)
    else:
        _, (scene, cam, cfg, key) = _setup(**kw)
        w_mat = _w_mat(cfg.n_pixels)
    params = {k: torch.as_tensor(v) for k, v in
              tparams.split(scene.to("cpu"))[0].items()}
    _, grads = tadj.render_grad(params, scene, cam, cfg, key, w_mat,
                                device="cpu")
    g = float(grads[name][idx])

    def eval_at(delta):
        arr = params[name].clone()
        arr[idx] += delta
        return _scalar(dict(params, **{name: arr}), scene, cam, cfg, key,
                       w_mat)

    fd = (eval_at(eps) - eval_at(-eps)) / (2 * eps)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=atol)


# ---- the differentiable wavefront loop --------------------------------------

@pytest.fixture(scope="module")
def wave64():
    """tests/test_diff.py:134-183's set-up: 64², spp 1, the cluster BVH,
    target zeros; the JAX package's loss and grads at queue 1024 and the
    port's inputs (the same cluster BVH, carried across)."""
    (sj, camj, cfgj, keyj), (st, camt, cfgt, keyt) = _setup(spp=1, w=64, h=64)
    cj = jcl.build_cluster_bvh(sj)
    params, _ = jparams.split(sj)
    target = np.zeros((cfgj.n_pixels, 3), np.float32)
    loss, grads = jadj.loss_and_grad_wavefront(
        params, sj, camj, cfgj, keyj, jnp.asarray(target), cj, queue=1024)
    return dict(loss=float(loss), grads=grads, scene=st, cam=camt, cfg=cfgt,
                key=keyt, bvh=convert.cluster_bvh_from_numpy(bvh_dict(cj),
                                                            "cpu"),
                params={k: np.asarray(v) for k, v in params.items()},
                target=target)


def _wave(w, queue, params=None, **kw):
    return tadj.loss_and_grad_wavefront(
        w["params"] if params is None else params, w["scene"], w["cam"],
        w["cfg"], w["key"], w["target"], w["bvh"], queue=queue, device="cpu",
        **kw)


def test_loss_and_grad_wavefront_matches_jax(wave64):
    loss, grads = _wave(wave64, 1024)
    np.testing.assert_allclose(float(loss), wave64["loss"], rtol=1e-5)
    _assert_grads_close(grads, wave64["grads"])
    assert float(grads["albedo"].abs().sum()) > 0
    assert float(grads["vertices"].abs().sum()) > 0


def test_loss_and_grad_wavefront_finite_difference(wave64):
    """tests/test_diff.py:147-166 on the port: albedo moves no sampling
    decision, so the loss is smooth in it."""
    _, grads = _wave(wave64, 1024)
    g = float(grads["albedo"][0, 0])
    eps = 1e-2

    def loss_at(d):
        arr = wave64["params"]["albedo"].copy()
        arr[0, 0] += d
        return float(_wave(wave64, 1024, dict(wave64["params"],
                                              albedo=arr))[0])

    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-7)


def test_loss_and_grad_wavefront_queue_invariance(wave64):
    """tests/test_diff.py:168-183 on the port: the queue width changes no
    random number, and (the accumulate having one order) no bit."""
    l_small, g_small = _wave(wave64, 256)
    l_big, g_big = _wave(wave64, 4096)
    np.testing.assert_allclose(float(l_small), float(l_big), rtol=1e-5)
    _assert_grads_close(g_small, g_big)


def test_steps_hint_matches_full_bound():
    """tests/test_diff.py:208-241 on the port (packed backend): a sufficient
    hint changes nothing, bit for bit, and reports done; a hint of 3 does
    not."""
    scene = tc.cornell("spheres")
    pk = tnative.build_packed(scene)
    cfg = TConfig(width=16, height=16, spp=2, max_depth=3)
    cam = tc.camera(16, 16)
    params = tparams.split(scene.to("cpu"))[0]
    target = np.zeros((cfg.n_pixels, 3), np.float32)
    kw = dict(backend="packed", queue=128, device="cpu")
    assert twf.n_steps(cfg, 128) == 20
    loss0, g0 = tadj.loss_and_grad_wavefront(params, scene, cam, cfg, (0, 2),
                                             target, pk, **kw)
    loss1, g1, done = tadj.loss_and_grad_wavefront(
        params, scene, cam, cfg, (0, 2), target, pk, steps_hint=18, **kw)
    assert done is True
    assert float(loss0) == float(loss1) and float(loss0) > 0
    for k in tparams.KEYS:
        assert torch.equal(g0[k], g1[k]), k
    _, _, done_small = tadj.loss_and_grad_wavefront(
        params, scene, cam, cfg, (0, 2), target, pk, steps_hint=3, **kw)
    assert done_small is False


def _counting(monkeypatch, module, name, log):
    """Replace ``module.name`` (an intersector factory) by one whose
    closures log every call and keep every output."""
    real = getattr(module, name)

    def factory(*a, **k):
        fns = real(*a, **k)

        def wrap(fn):
            def run(*args, **kw):
                out = fn(*args, **kw)
                log.append(out)
                return out
            return run
        return tuple(wrap(f) for f in fns)

    monkeypatch.setattr(module, name, factory)


@pytest.mark.parametrize("path", ["wavefront", "flat", "wavefront_remat"])
def test_traversals_stay_out_of_backward(monkeypatch, path):
    """No intersector runs between the end of the forward pass and the end
    of backward(), and no traversal output carries a graph.  At queue 64
    the loop runs 9 steps; at queue 12 (``wavefront_remat``) it runs more
    than 16, and backward recomputes every chunk on its kept records."""
    log = []
    _, (st, cam, cfg, key) = _setup(
        spp=2, w=8, h=8, mat_row=GGX, direct_only=False, max_depth=2)
    st, cam = st.to("cpu"), cam.to("cpu")
    params = convert.params_from_numpy(
        {k: v.numpy() for k, v in tparams.split(st)[0].items()}, "cpu")
    if path.startswith("wavefront"):
        _counting(monkeypatch, twf, "_intersectors_counted", log)
        chunks = chunks_seen(monkeypatch)
        bvh = tcl.build_cluster_bvh(st).to("cpu")
        loss, img, counts, done = tadj.wavefront_loss(
            params, st, cam, cfg, key, torch.zeros((cfg.n_pixels, 3)), bvh,
            queue=12 if path == "wavefront_remat" else 64, use_kernels=False)
        assert done and counts[3] > (16 if path == "wavefront_remat" else 2)
        assert bool(chunks) == (path == "wavefront_remat")
    else:
        _counting(monkeypatch, tadj, "_intersectors", log)
        img = tadj.render_flat(tparams.merge(params, st), cam, cfg, key,
                               device="cpu", use_kernels=False)
        loss = torch.mean(img ** 2)
    n_forward = len(log)
    assert n_forward > 0 and loss.requires_grad
    loss.backward()
    assert len(log) == n_forward, "a traversal ran during backward()"
    if path.startswith("wavefront"):
        assert all(c.replays == 1 for c in chunks)
    def tensors(x):
        if torch.is_tensor(x):
            yield x
        elif isinstance(x, tuple):
            for y in x:
                yield from tensors(y)

    for x in tensors(tuple(log)):
        assert x.grad_fn is None and not x.requires_grad
    for k in tparams.KEYS:
        assert params[k].grad is not None and \
            bool(torch.isfinite(params[k].grad).all()), k
    assert float(params["vertices"].grad.abs().sum()) > 0
    assert float(params["roughness"].grad.abs().sum()) > 0


# ---- the order-fixed accumulate ----------------------------------------------

def _accumulate_before(accum, row, contrib, alive):
    """The accumulate as it was before the per-sample rows, spp = 1 form
    (row == pixel): live lanes add in place at their pixel, dead lanes at
    distinct spare rows past the image."""
    Q = row.shape[0]
    n_pix_local = accum.shape[0] - Q
    contrib = torch.where(alive, contrib, torch.zeros_like(contrib))
    lane = torch.arange(Q, device=row.device)
    pixel_u = torch.where(alive[:, 0], row, n_pix_local + lane)
    accum.index_add_(0, pixel_u, contrib)
    return accum


def test_accumulate_at_spp1_is_the_accumulate_before_bitwise(monkeypatch):
    scene, cam = tc.cornell("spheres"), tc.camera(16, 16)
    cb = tcl.build_cluster_bvh(scene)
    cfg = TConfig(width=16, height=16, spp=1, max_depth=3)
    kw = dict(queue=96, backend="cluster", device="cpu")
    new = twf.render_wavefront_counts(scene, cam, cfg, (0, 4), cb, **kw)
    monkeypatch.setattr(twf, "_accumulate", _accumulate_before)
    old = twf.render_wavefront_counts(scene, cam, cfg, (0, 4), cb, **kw)
    assert torch.equal(new[0], old[0]) and new[1:] == old[1:]


def test_accumulate_at_spp4_matches_jax_and_ignores_the_queue():
    """Several samples of a pixel are in flight in one step: the image is
    within the image tolerance of the JAX package's, and the same bits at
    any queue width (each sample's sum runs in bounce order, the samples
    are added in sample order)."""
    kw = dict(width=12, height=12, spp=4, max_depth=3)
    sj = jc.cornell("spheres")
    cj = jcl.build_cluster_bvh(sj)
    img_j = jwf.render_wavefront_counts(sj, jc.camera(12, 12), JConfig(**kw),
                                        jax.random.key(6), cj, queue=100,
                                        backend="cluster")[0]
    st, cam, cfg = tc.cornell("spheres"), tc.camera(12, 12), TConfig(**kw)
    ct = convert.cluster_bvh_from_numpy(bvh_dict(cj), "cpu")
    imgs = [twf.render_wavefront(st, cam, cfg, (0, 6), ct, queue=q,
                                 backend="cluster", device="cpu")
            for q in (100, 256)]
    np.testing.assert_allclose(imgs[0].numpy(), np.asarray(img_j), rtol=2e-4,
                               atol=2e-5)
    assert torch.equal(imgs[0], imgs[1])


def test_repair_at_spp2_equals_the_full_exact_render():
    """Suspect-pixel repair at spp 2 (the render24 set-up of
    test_torch_exact_repair.py, caps cut to a sixth): every repaired pixel is
    its value in the full fallback-attached render, bit for bit."""
    scene = jc.cornell("mesh")
    cb0 = jcl.build_cluster_bvh(scene, tile=32)
    cj = jcl.build_cluster_bvh(
        scene, tile=32, frontiers=tuple(max(2, c // 6) for c in cb0.frontiers),
        k_leaf=max(3, cb0.k_leaf // 6), pair_mults=(8, 8, 2))
    ct = convert.cluster_bvh_from_numpy(bvh_dict(cj), "cpu")
    st = tc.cornell("mesh")
    fb = tcl.attach_fallback(ct, st)
    cam = tc.camera(16, 16)
    cfg = TConfig(width=16, height=16, spp=2, max_depth=2)
    kw = dict(queue=256, backend="cluster", device="cpu")
    img, *_, novf, _, sus = twf.render_wavefront_suspect_counts(
        st, cam, cfg, (0, 9), ct, **kw)
    assert novf > 0 and 0 < int(sus.sum()) < cfg.n_pixels
    rep, _ = twf.repair_suspect_pixels(st, cam, cfg, (0, 9), fb, img, sus,
                                       **kw)
    full = twf.render_wavefront(st, cam, cfg, (0, 9), fb, **kw)
    hit = (sus > 0).reshape(16, 16)
    assert torch.equal(rep[hit], full[hit])
    assert torch.equal(rep[~hit], img[~hit])


# ---- kernel wrappers refuse inputs that require grad -------------------------

def test_check_cuda_input_refuses_grad_first():
    x = torch.zeros(8, requires_grad=True)   # on the CPU, and requires grad
    with pytest.raises(ValueError, match="requires grad"):
        _build.check_cuda_input("x", x, torch.float32)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        _build.check_cuda_input("x", x.detach(), torch.float32)


def _wrapper_calls():
    from tpu_pt_torch.kernels import cluster_isect, intersect, packed_walk
    from tpu_pt_torch.kernels import pair_fused, pair_scan

    g = torch.zeros(4, requires_grad=True)
    z = torch.zeros(4)
    return {
        "pair_tile_isect": lambda: cluster_isect.pair_tile_isect(z, z, g),
        "pair_tile_isect_dedup":
            lambda: cluster_isect.pair_tile_isect_dedup(z, z, g),
        "pair_segmin": lambda: pair_scan.pair_segmin(g, z, z, z, z, z),
        "pair_ray_reduce": lambda: pair_fused.pair_ray_reduce(
            z, z, g, z, z, z, z, z, z),
        "dense_closest": lambda: intersect.dense_closest(g, z),
        "dense_anyhit": lambda: intersect.dense_anyhit(z, g),
        "packed_walk": lambda: packed_walk.packed_walk(
            z, z, z, g, z, z, 1, 1, 1),
    }


@pytest.mark.parametrize("kernel", sorted(_wrapper_calls()))
def test_kernel_wrappers_and_plain_versions_refuse_grad(kernel):
    """Each wrapper, given CPU tensors, enters its plain version, whose
    first check refuses an input that requires grad."""
    with pytest.raises(ValueError, match="requires grad"):
        _wrapper_calls()[kernel]()


@pytest.mark.gpu
def test_on_the_card_backward_launches_no_kernel_and_wrappers_refuse_grad():
    """Needs an NVIDIA GPU and nvcc: loss_and_grad_wavefront at 64² on the
    card (cluster backend, fused pair stage) launches its pair kernel in the
    forward pass only, agrees with the plain versions bit for bit, and a
    CUDA tensor that requires grad is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from tpu_pt_torch.kernels import pair_fused

    x = torch.zeros(8, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        _build.check_cuda_input("x", x, torch.float32)
    _, (st, cam, cfg, key) = _setup(spp=1, w=64, h=64)
    bvh = tcl.build_cluster_bvh(st)
    st, cam, bvh = st.to("cuda"), cam.to("cuda"), bvh.to("cuda")
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in tparams.split(st)[0].items()}
    target = torch.zeros((cfg.n_pixels, 3), device="cuda")
    n0 = pair_fused.pair_ray_reduce.launches
    loss, _, counts, done = tadj.wavefront_loss(leaves, st, cam, cfg, key,
                                                target, bvh, queue=1024)
    torch.cuda.synchronize()
    n_fwd = pair_fused.pair_ray_reduce.launches - n0
    loss.backward()
    torch.cuda.synchronize()
    assert done and n_fwd == 2 * counts[3] > 0
    assert pair_fused.pair_ray_reduce.launches - n0 == n_fwd
    p = {k: v.detach() for k, v in leaves.items()}
    lk, gk = tadj.loss_and_grad_wavefront(p, st, cam, cfg, key, target, bvh,
                                          queue=1024)
    lp, gp = tadj.loss_and_grad_wavefront(p, st, cam, cfg, key, target, bvh,
                                          queue=1024, use_kernels=False)
    assert torch.equal(lk, lp)
    for k in tparams.KEYS:
        assert torch.equal(gk[k], gp[k]), k
        assert torch.equal(gk[k], leaves[k].grad), k
