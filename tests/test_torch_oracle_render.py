"""The oracle renderer of the port (tpu_pt_torch.render.driver.render and
integrator.radiance / render_chunk) against tpu_pt.render.driver.render on
the same scene, camera, config and key words, and the port's wavefront
renderer against the port's oracle.

Image tolerance against the JAX package: rtol 2e-4, atol 2e-5, the image
tolerance of the other parity tests.  Both packages draw the same random
numbers (bitwise-equal counter RNG), so the difference is rounding only:
over the cases below the worst absolute difference measured is 5.6e-5
(the chunk-tail case, 0.65 of the bound), 1.8e-5 elsewhere.  There the JAX
package is the one off: the port lies within 7.2e-7 of its own float64
render and the JAX package 5.6e-5 (its sphere solve cancels; the port's,
core/intersect.py::sphere_hit, does not; with the port's former solve the
worst was 4.1e-5).  Inside the port, the oracle on its intersectors and
the wavefront renderer give the same values (0 measured), held at the
same tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.kernels.intersect import PallasScene as JPallasScene
from tpu_pt.render.driver import render as jrender
from tpu_pt.scene import cornell as jc
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.kernels.intersect import PallasScene
from tpu_pt_torch.render import driver as tdriver
from tpu_pt_torch.render import integrator as tint
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.render.driver import render as trender
from tpu_pt_torch.scene import cornell as tc

import torch_port_util  # noqa: F401  (torch threads per xdist worker)


def _both(variant, backend, kw, key_i=5, pix_chunk=None):
    sj, st = jc.cornell(variant), tc.cornell(variant)
    w, h = kw["width"], kw["height"]
    img_j = jrender(sj, jc.camera(w, h), JConfig(**kw), jax.random.key(key_i),
                    backend=backend, pix_chunk=pix_chunk,
                    bvh=JPallasScene(sj) if backend == "pallas" else None)
    img_t = trender(st, tc.camera(w, h), TConfig(**kw), (0, key_i),
                    backend=backend, pix_chunk=pix_chunk, device="cpu",
                    bvh=PallasScene(st) if backend == "pallas" else None)
    return np.asarray(img_j), img_t


@pytest.mark.parametrize("variant", ["spheres", "glossy"])
@pytest.mark.parametrize("backend", ["brute", "pallas"])
def test_render_matches_jax(variant, backend):
    kw = dict(width=16, height=16, spp=2, max_depth=2)
    img_j, img_t = _both(variant, backend, kw)
    assert img_t.device.type == "cpu" and tuple(img_t.shape) == (16, 16, 3)
    assert img_t.dtype == torch.float32
    assert np.isfinite(img_t.numpy()).all() and img_t.numpy().mean() > 0.05
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("backend", ["brute", "pallas"])
def test_direct_only_and_russian_roulette_match_jax(backend):
    kw = dict(width=16, height=16, spp=2, max_depth=3, direct_only=True)
    img_j, img_t = _both("spheres", backend, kw)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=2e-4, atol=2e-5)
    # Depth 4 with roulette from bounce 1: every RR branch is taken.
    kw = dict(width=12, height=12, spp=2, max_depth=4, rr_start=1, rr_prob=0.6)
    img_j, img_t = _both("spheres", backend, kw, key_i=2)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=2e-4, atol=2e-5)


def test_two_light_samples_match_jax():
    kw = dict(width=12, height=12, spp=2, max_depth=1, ns_area_light=2)
    img_j, img_t = _both("spheres", "pallas", kw, key_i=1)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("backend", ["brute", "pallas"])
def test_chunk_tail_re_renders_the_last_pixel(backend):
    """15 x 11 = 165 pixels in chunks of 64: the last chunk holds 37 real
    pixels and 27 copies of the last one, which are cut off.  The chunking
    changes no pixel (draws are keyed by ray id)."""
    kw = dict(width=15, height=11, spp=2, max_depth=2)
    img_j, img_t = _both("spheres", backend, kw, pix_chunk=64)
    assert tuple(img_t.shape) == (11, 15, 3)
    np.testing.assert_allclose(img_t.numpy(), img_j, rtol=2e-4, atol=2e-5)
    st = tc.cornell("spheres")
    whole = trender(st, tc.camera(15, 11), TConfig(**kw), (0, 5),
                    backend=backend, device="cpu",
                    bvh=PallasScene(st) if backend == "pallas" else None)
    assert torch.equal(whole, img_t)


def test_default_chunk_rule():
    """brute: 1 << 22 ray x primitive pairs a chunk; others: (1 << 17) // spp
    pixels.  Seen through the chunk sizes render_chunk is called with."""
    st = tc.cornell("spheres")
    seen = []
    real = tdriver.render_chunk

    def spy(scene, cam, cfg, key, pixel_ids, sample_ids, isect, occl):
        seen.append(int(pixel_ids.shape[0]))
        return torch.zeros((pixel_ids.shape[0], 3))

    tdriver.render_chunk = spy
    try:
        cfg = TConfig(width=600, height=600, spp=4, max_depth=1)
        trender(st, tc.camera(600, 600), cfg, (0, 0), backend="brute",
                device="cpu")
        per = (1 << 22) // (4 * st.n_prims)
        assert seen[0] == per * 4 and len(seen) == -(-360000 // per)
        seen.clear()
        trender(st, tc.camera(600, 600), cfg, (0, 0), backend="pallas",
                bvh=PallasScene(st), device="cpu")
        assert seen == [1 << 17] * 11                  # ceil(360000 / 32768)
    finally:
        tdriver.render_chunk = real


def test_pallas_equals_brute_and_plain_versions_in_the_port():
    st = tc.cornell("mesh")
    ps = PallasScene(st)
    cfg = TConfig(width=16, height=16, spp=2, max_depth=3)
    cam = tc.camera(16, 16)
    a = trender(st, cam, cfg, (0, 7), backend="pallas", bvh=ps, device="cpu")
    b = trender(st, cam, cfg, (0, 7), backend="pallas", bvh=ps, device="cpu",
                use_kernels=False)
    assert torch.equal(a, b)
    c = trender(st, cam, cfg, (0, 7), backend="brute", device="cpu")
    np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-4, atol=2e-5)
    d = trender(st, cam, cfg, (0, 7), backend="cluster",
                bvh=tcl.build_cluster_bvh(st), device="cpu")
    np.testing.assert_allclose(a.numpy(), d.numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("variant,backend", [
    ("spheres", "brute"), ("spheres", "pallas"), ("spheres", "cluster"),
    ("mesh", "cluster")])
def test_wavefront_matches_the_ports_oracle(variant, backend):
    """Same draw ids, same shading code, same intersector: the wavefront
    renderer differs from the oracle in scheduling only.  rtol 2e-4 /
    atol 2e-5 is the JAX package's tolerance between its cluster backend and
    its oracle, held against the oracle on the brute intersector too (an
    ulp of t could move a specular path; none did)."""
    st = tc.cornell(variant)
    bvh = {"brute": None, "pallas": PallasScene(st),
           "cluster": tcl.build_cluster_bvh(st)}[backend]
    cfg = TConfig(width=20, height=20, spp=3, max_depth=3)
    cam = tc.camera(20, 20)
    ref = trender(st, cam, cfg, (0, 4), backend=backend, bvh=bvh, device="cpu")
    img, nc, ns, ovf, _ = twf.render_wavefront_counts(
        st, cam, cfg, (0, 4), bvh, queue=512, backend=backend, device="cpu")
    assert ovf == 0 and nc >= 20 * 20 * 3
    np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)
    brute_ref = trender(st, cam, cfg, (0, 4), backend="brute", device="cpu")
    np.testing.assert_allclose(img.numpy(), brute_ref.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_radiance_is_keyed_by_ray_id_not_by_position():
    """A permuted chunk gives the permuted radiance: draws depend on the ray
    id alone."""
    st = tc.cornell("spheres").to("cpu")
    cam = tc.camera(8, 8).to("cpu")
    cfg = TConfig(width=8, height=8, spp=2, max_depth=2)
    isect, occl = tdriver._intersectors("brute")
    pix = torch.arange(64).repeat_interleave(2)
    smp = torch.arange(2).repeat(64)
    a = tint.render_chunk(st, cam, cfg, (0, 9), pix, smp, isect, occl)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(128))
    b = tint.render_chunk(st, cam, cfg, (0, 9), pix[perm], smp[perm], isect,
                          occl)
    np.testing.assert_allclose(b.numpy(), a[perm].numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("backend", ["bvh", "packed", "nonsense"])
def test_unknown_and_unported_backends_raise(backend):
    """"nonsense" is no backend: it raises naming the backends there are.
    "packed" (the exact-repair walk) and "bvh" (the flat walk) are
    backends: asked for without their PackedBVH / FlatBVH they raise saying
    so."""
    st = tc.cornell("spheres")
    cfg = TConfig(width=4, height=4, spp=1, max_depth=1)
    match = {"packed": "requires a PackedBVH",
             "bvh": "requires a FlatBVH"}.get(
        backend, "brute, pallas, cluster, packed, bvh")
    with pytest.raises(ValueError, match=match):
        trender(st, tc.camera(4, 4), cfg, (0, 0), backend=backend,
                device="cpu")
    with pytest.raises(ValueError, match=match):
        tdriver._intersectors_counted(backend)
    with pytest.raises(ValueError, match=match):
        tdriver._intersectors_suspect(backend)


@pytest.mark.parametrize("backend", ["pallas", "cluster", "packed", "bvh"])
def test_backend_without_its_structure_raises(backend):
    st = tc.cornell("spheres")
    cfg = TConfig(width=4, height=4, spp=1, max_depth=1)
    with pytest.raises(ValueError, match="requires"):
        trender(st, tc.camera(4, 4), cfg, (0, 0), backend=backend,
                device="cpu")


def test_counted_pallas_intersector_reports_zero_overflow():
    st = tc.cornell("spheres")
    ps = PallasScene(st).to("cpu")
    scene = st.to("cpu")
    isect, occl = tdriver._intersectors_counted("pallas", ps)
    ro = torch.tensor([[0.0, 1.0, 3.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0]])
    hit, ovf = isect(scene, ro, rd, torch.zeros((1, 1)),
                     torch.full((1, 1), 1e30))
    assert bool(hit.hit[0, 0]) and abs(float(hit.t[0, 0]) - 4.0) < 1e-5
    assert int(ovf) == 0
    occ, ovf = occl(scene, ro, rd, torch.full((1, 1), 5.0), narrow=True)
    assert bool(occ[0, 0]) and int(ovf) == 0
