"""The ray-sphere solve of the port (``core/intersect.py::sphere_hit``, the
form of ``csrc/pair_isect_common.cuh::sphere_hit``) against a float64 solve
of the same float32 inputs, and the Cornell spheres' render against the
port's own float64 render.

The five places that solve it (``ray_sphere`` under the brute backend, the
plain versions of the dense sweep, of the pair tile test, of the packed
walk's row test and of the flat walk's primitive test) give the same bits
on every edge ray of ``tools/sphere_edges.py``: origins on a sphere leaving
outward and inward, near-tangent rays, far rays and the radius-0
placeholder.  Each is within ``ULPS`` float32 ulps of the float64 solve
(``sphere_edges.solve64``: the textbook quadratic, both roots, its
discriminant's sign exact, written independently of the port's form;
``sphere_edges.ulp_error``: ulps of the larger of the hit's distance and
the ray's from the centre, over the root's condition near tangency; 2.7 at
most measured) with the same hit bit.

The float32 render lies within ``WITNESS_ATOL`` of the float64 render of
the same scene, camera and random numbers at every pixel (6.1e-6 measured,
printed); the solve that cancelled (b^2 - 4ac and -b + sqrt(disc)) fails
this test.
"""

import numpy as np
import pytest
import torch

from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.core.intersect import INF, ray_sphere
from tpu_pt_torch.kernels import cluster_isect, flat_walk, packed_walk
from tpu_pt_torch.kernels import intersect as dense
from tpu_pt_torch.kernels.intersect import PallasScene
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc
from tpu_pt_torch.tools import sphere_edges as se

from torch_port_util import T

ULPS = 8
WITNESS_ATOL = 2e-5
N = 1024


def _cases():
    """(label, centre, radius, ro, rd, t_min, t_max) for every kind on each
    Cornell sphere, and the placeholder's rays."""
    sc = tc.cornell("spheres")
    out = []
    for k, kind in enumerate(se.KINDS):
        spheres = [se.PLACEHOLDER] if kind == "placeholder" else \
            list(zip(sc.sph_center, sc.sph_radius))
        for i, (c, r) in enumerate(spheres):
            out.append((f"{kind}_{i}", c, r,
                        *se.edge_rays(c, r, kind, N, seed=7 * k + i)))
    return out


CASES = _cases()


def _prim_row(c, r):
    """The 16-wide sphere row of the dense sweep and the packed walk."""
    row = np.zeros((16,), np.float32)
    row[0:3], row[3], row[10] = c, r, 1.0
    return row


def _site_ray_sphere(c, r, ro, rd, t_min, t_max):
    return tuple(T(x) for x in se.ray_sphere_np(ro, rd, c, r, t_min, t_max))


def _site_dense(c, r, ro, rd, t_min, t_max):
    rows = np.zeros((128, 16), np.float32)
    rows[0] = _prim_row(c, r)
    hit, t, _, _ = dense._pair_test(T(rows), T(ro), T(rd), T(t_min)[:, None],
                                    T(t_max)[:, None])
    return hit[:, 0], t[:, 0]


def _site_pair_tile(c, r, ro, rd, t_min, t_max):
    R = ro.shape[0]
    tiles = np.zeros((R, 12, 32), np.float32)
    tiles[:, 0:3, 0], tiles[:, 3, 0], tiles[:, 9, 0] = c, r, 1.0
    rays = np.zeros((R, 16), np.float32)
    rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7] = ro, rd, t_min, t_max
    rays[:, 8] = 1.0
    t, _, _ = cluster_isect._mt_group(T(tiles), T(rays))
    return t[:, 0] < INF, t[:, 0]


def _site_packed_row(c, r, ro, rd, t_min, t_max):
    R = ro.shape[0]
    hit, t, _, _ = packed_walk._prim_row_test(
        T(np.tile(_prim_row(c, r), (R, 1))), torch.ones((R, 1), dtype=bool),
        T(ro), T(rd), T(t_min)[:, None], T(t_max)[:, None])
    return hit[:, 0], t[:, 0]


def _site_flat_prim(c, r, ro, rd, t_min, t_max):
    R = ro.shape[0]
    hit, t, _, _ = flat_walk._prim_test(
        torch.zeros((0, 3), dtype=torch.int32), torch.zeros((0, 3)),
        T(np.asarray(c, np.float32))[None], T(np.full((1,), r, np.float32)),
        torch.zeros((R,), dtype=torch.int64), torch.ones((R, 1), dtype=bool),
        T(ro), T(rd), T(t_min)[:, None], T(t_max)[:, None])
    return hit[:, 0], t[:, 0]


SITES = {"dense_pair_test": _site_dense,
         "cluster_isect_mt_group": _site_pair_tile,
         "packed_walk_prim_row_test": _site_packed_row,
         "flat_walk_prim_test": _site_flat_prim}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_ray_sphere_within_ulps_of_float64(case):
    """Hit bit the float64 solve's, t within ``ULPS``; the outward rays and
    the placeholder's miss, the inward rays hit the far side."""
    label, c, r, ro, rd, t_min, t_max = case
    hit, t = se.ray_sphere_np(ro, rd, c, r, t_min, t_max)
    t64 = se.solve64(ro, rd, c, r, t_min, t_max)
    np.testing.assert_array_equal(hit, t64 < np.inf, err_msg=label)
    assert (t[~hit] == np.float32(INF)).all()
    err = se.ulp_error(t[hit], t64[hit], ro[hit], rd[hit], c, r)
    assert err.size == 0 or err.max() <= ULPS, (label, float(err.max()))
    kind = label.rsplit("_", 1)[0]
    if kind in ("out", "placeholder"):
        assert not hit.any()
    elif kind in ("in", "far"):
        assert hit.all()
    else:
        assert 0 < hit.sum() < len(hit)


@pytest.mark.parametrize("site", sorted(SITES))
def test_every_site_is_ray_sphere_bitwise(site):
    """Each plain version's sphere branch gives ``ray_sphere``'s hit and t
    bit for bit, on every case (t INF where it misses)."""
    for label, c, r, ro, rd, t_min, t_max in CASES:
        h0, t0 = _site_ray_sphere(c, r, ro, rd, t_min, t_max)
        h1, t1 = SITES[site](c, r, ro, rd, t_min, t_max)
        assert torch.equal(h0, h1), label
        t1 = torch.where(h1, t1, torch.full_like(t1, INF))
        assert torch.equal(t0, t1), label


def test_degenerate_rays_miss_without_nan():
    """A zero direction (a = 0), a ray tangent at its own origin (b = 0 and
    disc = 0, so q = 0) and a ray through the centre of a radius-0 sphere
    (disc = 0) miss: hit False, t INF, no NaN taken for a hit."""
    ro = torch.tensor([[0.0, 0.0, 5.0], [1.0, 0.0, 0.0], [0.0, 0.0, 5.0]])
    rd = torch.tensor([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, -1.0]])
    centre = torch.zeros((3, 3))
    radius = torch.tensor([[1.0], [1.0], [0.0]])
    t_min, t_max = torch.zeros((3, 1)), torch.full((3, 1), 1e30)
    hit, t, _ = ray_sphere(ro, rd, centre, radius, t_min, t_max)
    assert not hit.any() and bool((t == INF).all())
    # A well-posed ray still hits the unit sphere at 4 and from inside at 1.
    hit, t, n = ray_sphere(torch.tensor([[0.0, 0.0, 5.0], [0.0, 0.0, 0.0]]),
                           torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]]),
                           torch.zeros((2, 3)), torch.ones((2, 1)),
                           torch.zeros((2, 1)), torch.full((2, 1), 1e30))
    assert hit.all() and t[:, 0].tolist() == [4.0, 1.0]
    assert n.tolist() == [[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]]


def _wavefront(scene, cam, backend, bvh=None):
    cfg = TConfig(width=64, height=32, spp=2, max_depth=2, rr_start=1,
                  rr_prob=0.8)
    with torch.no_grad():
        return twf.wavefront_accum(scene, cam, cfg, (0, 11), bvh, 4096,
                                   backend, 0, cfg.n_pixels).numpy()


@pytest.fixture(scope="module")
def witness():
    """The Cornell spheres (64 x 32, spp 2, depth 2, key 11) rendered in
    float64 through "brute": scene and camera in float64, the random
    numbers float32 as in every render."""
    st, cam = tc.cornell("spheres").to("cpu"), tc.camera(64, 32).to("cpu")
    img = _wavefront(se.as_float64(st), se.as_float64(cam), "brute")
    assert img.dtype == np.float64
    return st, cam, img


@pytest.mark.parametrize("backend", ["brute", "pallas"])
def test_render_within_atol_of_its_float64_witness(witness, backend):
    st, cam, img64 = witness
    bvh = (PallasScene(tc.cornell("spheres")).to("cpu")
           if backend == "pallas" else None)
    img = _wavefront(st, cam, backend, bvh)
    assert img.dtype == np.float32 and img.mean() > 0.1
    err = np.abs(img - img64)
    print(f"{backend}: largest |float32 - float64| {err.max():.3g}")
    assert err.max() <= WITNESS_ATOL, (backend, float(err.max()),
                                       np.unravel_index(err.argmax(),
                                                        err.shape))
