"""Scene builders, cameras and environment tables of the PyTorch port vs the
JAX package: arrays equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.core import camera as jcam
from tpu_pt.render import envmap as jenv
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import meshes as jm
from tpu_pt_torch import convert
from tpu_pt_torch.config import RenderConfig
from tpu_pt_torch.core import camera as tcam
from tpu_pt_torch.render import envmap as tenv
from tpu_pt_torch.scene import cornell as tc
from tpu_pt_torch.scene import meshes as tm

from torch_port_util import T, assert_tree_equal, camera_dict, scene_dict


@pytest.mark.parametrize("variant", ["empty", "spheres", "mesh"])
def test_cornell_equal(variant):
    assert_tree_equal(jc.cornell(variant), tc.cornell(variant))


def test_big_scene_equal():
    a, b = jm.big_scene(4), tm.big_scene(4)
    assert_tree_equal(a, b)
    assert b.n_tris == a.n_tris and b.n_prims == a.n_prims


@pytest.mark.parametrize("col_rad,col_ny", [(16, 6), (12, 9)])
def test_atrium_scene_equal(col_rad, col_ny):
    """The atrium at reduced column resolution (the full scene has
    1,044,772 triangles): every array equal."""
    a = jm.atrium_scene(col_rad=col_rad, col_ny=col_ny)
    b = tm.atrium_scene(col_rad=col_rad, col_ny=col_ny)
    assert_tree_equal(a, b)
    assert b.n_tris == a.n_tris and b.lights.count == 2


@pytest.mark.parametrize("fn,args", [("_grid_quad", ((0, 1, 2), (3, 0, 0),
                                                     (0, 0, 2), 5, 3)),
                                     ("_column", (1.0, -2.0, 0.4, 0.5, 4.6,
                                                  24, 7)),
                                     ("_box", ((-1, 0, -2), (1, 0.5, 2)))])
def test_atrium_parts_equal(fn, args):
    va, fa = getattr(jm, fn)(*args)
    vb, fb = getattr(tm, fn)(*args)
    np.testing.assert_array_equal(np.asarray(va), vb)
    np.testing.assert_array_equal(np.asarray(fa), fb)
    assert vb.dtype == np.float32 and fb.dtype == np.int32


@pytest.mark.parametrize("fn,args", [("icosphere", (3,)),
                                     ("displaced_sphere", (4,))])
def test_mesh_primitives_equal(fn, args):
    va, fa = getattr(jm, fn)(*args)
    vb, fb = getattr(tm, fn)(*args)
    np.testing.assert_array_equal(np.asarray(va), vb)
    np.testing.assert_array_equal(np.asarray(fa), fb)


@pytest.mark.parametrize("which", ["cornell", "big", "atrium"])
def test_cameras_equal(which):
    a, b = {"cornell": (jc.camera(24, 16), tc.camera(24, 16)),
            "big": (jm.big_camera(32, 24), tm.big_camera(32, 24)),
            "atrium": (jm.atrium_camera(32, 24),
                       tm.atrium_camera(32, 24))}[which]
    assert_tree_equal(a, b)
    # Rays through the same screen points agree.
    xy = np.random.RandomState(0).rand(256, 2).astype(np.float32)
    ro_a, rd_a = jcam.generate_rays(a, jnp.asarray(xy))
    ro_b, rd_b = tcam.generate_rays(b.to("cpu"), T(xy))
    np.testing.assert_allclose(np.asarray(ro_a), ro_b.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(rd_a), rd_b.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_pixel_xy_equal():
    rs = np.random.RandomState(1)
    pix = rs.randint(0, 24 * 16, size=300).astype(np.int32)
    jit = rs.rand(300, 2).astype(np.float32)
    a = jcam.pixel_xy(24, 16, jnp.asarray(pix), jnp.asarray(jit))
    b = tcam.pixel_xy(24, 16, T(pix).long(), T(jit))
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-6, atol=1e-7)


def test_env_tables_equal():
    env = jenv.gradient_sky(16, 32)
    ma, ca = jenv.build_env_tables(np.asarray(env))
    mb, cb = tenv.build_env_tables(np.asarray(env))
    np.testing.assert_array_equal(np.asarray(ma), mb)
    np.testing.assert_array_equal(np.asarray(ca), cb)
    # The no-map placeholder.
    z = np.zeros((1, 1, 3), np.float32)
    for x, y in zip(jenv.build_env_tables(z), tenv.build_env_tables(z)):
        np.testing.assert_array_equal(np.asarray(x), y)


def test_convert_round_trip():
    """convert.py rebuilds the port's containers from plain numpy dicts."""
    js_, jcam_ = jc.cornell("spheres"), jc.camera(24, 24)
    s = convert.scene_from_numpy(scene_dict(js_), device="cpu")
    assert torch.is_tensor(s.vertices) and s.vertices.device.type == "cpu"
    assert_tree_equal(js_, s)
    c = convert.camera_from_numpy(camera_dict(jcam_), device="cpu")
    assert_tree_equal(jcam_, c)


def test_render_config_matches():
    from tpu_pt.config import RenderConfig as JC

    a = JC(width=32, height=24, spp=3, max_depth=4, rr_start=2, rr_prob=0.7)
    b = RenderConfig(width=32, height=24, spp=3, max_depth=4, rr_start=2,
                     rr_prob=0.7)
    for f in ("width", "height", "spp", "max_depth", "rr_start", "rr_prob",
              "ns_area_light", "eps", "direct_only", "n_pixels"):
        assert getattr(a, f) == getattr(b, f), f


def test_film_tonemap_and_png_equal(tmp_path):
    from tpu_pt.render import film as jfilm
    from tpu_pt_torch.render import film as tfilm

    img = np.random.RandomState(0).rand(6, 9, 3).astype(np.float32) * 1.5
    np.testing.assert_array_equal(jfilm.tonemap(img), tfilm.tonemap(img))
    pa, pb = tmp_path / "a.png", tmp_path / "b.png"
    jfilm.save(str(pa), img)
    tfilm.save(str(pb), img)
    assert pa.read_bytes() == pb.read_bytes()
    assert pb.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
