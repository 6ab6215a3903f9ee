"""The loaders of the port (tpu_pt_torch.scene.{obj,collada,exr},
render.envmap's file I/O, scene.types.with_envmap) against the JAX
package's on the same documents and seeded arrays: every Scene array equal,
the cameras equal, the EXR and PFM files byte-equal, the refusals the
same."""

import numpy as np
import pytest

from tpu_pt.render import envmap as jenv
from tpu_pt.scene import collada as jcol
from tpu_pt.scene import cornell as jc
from tpu_pt.scene import exr as jexr
from tpu_pt.scene import obj as jobj
from tpu_pt.scene import types as jtypes
from tpu_pt_torch.render import envmap as tenv
from tpu_pt_torch.scene import collada as tcol
from tpu_pt_torch.scene import cornell as tc
from tpu_pt_torch.scene import exr as texr
from tpu_pt_torch.scene import obj as tobj
from tpu_pt_torch.scene import types as ttypes

from test_loaders import (DAE_EXTRA_LIGHTS, DAE_NORMALS_SPHERE, DAE_TEXT,
                          MTL_TEXT, OBJ_TEXT)
from torch_port_util import assert_tree_equal, camera_dict

# A camera node that rotates and a <matrix> node: the transforms the other
# documents leave out.
DAE_MATRIX = DAE_TEXT.replace(
    '<node id="camnode"><translate>0 2 4</translate>',
    '<node id="camnode"><translate>0 2 4</translate>'
    '<rotate>1 0 0 -25</rotate>').replace(
    '<node id="floor">',
    '<node id="floor"><matrix>1 0 0 0.5 0 1 0 0 0 0 2 0 0 0 0 1</matrix>')

DOCUMENTS = {"dae": DAE_TEXT, "dae_normals_sphere": DAE_NORMALS_SPHERE,
             "dae_extra_lights": DAE_EXTRA_LIGHTS, "dae_matrix": DAE_MATRIX}


def _same_scene_and_cameras(out_j, out_t):
    (sj, cam_j), (st, cam_t) = out_j, out_t
    assert_tree_equal(sj, st)
    for w, h in ((16, 16), (24, 12)):
        cj, ct = camera_dict(cam_j(w, h)), camera_dict(cam_t(w, h))
        assert cj.keys() == ct.keys()
        for k in cj:
            np.testing.assert_array_equal(cj[k], ct[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(DOCUMENTS))
def test_collada_load_equals_jax(tmp_path, name):
    p = tmp_path / f"{name}.dae"
    p.write_text(DOCUMENTS[name])
    _same_scene_and_cameras(jcol.load(str(p)), tcol.load(str(p)))


@pytest.mark.parametrize("with_mtl", [True, False])
def test_obj_load_equals_jax(tmp_path, with_mtl):
    (tmp_path / "box.obj").write_text(
        OBJ_TEXT + "v 0 -1 0\nf -1 1 2\n")   # a negative index
    if with_mtl:
        (tmp_path / "box.mtl").write_text(MTL_TEXT)
    p = str(tmp_path / "box.obj")
    _same_scene_and_cameras(jobj.load(p), tobj.load(p))
    _same_scene_and_cameras(jobj.load(p, default_light=False),
                            tobj.load(p, default_light=False))


def _hdr(h=24, w=36, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w, 3).astype(np.float32) * 10.0
    img[min(3, h - 1), min(5, w - 1)] = 800.0
    return img


@pytest.mark.parametrize("h,w,half,compress,seed", [
    (24, 36, False, False, 0), (24, 36, False, True, 0),
    (24, 36, True, False, 1), (24, 36, True, True, 1),
    (40, 20, False, True, 2), (4, 8, False, True, 3)])
def test_exr_round_trip_equals_jax(tmp_path, h, w, half, compress, seed):
    img = _hdr(h, w, seed) if seed != 3 else \
        np.random.RandomState(3).rand(h, w, 3).astype(np.float32)
    pj, pt = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jexr.write_exr(pj, img, half=half, compress=compress)
    texr.write_exr(pt, img, half=half, compress=compress)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    np.testing.assert_array_equal(texr.read_exr(pj), jexr.read_exr(pj))
    if not half:
        np.testing.assert_array_equal(texr.read_exr(pt), img)


def _patched(tmp_path, what):
    img = _hdr(h=4, w=4, seed=5)
    p = str(tmp_path / f"{what}.exr")
    jexr.write_exr(p, img, compress=False)
    raw = bytearray(open(p, "rb").read())
    if what == "piz":
        i = raw.index(b"compression\x00compression\x00")
        raw[i + len(b"compression\x00compression\x00") + 4] = 4
    elif what == "tiled":
        raw[4:8] = (2 | 0x200).to_bytes(4, "little")
    elif what == "deep":
        raw[4:8] = (2 | 0x800).to_bytes(4, "little")
    elif what == "version":
        raw[4:8] = (3).to_bytes(4, "little")
    else:
        raw = bytearray(b"PNG\x00garbage")
    open(p, "wb").write(bytes(raw))
    return p


@pytest.mark.parametrize("what", ["piz", "tiled", "deep", "version",
                                  "not_exr"])
def test_exr_refusals_equal_jax(tmp_path, what):
    p = _patched(tmp_path, what)
    with pytest.raises(ValueError) as ej:
        jexr.read_exr(p)
    with pytest.raises(ValueError) as et:
        texr.read_exr(p)
    assert str(et.value) == str(ej.value)


def test_pfm_and_envmap_dispatch_equal_jax(tmp_path):
    img = np.random.RandomState(0).rand(8, 12, 3).astype(np.float32)
    pj, pt = str(tmp_path / "j.pfm"), str(tmp_path / "t.pfm")
    jenv.write_pfm(pj, img)
    tenv.write_pfm(pt, img)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    np.testing.assert_array_equal(tenv.load_pfm(pj), img)
    # A grey (Pf) big-endian map, replicated to RGB.
    grey = str(tmp_path / "g.pfm")
    with open(grey, "wb") as fh:
        fh.write(b"Pf\n3 2\n1.0\n")
        fh.write(np.arange(6, dtype=">f4").tobytes())
    np.testing.assert_array_equal(tenv.load_pfm(grey), jenv.load_pfm(grey))
    pe = str(tmp_path / "m.exr")
    texr.write_exr(pe, img)
    for p in (pe, pt):
        np.testing.assert_array_equal(tenv.load_envmap(p),
                                      jenv.load_envmap(p))
    for bad in ("m.hdr", "not.pfm"):
        path = str(tmp_path / bad)
        if bad.endswith(".pfm"):
            open(path, "wb").write(b"P6\n")
        with pytest.raises(ValueError) as ej:
            jenv.load_envmap(path)
        with pytest.raises(ValueError) as et:
            tenv.load_envmap(path)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("variant", ["empty", "spheres"])
def test_with_envmap_equals_jax(variant):
    env = _hdr(h=8, w=16, seed=7)
    sj = jtypes.with_envmap(jc.cornell(variant), env)
    st = ttypes.with_envmap(tc.cornell(variant), env)
    assert_tree_equal(sj, st)
    # Idempotent: a second map replaces the first, no second LIGHT_ENV row.
    sky = tenv.gradient_sky(h=4, w=8)
    assert_tree_equal(jtypes.with_envmap(sj, sky),
                      ttypes.with_envmap(st, sky))
    assert (st.lights.kind == ttypes.LIGHT_ENV).sum() == 1
