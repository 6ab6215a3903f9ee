"""Wavefront OBJ loader (stdlib and numpy): the port's copy of
``tpu_pt/scene/obj.py``.

Supports v/vn/f records with polygon triangulation (fan), negative indices,
and per-object material assignment via a tiny .mtl subset (Kd diffuse, Ke
emission).  Returns a host scene (numpy arrays, as ``make_scene``) and a
camera function giving the port's ``core.camera.Camera``."""

from __future__ import annotations

import os

import numpy as np

from tpu_pt_torch.core.camera import Camera
from tpu_pt_torch.scene.types import (
    LIGHT_AREA, MAT_DIFFUSE, MAT_EMISSIVE, make_lights,
    make_materials, make_scene,
)


def _parse_mtl(path: str):
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = dict(kind=MAT_DIFFUSE, albedo=(0.7, 0.7, 0.7))
            elif parts[0] == "Kd" and cur:
                mats[cur]["albedo"] = tuple(float(x) for x in parts[1:4])
            elif parts[0] == "Ke" and cur:
                ke = tuple(float(x) for x in parts[1:4])
                if max(ke) > 0:
                    mats[cur]["kind"] = MAT_EMISSIVE
                    mats[cur]["emission"] = ke
    return mats


def load(path: str, default_light: bool = True):
    """Load an OBJ file -> (Scene, camera_fn).

    The OBJ format has no camera or lights; a camera framing the bounding
    box and (optionally) an overhead area light are synthesized, matching
    how the reference viewer frames a loaded scene."""
    verts = []
    normals = []
    faces = []  # (i0, i1, i2, mat_id)
    mtl_rows = [dict(kind=MAT_DIFFUSE, albedo=(0.7, 0.7, 0.7))]
    mtl_index = {None: 0}
    cur_mat = 0
    mtl_defs = {}

    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                verts.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "vn":
                normals.append(tuple(float(x) for x in parts[1:4]))
            elif tag == "mtllib":
                mtl_defs.update(
                    _parse_mtl(os.path.join(os.path.dirname(path), parts[1]))
                )
            elif tag == "usemtl":
                name = parts[1]
                if name not in mtl_index:
                    mtl_index[name] = len(mtl_rows)
                    mtl_rows.append(mtl_defs.get(
                        name, dict(kind=MAT_DIFFUSE, albedo=(0.7, 0.7, 0.7))
                    ))
                cur_mat = mtl_index[name]
            elif tag == "f":
                idx = []
                for tok in parts[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1], cur_mat))

    v = np.asarray(verts, np.float32)
    f = np.asarray([(a, b, c) for a, b, c, _ in faces], np.int32)
    m = np.asarray([mm for *_, mm in faces], np.int32)

    lo, hi = v.min(axis=0), v.max(axis=0)
    center = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))

    light_rows = []
    if default_light:
        w = diag
        light_rows.append(dict(
            kind=LIGHT_AREA,
            position=(center[0] - w / 2, hi[1] + 0.6 * diag, center[2] - w / 2),
            edge_x=(w, 0, 0), edge_y=(0, 0, w), normal=(0, -1, 0),
            radiance=(6.0, 6.0, 6.0),
        ))

    scene = make_scene(v, f, m, make_materials(mtl_rows),
                       make_lights(light_rows))

    def camera_fn(width: int, height: int) -> Camera:
        eye = center + np.array([0.0, 0.35, 1.1]) * diag
        return Camera.look_at(eye=tuple(eye), target=tuple(center),
                              hfov=50.0, aspect=width / height)

    return scene, camera_fn
