"""Procedural Cornell-box scenes: red left wall, green right wall, white
elsewhere, quad ceiling light; optional sphere primitives or a mesh."""

from __future__ import annotations

import numpy as np

from tpu_pt_torch.core.camera import Camera
from tpu_pt_torch.scene import meshes
from tpu_pt_torch.scene.types import (
    LIGHT_AREA,
    MAT_DIFFUSE,
    MAT_EMISSIVE,
    MAT_GGX,
    MAT_GLASS,
    MAT_MIRROR,
    Scene,
    make_lights,
    make_materials,
    make_scene,
)

# Material table rows (indices are stable — tests rely on them).
M_WHITE, M_RED, M_GREEN, M_LIGHT, M_MIRROR, M_GLASS_, M_GLOSSY = \
    0, 1, 2, 3, 4, 5, 6

_MATS = [
    dict(kind=MAT_DIFFUSE, albedo=(0.725, 0.710, 0.680)),   # white
    dict(kind=MAT_DIFFUSE, albedo=(0.630, 0.065, 0.050)),   # red
    dict(kind=MAT_DIFFUSE, albedo=(0.140, 0.450, 0.091)),   # green
    dict(kind=MAT_EMISSIVE, albedo=(0, 0, 0), emission=(17.0, 12.0, 4.0)),
    dict(kind=MAT_MIRROR, albedo=(0.95, 0.95, 0.95)),
    dict(kind=MAT_GLASS, albedo=(0.98, 0.98, 0.98), ior=1.5),
    dict(kind=MAT_GGX, albedo=(0.9, 0.6, 0.2), roughness=0.3),  # rough gold
]

# Box: x ∈ [-1, 1], y ∈ [0, 2], z ∈ [-1, 1]; open toward +z (camera side).
_LIGHT_CORNER = (-0.35, 1.995, -0.35)
_LIGHT_EX = (0.7, 0.0, 0.0)
_LIGHT_EY = (0.0, 0.0, 0.7)


def _quad(verts, tris, mats, p0, p1, p2, p3, mat):
    """Append quad p0..p3 (ccw seen from its front) as two triangles."""
    base = len(verts)
    verts.extend([p0, p1, p2, p3])
    tris.append((base, base + 1, base + 2))
    tris.append((base, base + 2, base + 3))
    mats.extend([mat, mat])


def _box_geometry():
    verts, tris, mats = [], [], []
    # floor (normal +y)
    _quad(verts, tris, mats, (-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1), M_WHITE)
    # ceiling (normal -y)
    _quad(verts, tris, mats, (-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1), M_WHITE)
    # back wall z=-1 (normal +z)
    _quad(verts, tris, mats, (-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1), M_WHITE)
    # left wall x=-1 (normal +x) — red
    _quad(verts, tris, mats, (-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1), M_RED)
    # right wall x=+1 (normal -x) — green
    _quad(verts, tris, mats, (1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1), M_GREEN)
    # ceiling light quad (slightly below the ceiling, normal -y)
    c = np.asarray(_LIGHT_CORNER, np.float32)
    ex = np.asarray(_LIGHT_EX, np.float32)
    ey = np.asarray(_LIGHT_EY, np.float32)
    _quad(verts, tris, mats, tuple(c), tuple(c + ex), tuple(c + ex + ey), tuple(c + ey), M_LIGHT)
    return verts, tris, mats


def _lights():
    return make_lights([
        dict(kind=LIGHT_AREA, position=_LIGHT_CORNER, edge_x=_LIGHT_EX,
             edge_y=_LIGHT_EY, normal=(0.0, -1.0, 0.0),
             radiance=_MATS[M_LIGHT]["emission"]),
    ])


def cornell(variant: str = "empty", mesh_subdiv: int = 3) -> Scene:
    """Build a Cornell scene.  Variants:
      - "empty": box only
      - "spheres": mirror + glass spheres
      - "mesh": a subdivided icosphere as a diffuse 'bunny-class' mesh
        occupying the left half (tri count grows 4^subdiv)
    """
    verts, tris, mats = _box_geometry()
    sph_center = sph_radius = sph_mat = None
    if variant == "spheres":
        sph_center = [(-0.45, 0.45, -0.35), (0.45, 0.45, 0.3)]
        sph_radius = [0.45, 0.45]
        sph_mat = [M_MIRROR, M_GLASS_]
    elif variant == "glossy":
        # CBspheres layout with a rough-GGX sphere in place of the mirror
        # (exercises Materials.roughness end-to-end; golden + grad tests).
        sph_center = [(-0.45, 0.45, -0.35), (0.45, 0.45, 0.3)]
        sph_radius = [0.45, 0.45]
        sph_mat = [M_GLOSSY, M_GLASS_]
    elif variant == "mesh":
        mv, mt = meshes.icosphere(subdiv=mesh_subdiv)
        mv = mv * 0.45 + np.array([-0.35, 0.45, -0.2], np.float32)
        base = len(verts)
        verts.extend([tuple(v) for v in mv])
        tris.extend([(base + a, base + b, base + c) for a, b, c in mt])
        mats.extend([M_WHITE] * len(mt))
    elif variant != "empty":
        raise ValueError(f"unknown cornell variant {variant!r}")
    return make_scene(
        vertices=np.asarray(verts, np.float32),
        tri_idx=np.asarray(tris, np.int32),
        tri_mat=np.asarray(mats, np.int32),
        materials=make_materials(_MATS),
        lights=_lights(),
        sph_center=sph_center, sph_radius=sph_radius, sph_mat=sph_mat,
    )


def camera(width: int, height: int) -> Camera:
    return Camera.look_at(
        eye=(0.0, 1.0, 3.4), target=(0.0, 1.0, 0.0), up=(0.0, 1.0, 0.0),
        hfov=39.0, aspect=width / height,
    )
