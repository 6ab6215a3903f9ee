"""Editable scene graph: transform hierarchy -> flat render Scene (numpy):
the port's copy of ``tpu_pt/scene/graph.py``.

A host-side tree of nodes with local 4x4 transforms, meshes, spheres,
lights and cameras, and a ``get_static_scene()`` that bakes the transforms
into the SoA ``Scene`` (``scene/types.py``, host arrays).

  - Instancing: the same mesh dict may hang under several nodes; each
    instance is baked with its own world transform.
  - Editing: mutate ``Node.transform`` (or geometry/materials) and call
    ``get_static_scene()`` again.
  - Normals: light normals are transformed by the inverse-transpose
    rotation; meshes get area-weighted normals from ``make_scene``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from tpu_pt_torch.scene.types import (
    Scene, make_lights, make_materials, make_scene)


# ---- transform helpers (column-vector convention, row-major storage) ------

def translate(t) -> np.ndarray:
    m = np.eye(4, dtype=np.float64)
    m[:3, 3] = t
    return m


def scale(s) -> np.ndarray:
    s = np.broadcast_to(np.asarray(s, np.float64), (3,))
    m = np.eye(4, dtype=np.float64)
    m[0, 0], m[1, 1], m[2, 2] = s
    return m


def rotate(axis, degrees: float) -> np.ndarray:
    """Axis-angle rotation (Rodrigues)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    th = np.deg2rad(degrees)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = R
    return m


def _xform_points(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    return p @ m[:3, :3].T + m[:3, 3]


def _xform_dirs(m: np.ndarray, d: np.ndarray) -> np.ndarray:
    return d @ m[:3, :3].T


def _xform_normals(m: np.ndarray, n: np.ndarray) -> np.ndarray:
    it = np.linalg.inv(m[:3, :3]).T
    out = n @ it.T
    ln = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(ln, 1e-20)


# ---- graph nodes -----------------------------------------------------------


@dataclass
class Node:
    """One scene-graph node: a local transform plus optional payloads.

    mesh: dict(vertices (V,3), tris (T,3), material=str, normals=(V,3)?)
    sphere: dict(center (3,), radius float, material=str)
    light: dict(kind=..., **sample_light fields) — positions/directions are
           LOCAL and baked by the node's world transform.
    camera: dict(eye, target, up?, hfov) — local, baked like lights.
    """
    name: str = ""
    transform: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float64))
    children: List["Node"] = field(default_factory=list)
    mesh: Optional[dict] = None
    sphere: Optional[dict] = None
    light: Optional[dict] = None
    camera: Optional[dict] = None

    def add(self, child: "Node") -> "Node":
        self.children.append(child)
        return child

    def find(self, name: str) -> Optional["Node"]:
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None


class SceneGraph:
    """Root node + material table + environment; flattens to ``Scene``."""

    def __init__(self):
        self.root = Node(name="root")
        # name -> material row dict (kind/albedo/emission/ior/roughness)
        self.materials: Dict[str, dict] = {"default": dict()}
        self.env_map = None

    # -- editing helpers ---------------------------------------------------
    def node(self, name: str) -> Node:
        n = self.root.find(name)
        if n is None:
            raise KeyError(name)
        return n

    def set_material(self, name: str, **row) -> None:
        self.materials[name] = row

    # -- flattening (the reference's get_static_scene) ----------------------
    def get_static_scene(self) -> Scene:
        mat_names = list(self.materials)
        mat_id = {n: i for i, n in enumerate(mat_names)}
        verts_l, tris_l, tmat_l = [], [], []
        sph_c, sph_r, sph_m = [], [], []
        light_rows = []
        self._camera = None

        def walk(node: Node, m: np.ndarray):
            m = m @ node.transform
            if node.mesh is not None:
                v = np.asarray(node.mesh["vertices"], np.float64)
                t = np.asarray(node.mesh["tris"], np.int64).reshape(-1, 3)
                base = sum(len(x) for x in verts_l)
                verts_l.append(_xform_points(m, v).astype(np.float32))
                tris_l.append((t + base).astype(np.int32))
                mid = mat_id[node.mesh.get("material", "default")]
                tmat_l.append(np.full((len(t),), mid, np.int32))
            if node.sphere is not None:
                c = _xform_points(
                    m, np.asarray(node.sphere["center"], np.float64)[None])[0]
                # Uniform scale assumed for spheres (reference SphereObject
                # had no per-axis scale either); use the mean axis scale.
                s = np.cbrt(abs(np.linalg.det(m[:3, :3])))
                sph_c.append(c.astype(np.float32))
                sph_r.append(np.float32(node.sphere["radius"] * s))
                sph_m.append(mat_id[node.sphere.get("material", "default")])
            if node.light is not None:
                row = dict(node.light)
                for k in ("position",):
                    if k in row:
                        row[k] = _xform_points(
                            m, np.asarray(row[k], np.float64)[None])[0]
                for k in ("edge_x", "edge_y"):
                    if k in row:
                        row[k] = _xform_dirs(
                            m, np.asarray(row[k], np.float64)[None])[0]
                if "normal" in row:
                    row["normal"] = _xform_normals(
                        m, np.asarray(row["normal"], np.float64)[None])[0]
                light_rows.append(row)
            if node.camera is not None and self._camera is None:
                cam = dict(node.camera)
                cam["eye"] = _xform_points(
                    m, np.asarray(cam["eye"], np.float64)[None])[0]
                cam["target"] = _xform_points(
                    m, np.asarray(cam["target"], np.float64)[None])[0]
                if "up" in cam:
                    cam["up"] = _xform_dirs(
                        m, np.asarray(cam["up"], np.float64)[None])[0]
                self._camera = cam
            for c in node.children:
                walk(c, m)

        walk(self.root, np.eye(4, dtype=np.float64))

        if verts_l:
            vertices = np.concatenate(verts_l, 0)
            tris = np.concatenate(tris_l, 0)
            tmat = np.concatenate(tmat_l, 0)
        else:
            vertices = np.zeros((0, 3), np.float32)
            tris = np.zeros((0, 3), np.int32)
            tmat = np.zeros((0,), np.int32)
        return make_scene(
            vertices, tris, tmat,
            make_materials([self.materials[n] for n in mat_names]),
            make_lights(light_rows),
            sph_center=np.asarray(sph_c, np.float32).reshape(-1, 3)
            if sph_c else None,
            sph_radius=np.asarray(sph_r, np.float32) if sph_c else None,
            sph_mat=np.asarray(sph_m, np.int32) if sph_c else None,
            env_map=self.env_map,
        )

    def get_camera(self, width: int, height: int):
        """Camera baked by its node's world transform (set during the last
        get_static_scene walk), or None if the graph has no camera node."""
        if getattr(self, "_camera", None) is None:
            return None
        from tpu_pt_torch.core.camera import Camera

        c = self._camera
        return Camera.look_at(
            eye=tuple(c["eye"]), target=tuple(c["target"]),
            hfov=float(c.get("hfov", 50.0)), aspect=width / height,
            **({"up": tuple(c["up"])} if "up" in c else {}),
        )
