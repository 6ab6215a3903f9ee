"""Procedural meshes: icosphere subdivision + the large benchmark scene
(a displaced sphere of 20 * 4^subdiv triangles over a ground plane)."""

from __future__ import annotations

import numpy as np


def icosphere(subdiv: int = 3):
    """Unit icosphere.  Returns (verts (V,3) f32, tris (T,3) i32).
    T = 20 * 4^subdiv (subdiv=3 → 1280 tris; 5 → 20480; 8 → 1.3M)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
        (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
        (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ], np.int64)
    for _ in range(subdiv):
        verts = list(map(tuple, v))
        cache = {}

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k in cache:
                return cache[k]
            m = (v[a] + v[b]) / 2.0
            m = m / np.linalg.norm(m)
            verts.append(tuple(m))
            cache[k] = len(verts) - 1
            return cache[k]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        v = np.asarray(verts, np.float64)
        f = np.asarray(nf, np.int64)
    return v.astype(np.float32), f.astype(np.int32)


def displaced_sphere(subdiv: int = 8, amp: float = 0.15, freq: float = 9.0,
                     seed: int = 0):
    """A 'dragon-class' irregular mesh: icosphere displaced by a few octaves
    of sinusoidal noise so the BVH sees non-uniform geometry."""
    v, f = icosphere(subdiv)
    rng = np.random.RandomState(seed)
    d = np.zeros(len(v), np.float32)
    for o in range(4):
        k = rng.normal(size=(3, 3)).astype(np.float32) * freq * (1.6 ** o)
        ph = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
        for j in range(3):
            d += (amp / (2.0 ** o)) * np.sin(v @ k[j] + ph[j]).astype(np.float32)
    v = v * (1.0 + d[:, None] * 0.35)
    return v.astype(np.float32), f


def big_scene(subdiv: int = 8, width_light: float = 4.0):
    """~1M-triangle benchmark scene (at subdiv=8): a displaced sphere over a
    ground plane under one big area light.  Returns a Scene."""
    from tpu_pt_torch.scene.types import (
        LIGHT_AREA, MAT_DIFFUSE, MAT_EMISSIVE, make_lights, make_materials,
        make_scene,
    )

    mv, mt = displaced_sphere(subdiv=subdiv)
    mv = mv * 1.0 + np.array([0.0, 1.4, 0.0], np.float32)
    verts = list(map(tuple, mv))
    tris = list(map(tuple, mt))
    mats = [0] * len(mt)
    # ground plane
    base = len(verts)
    g = 6.0
    verts += [(-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)]
    tris += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    mats += [1, 1]
    w = width_light / 2
    lights = make_lights([
        dict(kind=LIGHT_AREA, position=(-w, 5.0, -w), edge_x=(width_light, 0, 0),
             edge_y=(0, 0, width_light), normal=(0, -1, 0),
             radiance=(10.0, 10.0, 10.0)),
    ])
    materials = make_materials([
        dict(kind=MAT_DIFFUSE, albedo=(0.55, 0.5, 0.45)),
        dict(kind=MAT_DIFFUSE, albedo=(0.4, 0.4, 0.42)),
    ])
    return make_scene(
        vertices=np.asarray(verts, np.float32),
        tri_idx=np.asarray(tris, np.int32),
        tri_mat=np.asarray(mats, np.int32),
        materials=materials, lights=lights,
    )


def big_camera(width: int, height: int):
    from tpu_pt_torch.core.camera import Camera

    return Camera.look_at(
        eye=(2.8, 2.4, 3.2), target=(0.0, 1.2, 0.0), hfov=55.0,
        aspect=width / height,
    )
