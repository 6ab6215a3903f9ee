"""Scene representation: flat structure-of-arrays.

Host fields are numpy arrays (what the builders below return); ``to(device)``
gives the same containers holding tensors.  Primitives share one index
space: [0, T) triangles, [T, T+S) spheres.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# Material kinds.
MAT_DIFFUSE = 0
MAT_MIRROR = 1
MAT_GLASS = 2
MAT_REFRACT = 3
MAT_EMISSIVE = 4
MAT_GGX = 5  # rough conductor: GGX microfacet lobe driven by Materials.roughness

# Light kinds.  LIGHT_TRI is the mesh-light form for emissive triangles.
LIGHT_AREA = 0
LIGHT_POINT = 1
LIGHT_DIRECTIONAL = 2
LIGHT_HEMISPHERE = 3
LIGHT_TRI = 4
LIGHT_ENV = 5  # environment map (uniform-sphere NEE; radiance from Scene.env_map)
LIGHT_SPOT = 6  # spot: position + normal(=axis) + hard cone, cos(half-angle) in edge_x[0]


def as_tensor(x):
    """``x`` if it is a tensor, else a CPU tensor over the host array."""
    return x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))


def _to_tensors(nt, device):
    """NamedTuple of numpy arrays / tensors / nested NamedTuples -> the same
    container holding tensors on ``device`` (dtypes kept)."""
    out = []
    for x in nt:
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            out.append(_to_tensors(x, device))
        elif torch.is_tensor(x):
            out.append(x.to(device))
        else:
            out.append(as_tensor(x).to(device))
    return type(nt)(*out)


def _detached(nt):
    """NamedTuple of tensors / nested NamedTuples -> the same container
    with every tensor detached."""
    return type(nt)(*(_detached(x) if hasattr(x, "_fields") else x.detach()
                      for x in nt))


class Materials(NamedTuple):
    kind: object       # (M,) int32
    albedo: object     # (M, 3) f32 — diffuse albedo / specular tint / transmittance
    emission: object   # (M, 3) f32 — radiance for emissive materials
    ior: object        # (M,) f32 — index of refraction (glass/refract)
    roughness: object  # (M,) f32 — GGX-style roughness (0 = ideal; grad target)


class Lights(NamedTuple):
    kind: object       # (L,) int32
    position: object   # (L, 3) area: corner; point: position; else unused
    edge_x: object     # (L, 3) area quad edge 0
    edge_y: object     # (L, 3) area quad edge 1
    normal: object     # (L, 3) area: emission normal; directional: direction TOWARD scene
    radiance: object   # (L, 3) emitted radiance (area/hemisphere) or intensity (point/directional)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


class Scene(NamedTuple):
    vertices: object     # (V, 3) f32   — differentiable
    normals: object      # (V, 3) f32 vertex normals (unit)
    tri_idx: object      # (T, 3) int32 indices into vertices/normals
    tri_mat: object      # (T,) int32 material ids
    sph_center: object   # (S, 3) f32
    sph_radius: object   # (S,) f32
    sph_mat: object      # (S,) int32
    materials: Materials
    lights: Lights
    env_map: object      # (He, We, 3) f32 lat-long radiance; (1,1,3) zeros = none
    env_marg_cdf: object  # (He,) f32 row CDF of luminance*sin(theta) (env NEE importance sampling)
    env_cond_cdf: object  # (He, We) f32 per-row column CDF

    def to(self, device) -> "Scene":
        """The same scene with every array a tensor on ``device``."""
        return _to_tensors(self, device)

    def detach(self) -> "Scene":
        """The same scene (of tensors) cut from the autograd graph."""
        return _detached(self)

    @property
    def n_tris(self) -> int:
        return self.tri_idx.shape[0]

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def n_prims(self) -> int:
        """Primitives share one index space: [0, T) triangles, [T, T+S) spheres."""
        return self.n_tris + self.n_spheres


def make_materials(rows) -> Materials:
    """rows: list of dicts with kind/albedo/emission/ior/roughness."""
    m = len(rows)
    kind = np.zeros((m,), np.int32)
    albedo = np.zeros((m, 3), np.float32)
    emission = np.zeros((m, 3), np.float32)
    ior = np.full((m,), 1.5, np.float32)
    rough = np.zeros((m,), np.float32)
    for i, r in enumerate(rows):
        kind[i] = r.get("kind", MAT_DIFFUSE)
        albedo[i] = np.asarray(r.get("albedo", (0.5, 0.5, 0.5)), np.float32)
        emission[i] = np.asarray(r.get("emission", (0.0, 0.0, 0.0)), np.float32)
        ior[i] = r.get("ior", 1.5)
        rough[i] = r.get("roughness", 0.0)
    return Materials(
        kind=kind, albedo=albedo, emission=emission, ior=ior, roughness=rough,
    )


def make_lights(rows) -> Lights:
    """rows: list of dicts with kind and kind-specific fields.  At least one
    row is required (pad with a zero-radiance area light if scene is dark)."""
    if not rows:
        rows = [dict(kind=LIGHT_AREA, position=(0, 1e8, 0), edge_x=(1, 0, 0),
                     edge_y=(0, 0, 1), normal=(0, -1, 0), radiance=(0, 0, 0))]
    n = len(rows)
    kind = np.zeros((n,), np.int32)
    pos = np.zeros((n, 3), np.float32)
    ex = np.zeros((n, 3), np.float32)
    ey = np.zeros((n, 3), np.float32)
    nrm = np.zeros((n, 3), np.float32)
    rad = np.zeros((n, 3), np.float32)
    for i, r in enumerate(rows):
        kind[i] = r["kind"]
        pos[i] = np.asarray(r.get("position", (0, 0, 0)), np.float32)
        ex[i] = np.asarray(r.get("edge_x", (1, 0, 0)), np.float32)
        ey[i] = np.asarray(r.get("edge_y", (0, 0, 1)), np.float32)
        nrm[i] = np.asarray(r.get("normal", (0, -1, 0)), np.float32)
        rad[i] = np.asarray(r.get("radiance", (0, 0, 0)), np.float32)
    return Lights(kind=kind, position=pos, edge_x=ex, edge_y=ey,
                  normal=nrm, radiance=rad)


def make_scene(vertices, tri_idx, tri_mat, materials: Materials,
               lights: Lights, normals: Optional[np.ndarray] = None,
               sph_center=None, sph_radius=None, sph_mat=None,
               env_map=None) -> Scene:
    """Assemble a Scene; computes area-weighted vertex normals if absent and
    pads empty primitive classes with one never-hit degenerate (static shapes
    stay >= 1)."""
    vertices = np.asarray(vertices, np.float32)
    tri_idx = np.asarray(tri_idx, np.int32).reshape(-1, 3)
    tri_mat = np.asarray(tri_mat, np.int32)
    if tri_idx.shape[0] == 0:
        vertices = np.concatenate([vertices, np.full((3, 3), 1e8, np.float32)], 0)
        v = vertices.shape[0]
        tri_idx = np.array([[v - 3, v - 2, v - 1]], np.int32)
        tri_mat = np.zeros((1,), np.int32)
    if normals is None:
        normals = _vertex_normals(vertices, tri_idx)
    else:
        normals = np.asarray(normals, np.float32)
    if sph_center is None or len(np.atleast_1d(sph_radius or [])) == 0:
        sph_center = np.full((1, 3), 1e8, np.float32)
        sph_radius = np.zeros((1,), np.float32)
        sph_mat = np.zeros((1,), np.int32)
    from tpu_pt_torch.render.envmap import build_env_tables

    env = (np.zeros((1, 1, 3), np.float32) if env_map is None
           else np.asarray(env_map, np.float32))
    marg_cdf, cond_cdf = build_env_tables(env)
    return Scene(
        vertices=vertices,
        normals=normals,
        tri_idx=tri_idx,
        tri_mat=tri_mat,
        sph_center=np.asarray(sph_center, np.float32).reshape(-1, 3),
        sph_radius=np.asarray(sph_radius, np.float32).reshape(-1),
        sph_mat=np.asarray(sph_mat, np.int32).reshape(-1),
        materials=materials,
        lights=lights,
        env_map=env,
        env_marg_cdf=marg_cdf,
        env_cond_cdf=cond_cdf,
    )


def with_envmap(scene: Scene, env_map: np.ndarray) -> Scene:
    """Attach a lat-long radiance map to a host scene: rebuilds the
    importance-sampling CDF tables and appends a LIGHT_ENV row (if absent)
    so next-event estimation samples the map.  Host arrays in, host arrays
    out, like ``make_scene``; the command line's ``-e`` path."""
    from tpu_pt_torch.render.envmap import build_env_tables

    env = np.asarray(env_map, np.float32)
    marg_cdf, cond_cdf = build_env_tables(env)
    lights = scene.lights
    kinds = np.asarray(lights.kind)
    if not (kinds == LIGHT_ENV).any():
        z3 = np.zeros((1, 3), np.float32)
        lights = Lights(
            kind=np.concatenate([kinds, np.full((1,), LIGHT_ENV, np.int32)]),
            position=np.concatenate([np.asarray(lights.position), z3]),
            edge_x=np.concatenate([np.asarray(lights.edge_x), z3]),
            edge_y=np.concatenate([np.asarray(lights.edge_y), z3]),
            normal=np.concatenate([np.asarray(lights.normal), z3]),
            radiance=np.concatenate([np.asarray(lights.radiance), z3]),
        )
    return scene._replace(env_map=env, env_marg_cdf=marg_cdf,
                          env_cond_cdf=cond_cdf, lights=lights)


def _vertex_normals(vertices: np.ndarray, tri_idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (host-side)."""
    n = np.zeros_like(vertices)
    v0 = vertices[tri_idx[:, 0]]
    v1 = vertices[tri_idx[:, 1]]
    v2 = vertices[tri_idx[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    for k in range(3):
        np.add.at(n, tri_idx[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)
