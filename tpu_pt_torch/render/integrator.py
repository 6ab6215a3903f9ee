"""Shading shared by every acceleration backend: draw-id layout and the
hit-point gather.  (The unrolled oracle renderer is not part of the port
yet; the wavefront renderer is the only consumer.)"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pt_torch.core.vecmath import cross, dot, normalize
from tpu_pt_torch.render import bsdf as bsdf_mod
from tpu_pt_torch.render.brute import Hit
from tpu_pt_torch.scene.types import Scene

# draw_id layout: stride per bounce; draw ids make randomness independent of
# ray order (see core/sampling.py).
DRAW_JITTER = 0
_STRIDE = 64
_LIGHT0 = 0      # + li*ns + s   (light NEE draws)
_BSDF = 48       # bsdf lobe+direction draws
_RR = 49         # russian roulette


class ShadeInfo(NamedTuple):
    p: torch.Tensor        # (R, 3) hit position
    ns: torch.Tensor       # (R, 3) shading normal (unit)
    ng: torch.Tensor       # (R, 3) geometric normal (unit)
    mat: bsdf_mod.MatProps


def shade_info(scene: Scene, ro, rd, hit: Hit) -> ShadeInfo:
    """Gather hit-point geometry + material.  The triangle hit position is
    recomputed from the barycentrics as (1-u-v)·v0 + u·v1 + v·v2."""
    is_tri = hit.prim < scene.n_tris
    zero_i = torch.zeros_like(hit.prim)
    tri_id = torch.where(is_tri, hit.prim, zero_i)
    sph_id = torch.where(is_tri, zero_i, hit.prim - scene.n_tris)

    idx = scene.tri_idx[tri_id]                      # (R, 3)
    v0 = scene.vertices[idx[:, 0]]
    v1 = scene.vertices[idx[:, 1]]
    v2 = scene.vertices[idx[:, 2]]
    u = hit.u
    v = hit.v
    w0 = 1.0 - u - v
    p_tri = w0 * v0 + u * v1 + v * v2
    n0 = scene.normals[idx[:, 0]]
    n1 = scene.normals[idx[:, 1]]
    n2 = scene.normals[idx[:, 2]]
    ns_tri = normalize(w0 * n0 + u * n1 + v * n2)
    ng_tri = normalize(cross(v1 - v0, v2 - v0))
    # Keep geometric normal on the same side as the shading normal.
    ng_tri = torch.where(dot(ng_tri, ns_tri) < 0.0, -ng_tri, ng_tri)

    center = scene.sph_center[sph_id]
    p_sph = ro + hit.t * rd
    ns_sph = normalize(p_sph - center)

    is_tri_c = is_tri[:, None]
    p = torch.where(is_tri_c, p_tri, p_sph)
    ns = torch.where(is_tri_c, ns_tri, ns_sph)
    ng = torch.where(is_tri_c, ng_tri, ns_sph)
    mat_id = torch.where(is_tri, scene.tri_mat[tri_id], scene.sph_mat[sph_id])
    return ShadeInfo(p=p, ns=ns, ng=ng,
                     mat=bsdf_mod.gather_mat(scene.materials, mat_id))
