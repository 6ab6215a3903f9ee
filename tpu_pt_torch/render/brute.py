"""Brute-force flat-list intersector: every ray against every primitive
(O(R·T) memory).  The port's own dense oracle; small scenes only."""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pt_torch.core.intersect import INF, ray_sphere, ray_triangle
from tpu_pt_torch.scene.types import Scene


class Hit(NamedTuple):
    hit: torch.Tensor   # (R, 1) bool
    t: torch.Tensor     # (R, 1) f32 (INF when miss)
    prim: torch.Tensor  # (R,) int32 — [0,T) triangle id, [T,T+S) sphere id
    u: torch.Tensor     # (R, 1) barycentric u (triangles only)
    v: torch.Tensor     # (R, 1) barycentric v


def _tri_soa(scene: Scene):
    v0 = scene.vertices[scene.tri_idx[:, 0]]
    v1 = scene.vertices[scene.tri_idx[:, 1]]
    v2 = scene.vertices[scene.tri_idx[:, 2]]
    return v0, v1 - v0, v2 - v0


def intersect(scene: Scene, ro, rd, t_min, t_max) -> Hit:
    """Nearest hit against all primitives.  ro/rd: (R,3); t_min/t_max:
    (R,1).  Lowest primitive id wins at equal t."""
    v0, e1, e2 = _tri_soa(scene)
    _, t_t, u_t, v_t = ray_triangle(
        ro[:, None, :], rd[:, None, :], v0[None], e1[None], e2[None],
        t_min[:, None, :], t_max[:, None, :],
    )
    t_tri = t_t[..., 0]                                   # (R, T)
    t_best_tri, best_tri = torch.min(t_tri, dim=1, keepdim=True)
    # torch.min does not promise the FIRST index at ties; take it explicitly.
    T = t_tri.shape[1]
    ar = torch.arange(T, device=ro.device)
    best_tri = torch.min(torch.where(t_tri == t_best_tri, ar, T), dim=1,
                         keepdim=True).values.clamp_max(T - 1)
    u_best = torch.gather(u_t[..., 0], 1, best_tri)
    v_best = torch.gather(v_t[..., 0], 1, best_tri)

    _, t_s, _ = ray_sphere(
        ro[:, None, :], rd[:, None, :],
        scene.sph_center[None], scene.sph_radius[None, :, None],
        t_min[:, None, :], t_max[:, None, :],
    )
    t_sph = t_s[..., 0]                                   # (R, S)
    S = t_sph.shape[1]
    t_best_sph = torch.min(t_sph, dim=1, keepdim=True).values
    best_sph = torch.min(
        torch.where(t_sph == t_best_sph, torch.arange(S, device=ro.device), S),
        dim=1, keepdim=True).values.clamp_max(S - 1)

    take_tri = t_best_tri <= t_best_sph
    t = torch.minimum(t_best_tri, t_best_sph)
    prim = torch.where(take_tri, best_tri, scene.n_tris + best_sph)[:, 0]
    zero = torch.zeros_like(u_best)
    return Hit(
        hit=t < INF,
        t=t,
        prim=prim.to(torch.int32),
        u=torch.where(take_tri, u_best, zero),
        v=torch.where(take_tri, v_best, zero),
    )


def occluded(scene: Scene, ro, rd, t_max):
    """Any-hit test for shadow rays: (R,1) bool."""
    t_min = torch.zeros_like(t_max)
    v0, e1, e2 = _tri_soa(scene)
    h_t, _, _, _ = ray_triangle(
        ro[:, None, :], rd[:, None, :], v0[None], e1[None], e2[None],
        t_min[:, None, :], t_max[:, None, :],
    )
    h_s, _, _ = ray_sphere(
        ro[:, None, :], rd[:, None, :],
        scene.sph_center[None], scene.sph_radius[None, :, None],
        t_min[:, None, :], t_max[:, None, :],
    )
    any_hit = torch.any(h_t[..., 0], dim=1) | torch.any(h_s[..., 0], dim=1)
    return any_hit[:, None]
