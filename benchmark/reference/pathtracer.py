"""The plain reference: a path tracer in plain PyTorch that follows the
port's light transport for a set of pixels, forward or under autograd.

It imports nothing of the program.  It takes the benchmark's inputs (the
scene's arrays, the material and light rows, the camera, the key) and works
out again everything the program derives from them: the vertex normals,
every random draw, the camera rays with their jitter, each segment's
closest hit and each shadow ray's occlusion (through an acceleration
structure of its own, below), and the shading.

Light transport, as the port's wavefront (``render/wavefront.py``) defines
it for one path: emission at a hit where the segment takes emission
(camera rays, after a delta bounce); one next-event shadow ray per light
and light sample at every non-delta hit; a BSDF sample; the path continues
while its depth is below ``max_depth``, and Russian roulette from bounce
``rr_start`` keeps it with probability ``rr_prob``.  Randomness is keyed
by (key, sample id, draw id), so a pixel's value does not depend on which
other pixels are traced with it.  The shading functions below are frozen
copies of the port's formulas, kept in its operation order.

Hits: triangles are grouped in Morton order, ``LEAF`` to a leaf and
``GROUP`` leaves to a group, with padded boxes; a ray is tested against
every group box, then the leaf boxes of the groups it meets, then every
triangle of the leaves it meets (Moller-Trumbore in the port's kernels'
operation order).  The closest hit is the least t, ties to the lowest
triangle id; a shadow ray is occluded by any hit in [0, t_max].  The
boxes only prune: every triangle that the test would hit lies in a leaf
the ray meets, so the result is brute force's.

``dtype`` is the precision of everything the tracer computes (the scene,
the camera, the rays, the hits and the shading); float32 is the
configuration's.  The control of the benchmark's check runs it in
bfloat16.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INF = 1e30
LEAF = 32
GROUP = 64
DRAW_JITTER = 0
STRIDE = 64
LIGHT0 = 0
BSDF = 48
RR = 49
MAT_DIFFUSE, MAT_MIRROR, MAT_GLASS, MAT_REFRACT, MAT_EMISSIVE, MAT_GGX = range(6)
LIGHT_AREA = 0

# --------------------------------------------------------------------------
# Random draws: three murmur3-finalizer rounds on 32-bit words held in int64.
# --------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def uniforms(key, ray_ids, draw_id, n: int):
    """(R, n) float32 uniforms in [0, 1) of (key, ray id, draw id, i)."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    dev = ray_ids.device
    r = (ray_ids.to(torch.int64) & _M32)[:, None]
    d = (torch.as_tensor(draw_id, device=dev).to(torch.int64).expand_as(
        ray_ids) & _M32)[:, None]
    i = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    ig = torch.tensor([(j * 0x9E3779B9) & _M32 for j in range(n)],
                      dtype=torch.int64, device=dev)[None, :]
    h = _mix(d ^ k1 ^ ig)
    h = _mix(r ^ h ^ k0)
    h = _mix((h + i) & _M32)
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


# --------------------------------------------------------------------------
# Vector helpers (last axis xyz).
# --------------------------------------------------------------------------

def dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def normalize(v, eps: float = 1e-20):
    n2 = dot(v, v)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp_min(n2, eps)),
                      torch.zeros_like(n2))
    return v * inv


def coord_space(n):
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    bcoef = nx * ny * a
    t = torch.cat([1.0 + sign * nx * nx * a, sign * bcoef, -sign * nx], dim=-1)
    b = torch.cat([bcoef, sign + ny * ny * a, -ny], dim=-1)
    return t, b


def to_local(w, t, b, n):
    return torch.cat([dot(w, t), dot(w, b), dot(w, n)], dim=-1)


def to_world(w, t, b, n):
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n


# --------------------------------------------------------------------------
# The scene as the reference holds it.
# --------------------------------------------------------------------------

class RefScene(NamedTuple):
    vertices: torch.Tensor   # (V, 3)
    normals: torch.Tensor    # (V, 3)
    tri_idx: torch.Tensor    # (T, 3) int64
    tri_mat: torch.Tensor    # (T,) int64
    kind: torch.Tensor       # (M,) int64
    albedo: torch.Tensor     # (M, 3)
    emission: torch.Tensor   # (M, 3)
    ior: torch.Tensor        # (M,)
    roughness: torch.Tensor  # (M,)
    light_pos: torch.Tensor  # (L, 3)
    light_ex: torch.Tensor
    light_ey: torch.Tensor
    light_nrm: torch.Tensor
    light_rad: torch.Tensor  # (L, 3)


def vertex_normals(vertices: np.ndarray, tri_idx: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals, in float32 on the host."""
    n = np.zeros_like(vertices)
    v0 = vertices[tri_idx[:, 0]]
    v1 = vertices[tri_idx[:, 1]]
    v2 = vertices[tri_idx[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    for k in range(3):
        np.add.at(n, tri_idx[:, k], fn)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    return (n / np.maximum(ln, 1e-20)).astype(np.float32)


def make_scene(geo: dict, materials: list, device, dtype=torch.float32,
               normals: np.ndarray | None = None) -> RefScene:
    """The reference's scene from the benchmark's arrays and rows.  Only
    area lights, and no environment map: the benchmark's scenes have none
    else, and any other light kind is refused."""
    for row in geo["lights"]:
        if row["kind"] != LIGHT_AREA:
            raise ValueError("the reference traces area lights only")
    verts = np.asarray(geo["vertices"], np.float32)
    tris = np.asarray(geo["tri_idx"], np.int64)
    if normals is None:
        normals = vertex_normals(verts, tris)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32)).to(device, dtype)

    def rows(key, default):
        return f([r.get(key, default) for r in materials])

    def lrow(key):
        return f([r[key] for r in geo["lights"]])

    return RefScene(
        vertices=f(verts), normals=f(normals),
        tri_idx=torch.as_tensor(tris, device=device),
        tri_mat=torch.as_tensor(np.asarray(geo["tri_mat"], np.int64),
                                device=device),
        kind=torch.tensor([r.get("kind", MAT_DIFFUSE) for r in materials],
                          dtype=torch.int64, device=device),
        albedo=rows("albedo", (0.5, 0.5, 0.5)),
        emission=rows("emission", (0.0, 0.0, 0.0)),
        ior=rows("ior", 1.5), roughness=rows("roughness", 0.0),
        light_pos=lrow("position"), light_ex=lrow("edge_x"),
        light_ey=lrow("edge_y"), light_nrm=lrow("normal"),
        light_rad=lrow("radiance"))


# --------------------------------------------------------------------------
# Hits.
# --------------------------------------------------------------------------

def _morton(c):
    """30-bit Morton codes of points c (N, 3) in [0, 1]^3."""
    q = torch.clamp((c * 1023.0).to(torch.int64), 0, 1023)
    out = torch.zeros(c.shape[0], dtype=torch.int64, device=c.device)
    for bit in range(10):
        for ax in range(3):
            out |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
    return out


class Accel:
    """Triangles in Morton order with two levels of padded boxes."""

    def __init__(self, vertices, tri_idx):
        dt = vertices.dtype
        V = vertices.detach()
        v0, v1, v2 = (V[tri_idx[:, k]] for k in range(3))
        lo = torch.minimum(torch.minimum(v0, v1), v2).float()
        hi = torch.maximum(torch.maximum(v0, v1), v2).float()
        s_lo, s_hi = lo.min(0).values, hi.max(0).values
        ext = torch.clamp_min(s_hi - s_lo, 1e-6)
        order = torch.argsort(_morton((0.5 * (lo + hi) - s_lo) / ext),
                              stable=True)
        T = tri_idx.shape[0]
        n = -(-T // (LEAF * GROUP)) * LEAF * GROUP
        pad = n - T
        idx = torch.cat([order, order[:1].expand(pad)])
        self.tri_id = torch.cat([order, torch.full(
            (pad,), -1, dtype=torch.int64, device=V.device)])
        self.v0 = v0[idx]
        self.e1 = (v1 - v0)[idx]
        self.e2 = (v2 - v0)[idx]
        self.e1[T:] = 0.0          # padding: zero edges never hit
        self.e2[T:] = 0.0
        # Boxes in float32, widened so that rounding never drops a hit.
        margin = 1e-5 * float(ext.max()) + 1e-6
        llo = lo[idx].reshape(-1, LEAF, 3).min(1).values - margin
        lhi = hi[idx].reshape(-1, LEAF, 3).max(1).values + margin
        self.leaf_lo, self.leaf_hi = llo.to(dt), lhi.to(dt)
        self.group_lo = llo.reshape(-1, GROUP, 3).min(1).values.to(dt)
        self.group_hi = lhi.reshape(-1, GROUP, 3).max(1).values.to(dt)

    def _candidates(self, ro, inv, t_min, t_max, block: int):
        """(ray, leaf) pairs whose boxes meet, a block of rays at a time."""
        for r0 in range(0, ro.shape[0], block):
            o, iv = ro[r0:r0 + block], inv[r0:r0 + block]
            tmn, tmx = t_min[r0:r0 + block], t_max[r0:r0 + block]
            g = _slab(o[:, None], iv[:, None], self.group_lo[None],
                      self.group_hi[None], tmn[:, None], tmx[:, None])
            r, gi = torch.nonzero(g, as_tuple=True)
            if r.numel() == 0:
                continue
            li = gi[:, None] * GROUP + torch.arange(GROUP, device=ro.device)
            m = _slab(o[r][:, None], iv[r][:, None], self.leaf_lo[li],
                      self.leaf_hi[li], tmn[r][:, None], tmx[r][:, None])
            p, k = torch.nonzero(m, as_tuple=True)
            yield r0 + r[p], li[p, k]

    def _hits(self, ro, rd, t_min, t_max, block=1 << 16, chunk=1 << 19):
        """Every (ray, triangle id, t, u, v) with a hit in [t_min, t_max]."""
        rd_s = torch.where(rd.abs() < 1e-20, torch.full_like(rd, 1e-20), rd)
        inv = 1.0 / rd_s
        out = []
        for ray, leaf in self._candidates(ro, inv, t_min, t_max, block):
            for c0 in range(0, ray.numel(), chunk):
                r = ray[c0:c0 + chunk]
                ti = leaf[c0:c0 + chunk, None] * LEAF + torch.arange(
                    LEAF, device=ro.device)
                hit, t, u, v = ray_triangle(
                    ro[r][:, None], rd[r][:, None], self.v0[ti], self.e1[ti],
                    self.e2[ti], t_min[r][:, None, None],
                    t_max[r][:, None, None])
                p, k = torch.nonzero(hit[..., 0], as_tuple=True)
                out.append((r[p], self.tri_id[ti[p, k]], t[p, k, 0],
                            u[p, k, 0], v[p, k, 0]))
        if not out:
            e = ro.new_zeros((0,))
            return e.long(), e.long(), e, e, e
        return tuple(torch.cat(x) for x in zip(*out))

    def closest(self, ro, rd):
        """(hit (R,) bool, prim (R,), t, u, v (R,)) of the nearest hit in
        [0, INF), ties to the lowest triangle id."""
        R = ro.shape[0]
        t_min = torch.zeros((R,), dtype=ro.dtype, device=ro.device)
        t_max = torch.full((R,), INF, dtype=ro.dtype, device=ro.device)
        ray, tid, t, u, v = self._hits(ro, rd, t_min, t_max)
        best = torch.full((R,), INF, dtype=ro.dtype, device=ro.device)
        best = best.scatter_reduce(0, ray, t, "amin")
        at_best = t == best[ray]
        big = torch.iinfo(torch.int64).max
        bid = torch.full((R,), big, dtype=torch.int64, device=ro.device)
        bid = bid.scatter_reduce(0, ray[at_best], tid[at_best], "amin")
        win = at_best & (tid == bid[ray])
        uu = torch.zeros((R,), dtype=ro.dtype, device=ro.device)
        vv = torch.zeros((R,), dtype=ro.dtype, device=ro.device)
        uu[ray[win]] = u[win]
        vv[ray[win]] = v[win]
        found = best < INF
        return found, torch.where(found, bid, 0), best, uu, vv

    def occluded(self, ro, rd, t_max):
        """(R,) bool: any hit in [0, t_max]."""
        R = ro.shape[0]
        t_min = torch.zeros((R,), dtype=ro.dtype, device=ro.device)
        ray = self._hits(ro, rd, t_min, t_max)[0]
        occ = torch.zeros((R,), dtype=torch.bool, device=ro.device)
        occ[ray] = True
        return occ


def _slab(ro, inv, lo, hi, t_min, t_max):
    t0 = (lo - ro) * inv
    t1 = (hi - ro) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return (tn <= tf) & (tf >= t_min) & (tn <= t_max)


def ray_triangle(ro, rd, v0, e1, e2, t_min, t_max):
    """Moller-Trumbore, written out component by component in the port's
    kernels' operation order (each dot product summed x, y, then z): (hit,
    t, u, v), each (..., 1)."""
    dx, dy, dz = rd[..., 0:1], rd[..., 1:2], rd[..., 2:3]
    e1x, e1y, e1z = e1[..., 0:1], e1[..., 1:2], e1[..., 2:3]
    e2x, e2y, e2z = e2[..., 0:1], e2[..., 1:2], e2[..., 2:3]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    parallel = torch.abs(det) < 1e-12
    one = torch.ones_like(det)
    inv_det = torch.where(parallel, torch.zeros_like(det),
                          1.0 / torch.where(parallel, one, det))
    tv = ro - v0
    tvx, tvy, tvz = tv[..., 0:1], tv[..., 1:2], tv[..., 2:3]
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ((~parallel) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t >= t_min) & (t <= t_max))
    return hit, t, u, v


# --------------------------------------------------------------------------
# Shading: the port's formulas.
# --------------------------------------------------------------------------

class Mat(NamedTuple):
    kind: torch.Tensor
    albedo: torch.Tensor
    emission: torch.Tensor
    ior: torch.Tensor
    roughness: torch.Tensor


def _is_delta(mat: Mat):
    k = mat.kind[..., None]
    return (k == MAT_MIRROR) | (k == MAT_GLASS) | (k == MAT_REFRACT)


def _ggx_alpha(roughness):
    return torch.clamp(roughness, 0.01, 1.0) ** 2


def _ggx_d(cos_h, alpha):
    a2 = alpha * alpha
    c2 = cos_h * cos_h
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * denom * denom, 1e-12)


def _ggx_g1(cos_v, alpha):
    a2 = alpha * alpha
    c = torch.clamp_min(torch.abs(cos_v), 1e-6)
    return 2.0 * c / (c + torch.sqrt(a2 + (1.0 - a2) * c * c))


def _ggx_f(mat: Mat, wo, wi):
    alpha = _ggx_alpha(mat.roughness)
    h = wo + wi
    h = h / torch.clamp_min(torch.linalg.norm(h, dim=-1, keepdim=True), 1e-12)
    cos_h = h[..., 2:3]
    cos_o = torch.clamp_min(wo[..., 2:3], 1e-6)
    cos_i = torch.clamp_min(wi[..., 2:3], 1e-6)
    d = _ggx_d(cos_h, alpha)
    g = _ggx_g1(wo[..., 2:3], alpha) * _ggx_g1(wi[..., 2:3], alpha)
    oh = torch.clamp_min(torch.sum(wo * h, dim=-1, keepdim=True), 0.0)
    fres = mat.albedo + (1.0 - mat.albedo) * (1.0 - oh) ** 5
    return d * g * fres / (4.0 * cos_o * cos_i)


def eval_f(mat: Mat, wo, wi):
    k = mat.kind[..., None]
    same_side = (wi[..., 2:3] > 0.0) & (wo[..., 2:3] > 0.0)
    zero = torch.zeros_like(mat.albedo)
    f = torch.where((k == MAT_DIFFUSE) & same_side, mat.albedo / math.pi, zero)
    return f + torch.where((k == MAT_GGX) & same_side, _ggx_f(mat, wo, wi),
                           zero)


def _schlick(cos_i, ior):
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_i) ** 5


def _refract(wo, ior):
    entering = wo[..., 2:3] > 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    cos_i = torch.abs(wo[..., 2:3])
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_i * cos_i, 0.0)
    tir = sin2_t > 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin2_t, 0.0))
    wi = torch.cat([-eta * wo[..., 0:1], -eta * wo[..., 1:2],
                    -torch.sign(wo[..., 2:3]) * cos_t], dim=-1)
    return wi, tir, eta


def _cosine_hemisphere(u):
    phi = 2.0 * math.pi * u[..., 0:1]
    cos_t = torch.sqrt(torch.clamp_min(1.0 - u[..., 1:2], 0.0))
    sin_t = torch.sqrt(torch.clamp_min(u[..., 1:2], 0.0))
    return torch.cat([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t],
                     dim=-1)


def sample_bsdf(mat: Mat, wo, u):
    """(wi, weight, delta, valid) of a BSDF sample from uniforms u (R, 3)."""
    k = mat.kind[..., None]
    zero3 = torch.zeros_like(mat.albedo)
    wi_d = _cosine_hemisphere(u[..., 0:2])
    flip = torch.where(wo[..., 2:3] < 0.0, -1.0, 1.0).to(wo.dtype)
    flip3 = torch.cat([torch.ones_like(flip), torch.ones_like(flip), flip], -1)
    wi_d = wi_d * flip3
    w_d = mat.albedo
    wi_m = torch.cat([-wo[..., 0:1], -wo[..., 1:2], wo[..., 2:3]], dim=-1)
    w_m = mat.albedo
    wi_t, tir, eta = _refract(wo, mat.ior)
    cos_i = torch.abs(wo[..., 2:3])
    fresnel = torch.where(tir, torch.ones_like(cos_i), _schlick(cos_i, mat.ior))
    take_refl = (u[..., 2:3] < fresnel) | tir
    wi_g = torch.where(take_refl, wi_m, wi_t)
    w_g = torch.where(take_refl, mat.albedo, mat.albedo * (eta * eta))
    wi_r = wi_t
    w_r = torch.where(tir, zero3, mat.albedo * (eta * eta))
    alpha_d = _ggx_alpha(mat.roughness).detach()
    a2_d = alpha_d * alpha_d
    u0 = u[..., 0:1]
    c2 = (1.0 - u0) / torch.clamp_min(1.0 + (a2_d - 1.0) * u0, 1e-12)
    cos_h = torch.sqrt(torch.clamp(c2, 0.0, 1.0))
    sin_h = torch.sqrt(torch.clamp(1.0 - c2, 0.0, 1.0))
    phi = 2.0 * math.pi * u[..., 1:2]
    h = torch.cat(
        [torch.cos(phi) * sin_h, torch.sin(phi) * sin_h, cos_h * flip], dim=-1)
    oh = torch.sum(wo * h, dim=-1, keepdim=True)
    wi_gx = (2.0 * oh * h - wo).detach()
    pdf_h = (_ggx_d(cos_h, alpha_d) * cos_h / torch.clamp_min(
        4.0 * torch.abs(oh), 1e-9)).detach()
    same_side = (wi_gx[..., 2:3] * flip > 0.0)
    f_gx = _ggx_f(mat, wo * flip3, wi_gx * flip3)
    w_gx = torch.where(same_side & (pdf_h > 1e-12),
                       f_gx * torch.abs(wi_gx[..., 2:3]) /
                       torch.clamp_min(pdf_h, 1e-12), zero3)
    wi = torch.where(k == MAT_DIFFUSE, wi_d,
         torch.where(k == MAT_MIRROR, wi_m,
         torch.where(k == MAT_GLASS, wi_g,
         torch.where(k == MAT_REFRACT, wi_r,
         torch.where(k == MAT_GGX, wi_gx, wi_d)))))
    weight = torch.where(k == MAT_DIFFUSE, w_d,
             torch.where(k == MAT_MIRROR, w_m,
             torch.where(k == MAT_GLASS, w_g,
             torch.where(k == MAT_REFRACT, w_r,
             torch.where(k == MAT_GGX, w_gx, zero3)))))
    valid = (k != MAT_EMISSIVE) & (
        torch.max(weight, dim=-1, keepdim=True).values > 0.0)
    return wi, weight, _is_delta(mat), valid


def sample_area_light(sc: RefScene, li: int, p, u):
    """(wi, dist, radiance, pdf) of a uniform sample of area light ``li``."""
    pos, ex, ey = sc.light_pos[li], sc.light_ex[li], sc.light_ey[li]
    nrm, rad = sc.light_nrm[li], sc.light_rad[li]
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    q = pos + u[..., 0:1] * ex + u[..., 1:2] * ey
    d = q - p
    dist2 = torch.clamp_min(dot(d, d), 1e-12)
    dist = torch.sqrt(dist2)
    wi = d / dist
    area = torch.linalg.norm(cross(ex, ey)) * 1.0
    cos_l = dot(-wi, nrm)
    pdf = dist2 / torch.clamp_min(area * torch.clamp_min(cos_l, 1e-9), 1e-12)
    radiance = torch.where(cos_l > 0.0, rad, zero) * torch.ones_like(p)
    return wi, dist, radiance, pdf


# --------------------------------------------------------------------------
# Paths.
# --------------------------------------------------------------------------

class Render(NamedTuple):
    """What a set of pixels renders to: summed radiance (P, 3) over the
    pixel's samples, and the closest-hit segments and counted shadow rays
    that tracing them took."""
    radiance: torch.Tensor
    n_closest: int
    n_shadow: int


def camera_rays(cam, width: int, height: int, pixel, jitter):
    """Rays through pixels (flat ids, row 0 at the bottom) with jitter."""
    c2w, origin, hfov, vfov = cam
    px = (pixel % width).to(torch.float32)
    py = torch.div(pixel, width, rounding_mode="floor").to(torch.float32)
    x = (px[..., None] + jitter[..., 0:1]) / width
    y = (py[..., None] + jitter[..., 1:2]) / height
    xy = torch.cat([x, y], dim=-1).to(c2w.dtype)
    tan_h = torch.tan(torch.deg2rad(hfov) * 0.5)
    tan_v = torch.tan(torch.deg2rad(vfov) * 0.5)
    dx = (2.0 * xy[..., 0:1] - 1.0) * tan_h
    dy = (2.0 * xy[..., 1:2] - 1.0) * tan_v
    d_cam = torch.cat([dx, dy, -torch.ones_like(dx)], dim=-1)
    rd = normalize(d_cam @ c2w.T)
    return origin.expand_as(rd), rd


def make_camera(cam, device, dtype=torch.float32):
    return tuple(torch.as_tensor(np.asarray(x, np.float32)).to(device, dtype)
                 for x in cam)


def trace(sc: RefScene, acc: Accel, cam, rcfg: dict, key, pixels,
          sample: int = 0) -> Render:
    """Sample ``sample`` of each pixel of ``pixels`` ((P,) int64): radiance
    (P, 3) and the counts.  Differentiable in the float tensors of ``sc``
    that require grad; the hits run outside autograd."""
    dt = sc.vertices.dtype
    dev = pixels.device
    spp = int(rcfg["spp"])
    eps = float(rcfg.get("eps", 1e-4))
    n_lights = sc.light_pos.shape[0]
    ns = int(rcfg.get("ns_area_light", 1))
    rid = pixels * spp + sample
    P = pixels.shape[0]
    jit = uniforms(key, rid, DRAW_JITTER, 2)
    ro, rd = camera_rays(cam, rcfg["width"], rcfg["height"], pixels, jit)
    L = torch.zeros((P, 3), dtype=dt, device=dev)
    beta = torch.ones((P, 3), dtype=dt, device=dev)
    include_le = torch.ones((P, 1), dtype=torch.bool, device=dev)
    lane = torch.arange(P, device=dev)       # live lanes -> their pixel row
    n_closest = n_shadow = 0
    for depth in range(int(rcfg["max_depth"]) + 1):
        if lane.numel() == 0:
            break
        n_closest += lane.numel()
        with torch.no_grad():
            found, prim, _, hu, hv = acc.closest(ro.detach(), rd.detach())
        # A miss adds the environment, which is black in these scenes.
        lane, ro, rd, beta, include_le = (
            x[found] for x in (lane, ro, rd, beta, include_le))
        prim, hu, hv = prim[found], hu[found, None], hv[found, None]
        r = rid[lane]
        base = 1 + depth * STRIDE
        idx = sc.tri_idx[prim]
        v0, v1, v2 = (sc.vertices[idx[:, k]] for k in range(3))
        w0 = 1.0 - hu - hv
        p = w0 * v0 + hu * v1 + hv * v2
        n0, n1, n2 = (sc.normals[idx[:, k]] for k in range(3))
        nsh = normalize(w0 * n0 + hu * n1 + hv * n2)
        ng = normalize(cross(v1 - v0, v2 - v0))
        ng = torch.where(dot(ng, nsh) < 0.0, -ng, ng)
        m = sc.tri_mat[prim]
        mat = Mat(sc.kind[m], sc.albedo[m], sc.emission[m], sc.ior[m][:, None],
                  sc.roughness[m][:, None])
        wo_world = -rd
        tb, bb = coord_space(nsh)
        wo = to_local(wo_world, tb, bb, nsh)
        zero3 = torch.zeros_like(beta)
        front = dot(wo_world, nsh) > 0.0
        contrib = zero3 + torch.where(include_le & front,
                                      beta * mat.emission, zero3)
        delta = _is_delta(mat)
        n_shadow += int((~delta).sum()) * n_lights * ns
        for li in range(n_lights):
            for s in range(ns):
                u = uniforms(key, r, base + LIGHT0 + li * ns + s, 2).to(dt)
                wi, dist, rad, pdf = sample_area_light(sc, li, p, u)
                wi_l = to_local(wi, tb, bb, nsh)
                f = eval_f(mat, wo, wi_l)
                cos_s = torch.clamp_min(wi_l[..., 2:3], 0.0)
                mask = (~delta & (cos_s > 0.0)
                        & (torch.max(f * rad, dim=-1, keepdim=True).values
                           > 0.0))
                sh_o = p + ng * torch.where(dot(wi, ng) > 0.0, eps,
                                            -eps).to(dt)
                occ = torch.zeros_like(mask)
                sel = mask[:, 0]
                if bool(sel.any()):
                    with torch.no_grad():
                        occ[sel] = acc.occluded(
                            sh_o.detach()[sel], wi.detach()[sel],
                            (dist.detach() * (1.0 - 1e-3))[sel, 0])[:, None]
                w = f * rad * cos_s / (pdf * ns)
                contrib = contrib + torch.where(mask & ~occ, beta * w, zero3)
        L = L.index_add(0, lane, contrib)
        u3 = uniforms(key, r, base + BSDF, 3).to(dt)
        wi_s, weight, bdelta, valid = sample_bsdf(mat, wo, u3.detach())
        wi_world = to_world(wi_s.detach(), tb, bb, nsh)
        cont = valid & (depth < int(rcfg["max_depth"]))
        beta = beta * torch.where(cont, weight, torch.ones_like(weight))
        do_rr = depth + 1 >= int(rcfg["rr_start"])
        if do_rr:
            u_rr = uniforms(key, r, base + RR, 1).to(dt)
            beta = torch.where(cont, beta / float(rcfg["rr_prob"]), beta)
            cont = cont & ~(u_rr >= float(rcfg["rr_prob"]))
        ro = p + ng * torch.where(dot(wi_world, ng) > 0.0, eps,
                                  -eps).to(dt)
        c = cont[:, 0]
        lane, ro, rd, beta, include_le = (
            lane[c], ro[c], wi_world[c], beta[c], bdelta[c])
    return Render(L, n_closest, n_shadow)


def render_image(sc, acc, cam, rcfg, key, block: int = 1 << 18) -> Render:
    """Every pixel of the image, in blocks: (n_pixels, 3) radiance (the
    mean over spp) and the image's counts."""
    n_pix = int(rcfg["width"]) * int(rcfg["height"])
    spp = int(rcfg["spp"])
    dev = sc.vertices.device
    out, nc, ns = [], 0, 0
    with torch.no_grad():
        for p0 in range(0, n_pix, block):
            pix = torch.arange(p0, min(n_pix, p0 + block), device=dev)
            acc_l = None
            for s in range(spp):
                r = trace(sc, acc, cam, rcfg, key, pix, s)
                acc_l = r.radiance if acc_l is None else acc_l + r.radiance
                nc += r.n_closest
                ns += r.n_shadow
            out.append(acc_l / spp)
    return Render(torch.cat(out), nc, ns)


# The differentiable parameters, by the names the program's gradient step
# gives them, and the fields of the reference's scene that hold them.
PARAMS = {"vertices": "vertices", "albedo": "albedo",
          "roughness": "roughness", "emission": "emission",
          "light_radiance": "light_rad"}


def loss_and_grad(sc, params: dict, acc, cam, rcfg, key, target,
                  block: int = 1 << 17, keep=None):
    """The L2 image loss mean((image - target)^2) over every pixel and
    channel, and its gradient with respect to ``params`` (a dict keyed as
    ``PARAMS``), summed over blocks of pixels.  ``keep`` ((n_pixels,) bool)
    takes the mean over those pixels alone."""
    n_pix = int(rcfg["width"]) * int(rcfg["height"])
    spp = int(rcfg["spp"])
    dev = sc.vertices.device
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    scp = sc._replace(**{PARAMS[k]: v for k, v in leaves.items()})
    n_used = n_pix if keep is None else int(keep.sum())
    loss = 0.0
    for p0 in range(0, n_pix, block):
        pix = torch.arange(p0, min(n_pix, p0 + block), device=dev)
        if keep is not None:
            pix = pix[keep[pix]]
        L = None
        for s in range(spp):
            r = trace(scp, acc, cam, rcfg, key, pix, s).radiance
            L = r if L is None else L + r
        part = ((L / spp - target[pix]) ** 2).sum() / (n_used * 3)
        part.backward()
        loss += float(part.detach())
    return loss, {k: (torch.zeros_like(v) if v.grad is None else v.grad)
                  for k, v in leaves.items()}
