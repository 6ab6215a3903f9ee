"""Dense-sweep intersection: every ray against every primitive row.

Counterpart of ``tpu_pt/kernels/intersect.py`` (names kept so that a reader
finds it; the backend string stays ``"pallas"`` in both packages).
Complexity is O(R·P), so this is the backend for small and medium
primitive counts (the Cornell family) and the intersector under the oracle
renderer (``render/driver.py::render``).

``dense_closest`` and ``dense_anyhit`` launch the hand-written CUDA kernels
of ``csrc/dense_isect.cu`` (which replace the Pallas kernels
``_closest_kernel`` and ``_anyhit_kernel``) for CUDA tensors and run
``closest_ref`` / ``anyhit_ref``, the plain PyTorch versions, for CPU
tensors.  The choice follows the tensors' device and nothing else.

Primitive rows ((P, 16) f32, P % 128 == 0, see ``bvh/native.py::prim_rows``):
  tri:    [v0, e1, e2, mat bits, 0 (type), pad]
  sphere: [centre, r, 0 0, 0 0 0, mat bits, 1 (type), pad]
Column 9 is a bit pattern and is never read here; all-zero rows are padding
and never hit (det = 0).  Ray rows ((R, 8) f32): [ro, t_min, rd, t_max];
a ray with t_max < t_min never hits.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pt_torch.core.intersect import INF, sphere_hit
from tpu_pt_torch.kernels import _build
from tpu_pt_torch.render.brute import Hit
from tpu_pt_torch.scene.types import Scene

RBLK = 128   # rays per kernel block
TBLK = 128   # primitive rows per staged tile


def _pair_test(rows, ro, rd, t_min, t_max):
    """Dense test of R rays against T primitive rows.

    rows: (T, 16); ro/rd: (R, 3); t_min/t_max: (R, 1).  Returns
    (hit, t, u, v) each (R, T), t = INF on miss.  u, v are the triangle
    branch's for sphere rows too (0 there, because a sphere row has
    e2 = 0, hence det = 0 and inv_det = 0).  Every component is written
    out in the kernel's operation order, one rounding per operation, so the
    two agree bit for bit."""
    def col(c):
        return rows[None, :, c]                    # (1, T)

    def rcol(x, i):
        return x[:, i:i + 1]                       # (R, 1)

    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    typ = col(10)
    ox, oy, oz = rcol(ro, 0), rcol(ro, 1), rcol(ro, 2)
    dx, dy, dz = rcol(rd, 0), rcol(rd, 1), rcol(rd, 2)
    zero = torch.zeros((), dtype=rows.dtype, device=rows.device)
    one = torch.ones((), dtype=rows.dtype, device=rows.device)

    # pvec = rd x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    par = torch.abs(det) < 1e-12
    inv_det = torch.where(par, zero, 1.0 / torch.where(par, one, det))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    # qvec = tvec x e1
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t_tri = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit_tri = (~par) & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t_tri >= t_min) & (t_tri <= t_max)

    # Sphere rows: v0 = centre, e1.x = radius.
    hit_sph, t_sph = sphere_hit(tvx, tvy, tvz, dx, dy, dz, e1x, t_min, t_max)

    is_sph = typ > 0.5
    hit = torch.where(is_sph, hit_sph, hit_tri)
    t = torch.where(is_sph, t_sph, t_tri)
    return hit, torch.where(hit, t, torch.full_like(t, INF)), u, v


def _check_shapes(rays, prims):
    _build.refuse_grad("dense sweep", rays=rays, prims=prims)
    if rays.dim() != 2 or rays.shape[1] != 8:
        raise ValueError(f"rays: expected (R, 8), got {tuple(rays.shape)}")
    if prims.dim() != 2 or prims.shape[1] != 16 or prims.shape[0] % TBLK \
            or prims.shape[0] == 0:
        raise ValueError(f"prims: expected (P, 16) with P a positive "
                         f"multiple of {TBLK}, got {tuple(prims.shape)}")
    if rays.dtype != torch.float32 or prims.dtype != torch.float32:
        raise TypeError(f"rays and prims: expected float32, got "
                        f"{rays.dtype} and {prims.dtype}")


def closest_ref(rays, prims):
    """Plain PyTorch version of :func:`dense_closest`: a loop over 128-row
    tiles with (R, 128) temporaries (never an (R, P) tensor).  Inside a tile
    the first lowest t wins; across tiles a strict ``<`` while the range is
    cut to ``min(t_max, best so far)``: a later row at exactly the same t
    passes the range test and then loses, so the lowest slot wins."""
    _check_shapes(rays, prims)
    R = rays.shape[0]
    dev = rays.device
    ro, t_min = rays[:, 0:3], rays[:, 3:4]
    rd, t_max = rays[:, 4:7], rays[:, 7:8]
    best_t = torch.full((R, 1), INF, dtype=torch.float32, device=dev)
    best_u = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    best_slot = torch.zeros((R, 1), dtype=torch.int64, device=dev)
    lanes = torch.arange(TBLK, device=dev)[None, :]
    for k in range(prims.shape[0] // TBLK):
        rows = prims[k * TBLK:(k + 1) * TBLK]
        _, t, u, v = _pair_test(rows, ro, rd, t_min,
                                torch.minimum(t_max, best_t))
        tile_t = torch.min(t, dim=1, keepdim=True).values
        arg = torch.min(torch.where(t == tile_t, lanes, TBLK), dim=1,
                        keepdim=True).values               # first lowest
        closer = tile_t < best_t
        best_t = torch.where(closer, tile_t, best_t)
        best_u = torch.where(closer, torch.gather(u, 1, arg), best_u)
        best_v = torch.where(closer, torch.gather(v, 1, arg), best_v)
        best_slot = torch.where(closer, k * TBLK + arg, best_slot)
    return (best_t[:, 0], best_u[:, 0], best_v[:, 0],
            best_slot[:, 0].to(torch.int32))


def anyhit_ref(rays, prims):
    """Plain PyTorch version of :func:`dense_anyhit`: 1.0 where any row
    hits inside [t_min, t_max], tile by tile."""
    _check_shapes(rays, prims)
    ro, t_min = rays[:, 0:3], rays[:, 3:4]
    rd, t_max = rays[:, 4:7], rays[:, 7:8]
    occ = torch.zeros((rays.shape[0],), dtype=torch.bool, device=rays.device)
    for k in range(prims.shape[0] // TBLK):
        hit, _, _, _ = _pair_test(prims[k * TBLK:(k + 1) * TBLK], ro, rd,
                                  t_min, t_max)
        occ = occ | torch.any(hit, dim=1)
    return occ.to(torch.float32)


def _check_cuda(rays, prims, name):
    _check_shapes(rays, prims)
    _build.check_cuda_input("rays", rays, torch.float32)
    _build.check_cuda_input("prims", prims, torch.float32)
    if rays.device != prims.device:
        raise ValueError(f"{name}: tensors on different devices")
    return _build.load()


def dense_closest(rays, prims):
    """rays: (R, 8) f32 rows [ro, t_min, rd, t_max], any R; prims: (P, 16)
    f32, P % 128 == 0.  Returns (t (R,) f32 — INF on miss —, u, v,
    slot (R,) i32): the nearest hit of each ray over all rows, lowest slot
    at equal t.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    if not rays.is_cuda:
        return closest_ref(rays, prims)
    lib = _check_cuda(rays, prims, "dense_closest")
    R = rays.shape[0]
    t, u, v = (torch.empty((R,), dtype=torch.float32, device=rays.device)
               for _ in range(3))
    slot = torch.empty((R,), dtype=torch.int32, device=rays.device)
    if R == 0:
        return t, u, v, slot
    err = lib.dense_closest_launch(
        rays.data_ptr(), prims.data_ptr(), t.data_ptr(), u.data_ptr(),
        v.data_ptr(), slot.data_ptr(), R, prims.shape[0],
        torch.cuda.current_stream(rays.device).cuda_stream)
    dense_closest.launches += 1
    if err != 0:
        raise RuntimeError(f"dense_closest: CUDA launch error {err}")
    return t, u, v, slot


dense_closest.launches = 0   # kernel launches made by this process


def dense_anyhit(rays, prims):
    """Same operands as :func:`dense_closest`.  Returns (R,) f32: 1.0 where
    any row hits inside [t_min, t_max], else 0.0.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    if not rays.is_cuda:
        return anyhit_ref(rays, prims)
    lib = _check_cuda(rays, prims, "dense_anyhit")
    R = rays.shape[0]
    occ = torch.empty((R,), dtype=torch.float32, device=rays.device)
    if R == 0:
        return occ
    err = lib.dense_anyhit_launch(
        rays.data_ptr(), prims.data_ptr(), occ.data_ptr(), R, prims.shape[0],
        torch.cuda.current_stream(rays.device).cuda_stream)
    dense_anyhit.launches += 1
    if err != 0:
        raise RuntimeError(f"dense_anyhit: CUDA launch error {err}")
    return occ


dense_anyhit.launches = 0   # kernel launches made by this process


class PallasScene:
    """The dense-sweep container: every primitive of a scene as one (P, 16)
    row, P padded to a multiple of 128 with all-zero rows that never hit,
    plus the true count ``n_prims``.  Row i is primitive i of the scene's
    shared index space, so a slot is a primitive id.

    In the port this is a plain class built on the host (numpy rows) and
    moved with ``.to(device)``; it keeps the name of its counterpart in the
    JAX package, where it feeds the Pallas kernels."""

    def __init__(self, scene: Scene = None, *, prims=None, n_prims=None):
        if scene is not None:
            from tpu_pt_torch.bvh.native import prim_rows

            rows = prim_rows(scene, np.arange(scene.n_prims)).cpu().numpy()
            p = rows.shape[0]
            prims = np.zeros((-(-p // TBLK) * TBLK, 16), np.float32)
            prims[:p] = rows
            n_prims = p
        self.prims = prims
        self.n_prims = int(n_prims)

    def to(self, device) -> "PallasScene":
        prims = self.prims if torch.is_tensor(self.prims) \
            else torch.from_numpy(np.ascontiguousarray(self.prims))
        return PallasScene(prims=prims.to(device).contiguous(),
                           n_prims=self.n_prims)


def _ray_rows(ro, rd, t_min, t_max):
    R = ro.shape[0]
    return torch.cat([ro, t_min.expand(R, 1), rd, t_max.expand(R, 1)],
                     dim=1).contiguous()


def intersect(ps: PallasScene, scene: Scene, ro, rd, t_min, t_max,
              use_kernels: bool = True) -> Hit:
    """Nearest hit of each ray over all primitives.  ro/rd: (R, 3);
    t_min/t_max: (R, 1).  ``use_kernels=False`` runs the plain version on
    whatever device the tensors are on."""
    rays = _ray_rows(ro, rd, t_min, t_max)
    closest = dense_closest if use_kernels else closest_ref
    t, u, v, slot = closest(rays, ps.prims)
    t = t[:, None]
    return Hit(hit=t < INF, t=t, prim=slot.clamp(0, ps.n_prims - 1),
               u=u[:, None], v=v[:, None])


def occluded(ps: PallasScene, scene: Scene, ro, rd, t_max,
             use_kernels: bool = True):
    """Any-hit test for shadow rays: (R, 1) bool."""
    rays = _ray_rows(ro, rd, torch.zeros_like(t_max), t_max)
    anyhit = dense_anyhit if use_kernels else anyhit_ref
    return anyhit(rays, ps.prims)[:, None] > 0.5
