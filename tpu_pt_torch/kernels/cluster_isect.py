"""Pair-tile intersection: tile fetch + primitive test + lane reduction.

For each (ray, cluster) pair the cluster's (12, L) tile is tested against
the ray (Möller–Trumbore on triangle lanes, the quadratic on sphere lanes)
and the L lanes are reduced to the nearest hit, lowest lane at equal t.
Tile lanes are sorted by primitive id at build time, so "lowest lane" is
the lowest-id tie rule.

``pair_tile_isect`` launches the hand-written CUDA kernel
(``csrc/pair_tile_isect.cu``, which replaces the Pallas kernel
``tpu_pt/kernels/cluster_isect.py::pair_tile_isect``) for CUDA tensors and
runs ``pair_tile_isect_ref``, the plain PyTorch version, for CPU tensors.
``pair_tile_isect_dedup`` is the same function for a pair list sorted by
cluster id (``csrc/pair_tile_isect_dedup.cu``).  The choice between kernel
and plain version follows the tensors' device and nothing else.

Row layout of a tile: lane p holds primitive p as rows
[v0.xyz, e1.xyz, e2.xyz, type, 0, 0]; type 1 = sphere (v0 = centre,
e1.x = radius); all-zero lanes are padding and never hit.
Ray rows: [ro(3), rd(3), t_min, t_max, live, pad...] (16 floats).
Output row per pair: [t, lane, u, v, 0, 0, 0, 0] with t = INF on miss.
"""

from __future__ import annotations

import torch

from tpu_pt_torch.core.intersect import INF, sphere_hit
from tpu_pt_torch.kernels import _build

B = 128      # the pair count must be a multiple of this
ROWS = 12
LANE_WIDTHS = (32, 64, 128)   # tile widths the kernel takes

# The cluster-major kernel's grid: blocks of four warps, a warp per pair
# slot, at most five blocks an SM (2,640 warps on 132 SMs hold the live
# pairs of a steady-state sub-batch in one pass).
DEDUP_WARPS_PER_BLOCK = 4
DEDUP_BLOCKS_PER_SM = 5


def _mt_group(tiles, rays):
    """Dense test of P rays against their P tiles.

    tiles: (P, ROWS, L); rays: (P, 16).  Returns (t, u, v) each (P, L), INF
    on miss.  The operation order is the kernel's, one rounding per
    operation, so the two agree bit for bit."""
    def trow(r):
        return tiles[:, r, :]                      # (P, L)

    def rcol(c):
        return rays[:, c:c + 1]                    # (P, 1)

    v0x, v0y, v0z = trow(0), trow(1), trow(2)
    e1x, e1y, e1z = trow(3), trow(4), trow(5)
    e2x, e2y, e2z = trow(6), trow(7), trow(8)
    typ = trow(9)
    ox, oy, oz = rcol(0), rcol(1), rcol(2)
    dx, dy, dz = rcol(3), rcol(4), rcol(5)
    t_min, t_max, live = rcol(6), rcol(7), rcol(8)
    zero = torch.zeros((), dtype=tiles.dtype, device=tiles.device)
    one = torch.ones((), dtype=tiles.dtype, device=tiles.device)

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
    ok_tri = (~par) & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t_tri >= t_min) & (t_tri <= t_max)

    # Sphere lanes: v0 = centre, e1.x = radius.
    ok_sph, t_sph = sphere_hit(tvx, tvy, tvz, dx, dy, dz, e1x, t_min, t_max)

    is_sph = typ > 0.5
    ok = ((is_sph & ok_sph) | (~is_sph & ok_tri)) & (live > 0.0)
    t = torch.where(ok, torch.where(is_sph, t_sph, t_tri),
                    torch.full_like(t_tri, INF))
    return t, torch.where(is_sph, zero, u), torch.where(is_sph, zero, v)


def pair_rows(ro, rd, t_min1, t_max1, ray_c, cid_c, pair_ok):
    """Operands of the pair-tile kernel for a flat pair batch: the cluster
    ids (i32) and the (P, 16) ray rows, both padded with dead pairs to a
    multiple of 128."""
    P = cid_c.shape[0]
    pad = (-P) % B
    rays = torch.zeros((P + pad, 16), dtype=torch.float32, device=ro.device)
    rays[:P, 0:3] = ro[ray_c]
    rays[:P, 3:6] = rd[ray_c]
    rays[:P, 6] = t_min1[ray_c]
    rays[:P, 7] = t_max1[ray_c]
    rays[:P, 8] = pair_ok.to(torch.float32)
    cid_p = cid_c.to(torch.int32)
    if pad:
        cid_p = torch.cat([cid_p, cid_p.new_zeros((pad,))])
    return cid_p.contiguous(), rays


def _check_shapes(tiles, cid, rays):
    _build.refuse_grad("pair_tile_isect", tiles=tiles, cid=cid, rays=rays)
    if tiles.dim() != 3 or tiles.shape[1] != ROWS \
            or tiles.shape[2] not in LANE_WIDTHS or tiles.shape[0] < 1:
        raise ValueError(f"tiles: expected (C, {ROWS}, L) with C >= 1 and L "
                         f"in {LANE_WIDTHS}, got {tuple(tiles.shape)}")
    P = cid.shape[0]
    if cid.dim() != 1 or P % B != 0:
        raise ValueError(f"cid: expected (P,) with P % {B} == 0, got "
                         f"{tuple(cid.shape)}")
    if tuple(rays.shape) != (P, 16):
        raise ValueError(f"rays: expected ({P}, 16), got {tuple(rays.shape)}")
    if cid.device != tiles.device or rays.device != tiles.device:
        raise ValueError("tiles, cid and rays on different devices")


def pair_tile_isect_ref(tiles, cid, rays):
    """Plain PyTorch version of :func:`pair_tile_isect`: materialises the
    (P, 12, L) tile gather, then elementwise math and a lane argmin."""
    _check_shapes(tiles, cid, rays)
    L = tiles.shape[2]
    t, u, v = _mt_group(tiles[cid.long()], rays)
    t_best = torch.min(t, dim=1, keepdim=True).values          # (P, 1)
    lanes = torch.arange(L, device=t.device)[None, :]
    lane = torch.min(torch.where(t == t_best, lanes, L), dim=1,
                     keepdim=True).values                      # lowest at ties
    found = t_best < INF
    zero = torch.zeros_like(t_best)
    u_b = torch.where(found, torch.gather(u, 1, lane), zero)
    v_b = torch.where(found, torch.gather(v, 1, lane), zero)
    out = torch.zeros((cid.shape[0], 8), dtype=tiles.dtype, device=tiles.device)
    out[:, 0:1] = t_best
    out[:, 1:2] = lane.to(tiles.dtype)
    out[:, 2:3] = u_b
    out[:, 3:4] = v_b
    return out


def _check_aligned(name, **tensors):
    """Raise unless every tensor starts on a 16-byte boundary (the
    cluster-major kernel reads tile and ray rows 16 bytes at a time)."""
    for what, x in tensors.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned")


def _launch(wrapper, launch_name, tiles, cid, rays, *extra):
    """Checks shared by the two pair-tile kernels, then one launch of
    ``launch_name`` (tiles, cid, rays, out, P, L, *extra, stream) on the
    current stream, counted on ``wrapper``."""
    name = wrapper.__name__
    _check_shapes(tiles, cid, rays)
    P = cid.shape[0]
    _build.check_cuda_input("tiles", tiles, torch.float32)
    _build.check_cuda_input("cid", cid, torch.int32, (P,))
    _build.check_cuda_input("rays", rays, torch.float32, (P, 16))
    out = torch.empty((P, 8), dtype=torch.float32, device=tiles.device)
    if P == 0:
        return out
    err = getattr(_build.load(), launch_name)(
        tiles.data_ptr(), cid.data_ptr(), rays.data_ptr(), out.data_ptr(),
        P, tiles.shape[2], *extra,
        torch.cuda.current_stream(tiles.device).cuda_stream)
    wrapper.launches += 1
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch error {err}")
    return out


def pair_tile_isect(tiles, cid, rays):
    """tiles: (C, 12, L) f32, L in {32, 64, 128}; cid: (P,) i32
    (P % 128 == 0, every id in [0, C)); rays: (P, 16) f32 rows
    [ro(3), rd(3), t_min, t_max, live, pad...].  Returns (P, 8) f32 rows
    [t, lane, u, v, 0...] (t = INF for dead/miss pairs).

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    if not tiles.is_cuda:
        return pair_tile_isect_ref(tiles, cid, rays)
    return _launch(pair_tile_isect, "pair_tile_isect_launch", tiles, cid, rays)


pair_tile_isect.launches = 0   # kernel launches made by this process


def pair_tile_isect_dedup_ref(tiles, cid, rays):
    """Plain PyTorch version of :func:`pair_tile_isect_dedup`.  The function
    computed is :func:`pair_tile_isect`'s, pair by pair; the order of the
    list only decides how many tile fetches the kernel saves."""
    return pair_tile_isect_ref(tiles, cid, rays)


def dedup_grid_blocks(P: int, n_sm: int) -> int:
    """Blocks of the cluster-major kernel for P pair slots on a card with
    ``n_sm`` SMs: a warp per slot, but no more than DEDUP_BLOCKS_PER_SM
    blocks an SM; the grid strides over the rest."""
    if P < 0 or n_sm < 1:
        raise ValueError(f"dedup_grid_blocks: P {P}, n_sm {n_sm}")
    return max(1, min(-(-P // DEDUP_WARPS_PER_BLOCK),
                      DEDUP_BLOCKS_PER_SM * n_sm))


def pair_tile_isect_dedup(tiles, cid, rays):
    """Cluster-major variant of :func:`pair_tile_isect`: same operands and
    output, for a pair list SORTED BY cid ascending (dead pairs' ids clipped
    into range).  The kernel (``csrc/pair_tile_isect_dedup.cu``, which
    replaces the Pallas kernel
    ``tpu_pt/kernels/cluster_isect.py::pair_tile_isect_dedup``) gives each
    pair slot a warp; the warps of a block take consecutive slots, so the
    pairs that name one tile find it in cache.  tiles and rays must be
    16-byte aligned; ids outside [0, C) are clamped by the kernel.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    if not tiles.is_cuda:
        return pair_tile_isect_dedup_ref(tiles, cid, rays)
    _check_aligned("pair_tile_isect_dedup", tiles=tiles, rays=rays)
    blocks = dedup_grid_blocks(cid.shape[0], _build.sm_count(tiles.device))
    return _launch(pair_tile_isect_dedup, "pair_tile_isect_dedup_launch",
                   tiles, cid, rays, tiles.shape[0], blocks)


pair_tile_isect_dedup.launches = 0   # kernel launches made by this process


def check_pair_out(out, rays, label: str = "pair_tile_isect"):
    """Output contract, per pair row [t, lane, u, v, ...] against rays
    [.., t_min, t_max, live, ..]: a reported hit has t inside
    [t_min, t_max], a lane index in [0, 128) and finite u/v; dead pairs
    report t = INF.  Raises AssertionError (reads the device)."""
    t = out[:, 0]
    lane = out[:, 1]
    hit = t < INF
    t_min, t_max, live = rays[:, 6], rays[:, 7], rays[:, 8] > 0.5
    true = torch.ones_like(hit)
    if not bool(torch.all(torch.where(hit, (t >= t_min) & (t <= t_max), true))):
        raise AssertionError(label + ": hit t outside the query range")
    if not bool(torch.all(torch.where(hit, (lane >= 0) & (lane < 128), true))):
        raise AssertionError(label + ": lane index out of range")
    if not bool(torch.all(torch.isfinite(
            torch.where(hit[:, None], out[:, 2:4],
                        torch.zeros_like(out[:, 2:4]))))):
        raise AssertionError(label + ": non-finite barycentrics")
    if not bool(torch.all(torch.where(live, true, ~hit))):
        raise AssertionError(label + ": dead pair reported a hit")


def _check_pair_in(tiles, cid, label):
    """Input sanitation: NaN geometry silently MASKS hits (every NaN
    comparison is False, hence a miss), so poisoned tiles cannot be seen
    from the output alone; the guard looks at the operands."""
    if not bool(torch.all(torch.isfinite(tiles))):
        raise AssertionError(label + ": non-finite tile geometry")
    if not bool(torch.all((cid >= 0) & (cid < tiles.shape[0]))):
        raise AssertionError(label + ": cluster id out of range")


def pair_tile_isect_checked(tiles, cid, rays):
    """pair_tile_isect + input/output contract checks."""
    _check_pair_in(tiles, cid, "pair_tile_isect")
    out = pair_tile_isect(tiles, cid, rays)
    check_pair_out(out, rays)
    return out


def pair_tile_isect_dedup_checked(tiles, cid, rays):
    """pair_tile_isect_dedup + input/output contract checks, the ascending
    order of cid among them."""
    _check_pair_in(tiles, cid, "pair_tile_isect_dedup")
    if not bool(torch.all(cid[1:] >= cid[:-1])):
        raise AssertionError("pair_tile_isect_dedup: cluster ids not sorted")
    out = pair_tile_isect_dedup(tiles, cid, rays)
    check_pair_out(out, rays, label="pair_tile_isect_dedup")
    return out
