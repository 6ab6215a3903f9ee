"""The ray-major pair stage as one kernel: per ray, tile-test every
(ray, cluster) pair of the ray's segment of the pair list and reduce all of
them to the nearest hit.

The compact traversal flattens its candidates into one ray-major pair list;
ray q's pairs occupy ``[right[q] - cnt[q], right[q])``.  The split form of
the stage runs the pair-tile kernel over the list
(``kernels.cluster_isect.pair_tile_isect``: one (t, lane, u, v) row per
pair), gathers each row's primitive id and reduces per ray
(``kernels.pair_scan.pair_segmin``), with array code before, between and
after the two.  ``pair_ray_reduce`` computes the same per-ray result from the
traversal's own tensors in ONE launch: it takes the cluster ids and the
segment bounds in the dtype ``_flat_pairs`` makes them (int64), gathers the
ray by index and writes one masked row per ray.

What it returns, bit for bit the split stage's: the lexicographic minimum of
``(t, gid)`` over all lanes of all the ray's pairs, with the winner's u, v
(0 on sphere lanes), or ``(INF, 0, 0, 0)`` where the segment is empty or
nothing hit; in any-hit form, whether anything hit.  The split stage takes
the lowest LANE at equal t inside a tile and the lowest gid across tiles;
the two agree because the lanes of a tile are sorted by primitive id when
the tree is built (``tile_gid`` ascends over the live lanes of a tile).

``pair_ray_reduce`` launches the hand-written CUDA kernel
(``csrc/pair_ray_reduce.cu``, which replaces the Pallas kernels
``tpu_pt/kernels/cluster_isect.py::pair_tile_isect`` and
``tpu_pt/kernels/pair_scan.py::pair_segmin_scan`` as one stage) for CUDA
tensors and runs ``pair_ray_reduce_ref`` for CPU tensors.  The plain version
IS the split stage on plain versions.

The kernel gives every pair slot a warp and lets the warp that finishes a
ray's last pair reduce the ray (the source says why, and what a grid with a
group of threads per ray cost).  For that it keeps one int32 counter per ray,
which every launch leaves at zero, so the wrapper keeps a zeroed buffer per
device and stream and never clears it again.  The buffer belongs to the
thread that launches on that stream: two host threads must not launch
``pair_ray_reduce`` on one stream, and a launch must not be captured into a
graph that is replayed beside others.  ``pair_ray_reduce_checked`` is the
form that verifies what the kernel relies on (ordered, consistent segments
before the launch, zero counters after it).

Segments may leave gaps between them: a slot that lies in no ray's segment
is never tested.  ``row_segments`` gives the frontier walk's round 1 in that
form, each ray's live candidates left in its row of the (Q, pair_budget)
slots.
"""

from __future__ import annotations

import torch

from tpu_pt_torch.core.intersect import INF
from tpu_pt_torch.kernels import _build
from tpu_pt_torch.kernels.cluster_isect import (
    LANE_WIDTHS, ROWS, pair_rows, pair_tile_isect_ref)
from tpu_pt_torch.kernels.pair_scan import pair_segmin_ref

# The kernel's grid: blocks (of four warps) per SM.  20 warps an SM hold the
# live pairs of a steady-state sub-batch in one pass, and at the kernel's 95
# registers a thread five blocks are what an SM keeps resident.
PAIR_BLOCKS_PER_SM = 5

_counters = {}   # (device index, stream) -> (Q',) i32 zeros, Q' >= Q


def pair_grid_blocks(device) -> int:
    """Most blocks the kernel launches on ``device``."""
    return PAIR_BLOCKS_PER_SM * _build.sm_count(device)


def _ray_counters(device, Q: int):
    """The kernel's per-ray arrival counters for the current stream: all
    zero, and left all zero by every launch."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.shape[0] < Q:
        buf = torch.zeros((max(Q, 4096),), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _check_shapes(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt, right):
    _build.refuse_grad("pair_ray_reduce", tiles=tiles, tile_gid=tile_gid,
                       ro=ro, rd=rd, t_min=t_min, t_max=t_max, cid=cid,
                       cnt=cnt, right=right)
    if tiles.dim() != 3 or tiles.shape[1] != ROWS \
            or tiles.shape[2] not in LANE_WIDTHS or tiles.shape[0] < 1:
        raise ValueError(f"tiles: expected (C, {ROWS}, L) with C >= 1 and L "
                         f"in {LANE_WIDTHS}, got {tuple(tiles.shape)}")
    C, _, L = tiles.shape
    if tuple(tile_gid.shape) != (C, L):
        raise ValueError(f"tile_gid: expected ({C}, {L}), got "
                         f"{tuple(tile_gid.shape)}")
    if cnt.dim() != 1:
        raise ValueError(f"cnt: expected (Q,), got {tuple(cnt.shape)}")
    Q = cnt.shape[0]
    for name, x, shape in (("ro", ro, (Q, 3)), ("rd", rd, (Q, 3)),
                           ("t_min", t_min, (Q,)), ("t_max", t_max, (Q,)),
                           ("right", right, (Q,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(x.shape)}")
    if cid.dim() != 1:
        raise ValueError(f"cid: expected (P,), got {tuple(cid.shape)}")
    for name, x, dt in (("tiles", tiles, torch.float32),
                        ("tile_gid", tile_gid, torch.int32),
                        ("ro", ro, torch.float32), ("rd", rd, torch.float32),
                        ("t_min", t_min, torch.float32),
                        ("t_max", t_max, torch.float32),
                        ("cid", cid, torch.int64), ("cnt", cnt, torch.int64),
                        ("right", right, torch.int64)):
        if x.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {x.dtype}")
        if x.device != tiles.device:
            raise ValueError("pair_ray_reduce: tensors on different devices")


def pair_ray_reduce_ref(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt,
                        right, any_hit: bool = False):
    """Plain PyTorch version of :func:`pair_ray_reduce`: the split stage on
    plain versions.  Ray rows per pair, ``pair_tile_isect_ref``, the gid
    gather, ``pair_segmin_ref``, the masks.  ``right`` must not decrease (it
    is a running sum), so that a pair's ray can be found by bisection."""
    _check_shapes(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt, right)
    C, _, L = tiles.shape
    P, Q = cid.shape[0], cnt.shape[0]
    dev = tiles.device
    if Q == 0:
        if any_hit:
            return torch.zeros((0,), dtype=torch.bool, device=dev)
        z = torch.zeros((0,), dtype=torch.float32, device=dev)
        return z, z.to(torch.int32), z.clone(), z.clone()
    # The segments, held inside [0, P] and behind one another as the kernel
    # holds them.
    end = right.clamp(0, P)
    prev = torch.cat([end.new_zeros((1,)), end[:-1]])
    start = torch.maximum(end - cnt.clamp_min(0), prev)
    cnt = (end - start).clamp_min(0)
    pos = torch.arange(P, device=dev)
    ray = torch.searchsorted(end, pos, right=True).clamp_max(Q - 1)
    pair_ok = (pos >= start[ray]) & (pos < end[ray])
    cid_c = cid.clamp(0, C - 1)
    cid_p, rays = pair_rows(ro, rd, t_min, t_max, ray, cid_c, pair_ok)
    out = pair_tile_isect_ref(tiles, cid_p, rays)[:P]
    lane = out[:, 1].to(torch.int64).clamp(0, L - 1)
    gid = torch.zeros((P,), dtype=torch.int32, device=dev) if any_hit \
        else tile_gid[cid_c, lane]
    best_t, best_g, best_u, best_v = pair_segmin_ref(
        out[:, 0].contiguous(), gid.contiguous(), out[:, 2].contiguous(),
        out[:, 3].contiguous(), cnt.to(torch.int32), end.to(torch.int32))
    has = (cnt > 0) & (best_t < INF)
    if any_hit:
        return has
    zero = torch.zeros_like(best_t)
    return (torch.where(has, best_t, torch.full_like(best_t, INF)),
            torch.where(has, best_g, torch.zeros_like(best_g)),
            torch.where(has, best_u, zero), torch.where(has, best_v, zero))


def pair_ray_reduce(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt, right,
                    any_hit: bool = False):
    """tiles: (C, 12, L) f32, L in {32, 64, 128}; tile_gid: (C, L) i32,
    ascending over the live lanes of a tile; ro, rd: (Q, 3) f32; t_min,
    t_max: (Q,) f32; cid: (P,) i64 (clamped into [0, C) by the function);
    cnt, right: (Q,) i64, ray q's pairs at ``[right[q] - cnt[q], right[q])``
    inside [0, P], ``right`` not decreasing, segments not overlapping (the
    shape ``_flat_pairs`` gives them; gaps between them are allowed).  The
    list beyond the last segment is never read.

    Returns per ray (t (Q,) f32, gid (Q,) i32, u, v) of the nearest hit over
    the ray's pairs, lowest gid at equal t; (INF, 0, 0, 0) where the segment
    is empty or nothing hit.  With ``any_hit`` returns (Q,) bool instead:
    the segment is not empty and something hit.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version.  The kernel relies on the segments being as stated and cannot
    say when they are not: :func:`pair_ray_reduce_checked` can."""
    if not tiles.is_cuda:
        return pair_ray_reduce_ref(tiles, tile_gid, ro, rd, t_min, t_max, cid,
                                   cnt, right, any_hit)
    _check_shapes(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt, right)
    for name, x in (("tiles", tiles), ("tile_gid", tile_gid), ("ro", ro),
                    ("rd", rd), ("t_min", t_min), ("t_max", t_max),
                    ("cid", cid), ("cnt", cnt), ("right", right)):
        _build.check_cuda_input(name, x, x.dtype)
    if tiles.data_ptr() % 16 or tile_gid.data_ptr() % 16:
        raise ValueError("pair_ray_reduce: tiles and tile_gid must be "
                         "16-byte aligned")
    C, _, L = tiles.shape
    P, Q = cid.shape[0], cnt.shape[0]
    dev = tiles.device
    if Q > 0:
        # One (t, gid, u, v) row per pair slot; alive until the launch.
        scratch = torch.empty((P, 4), dtype=torch.float32, device=dev)
        count = _ray_counters(dev, Q)
    if any_hit:
        occ = torch.empty((Q,), dtype=torch.bool, device=dev)
        outs = (0, 0, 0, 0, occ.data_ptr())
    else:
        out_t = torch.empty((Q,), dtype=torch.float32, device=dev)
        out_g = torch.empty((Q,), dtype=torch.int32, device=dev)
        out_u = torch.empty_like(out_t)
        out_v = torch.empty_like(out_t)
        outs = (out_t.data_ptr(), out_g.data_ptr(), out_u.data_ptr(),
                out_v.data_ptr(), 0)
    if Q > 0:
        err = _build.load().pair_ray_reduce_launch(
            tiles.data_ptr(), tile_gid.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), cid.data_ptr(),
            cnt.data_ptr(), right.data_ptr(), *outs,
            scratch.data_ptr(), count.data_ptr(), Q, P, C, L,
            int(bool(any_hit)), pair_grid_blocks(dev),
            torch.cuda.current_stream(dev).cuda_stream)
        pair_ray_reduce.launches += 1
        if err != 0:
            raise RuntimeError(f"pair_ray_reduce: CUDA launch error {err} "
                               f"(L {L})")
    return occ if any_hit else (out_t, out_g, out_u, out_v)


pair_ray_reduce.launches = 0   # kernel launches made by this process


def pair_ray_reduce_checked(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt,
                            right, any_hit: bool = False):
    """pair_ray_reduce + the contract checks the kernel cannot make itself
    (they read the device).  Before the launch: finite tile geometry (NaN
    geometry silently masks hits); ``right`` inside [0, P] and not
    decreasing; ``cnt`` not negative and no segment reaching back into the
    one before it (a gap is fine).  After it: a reported hit has t inside [t_min, t_max] and
    finite u, v, a ray without pairs reports none, and the per-ray counters
    of the stream are all zero again.  Raises AssertionError."""
    _check_shapes(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt, right)
    name = "pair_ray_reduce"
    P = cid.shape[0]
    if not bool(torch.all(torch.isfinite(tiles))):
        raise AssertionError(name + ": non-finite tile geometry")
    if not bool(torch.all((right >= 0) & (right <= P))):
        raise AssertionError(name + ": segment end outside the pair list")
    if not bool(torch.all(right[1:] >= right[:-1])):
        raise AssertionError(name + ": segment ends decrease")
    prev = torch.cat([right.new_zeros((1,)), right[:-1]])
    if not bool(torch.all((cnt >= 0) & (right - cnt >= prev))):
        raise AssertionError(name + ": segment counts and ends disagree")
    out = pair_ray_reduce(tiles, tile_gid, ro, rd, t_min, t_max, cid, cnt,
                          right, any_hit)
    if any_hit:
        hit = out
    else:
        t, _, u, v = out
        hit = t < INF
        true = torch.ones_like(hit)
        if not bool(torch.all(torch.where(hit, (t >= t_min) & (t <= t_max),
                                          true))):
            raise AssertionError(name + ": hit t outside the query range")
        if not bool(torch.all(torch.isfinite(u) & torch.isfinite(v))):
            raise AssertionError(name + ": non-finite barycentrics")
    if bool(torch.any(hit & (cnt <= 0))):
        raise AssertionError(name + ": a ray without pairs reported a hit")
    if tiles.is_cuda:
        key = (tiles.device.index,
               torch.cuda.current_stream(tiles.device).cuda_stream)
        if key in _counters and bool(_counters[key].any()):
            raise AssertionError(name + ": a per-ray counter was left above "
                                 "zero; later launches on this stream are "
                                 "not to be trusted")
    return out


def row_segments(cid_rows, n):
    """Per-ray candidate rows as a gapped pair list: ray q's segment is the
    first ``n[q]`` slots of row q of ``cid_rows`` ((Q, R) i64), and the rest
    of the row is a gap.  Returns (cid (Q R,), cnt, right) for
    ``pair_ray_reduce``: no pair is moved."""
    Q, R = cid_rows.shape
    cnt = n.to(torch.int64)
    right = torch.arange(0, Q * R, R, device=cnt.device) + cnt
    return cid_rows.reshape(-1).contiguous(), cnt, right
