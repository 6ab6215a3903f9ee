"""Per-ray segmented (t, gid)-min over a ray-sorted pair list: the reduce
stage of the cluster-BVH pair traversal.

The compact traversal tests one flat ray-major pair list per batch; ray q's
pairs occupy ``[right[q] - cnt[q], right[q])``.  Per ray the reduce returns
the pair with the lowest t, ties broken by the LOWEST gid.  The combine is
``later wins iff t_b < t_a or (t_b == t_a and gid_b < gid_a)``: selection
only, no float arithmetic, so every evaluation order gives the same bits.

``pair_segmin`` launches the hand-written CUDA kernel
(``csrc/pair_segmin.cu``, which replaces the Pallas kernel
``tpu_pt/kernels/pair_scan.py::pair_segmin_scan``) for CUDA tensors and
runs ``pair_segmin_ref`` for CPU tensors.  The Pallas kernel produces the
whole inclusive segmented scan and its callers read one column per ray (the
segment end, ``right - 1``); this function returns exactly those columns.
gid is int32 here (the scan carried it in f32).

NaN: a NaN t that HEADS a segment is kept (no later element compares below
it), as in the scan; a NaN elsewhere never wins against an earlier
aggregate, and where it meets later elements the result depends on the
evaluation order.  The traversal masks every miss to INF before the
reduce, so NaN does not occur on the rendering path.
"""

from __future__ import annotations

import torch

from tpu_pt_torch.core.intersect import INF
from tpu_pt_torch.kernels import _build


def _check_shapes(t, gid, u, v, cnt, right):
    _build.refuse_grad("pair_segmin", t=t, gid=gid, u=u, v=v, cnt=cnt,
                       right=right)
    P = t.shape[0]
    for name, x in (("t", t), ("gid", gid), ("u", u), ("v", v)):
        if tuple(x.shape) != (P,):
            raise ValueError(f"{name}: expected ({P},), got {tuple(x.shape)}")
    if cnt.dim() != 1 or right.shape != cnt.shape:
        raise ValueError("cnt/right: expected two (Q,) tensors")


def pair_segmin_ref(t, gid, u, v, cnt, right):
    """Plain PyTorch version of :func:`pair_segmin`: a left fold over the
    position inside the segment, all rays at once (reads ``cnt.max()``)."""
    _check_shapes(t, gid, u, v, cnt, right)
    P = t.shape[0]
    cnt = cnt.long()
    start = right.long() - cnt
    has = cnt > 0
    if P == 0 or cnt.numel() == 0:
        z = torch.zeros(cnt.shape, dtype=t.dtype, device=t.device)
        return z + INF, z.to(torch.int32), z, z.clone()
    head = start.clamp(0, P - 1)
    bt, bg, bu, bv = t[head], gid[head], u[head], v[head]
    for j in range(1, int(cnt.max())):
        valid = cnt > j
        p = (start + j).clamp(0, P - 1)
        tb, gb = t[p], gid[p]
        take = valid & ((tb < bt) | ((tb == bt) & (gb < bg)))
        bt = torch.where(take, tb, bt)
        bg = torch.where(take, gb, bg)
        bu = torch.where(take, u[p], bu)
        bv = torch.where(take, v[p], bv)
    zero = torch.zeros_like(bt)
    return (torch.where(has, bt, torch.full_like(bt, INF)),
            torch.where(has, bg, torch.zeros_like(bg)),
            torch.where(has, bu, zero), torch.where(has, bv, zero))


def pair_segmin(t, gid, u, v, cnt, right):
    """t, u, v: (P,) f32; gid: (P,) i32; cnt, right: (Q,) i32 with ray q's
    pairs at ``[right[q] - cnt[q], right[q])`` inside [0, P].  Returns
    per-ray (t (Q,) f32, gid (Q,) i32, u, v) of the lexicographic (t, gid)
    minimum; (INF, 0, 0, 0) where ``cnt == 0``.

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    if not t.is_cuda:
        return pair_segmin_ref(t, gid, u, v, cnt, right)
    _check_shapes(t, gid, u, v, cnt, right)
    P, Q = t.shape[0], cnt.shape[0]
    for name, x, dt, n in (("t", t, torch.float32, P),
                           ("gid", gid, torch.int32, P),
                           ("u", u, torch.float32, P),
                           ("v", v, torch.float32, P),
                           ("cnt", cnt, torch.int32, Q),
                           ("right", right, torch.int32, Q)):
        _build.check_cuda_input(name, x, dt, (n,))
        if x.device != t.device:
            raise ValueError("pair_segmin: tensors on different devices")
    out_t = torch.empty((Q,), dtype=torch.float32, device=t.device)
    out_g = torch.empty((Q,), dtype=torch.int32, device=t.device)
    out_u = torch.empty_like(out_t)
    out_v = torch.empty_like(out_t)
    if Q == 0:
        return out_t, out_g, out_u, out_v
    lib = _build.load()
    err = lib.pair_segmin_launch(
        t.data_ptr(), gid.data_ptr(), u.data_ptr(), v.data_ptr(),
        cnt.data_ptr(), right.data_ptr(), out_t.data_ptr(), out_g.data_ptr(),
        out_u.data_ptr(), out_v.data_ptr(), Q,
        torch.cuda.current_stream(t.device).cuda_stream)
    pair_segmin.launches += 1
    if err != 0:
        raise RuntimeError(f"pair_segmin: CUDA launch error {err}")
    return out_t, out_g, out_u, out_v


pair_segmin.launches = 0   # kernel launches made by this process
