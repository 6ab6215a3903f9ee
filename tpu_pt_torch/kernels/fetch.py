"""Row fetch from a bf16 table, widened to f32: the cluster descent's child
fetch, and the kernel behind the ported fetch probes (``tools/``).

``fetch_rows(table, idx, clamp=...)`` returns ``table[idx].float()``, shape
``idx.shape + (W,)``; ``fetch_rows_t(table, idx)`` the same rows
field-major, ``(W, P)``; ``fetch_fields(table, cand, fields)`` the first
``fields`` 8-wide words of each clamped row of a (N, 64) table as planes,
``(fields, Q, K * 8)``: the layout the cluster descent's slab test reads
(``bvh/cluster.py::_descend_compact``, whose ``fetch="rows"`` twin is
``fetch_rows`` and a copy a field).  Counterparts of the TPU probes
``tools/microbench_vmem_gather.py::vmem_gather`` and
``tools/microbench_fetch_kernel.py::onehot_fetch`` / ``grouped_fetch``
(the row-major form) and ``::lane_gather_fetch`` (field-major), which
compute this one gather on a VMEM-resident table.  The one-hot forms
multiply by a 0/1 row, so they are exact on finite tables only (0 x inf =
NaN); the descent's tables hold +/-inf in empty child slots, and the
kernel here gathers, exact on every bit pattern.

CUDA tensors go to the kernel (``csrc/fetch_rows.cu``) or raise; CPU
tensors to the plain versions ``fetch_rows_ref`` / ``fetch_rows_t_ref`` /
``fetch_fields_ref``.
Neither takes part in autograd (``_build.refuse_grad``).
"""

from __future__ import annotations

import torch

from tpu_pt_torch.kernels import _build


def _check(name, table, idx):
    _build.refuse_grad(name, table=table, idx=idx)
    if table.dtype != torch.bfloat16 or table.dim() != 2:
        raise TypeError(f"{name}: table must be a 2-D bfloat16 tensor, got "
                        f"{table.dtype} {tuple(table.shape)}")
    if table.shape[0] < 1 or table.shape[1] % 64 != 0 or table.shape[1] < 64:
        raise ValueError(f"{name}: table (N, W) needs N >= 1 and W a "
                         f"multiple of 64, got {tuple(table.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: idx must be int32 or int64, got "
                        f"{idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"{name}: table on {table.device}, idx on "
                         f"{idx.device}")


def fetch_rows_ref(table, idx, *, clamp: bool = False):
    """Plain version of :func:`fetch_rows`: ``table[idx].float()``, with
    ``idx`` clamped into [0, N) first under ``clamp``."""
    _check("fetch_rows", table, idx)
    if clamp:
        idx = torch.clamp(idx, 0, table.shape[0] - 1)
    return table[idx].float()


def fetch_rows(table, idx, *, clamp: bool = False):
    """Rows of ``table`` (N, W) bf16, W a multiple of 64, at ``idx`` (any
    shape, int32 or int64), as f32: ``idx.shape + (W,)``.

    With ``clamp`` every index is clamped into [0, N) (the descent's
    fetch); without it an index must lie in [-N, N) (a negative one counts
    from the end): beyond that the plain version raises, as torch indexing
    does, and the kernel writes a row of NaN without reading outside the
    table.  The index is read in place when its last dimension is
    contiguous and the others fold into one stride (the descent's column
    slice of its compaction buffer); otherwise it is copied once."""
    if table.device.type == "cpu":
        return fetch_rows_ref(table, idx, clamp=clamp)
    _check("fetch_rows", table, idx)
    _build.check_cuda_input("table", table, torch.bfloat16)
    if table.data_ptr() % 16:
        raise ValueError("fetch_rows: table must be 16-byte aligned")
    N, W = table.shape
    out = torch.empty(tuple(idx.shape) + (W,), dtype=torch.float32,
                      device=table.device)
    K = idx.shape[-1] if idx.dim() else 1
    P = idx.numel()
    if P == 0:
        return out
    idx2 = idx.reshape(-1, K)
    if K > 1 and idx2.stride(1) != 1:
        idx2 = idx2.contiguous()
    stride = idx2.stride(0) if idx2.shape[0] > 1 else K
    err = _build.load().fetch_rows_launch(
        table.data_ptr(), idx2.data_ptr(), out.data_ptr(), P, K, stride, N, W,
        int(idx.dtype == torch.int64), int(bool(clamp)),
        torch.cuda.current_stream(table.device).cuda_stream)
    fetch_rows.launches += 1
    if err != 0:
        raise RuntimeError(f"fetch_rows: CUDA launch error {err}")
    return out


def fetch_rows_t_ref(table, idx):
    """Plain version of :func:`fetch_rows_t`."""
    _check("fetch_rows_t", table, idx)
    if idx.dim() != 1:
        raise ValueError(f"fetch_rows_t: idx must be 1-D, got "
                         f"{tuple(idx.shape)}")
    return table[idx].float().t().contiguous()


def fetch_rows_t(table, idx):
    """Field-major :func:`fetch_rows` without clamping: ``idx`` (P,), the
    result (W, P) f32, ``out[f, p] = float(table[idx[p], f])``."""
    if table.device.type == "cpu":
        return fetch_rows_t_ref(table, idx)
    _check("fetch_rows_t", table, idx)
    if idx.dim() != 1:
        raise ValueError(f"fetch_rows_t: idx must be 1-D, got "
                         f"{tuple(idx.shape)}")
    _build.check_cuda_input("table", table, torch.bfloat16)
    if table.data_ptr() % 16:
        raise ValueError("fetch_rows_t: table must be 16-byte aligned")
    N, W = table.shape
    P = idx.shape[0]
    out = torch.empty((W, P), dtype=torch.float32, device=table.device)
    if P == 0:
        return out
    idx = idx.contiguous()
    err = _build.load().fetch_rows_t_launch(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), P, N, W,
        int(idx.dtype == torch.int64),
        torch.cuda.current_stream(table.device).cuda_stream)
    fetch_rows_t.launches += 1
    if err != 0:
        raise RuntimeError(f"fetch_rows_t: CUDA launch error {err}")
    return out


def _check_fields(table, cand, fields):
    _check("fetch_fields", table, cand)
    if table.shape[1] != 64:
        raise ValueError(f"fetch_fields: table must be (N, 64), got "
                         f"{tuple(table.shape)}")
    if cand.dim() != 2:
        raise ValueError(f"fetch_fields: cand must be (Q, K), got "
                         f"{tuple(cand.shape)}")
    if not 1 <= int(fields) <= 8:
        raise ValueError(f"fetch_fields: fields must lie in [1, 8], got "
                         f"{fields}")


def fetch_fields_ref(table, cand, fields: int = 6):
    """Plain version of :func:`fetch_fields`: the clamped row fetch, its
    first ``fields`` words moved to the front as planes."""
    _check_fields(table, cand, fields)
    Q, K = cand.shape
    rows = fetch_rows_ref(table, cand, clamp=True).reshape(Q, K, 8, 8)
    return rows[:, :, :fields].permute(2, 0, 1, 3).reshape(fields, Q, K * 8)


def fetch_fields(table, cand, fields: int = 6):
    """``out[f, q, k * 8 + c] = float(table[clamp(cand[q, k]), f * 8 + c])``
    for ``f < fields``: table (N, 64) bf16, cand (Q, K) int32 or int64
    (clamped into [0, N)), the result (fields, Q, K * 8) f32, so that
    ``out[f]`` is a contiguous plane.  ``cand`` is read in place when its
    last dimension is contiguous (the descent's column slice of its
    compaction buffer); otherwise it is copied once."""
    if table.device.type == "cpu":
        return fetch_fields_ref(table, cand, fields)
    _check_fields(table, cand, fields)
    _build.check_cuda_input("table", table, torch.bfloat16)
    if table.data_ptr() % 16:
        raise ValueError("fetch_fields: table must be 16-byte aligned")
    N = table.shape[0]
    Q, K = cand.shape
    out = torch.empty((int(fields), Q, K * 8), dtype=torch.float32,
                      device=table.device)
    P = Q * K
    if P == 0:
        return out
    if K > 1 and cand.stride(1) != 1:
        cand = cand.contiguous()
    stride = cand.stride(0) if Q > 1 else K
    err = _build.load().fetch_fields_launch(
        table.data_ptr(), cand.data_ptr(), out.data_ptr(), P, K, stride, N,
        int(fields), int(cand.dtype == torch.int64),
        torch.cuda.current_stream(table.device).cuda_stream)
    fetch_fields.launches += 1
    if err != 0:
        raise RuntimeError(f"fetch_fields: CUDA launch error {err}")
    return out


fetch_rows.launches = 0     # kernel launches made by this process
fetch_rows_t.launches = 0
fetch_fields.launches = 0
