"""Chained same-shape gathers: ``reps`` times ``x = gather(x, dim, idx)``
on an (M, N) array.

Counterpart of the kernel of ``tools/microbench_dyngather.py::run_case``,
the TPU probe of Mosaic's same-shape dynamic gather (``jnp.take_along_axis``
applied ``reps`` times inside one ``pl.pallas_call``).  CUDA tensors go to
the kernel (``csrc/take_along.cu``) or raise; CPU tensors to the plain
version ``take_along_ref``, ``torch.gather`` ``reps`` times.

The kernel has two forms, chosen from the shape (``take_along_form``).
A gather never leaves its line (a row for dim 1, a column for dim 0), so
where a line holds at most ``MAX_LINE`` elements, ``"lines"`` gives each
block whole lines (``lines_per_block``) and runs every rep in its shared
memory, one launch in all; otherwise ``"passes"`` runs one launch a rep
over device memory.
"""

from __future__ import annotations

import torch

from tpu_pt_torch.kernels import _build

DTYPES = (torch.float32, torch.bfloat16, torch.int32)
MAX_LINE = 256 * 16     # csrc/take_along.cu: threads x elements a block


def lines_per_block(M: int, N: int, dim: int) -> int:
    """Whole lines a block takes in the lines form (about 1,024 elements),
    0 where a line is too long for it."""
    line = N if dim == 1 else M
    return 0 if line > MAX_LINE else max(1, 1024 // line)


def take_along_form(M: int, N: int, dim: int) -> str:
    """The form of the kernel that an (M, N) array gathered along ``dim``
    runs."""
    return "lines" if lines_per_block(M, N, dim) else "passes"


def _check(x, idx, dim, reps):
    _build.refuse_grad("take_along", x=x, idx=idx)
    if x.dtype not in DTYPES or x.dim() != 2:
        raise TypeError(f"take_along: x must be a 2-D float32, bfloat16 or "
                        f"int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != tuple(x.shape):
        raise TypeError(f"take_along: idx must be int32 of x's shape "
                        f"{tuple(x.shape)}, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if idx.device != x.device:
        raise ValueError(f"take_along: x on {x.device}, idx on {idx.device}")
    if dim not in (0, 1) or reps < 1:
        raise ValueError(f"take_along: needs dim 0 or 1 and reps >= 1, got "
                         f"dim {dim}, reps {reps}")


def take_along_ref(x, idx, dim: int, reps: int):
    """Plain version of :func:`take_along`: ``torch.gather`` ``reps``
    times (it raises on an index out of range)."""
    _check(x, idx, dim, reps)
    ix = idx.long()
    for _ in range(reps):
        x = torch.gather(x, dim, ix)
    return x


def take_along(x, idx, dim: int, reps: int):
    """x (M, N) float32, bfloat16 or int32; idx (M, N) int32.  Returns x
    after ``reps`` gathers along ``dim``: dim 0 ``x[s, l] <- x[idx[s, l],
    l]``, dim 1 ``x[s, l] <- x[s, idx[s, l]]``.  An index must lie in
    [0, size of dim): the plain version raises beyond it, the kernel writes
    a zero element there without reading outside x."""
    if x.device.type == "cpu":
        return take_along_ref(x, idx, dim, reps)
    _check(x, idx, dim, reps)
    _build.check_cuda_input("x", x, x.dtype)
    _build.check_cuda_input("idx", idx, torch.int32)
    M, N = x.shape
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lines = lines_per_block(M, N, dim)
    scratch = torch.empty_like(x) if not lines and reps > 1 else None
    err = _build.load().take_along_launch(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), M, N, int(dim),
        int(reps), x.element_size(), lines,
        torch.cuda.current_stream(x.device).cuda_stream)
    take_along.launches += 1 if lines else reps
    if err != 0:
        raise RuntimeError(f"take_along: CUDA launch error {err}")
    return out


take_along.launches = 0     # kernel launches made by this process
