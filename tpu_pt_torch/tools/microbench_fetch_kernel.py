"""The fetch forms of the fused-descent probe on the card: the counterpart
of the JAX package's ``tools/microbench_fetch_kernel.py``.

    python -m tpu_pt_torch.tools.microbench_fetch_kernel
    python -m tpu_pt_torch.tools.microbench_fetch_kernel --device cpu \\
        --rays 64                          # the checks only, at a small size

The JAX tool races three in-kernel forms of one gather, row ``idx[p]`` of
a bf16 child table as f32, against XLA's row gather: A, a one-hot matmul
(``onehot_fetch``); B, the field-major form, (64, P) out
(``lane_gather_fetch``); C, the one-hot form on 512-wide rows of 8 sibling
rows (``grouped_fetch``).  On the card each is the kernel of
``kernels/fetch.py``: A and C are ``fetch_rows`` (W = 64 and 512), B is
``fetch_rows_t``; the one-hot product is left out, since it does W x N
multiply-adds to move a row a gather moves with none, and is exact on
finite tables only.  Shapes are the JAX tool's: A and B at P = Q x 34 rows
from N = 233 and P = Q x 59 from N = 1,864 (P a multiple of 512, as
both JAX forms take it), C at
P = Q x 34 grouped rows (a multiple of 128) of the (233, 512) grouped form
of an (1,864, 64) table; Q = 4,096, int32 indices, standard normal tables
rounded to bf16, seeded with numpy.  Each case is checked bit for bit
against the plain version and prints one JSON line, with torch's gather +
cast (and transpose, for B) beside it.
"""

from __future__ import annotations

import sys

import numpy as np

from tpu_pt_torch.kernels.fetch import (
    fetch_rows, fetch_rows_ref, fetch_rows_t, fetch_rows_t_ref)
from tpu_pt_torch.tools import _probe

B = 256     # rows a grid step of the one-hot form
L = 512     # lanes a grid step of the field-major form
BC = 128    # grouped rows a grid step
SHAPES = (("L1", 34, 233), ("L2", 59, 1864))


def run_case(device, case, form, table, idx):
    N, W = table.shape
    if form == "fetch_rows_t":
        kern, ref = fetch_rows_t, fetch_rows_t_ref
    else:
        kern, ref = fetch_rows, fetch_rows_ref
    exact = _probe.bitwise_equal(kern(table, idx), ref(table, idx))
    plain = (lambda: table[idx].float().t().contiguous()) \
        if form == "fetch_rows_t" else (lambda: table[idx].float())
    line = {"tool": "microbench_fetch_kernel", "case": case, "form": form,
            "device": _probe.device_name(device), "P": idx.numel(), "N": N,
            "W": W, "exact": exact,
            **_probe.times(device, lambda: kern(table, idx), plain,
                           _probe.fetch_bytes(idx, N, W))}
    _probe.emit(line)
    assert exact, f"{form} {case}: kernel and plain version differ"
    return line


def main(argv=None):
    """Runs every case; returns their lines."""
    ap = _probe.parser(__doc__)
    ap.add_argument("--rays", type=int, default=4096,
                    help="Q of the shapes (P = Q x rows a ray)")
    args = ap.parse_args(argv)
    device = _probe.device_of(args)
    lines = []
    for case, per_ray, N in SHAPES:
        rs = np.random.RandomState(args.seed)
        table = _probe.bf16_table(rs, N, 64, device)
        idx = _probe.index(rs, N, (max(L, args.rays * per_ray // L * L),),
                           device)
        for form in ("fetch_rows", "fetch_rows_t"):
            lines.append(run_case(device, case, form, table, idx))
    rs = np.random.RandomState(args.seed + 1)
    N = 1864
    grouped = _probe.bf16_table(rs, N, 64, device).reshape(N // 8, 512)
    idx = _probe.index(rs, N // 8, (max(BC, args.rays * 34 // BC * BC),),
                       device)
    lines.append(run_case(device, "grouped", "fetch_rows", grouped, idx))
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
