"""Chained same-shape gathers on the card: the counterpart of the JAX
package's ``tools/microbench_dyngather.py`` (the probe of Mosaic's
``tpu.dynamic_gather``).

    python -m tpu_pt_torch.tools.microbench_dyngather
    python -m tpu_pt_torch.tools.microbench_dyngather --device cpu

Runs the JAX tool's matrices through the kernel ``take_along``: its
feasibility cases (one gather, dims 0 and 1, (8, 128) to (2048, 128)
f32), its cost cases (16 chained gathers), and its bf16 and int32 cases.
Inputs: x standard normal, cast to the case's type (int32 truncates, as
JAX's astype does), and int32 indices uniform over the gathered axis,
seeded with numpy.  Each case is checked bit for bit against the plain
version (``torch.gather`` ``reps`` times) and prints one JSON line: the
kernel's form (``lines``: every rep in shared memory, whole lines a block;
``passes``: a launch a rep), its time and torch's per gather, and ns an
element.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_pt_torch.kernels.take_along import (
    take_along, take_along_form, take_along_ref)
from tpu_pt_torch.tools import _probe

FEASIBILITY = ((8, 128), (8, 512), (64, 128), (256, 128), (256, 512),
               (256, 2048), (2048, 128))
COST = ((8, 512), (256, 128), (256, 512), (256, 2048), (2048, 128))
# (dim, M, N, reps, dtype) of every case, in the JAX tool's order.
CASES = tuple((dim, M, N, 1, torch.float32) for dim in (0, 1)
              for M, N in FEASIBILITY) \
    + tuple((dim, M, N, 16, torch.float32) for dim in (0, 1)
            for M, N in COST) \
    + ((0, 256, 128, 16, torch.bfloat16), (1, 256, 512, 16, torch.bfloat16),
       (1, 256, 512, 16, torch.int32))


def inputs(dim, M, N, dtype, seed, device):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.normal(size=(M, N)).astype(np.float32)).to(dtype)
    idx = rs.randint(0, M if dim == 0 else N, (M, N)).astype(np.int32)
    return x.to(device), torch.from_numpy(idx).to(device)


def run_case(device, dim, M, N, reps, dtype, seed):
    x, idx = inputs(dim, M, N, dtype, seed, device)
    exact = _probe.bitwise_equal(take_along(x, idx, dim, reps),
                                 take_along_ref(x, idx, dim, reps))
    ix = idx.long()

    def torch_fn():
        y = x
        for _ in range(reps):
            y = torch.gather(y, dim, ix)
        return y

    nbytes = M * N * (2 * x.element_size() + 4)
    t = _probe.times(device, lambda: take_along(x, idx, dim, reps), torch_fn,
                     nbytes)
    line = {"tool": "microbench_dyngather", "dim": dim, "M": M, "N": N,
            "dtype": str(dtype).replace("torch.", ""), "reps": reps,
            "form": take_along_form(M, N, dim),
            "device": _probe.device_name(device), "exact": exact, **t}
    if t["timed"]:
        line["kernel_us_per_gather"] = t["kernel_ms"] * 1e3 / reps
        line["torch_us_per_gather"] = t["torch_ms"] * 1e3 / reps
        line["kernel_ns_per_el"] = t["kernel_ms"] * 1e6 / reps / (M * N)
    _probe.emit(line)
    assert exact, f"take_along dim {dim} ({M}, {N}) {dtype} x{reps}: " \
                  "kernel and plain version differ"
    return line


def main(argv=None):
    """Runs every case; returns their lines."""
    args = _probe.parser(__doc__).parse_args(argv)
    device = _probe.device_of(args)
    return [run_case(device, *case, args.seed) for case in CASES]


if __name__ == "__main__":
    main(sys.argv[1:])
