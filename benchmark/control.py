#!/usr/bin/env python3
"""The control of a cell's output check, and its planted faults, at the
cell's own size: the numbers that set the upper end of each limit.

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13

The control is the reference put in the program's place and computed in
bfloat16, the precision below the configuration's float32, judged by the
cell's own comparison against the float32 reference.  For a gradient cell
the planted fault "half of the batch left out" (the reference's loss taken
over every other pixel) is read too.  One JSON line a seed and reading.
The benchmark's own runs never run this; the limits in each workload file
were set from its readings and the program's (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def render_numbers(cell, seed, device):
    import torch

    import checks
    import program
    import scenes
    from reference import pathtracer as ref

    geo, cam = scenes.make(cell.config)
    out = {}
    imgs = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        t = time.perf_counter()
        sc = ref.make_scene(geo, cell.config["materials"], device, dt)
        acc = ref.Accel(sc.vertices, sc.tri_idx)
        r = ref.render_image(sc, acc, ref.make_camera(cam, device, dt),
                             cell.config["render"], program.key(seed, 0))
        imgs[name] = r
        out[f"{name}_s"] = time.perf_counter() - t
        del sc, acc
    a, b = imgs["bfloat16"], imgs["float32"]
    out["control"] = {**checks.image_numbers(a.radiance.float().cpu(),
                                             b.radiance.cpu()),
                      **checks.count_numbers(a.n_closest, a.n_shadow,
                                             b.n_closest, b.n_shadow)}
    out["reference_counts"] = [b.n_closest, b.n_shadow]
    return out


def grad_numbers(cell, seed, device):
    import torch

    import checks
    import scenes

    entry = cell.entry().Entry(cell, seed, device)
    entry.geo, entry.cam = scenes.make(cell.config)
    entry.inputs()
    entry.start = {k: v.cpu() for k, v in entry.start.items()}
    out = {}
    t = time.perf_counter()
    base = entry.reference()
    out["float32_s"] = time.perf_counter() - t
    t = time.perf_counter()
    low = entry.reference(dtype=torch.bfloat16)
    out["bfloat16_s"] = time.perf_counter() - t
    out["control"] = checks.training_numbers(low, base)
    n = entry.target.shape[0]
    keep = torch.arange(n, device=device) % 2 == 0
    out["half_batch"] = checks.training_numbers(entry.reference(keep=keep),
                                                base)
    out["loss"] = base["loss"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    import run

    run.set_caches()
    cell = run.Cell(args.workload)
    fn = grad_numbers if cell.traffic["entry"] == "grad" else render_numbers
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **fn(cell, seed, args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
