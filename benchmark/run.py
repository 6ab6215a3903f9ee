#!/usr/bin/env python3
"""The benchmark of ``tpu_pt_torch`` on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is ``benchmark/workloads/<cell>.json``: it names its configuration
(``benchmark/configs/<config>.json``) and its traffic
(``benchmark/traffic/<traffic>.json``: the entry it drives,
``benchmark/entries/<entry>.py``, and that entry's parameters), and holds
the limits of its output check.  The run makes the cell's inputs from the seed, sets
the program up and warms up the shapes the cell uses (``setup_s``), then
calls the entry back to back, one client waiting on each call, until
``--seconds`` have passed.  ``--trace 1`` is a run of its own: the
window's first call runs under ``torch.profiler``.  After the window the
run reads the metrics that ``BENCHMARK.json`` gives the cell, each through
``benchmark/metrics/<name>.py``, checks the window's outputs against the
plain reference (``benchmark/reference/``), prints each number compared
beside its limit on standard error and, as the last line of standard
output, one JSON object.

It exits with 2 and prints no result where there is no CUDA device (or
fewer than the cell asks for), and with 3 where a module of JAX or of the
JAX package is loaded once the window has closed and the output has been
checked.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_pt")


def set_caches() -> None:
    """Every compile cache at a fixed path inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's workload file, its configuration and its entry, found by
    name under ``bench_dir``."""

    def __init__(self, name: str, bench_dir: str = HERE):
        self.name = name
        self.dir = bench_dir
        self.workload = load_json(bench_dir, "workloads", name + ".json")
        self.config = load_json(bench_dir, "configs",
                                self.workload["config"] + ".json")
        self.traffic = load_json(bench_dir, "traffic",
                                 self.workload["traffic"] + ".json")
        self.entry_path = os.path.join(bench_dir, "entries",
                                       self.traffic["entry"] + ".py")

    def entry(self):
        if HERE not in sys.path:
            sys.path.insert(0, HERE)
        return load_module(self.entry_path,
                           "bench_entry_" + self.traffic["entry"])


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries of ``BENCHMARK.json`` that ``cell`` reports: with
    ``trace`` the per-layer ones, else the end-to-end ones.  A metric
    without a ``workloads`` key goes to every cell (a per-layer one, to
    every cell that reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def read_metrics(entries: list, run, bench_dir: str = HERE) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read."""
    out = {}
    if os.path.join(bench_dir, "metrics") not in sys.path:
        sys.path.insert(0, os.path.join(bench_dir, "metrics"))
    for m in entries:
        mod = load_module(os.path.join(bench_dir, "metrics",
                                       m["name"] + ".py"),
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self):
        self.setup_s = None        # process start to the first timed call
        self.spans = {}            # set-up spans, seconds
        self.records = []          # one dict per call of the window
        self.window_s = None
        self.window_peak_bytes = None
        self.trace = None          # trace.Trace of the traced call
        self.traced_records = []


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench_path: str | None = None):
    """Set up, measure, check: (result dict, checks).  ``device="cpu"``
    runs the same steps on the host (the tests' small cells); it reports
    no device numbers."""
    import torch

    if HERE not in sys.path:
        sys.path.insert(0, HERE)
    from tracing import from_profile

    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    entry = cell.entry().Entry(cell, seed, device)
    run = Run()
    on_card = device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    imports_s = time.perf_counter() - T_START
    run.spans = entry.setup()
    run.spans["imports_s"] = imports_s
    sync()
    run.setup_s = time.perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    min_calls = int(cell.workload.get("min_calls", 1))
    prof = None
    t0 = time.perf_counter()
    i = 0
    while True:
        if i == 0 and trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            sync()
            prof.__enter__()
            m0 = time.time_ns()
        tc = time.perf_counter()
        rec = entry.call(i, traced=trace)
        rec["call_s"] = time.perf_counter() - tc
        run.records.append(rec)
        i += 1
        if prof is not None:
            sync()
            m1 = time.time_ns()
            prof.__exit__(None, None, None)
            traced, prof = prof, None
            run.traced_records = list(run.records)
        if time.perf_counter() - t0 >= seconds and i >= min_calls:
            break
    sync()
    run.window_s = time.perf_counter() - t0
    if trace:
        # Read after the window: reading the events takes seconds.
        run.trace = from_profile(traced, m0, m1)
    run.window_peak_bytes = (torch.cuda.max_memory_allocated()
                             if on_card else 0)
    metrics = read_metrics(metrics_for(bench, cell.name, trace), run,
                           cell.dir)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(max(setup_peak,
                                                run.window_peak_bytes))}
    breakdown = None
    if trace and run.trace is not None:
        import tracing as tr

        device_info["busy_s"] = tr.busy_us(run.trace) / 1e6
        device_info["window_s"] = tr.window_us(run.trace) / 1e6
        breakdown = {"device_ops": tr.top_device_ops(run.trace),
                     "idle_gaps": tr.idle_gaps(run.trace)}
    entry.release()
    t_check = time.perf_counter()
    checks = entry.check()
    print(json.dumps({"spans": run.spans, "setup_s": run.setup_s,
                      "window_s": run.window_s, "calls": run.records,
                      "check_s": time.perf_counter() - t_check}),
          file=sys.stderr)
    # After everything the run loads: the readers, the check, the reference.
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        sys.exit(3)
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    failed = sum(1 for r in run.records if r.get("failed"))
    result = {"correct": bool(correct and failed == 0),
              "attempted": len(run.records), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    sys.path.insert(0, ROOT)
    cell = Cell(args.workload)
    import torch

    chips = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace))
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
