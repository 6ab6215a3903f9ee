"""A small copy of the benchmark for the CPU tests: every cell file under
``benchmark/workloads`` (those of ``BENCHMARK.json``, and
``big1m-render``, kept for a later cell) again as ``t-<cell>``, on a
configuration cut to a few hundred triangles and 24 x 16 pixels, with the
cell's own traffic and limits."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SMALL = {"big-1m": {"geometry": {"subdiv": 2}},
         "big-1m-tuned": {"geometry": {"subdiv": 2}, "bvh": {"queue": 512}},
         "atrium": {"geometry": {"col_rad": 8, "col_ny": 6},
                    "bvh": {"queue": 512}}}


def _load(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def _dump(obj, *parts):
    with open(os.path.join(*parts), "w") as f:
        json.dump(obj, f, indent=1)


def make_copy(dst: str) -> str:
    """A copy of the benchmark under ``dst`` with the small cells added;
    returns the path of its ``BENCHMARK.json``."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = _load(ROOT, "BENCHMARK.json")
    b = os.path.join(dst, "benchmark")
    for name, cut in SMALL.items():
        c = _load(b, "configs", name + ".json")
        for k, v in cut.items():
            c[k].update(v)
        c["render"].update(width=24, height=16)
        _dump(c, b, "configs", "t-" + name + ".json")
    for f in sorted(os.listdir(os.path.join(b, "workloads"))):
        cell = _load(b, "workloads", f)
        cell["config"] = "t-" + cell["config"]
        _dump(cell, b, "workloads", "t-" + f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + ["t-" + x for x in m["workloads"]]
    path = os.path.join(dst, "BENCHMARK.json")
    _dump(bench, path)
    return path


@pytest.fixture(scope="session")
def small(tmp_path_factory):
    """(benchmark directory of the copy, its BENCHMARK.json, the run
    module)."""
    dst = str(tmp_path_factory.mktemp("bench"))
    path = make_copy(dst)
    bdir = os.path.join(dst, "benchmark")
    for p in (ROOT, bdir):
        if p not in sys.path:
            sys.path.insert(0, p)
    import run

    return bdir, path, run


def run_small(small, cell: str, seed: int = 12345, seconds: float = 0.5,
              trace: bool = False):
    bdir, path, run = small
    return run.run_cell(run.Cell(cell, bench_dir=bdir), seed, seconds, trace,
                        device="cpu", bench_path=path)
