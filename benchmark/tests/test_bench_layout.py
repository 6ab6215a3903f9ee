"""The benchmark's layout: every part found by name, a new cell and a new
metric added as files alone, the names and units of BENCHMARK.json, and
no module of JAX or of the JAX package loaded."""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT, _dump, _load, run_small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def bench():
    return _load(ROOT, "BENCHMARK.json")


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == TOP
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b).encode()) <= 64 * 1024


def test_every_part_resolves_by_name():
    sys.path.insert(0, BENCH)
    import run

    b = bench()
    for w in b["workloads"]:
        cell = run.Cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.workload["chips"] == w["chips"]
        assert os.path.exists(cell.entry_path)
        assert hasattr(cell.entry(), "Entry")
        assert set(cell.workload["limits"])
        for trace in (False, True):
            for m in run.metrics_for(b, w["name"], trace):
                path = os.path.join(BENCH, "metrics", m["name"] + ".py")
                assert os.path.exists(path), path
        reported = {m["moves"] for m in run.metrics_for(b, w["name"], True)}
        assert len(run.metrics_for(b, w["name"], False)) >= 2
        assert reported, w["name"]


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_cell_and_metric_are_files_alone(small):
    bdir, path, run = small
    before = _digest(bdir)
    # A throwaway cell (a traffic and a cell file) and a metric (a reader).
    t = _load(bdir, "traffic", "images-q32768.json")
    t["queue"] = 128
    _dump(t, bdir, "traffic", "images-q128.json")
    w = _load(bdir, "workloads", "t-big1m-render.json")
    w["traffic"] = "images-q128"
    _dump(w, bdir, "workloads", "t-extra.json")
    with open(os.path.join(bdir, "metrics", "calls_done.py"), "w") as f:
        f.write("def read(run):\n    return len(run.records)\n")
    b = _load(path)
    b["workloads"].append({"name": "t-extra", "config": "t-big-1m",
                           "traffic": "images-q128", "chips": 1,
                           "why": "a throwaway cell"})
    b["end_to_end"].append({"name": "calls_done", "unit": "calls",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": ["t-extra"]})
    for m in b["end_to_end"]:
        if "t-big1m-tuned-render" in m.get("workloads", []):
            m["workloads"].append("t-extra")
    _dump(b, path)
    after = _digest(bdir)
    assert all(after[k] == v for k, v in before.items())
    res, _ = run_small(small, "t-extra")
    assert res["correct"]
    assert res["metrics"]["calls_done"]["value"] >= 1
    assert "rays_per_s" in res["metrics"]


@pytest.mark.parametrize("cell", ["t-big1m-render", "t-big1m-tuned-render",
                                  "t-big1m-grad", "t-atrium-render"])
def test_reference_matches_the_port(small, cell):
    res, checks = run_small(small, cell)
    assert res["correct"], checks
    for c in checks.values():
        assert c["value"] <= c["limit"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_no_jax_is_loaded(small, tmp_path):
    """A run, its check and the control in a fresh process, then the
    top-level names of every loaded module (compared whole)."""
    bdir, path, _ = small
    code = f"""
import sys, json
sys.path[:0] = [{ROOT!r}, {bdir!r}]
import run, control
cell = run.Cell("t-big1m-grad", bench_dir={bdir!r})
run.run_cell(cell, 7, 0.1, True, device="cpu", bench_path={path!r})
control.render_numbers(run.Cell("t-big1m-render", bench_dir={bdir!r}), 7, "cpu")
import importlib.util
for f in ("tracing", "checks", "program", "scenes"):
    __import__(f)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "tpu_pt"}
    assert "tpu_pt_torch" in top


def test_reference_imports_nothing_of_the_program():
    src = os.path.join(BENCH, "reference")
    for f in os.listdir(src):
        if f.endswith(".py"):
            with open(os.path.join(src, f)) as fh:
                text = fh.read()
            assert not re.search(r"^\s*(from|import)\s+(tpu_pt|jax)",
                                 text, re.M), f


def test_no_card_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints nothing
    on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "big1m-tuned-render", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
