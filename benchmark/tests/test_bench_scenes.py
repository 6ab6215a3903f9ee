"""The benchmark's scenes are the port's built-ins: ``scenes.py`` makes
``meshes.big_scene`` and ``meshes.atrium_scene`` again (with a vectorised
icosphere), and each configuration's materials and camera are the
built-in's.  Held array for array, bit for bit, at small sizes."""

from __future__ import annotations

import sys

import numpy as np
import pytest
from conftest import BENCH, ROOT, _load

sys.path[:0] = [p for p in (ROOT, BENCH) if p not in sys.path]

import program  # noqa: E402
import scenes  # noqa: E402
from tpu_pt_torch.scene import meshes  # noqa: E402


def _fields(nt):
    """{path: array} of a NamedTuple of arrays, nested ones flattened."""
    out = {}
    for k, v in nt._asdict().items():
        if hasattr(v, "_asdict"):
            out.update({f"{k}.{kk}": vv for kk, vv in _fields(v).items()})
        else:
            out[k] = np.asarray(v)
    return out


def _equal(ours, theirs):
    a, b = _fields(ours), _fields(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("config,geometry,port", [
    ("big-1m", {"subdiv": 2}, lambda: meshes.big_scene(subdiv=2)),
    ("big-1m", {"subdiv": 3}, lambda: meshes.big_scene(subdiv=3)),
    ("atrium", {"col_rad": 8, "col_ny": 6},
     lambda: meshes.atrium_scene(col_rad=8, col_ny=6)),
    ("atrium", {"col_rad": 12, "col_ny": 10},
     lambda: meshes.atrium_scene(col_rad=12, col_ny=10)),
])
def test_scene_equals_the_ports_built_in(config, geometry, port):
    cfg = _load(BENCH, "configs", config + ".json")
    cfg["geometry"].update(geometry)
    geo, _ = scenes.make(cfg)
    _equal(program.host_scene(geo, cfg["materials"]), port())


@pytest.mark.parametrize("config,port", [("big-1m", meshes.big_camera),
                                         ("atrium", meshes.atrium_camera)])
def test_camera_equals_the_ports_built_in(config, port):
    cfg = _load(BENCH, "configs", config + ".json")
    _, cam = scenes.make(cfg)
    r = cfg["render"]
    _equal(program.camera(cam), port(r["width"], r["height"]))
