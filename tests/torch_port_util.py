"""Helpers shared by the tests/test_torch_*.py parity tests: flatten the JAX
package's containers into plain dicts of numpy arrays (the input format of
``tpu_pt_torch.convert``) and make seeded numpy inputs for both packages.

Imported by every test_torch_*.py file: under pytest-xdist it gives each
worker process its share of the cores for torch's intra-op threads, so that
N workers do not each start one thread per core."""

import os

import numpy as np
import torch

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(
        1, (os.cpu_count() or 1) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def T(x):
    """Array -> CPU tensor (dtype kept; a copy, so read-only buffers of the
    other framework are never aliased)."""
    return torch.from_numpy(np.array(x, order="C"))


def scene_dict(scene) -> dict:
    d = {f: np.asarray(getattr(scene, f)) for f in scene._fields
         if f not in ("materials", "lights")}
    d["materials"] = {f: np.asarray(getattr(scene.materials, f))
                      for f in scene.materials._fields}
    d["lights"] = {f: np.asarray(getattr(scene.lights, f))
                   for f in scene.lights._fields}
    return d


def bvh_dict(cb) -> dict:
    return dict(
        levels=[np.asarray(lv) for lv in cb.levels],
        tiles=np.asarray(cb.tiles), tile_gid=np.asarray(cb.tile_gid),
        frontiers=cb.frontiers, k_leaf=cb.k_leaf, pair_budget=cb.pair_budget,
        pair_mults=cb.pair_mults,
        levels16=[np.asarray(lv).view(np.uint16) for lv in cb.levels16])


def camera_dict(cam) -> dict:
    return {f: np.asarray(getattr(cam, f)) for f in cam._fields}


def rays(n: int, seed: int):
    """Random origins in [-3, 3)^3 and unit directions, float32 numpy."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def assert_tree_equal(a, b):
    """Field-by-field array equality of two (nested) NamedTuples; ``b`` may
    hold numpy arrays or tensors."""
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if hasattr(x, "_fields"):
            assert_tree_equal(x, y)
        else:
            y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
            x = np.asarray(x)
            assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f)


def chunks_seen(monkeypatch, inputs=None):
    """Spy on the differentiable loop's checkpoint
    (``tpu_pt_torch.render.wavefront.checkpoint``): the list of every chunk
    it is given, in order (each a ``_Chunk``: ``n`` steps run, ``replays``
    recomputations, ``records``), while ``monkeypatch`` holds; each call's
    inputs are appended to ``inputs`` where a list is given."""
    from tpu_pt_torch.render import wavefront

    seen = []
    real = wavefront.checkpoint

    def spy(fn, *a, **kw):
        seen.append(fn)
        if inputs is not None:
            inputs.append(a)
        return real(fn, *a, **kw)

    monkeypatch.setattr(wavefront, "checkpoint", spy)
    return seen
