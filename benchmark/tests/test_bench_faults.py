"""The output check catches a broken timed path: each fault a cell can
have, planted under the harness in the port, makes ``correct`` false
(the rest of the run as on the card: set-up, window, metrics, check); and
the control, the reference in bfloat16 in the program's place, fails the
limits too."""

from __future__ import annotations

import pytest
import torch
from conftest import run_small

from tpu_pt_torch.diff import adjoint
from tpu_pt_torch.render import wavefront


def _altered(fn, how):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        return (how(out[0]), *out[1:])
    return wrapped


def _answer_altered(img):
    return img * (1.0 + 1e-3) + 1e-4


def _half_left_out(img):
    flat = img.reshape(-1, 3).clone()
    flat[1::2] = 0.0
    return flat.reshape(img.shape)


@pytest.mark.parametrize("fault", [_answer_altered, _half_left_out])
@pytest.mark.parametrize("cell,fn", [
    ("t-big1m-render", "render_wavefront_counts"),
    ("t-big1m-tuned-render", "render_wavefront_suspect_counts"),
    ("t-atrium-render", "render_wavefront_suspect_counts")])
def test_render_fault_is_not_correct(small, monkeypatch, cell, fn, fault):
    monkeypatch.setattr(wavefront, fn,
                        _altered(getattr(wavefront, fn), fault))
    res, checks = run_small(small, cell)
    assert not res["correct"], checks


def _state_unchanged(loss, img, target):
    return loss.detach().requires_grad_(True)


def _half_batch(loss, img, target):
    return torch.mean((img[::2] - target[::2]) ** 2)


def _loss_altered(loss, img, target):
    return loss * (1.0 + 1e-2)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _loss_altered])
def test_grad_fault_is_not_correct(small, monkeypatch, fault):
    real = adjoint.wavefront_loss

    def broken(params, scene, cam, cfg, key, target, *a, **kw):
        loss, img, counts, done = real(params, scene, cam, cfg, key, target,
                                       *a, **kw)
        return fault(loss, img, target), img, counts, done

    monkeypatch.setattr(adjoint, "wavefront_loss", broken)
    res, checks = run_small(small, "t-big1m-grad", seconds=0.1)
    assert not res["correct"], checks


@pytest.mark.parametrize("cell", ["t-big1m-render", "t-big1m-tuned-render",
                                  "t-big1m-grad"])
def test_control_fails_the_limits(small, cell):
    bdir, _, run = small
    import control

    c = run.Cell(cell, bench_dir=bdir)
    fn = (control.grad_numbers if c.traffic["entry"] == "grad"
          else control.render_numbers)
    out = fn(c, 21, "cpu")
    limits = c.workload["limits"]
    assert any(v > limits[k] for k, v in out["control"].items()), out


def _caps_cut(monkeypatch):
    """Every cell's BVH built with capacities that overflow the small
    scenes (one frontier level, two leaf clusters a ray)."""
    import program
    from tpu_pt_torch.bvh import cluster

    monkeypatch.setattr(program, "build_bvh", lambda spec, scene, *a:
                        cluster.build_cluster_bvh(scene, dense_start=1,
                                                  k_leaf=2))


@pytest.mark.parametrize("cell", ["t-big1m-render", "t-big1m-grad"])
def test_overflowing_call_fails(small, monkeypatch, cell):
    """big-1m guarantees overflow 0: a call whose traversals overflow is
    failed, whatever its pixels read."""
    _caps_cut(monkeypatch)
    res, checks = run_small(small, cell, seconds=0.1)
    assert res["failed"] >= 1 and not res["correct"], (res["failed"], checks)


def _unrepaired(everywhere: bool, seed: int, n_calls: int):
    """A repair that returns the image as it came, for every image or for
    every one but the image the check draws."""
    import random

    real = wavefront.repair_suspect_pixels
    drawn = random.Random(seed).randrange(n_calls)

    def repair(scene, cam, cfg, key, bvh, img, sus, **kw):
        out, left = real(scene, cam, cfg, key, bvh, img, sus, **kw)
        if everywhere or key[1] != drawn:
            return torch.as_tensor(img).reshape(out.shape), left
        return out, left
    return repair


@pytest.mark.parametrize("fault", [None, "everywhere", "all_but_drawn"])
def test_repaired_images_are_judged(small, monkeypatch, fault):
    """The atrium's images overflow and are repaired: sound repairs pass,
    and an image left unrepaired fails the check, also where it is not the
    image drawn for the counts."""
    bdir, path, run = small
    seed, n_calls = 4242, 3
    _caps_cut(monkeypatch)
    if fault:
        monkeypatch.setattr(wavefront, "repair_suspect_pixels", _unrepaired(
            fault == "everywhere", seed, n_calls))
    cell = run.Cell("t-atrium-render", bench_dir=bdir)
    cell.workload = dict(cell.workload, min_calls=n_calls)
    res, checks = run.run_cell(cell, seed, 0.0, False, device="cpu",
                               bench_path=path)
    assert res["attempted"] == n_calls and res["failed"] == 0
    assert res["correct"] == (fault is None), checks


def test_jax_loaded_by_the_check_ends_the_run(small, monkeypatch):
    """The look for JAX comes after the check: a module of JAX that the
    check loads ends the run with 3 and no result."""
    import sys
    import types

    import checks as ch

    real = ch.with_limits

    def loads_jax(*a, **kw):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(*a, **kw)

    monkeypatch.setattr(ch, "with_limits", loads_jax)
    with pytest.raises(SystemExit) as exc:
        run_small(small, "t-big1m-render", seconds=0.1)
    assert exc.value.code == 3
