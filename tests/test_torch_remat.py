"""The √steps-chunked recomputation of the differentiable wavefront loop
(``render/wavefront.py``: ``_Chunk``, ``wavefront_accum(remat=...)``) on
the CPU: against its twin without recomputation (``remat=False``), against
the JAX package where the JAX package recomputes too (past 16 steps), the
bytes the tape holds, and where it does not apply.

Tolerances: the twin bit for bit (one graph, the same ops on the same
inputs); the JAX package's loss rtol 1e-5 and gradients rtol 1e-3 / atol
1e-6 (its own queue-invariance tolerance, tests/test_diff.py:168-183)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.diff import adjoint as jadj
from tpu_pt.diff import params as jparams
from tpu_pt.render import wavefront as jwf
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import native as tnative
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.diff import adjoint as tadj
from tpu_pt_torch.diff import params as tparams
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc

from test_torch_diff import _assert_grads_close, _setup
from torch_port_util import bvh_dict, chunks_seen


def _plane64():
    """tests/test_diff.py:134-183's set-up on the port alone: 64², spp 1,
    direct light, target zeros, the port's cluster BVH."""
    _, (st, cam, cfg, key) = _setup(spp=1, w=64, h=64)
    st, cam = st.to("cpu"), cam.to("cpu")
    return (tparams.split(st)[0], st, cam, cfg, key,
            tcl.build_cluster_bvh(st).to("cpu"), "cluster")


def _spheres16(backend):
    """test_steps_hint_matches_full_bound's scene: the Cornell spheres at
    16², spp 2, depth 3."""
    st = tc.cornell("spheres").to("cpu")
    bvh = (tnative.build_packed(st) if backend == "packed"
           else tcl.build_cluster_bvh(st)).to("cpu")
    cfg = TConfig(width=16, height=16, spp=2, max_depth=3)
    return (tparams.split(st)[0], st, tc.camera(16, 16).to("cpu"), cfg,
            (0, 2), bvh, backend)


def _loss_and_grads(case, queue, remat, steps_hint=None):
    params, st, cam, cfg, key, bvh, backend = case
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, _, counts, done = tadj.wavefront_loss(
        leaves, st, cam, cfg, key, torch.zeros((cfg.n_pixels, 3)), bvh,
        backend, queue=queue, steps_hint=steps_hint, remat=remat)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(
        leaves.values()))))
    assert done
    return loss.detach(), grads, counts[3]


EQUAL_CASES = {
    # 65 steps a render at queue 64: chunks of 8.
    "plane64_cluster": (_plane64, 64, None),
    # A bound of 36 steps: chunks of 6.
    "spheres16_packed": (lambda: _spheres16("packed"), 64, None),
    # A hint of 18 under a bound of 20: chunks of 4.
    "spheres16_packed_hint": (lambda: _spheres16("packed"), 128, 18),
}


@pytest.mark.parametrize("name", sorted(EQUAL_CASES))
def test_recomputation_equals_the_twin_bitwise(monkeypatch, name):
    """Past 16 steps (the bound, or the hint) every chunk of
    round(sqrt(steps)) steps is checkpointed and recomputed once in
    backward; loss and gradients are the twin's bit for bit."""
    make, queue, hint = EQUAL_CASES[name]
    case = make()
    seen = chunks_seen(monkeypatch)
    loss, grads, steps_run = _loss_and_grads(case, queue, None, hint)
    cfg = case[3]
    steps = twf.n_steps(cfg, queue)
    if hint is not None:
        steps = min(steps, hint)
    inner = max(1, round(steps ** 0.5))
    assert steps > 16          # the rule reads the bound or the hint
    assert len(seen) == -(-steps_run // inner) > 1
    assert [c.n for c in seen[:-1]] == [inner] * (len(seen) - 1)
    assert sum(c.n for c in seen) == steps_run
    assert all(c.replays == 1 for c in seen)
    n_chunks = len(seen)
    loss0, grads0, steps0 = _loss_and_grads(case, queue, False, hint)
    assert len(seen) == n_chunks        # the twin checkpoints nothing
    assert steps0 == steps_run
    assert torch.equal(loss, loss0) and float(loss) > 0
    for k in tparams.KEYS:
        assert torch.equal(grads[k], grads0[k]), k
    assert float(grads["albedo"].abs().sum()) > 0


def test_recomputation_matches_jax(monkeypatch):
    """Queue 256 at 64²: 17 steps in both packages, so both recompute
    (the JAX package's √steps-chunked scan under jax.checkpoint)."""
    (sj, camj, cfgj, keyj), (st, camt, cfgt, keyt) = _setup(spp=1, w=64,
                                                           h=64)
    assert jwf.n_steps(cfgj, 256) == twf.n_steps(cfgt, 256) == 17
    cj = jcl.build_cluster_bvh(sj)
    params, _ = jparams.split(sj)
    target = np.zeros((cfgj.n_pixels, 3), np.float32)
    loss_j, grads_j = jadj.loss_and_grad_wavefront(
        params, sj, camj, cfgj, keyj, jnp.asarray(target), cj, queue=256)
    seen = chunks_seen(monkeypatch)
    loss, grads = tadj.loss_and_grad_wavefront(
        {k: np.asarray(v) for k, v in params.items()}, st, camt, cfgt, keyt,
        target, convert.cluster_bvh_from_numpy(bvh_dict(cj), "cpu"),
        queue=256, device="cpu")
    assert len(seen) > 1 and all(c.replays == 1 for c in seen)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    _assert_grads_close(grads, grads_j)


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def _tape_bytes(monkeypatch, case, queue, remat):
    """The bytes the tape holds at the end of the forward: the storages of
    every tensor autograd saved outside a checkpoint (an outer
    saved_tensors_hooks; inside one, the checkpoint's own hooks drop them),
    every checkpoint's inputs and every chunk's traversal records, each
    storage once.  Returns (bytes, steps_run, chunks)."""
    params, st, cam, cfg, key, bvh, backend = case
    inputs, saved = [], []
    with monkeypatch.context() as m:
        held = chunks_seen(m, inputs)
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            loss, _, counts, _ = tadj.wavefront_loss(
                leaves, st, cam, cfg, key, torch.zeros((cfg.n_pixels, 3)),
                bvh, backend, queue=queue, remat=remat)
    storages = {}
    for t in _tensors((saved, inputs, [c.records for c in held])):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
    return sum(storages.values()), counts[3], len(held)


def test_tape_holds_at_most_a_quarter_of_the_twins_bytes(monkeypatch):
    """At 100 steps or more the recomputing loop's tape (records, chunk
    inputs, what autograd saves outside the chunks) is at most 0.25 of
    the twin's (every step's shading)."""
    case = _spheres16("cluster")
    b, steps_run, n_chunks = _tape_bytes(monkeypatch, case, 12, None)
    b0, steps0, n0 = _tape_bytes(monkeypatch, case, 12, False)
    print(f"tape bytes: recomputed {b} ({n_chunks} chunks), twin {b0}, "
          f"{steps_run} steps, ratio {b / b0:.4f}")
    assert steps_run == steps0 >= 100
    assert n_chunks > 1 and n0 == 0
    assert b <= 0.25 * b0


@pytest.mark.parametrize("queue,hint,grad,recomputes", [
    (1024, None, True, False),     # 5 steps
    (274, None, True, False),      # 16 steps: the JAX package's limit
    (256, None, True, True),       # 17 steps
    (256, 16, True, False),        # a bound of 17 under a hint of 16
    (64, None, False, False),      # 65 steps under torch.no_grad()
])
def test_sixteen_steps_or_fewer_recompute_nothing(monkeypatch, queue, hint,
                                                  grad, recomputes):
    """The JAX package's rule: the loop recomputes past 16 steps, under
    autograd only; and the image is the same bits either way."""
    params, st, cam, cfg, key, bvh, backend = _plane64()
    seen = chunks_seen(monkeypatch)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    with torch.set_grad_enabled(grad):
        loss, img, _, done = tadj.wavefront_loss(
            leaves, st, cam, cfg, key, torch.zeros((cfg.n_pixels, 3)), bvh,
            backend, queue=queue, steps_hint=hint)
    assert done and bool(seen) == recomputes
    assert loss.requires_grad == grad
    if grad:
        loss.backward()
    with torch.no_grad():
        ref = twf.render_wavefront(st, cam, cfg, key, bvh, queue=queue,
                                   backend=backend, device="cpu", fast=False)
    assert torch.equal(img.detach().reshape(ref.shape), ref)


def test_remat_takes_none_or_false():
    params, st, cam, cfg, key, bvh, backend = _plane64()
    with pytest.raises(ValueError, match="remat"):
        tadj.wavefront_loss(params, st, cam, cfg, key,
                            torch.zeros((cfg.n_pixels, 3)), bvh, backend,
                            queue=256, remat=True)
