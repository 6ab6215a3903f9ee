"""Distribution in the port (tpu_pt_torch.dist.sharding, and
wavefront_accum's psum_group) against the port's own one-device renders and
against tpu_pt.dist.sharding.

Tolerances: the port's sharded renders against its single renders bitwise
(``torch.equal``: ray ids are global and the accumulate is order-fixed);
images against the JAX package rtol 2e-4 / atol 2e-5
(tests/test_cluster.py:117), per-shard steps and counts exactly; losses rel
1e-5, gradients rtol 1e-4 / atol 1e-6 (tests/test_dist.py:114-119); two
processes against each other rel 1e-6 / 1e-5 (tests/test_multiprocess.py:
51-54) and against one process rel 1e-5 / 1e-4; the per-chunk reduce
against one tail reduce rtol 1e-5 (atol 1e-9 for zeros)."""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tpu_pt.bvh import native as jnative
from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.diff.params import split as jsplit
from tpu_pt.dist import sharding as jsh
from tpu_pt.scene import cornell as jc
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import native as tnative
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.diff import adjoint as tadj
from tpu_pt_torch.diff import params as tparams
from tpu_pt_torch.dist import sharding as tsh
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc

import torch_dist_worker
import torch_port_util  # also sets torch's threads per xdist worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def ranks():
    """Two ranks of tests/torch_dist_worker.py, started when the module's
    first test starts (they run while the JAX package compiles) and killed
    at its end if still running."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [subprocess.Popen([sys.executable, WORKER, str(port), str(r), "2"],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(timeout=30)


@pytest.fixture(scope="module")
def spheres():
    scene = tc.cornell("spheres")
    return scene, tnative.build_packed_any(scene)


def _single_and_sharded(scene, bvh, backend, kw, key, queue, interleave,
                        with_stats=False):
    cfg = TConfig(**kw)
    cam = tc.camera(cfg.width, cfg.height)
    one = twf.render_wavefront(scene, cam, cfg, key, bvh, queue=queue,
                               backend=backend, device="cpu")
    out = tsh.render_sharded(scene, cam, cfg, key, bvh,
                             tsh.make_mesh(8, device="cpu"), queue=queue,
                             backend=backend, interleave=interleave,
                             with_stats=with_stats)
    return one, out


def test_mesh_of_local_shards_and_default_device():
    mesh = tsh.make_mesh(8, device="cpu")
    assert (mesh.size, mesh.world, mesh.rank, mesh.group) == (8, 1, 0, None)
    assert list(mesh.local_shards) == list(range(8))
    assert mesh.device == torch.device("cpu")
    assert tsh.make_mesh(device="cpu").size == 1     # one shard a rank
    tsh.init_distributed()                           # one process: nothing
    assert not torch.distributed.is_initialized()
    if torch.cuda.is_available():
        return
    scene, cb = tc.cornell("empty"), None
    cfg = TConfig(width=4, height=4, spp=1, max_depth=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsh.render_sharded(scene, tc.camera(4, 4), cfg, (0, 0), cb,
                           backend="brute")


def test_sharded_render_equals_single_bitwise(spheres):
    """tests/test_dist.py::test_sharded_render_matches_single (16², spp 4,
    depth 2, queue 512, packed), bitwise."""
    scene, pk = spheres
    kw = dict(width=16, height=16, spp=4, max_depth=2)
    one, img = _single_and_sharded(scene, pk, "packed", kw, (0, 0), 512, True)
    assert img.shape == (16, 16, 3) and float(img.mean()) > 0.05
    assert torch.equal(img, one)


def test_sharded_cluster_backend_equals_single_bitwise():
    scene = tc.cornell("spheres")
    cb = tcl.build_cluster_bvh(scene)
    kw = dict(width=16, height=16, spp=2, max_depth=2)
    one, (img, stats) = _single_and_sharded(scene, cb, "cluster", kw, (0, 2),
                                            256, True, with_stats=True)
    _, nc, ns, novf, _ = twf.render_wavefront_counts(
        scene, tc.camera(16, 16), TConfig(**kw), (0, 2), cb, queue=256,
        backend="cluster", device="cpu")
    assert int(stats["n_overflow"].sum()) == novf == 0
    assert (int(stats["n_closest"].sum()), int(stats["n_shadow"].sum())) == \
        (nc, ns)
    assert torch.equal(img, one)


@pytest.mark.parametrize("option", [dict(pair_stage="split"),
                                    dict(use_kernels=False)],
                         ids=["split", "plain"])
def test_sharded_render_passes_kernel_options_on(option, monkeypatch):
    """render_sharded's pair_stage / use_kernels reach every shard's
    wavefront_accum, and with either option the sharded cluster render
    equals the single one with the same option, bitwise."""
    seen = []

    def accum(*a, **kw):
        seen.append({k: kw[k] for k in option})
        return twf.wavefront_accum(*a, **kw)

    monkeypatch.setattr(tsh, "wavefront_accum", accum)
    scene = tc.cornell("spheres")
    cb = tcl.build_cluster_bvh(scene)
    cfg = TConfig(width=8, height=8, spp=2, max_depth=2)
    cam = tc.camera(8, 8)
    one = twf.render_wavefront(scene, cam, cfg, (0, 1), cb, queue=128,
                               backend="cluster", device="cpu", **option)
    img = tsh.render_sharded(scene, cam, cfg, (0, 1), cb,
                             tsh.make_mesh(8, device="cpu"), queue=128,
                             backend="cluster", interleave=False, **option)
    assert seen == [option] * 8
    assert float(img.mean()) > 0.05
    assert torch.equal(img, one)


@pytest.fixture(scope="module")
def padded_case(spheres):
    """tests/test_dist.py::test_interleaved_shards_bit_identical_with_stats
    (18², spp 2, depth 2, key 3, queue 512, packed: 324 pixels, a padded
    tail) in the port: the single render with its counts, the counts of the
    padded pixels alone, and the interleaved render with its stats."""
    scene, pk = spheres
    kw = dict(width=18, height=18, spp=2, max_depth=2)
    cfg = TConfig(**kw)
    cam = tc.camera(18, 18)
    counts = twf.render_wavefront_counts(scene, cam, cfg, (0, 3), pk,
                                         queue=512, backend="packed",
                                         device="cpu")
    img, stats = tsh.render_sharded(scene, cam, cfg, (0, 3), pk,
                                    tsh.make_mesh(8, device="cpu"), queue=512,
                                    backend="packed", with_stats=True)
    # The 4 padded pixels (324-327) are rendered too: their own segments.
    _, pad = twf.wavefront_accum(scene.to("cpu"), cam.to("cpu"), cfg, (0, 3),
                                 pk.to("cpu"), 512, "packed", 0, 4,
                                 with_counts=True, pix_ids=[324, 325, 326, 327])
    return kw, counts, pad, img, stats


def test_with_stats_counts_sum_to_the_single_render(padded_case):
    _, (one, nc, ns, novf, _), pad, img, stats = padded_case
    assert torch.equal(img, one)
    for k in ("steps_run", "n_closest", "n_shadow", "n_overflow"):
        assert stats[k].shape == (8,) and stats[k].dtype == np.int64, k
    assert (stats["steps_run"] > 0).all()
    assert int(pad[0]) > 0
    assert int(stats["n_closest"].sum()) == nc + int(pad[0])
    assert int(stats["n_shadow"].sum()) == ns + int(pad[1])
    assert int(stats["n_overflow"].sum()) == novf == 0


def test_contiguous_blocks_with_a_padded_tail_equal_single_bitwise(
        spheres, padded_case):
    scene, pk = spheres
    kw, (one, *_), _, img_i, _ = padded_case
    img_c = tsh.render_sharded(scene, tc.camera(18, 18), TConfig(**kw), (0, 3),
                               pk, tsh.make_mesh(8, device="cpu"), queue=512,
                               backend="packed", interleave=False)
    assert torch.equal(img_c, one) and torch.equal(img_c, img_i)


def test_render_sharded_matches_jax(padded_case):
    kw, _, _, img, stats = padded_case
    sj = jc.cornell("spheres")
    img_j, stats_j = jsh.render_sharded(
        sj, jc.camera(18, 18), JConfig(**kw), jax.random.key(3),
        jnative.build_packed_any(sj), jsh.make_mesh(8), queue=512,
        backend="packed", with_stats=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(img_j), rtol=2e-4,
                               atol=2e-5)
    for k in ("steps_run", "n_closest", "n_shadow", "n_overflow"):
        np.testing.assert_array_equal(stats[k], np.asarray(stats_j[k]),
                                      err_msg=k)


def _port_mp_step():
    """The port's sharded step on tests/test_multiprocess.py's inputs, one
    process holding the 8 shards."""
    params, scene, cam, cfg, key, target, pk = torch_dist_worker.setup("mp")
    return tsh.loss_and_grad_sharded(
        params, scene, cam, cfg, key, target, pk,
        tsh.make_mesh(8, device="cpu"), queue=64, backend="packed",
        with_stats=True)


@pytest.fixture(scope="module")
def mp_step():
    return _port_mp_step()


def test_loss_and_grad_sharded_matches_jax(mp_step):
    loss, grads, stats = mp_step
    assert stats["allreduces_bwd"] == sum(m for _, m in stats["chunks"])
    sj = jc.cornell("empty")
    cfg = JConfig(width=8, height=8, spp=2, max_depth=1, rr_start=9)
    loss_j, grads_j = jsh.loss_and_grad_sharded(
        jsplit(sj)[0], sj, jc.camera(8, 8), cfg, jax.random.key(2),
        np.zeros((cfg.n_pixels, 3), np.float32), jnative.build_packed_any(sj),
        jsh.make_mesh(8), queue=64, backend="packed")
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    assert set(grads) == set(grads_j)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(grads_j[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_reduces_start_per_chunk_during_backward():
    """One render of a block through ``psum_group`` (no process group): no
    reduce in forward, one per chunk in backward, and their sum is the
    plain gradient."""
    params, scene, cam, cfg, key, _, pk = torch_dist_worker.setup("chunks")
    scene, cam = scene.to("cpu"), cam.to("cpu")
    pk = pk.to("cpu")
    block = cfg.n_pixels // 8
    red = twf.ChunkReduce()
    grads = []
    for reduce in (red, None):
        leaves = tadj._leaves(params, "cpu")
        accum = twf.wavefront_accum(
            tparams.merge(leaves, scene), cam, cfg, key, pk, 32, "packed",
            3 * block, block, differentiable=True, psum_group=reduce)
        loss = torch.sum((accum / cfg.spp) ** 2)
        if reduce is not None:
            assert red.n_reduces == 0 and red.chunks == [(4, 4)]
            loss.backward()
            assert red.n_reduces == 4
            assert all(x.grad is None for x in leaves.values())
            grads.append(dict(zip(leaves, red.wait(leaves.values()))))
        else:
            loss.backward()
            grads.append({k: x.grad for k, x in leaves.items()})
    for k, g in grads[1].items():
        torch.testing.assert_close(grads[0][k], g, rtol=1e-5, atol=1e-9)
    with pytest.raises(ValueError, match="differentiable"):
        twf.wavefront_accum(scene, cam, cfg, key, pk, 32, "packed", 0, block,
                            psum_group=twf.ChunkReduce())


def test_recomputed_chunks_reduce_m_times_as_the_twin(monkeypatch):
    """Under ``psum_group`` every chunk is recomputed in backward (the JAX
    package's rule): the reduces in backward are still M, one per chunk,
    and their sum is the twin's (``remat=False``) bit for bit."""
    params, scene, cam, cfg, key, _, pk = torch_dist_worker.setup("chunks")
    scene, cam = scene.to("cpu"), cam.to("cpu")
    pk = pk.to("cpu")
    block = cfg.n_pixels // 8
    seen = torch_port_util.chunks_seen(monkeypatch)
    out = {}
    for remat in (None, False):
        red = twf.ChunkReduce()
        leaves = tadj._leaves(params, "cpu")
        accum = twf.wavefront_accum(
            tparams.merge(leaves, scene), cam, cfg, key, pk, 32, "packed",
            3 * block, block, differentiable=True, psum_group=red,
            remat=remat)
        torch.sum((accum / cfg.spp) ** 2).backward()
        assert red.chunks == [(4, 4)] and red.n_reduces == 4
        out[remat] = red.wait(leaves.values())
        if remat is None:
            assert len(seen) == 4 and all(c.replays == 1 for c in seen)
    assert len(seen) == 4       # the twin checkpoints nothing
    for g, g0 in zip(out[None], out[False]):
        assert torch.equal(g, g0)


def test_dryrun_multichip_on_the_cpu():
    loss, grads = tsh.dryrun_multichip(8, device="cpu")
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    assert set(grads) == set(tparams.KEYS)
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_two_processes_agree_and_reduce_per_chunk(ranks, mp_step):
    """Two gloo processes, 4 local shards each (tools/mp_worker.py's
    layout): the same loss and gradients on both, equal to one process
    holding the 8 shards; and on a case whose paired shards run unequal
    chunk counts, one reduce per agreed chunk, equal to a tail reduce."""
    outs = []
    for p in ranks:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
        outs.append(json.loads(out.strip().splitlines()[-1]))
    r0, r1 = outs
    assert r0["local_shards"] == [0, 1, 2, 3]
    assert r1["local_shards"] == [4, 5, 6, 7]
    assert r0["uneven_mesh_refused"] and r1["uneven_mesh_refused"]
    for case in ("mp", "chunks"):
        a, b = r0[case], r1[case]
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-6)
        for k in a["grads"]:
            _close(a["grads"][k], b["grads"][k], 1e-5, 1e-10)
    loss, grads, _ = mp_step
    assert r0["mp"]["loss"] == pytest.approx(float(loss), rel=1e-5)
    for k, g in grads.items():
        _close(r0["mp"]["grads"][k], g.numpy(), 1e-4, 1e-9)
    # The chunk case: shards 3 and 7 run 4 and 3 chunks (and any other
    # unequal pair), so a rank pads; each rank starts sum(M) reduces.
    ch0, ch1 = r0["chunks"]["chunks"], r1["chunks"]["chunks"]
    assert any(a[0] != b[0] for a, b in zip(ch0, ch1)), (ch0, ch1)
    for (n0, m0), (n1, m1) in zip(ch0, ch1):
        assert m0 == m1 == max(n0, n1) >= 3
    for r in (r0, r1):
        c = r["chunks"]
        assert c["allreduces_bwd"] == sum(m for _, m in c["chunks"])
        for k, g in c["grads"].items():
            _close(g, c["tail_grads"][k], 1e-5, 1e-9)
