"""The row fetch and the descent's field fetch (``kernels/fetch.py``), the
chained gather
(``kernels/take_along.py``) and the ported fetch probes
(``tpu_pt_torch/tools/``) against the JAX package's probes in ``tools/``,
which are loaded by path: their Pallas kernels run in interpret mode here.

Every comparison is bitwise (a gather moves bits; bf16 widens to f32 by a
shift in every implementation).  The kernels themselves run only on the card
(the ``gpu`` case); on the CPU the wrappers run their plain versions."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.scene import cornell as jc
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.kernels import fetch as tf
from tpu_pt_torch.kernels import take_along as tta
from tpu_pt_torch.tools import (
    microbench_dyngather, microbench_fetch_kernel, microbench_vmem_gather)

from torch_port_util import T, bvh_dict, rays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jtools():
    return {n: _tool(n) for n in ("microbench_vmem_gather",
                                  "microbench_fetch_kernel",
                                  "microbench_dyngather")}


def _bf16_bits(rs, rows, width, infs=False):
    """(rows, width) uint16 bf16 bit patterns of normal values (the low
    half of their f32 bits cut off, so both frameworks hold them exactly);
    with ``infs`` some rows are +inf / -inf, as the descent's empty child
    slots are, and one value is -0.0."""
    x = rs.normal(size=(rows, width)).astype(np.float32)
    if infs:
        x[::7, :] = np.inf
        x[3::7, 3:6] = -np.inf
        x[rows // 2, 1] = -0.0
    return (x.view(np.uint32) >> 16).astype(np.uint16)


def _both(bits):
    """The same bf16 table in JAX and in torch."""
    j = jnp.asarray(bits.view(np.int16)).view(jnp.bfloat16)
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def _same_bits(a, b):
    a = np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_fetch_rows_equals_vmem_gather_on_a_table_with_infinities(jtools):
    rs = np.random.RandomState(0)
    jt, tt = _both(_bf16_bits(rs, 233, 64, infs=True))
    idx = rs.randint(0, 233, 512).astype(np.int32)
    out = tf.fetch_rows(tt, T(idx))
    assert np.isinf(out.numpy()).any()
    _same_bits(jtools["microbench_vmem_gather"].vmem_gather(
        jt, jnp.asarray(idx)), out)


@pytest.mark.parametrize("n", [233, 1864])
def test_fetch_rows_equals_onehot_fetch(jtools, n):
    rs = np.random.RandomState(n)
    jt, tt = _both(_bf16_bits(rs, n, 64))
    idx = rs.randint(0, n, 256).astype(np.int32)
    _same_bits(jtools["microbench_fetch_kernel"].onehot_fetch(
        jt, jnp.asarray(idx)), tf.fetch_rows(tt, T(idx)))


def test_fetch_rows_equals_grouped_fetch_at_width_512(jtools):
    rs = np.random.RandomState(2)
    jt, tt = _both(_bf16_bits(rs, 1864, 64).reshape(233, 512))
    idx = rs.randint(0, 233, 128).astype(np.int32)
    out = tf.fetch_rows(tt, T(idx))
    assert out.shape == (128, 512)
    _same_bits(jtools["microbench_fetch_kernel"].grouped_fetch(
        jt, jnp.asarray(idx)), out)


def test_fetch_rows_t_equals_lane_gather_fetch(jtools):
    rs = np.random.RandomState(3)
    jt, tt = _both(_bf16_bits(rs, 233, 64))
    idx = rs.randint(0, 233, 512).astype(np.int32)
    out = tf.fetch_rows_t(tt, T(idx))
    assert out.shape == (64, 512)
    _same_bits(jtools["microbench_fetch_kernel"].lane_gather_fetch(
        jt, jnp.asarray(idx)), out)


def test_fetch_fields_equals_vmem_gather_rearranged(jtools):
    """The descent's field fetch is the row fetch with each row's words laid
    out as planes: its plain version against the JAX probe's gather
    (interpret mode), rearranged, on a table with +/-inf rows."""
    rs = np.random.RandomState(8)
    jt, tt = _both(_bf16_bits(rs, 233, 64, infs=True))
    Q, K = 64, 8
    idx = rs.randint(0, 233, Q * K).astype(np.int32)
    rows = np.asarray(jtools["microbench_vmem_gather"].vmem_gather(
        jt, jnp.asarray(idx)))
    want = rows.reshape(Q, K, 8, 8)[:, :, :6].transpose(2, 0, 1, 3) \
        .reshape(6, Q, K * 8)
    out = tf.fetch_fields(tt, T(idx.reshape(Q, K)).long())
    assert out.shape == (6, Q, K * 8) and np.isinf(out.numpy()).any()
    _same_bits(want, out)
    assert tf.fetch_fields.launches == 0


@pytest.mark.parametrize("fields", [1, 6, 8])
def test_fetch_fields_is_the_clamped_row_fetch_as_planes(fields):
    """Every field count, int32 / int64 / strided candidates with indices
    out of range: plane f of the result is word f of each clamped row, and
    each plane is contiguous (the descent reads it as it is)."""
    rs = np.random.RandomState(10 + fields)
    bits = _bf16_bits(rs, 19, 64, infs=True)
    _, tt = _both(bits)
    want = (bits.astype(np.uint32) << 16).view(np.float32)
    raw = rs.randint(-4, 25, (5, 3)).astype(np.int64)
    buf = torch.zeros((5, 4), dtype=torch.int64)
    buf[:, 1:] = T(raw)
    for cand in (T(raw), T(raw).int(), buf[:, 1:]):
        out = tf.fetch_fields(tt, cand, fields)
        assert out.shape == (fields, 5, 24) and out.is_contiguous()
        rows = want[np.clip(raw, 0, 18)].reshape(5, 3, 8, 8)
        _same_bits(rows[:, :, :fields].transpose(2, 0, 1, 3)
                   .reshape(fields, 5, 24), out)
        assert out[0].is_contiguous()
    empty = tf.fetch_fields(tt, torch.zeros((0, 3), dtype=torch.int64))
    assert empty.shape == (6, 0, 24)


def test_fetch_rows_clamp_index_types_and_shapes():
    """Under clamp every index lands in [0, N); int32 and int64 give the
    same rows; the result has idx's shape plus W, for a strided index
    too (the descent's column slice)."""
    rs = np.random.RandomState(4)
    bits = _bf16_bits(rs, 9, 64, infs=True)
    _, tt = _both(bits)
    want = (bits.astype(np.uint32) << 16).view(np.float32)
    raw = np.array([[-5, -1, 0, 3], [8, 9, 40, 2]], np.int64)
    buf = torch.zeros((2, 5), dtype=torch.int64)
    buf[:, :4] = T(raw)
    for idx in (T(raw), T(raw).int(), buf[:, :4]):
        out = tf.fetch_rows(tt, idx, clamp=True)
        assert out.shape == (2, 4, 64) and out.dtype == torch.float32
        _same_bits(want[np.clip(raw, 0, 8)], out)
    _same_bits(want[[4]], tf.fetch_rows(tt, T(np.array([4])), clamp=False))
    with pytest.raises(IndexError):
        tf.fetch_rows(tt, T(np.array([9])))


def test_fetch_wrappers_refuse_what_the_kernel_does_not_take():
    tt = torch.zeros((4, 64), dtype=torch.bfloat16)
    idx = torch.zeros((3,), dtype=torch.int64)
    with pytest.raises(TypeError):
        tf.fetch_rows(tt.float(), idx)
    with pytest.raises(TypeError):
        tf.fetch_rows(tt, idx.float())
    with pytest.raises(ValueError):
        tf.fetch_rows(torch.zeros((4, 48), dtype=torch.bfloat16), idx)
    with pytest.raises(ValueError, match="requires grad"):
        tf.fetch_rows(tt.float().requires_grad_(True).bfloat16(), idx)
    with pytest.raises(ValueError):
        tf.fetch_rows_t(tt, idx[None])
    cand = idx.reshape(1, 3)
    with pytest.raises(TypeError):
        tf.fetch_fields(tt.float(), cand)
    with pytest.raises(TypeError):
        tf.fetch_fields(tt, cand.float())
    with pytest.raises(ValueError, match=r"\(N, 64\)"):
        tf.fetch_fields(torch.zeros((4, 128), dtype=torch.bfloat16), cand)
    for fields in (0, 9):
        with pytest.raises(ValueError, match="fields"):
            tf.fetch_fields(tt, cand, fields)
    with pytest.raises(ValueError, match=r"\(Q, K\)"):
        tf.fetch_fields(tt, idx)
    assert tf.fetch_rows.launches == 0 and tf.fetch_rows_t.launches == 0
    assert tf.fetch_fields.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("dim", [0, 1])
def test_take_along_equals_numpy_take_along_axis(dim, dtype):
    """The dyngather tool's own reference, np.take_along_axis, applied
    ``reps`` times (bf16 compared on its bit patterns)."""
    M, N, reps = 24, 40, 5
    x, idx = microbench_dyngather.inputs(dim, M, N, getattr(torch, dtype),
                                         11 + dim, "cpu")
    out = tta.take_along(x, idx, dim, reps)
    want = x.view(torch.int16).numpy() if dtype == "bfloat16" else x.numpy()
    for _ in range(reps):
        want = np.take_along_axis(want, idx.numpy(), axis=dim)
    got = out.view(torch.int16).numpy() if dtype == "bfloat16" else \
        out.numpy()
    np.testing.assert_array_equal(got, want)
    assert out.dtype == x.dtype and tta.take_along.launches == 0


def test_take_along_forms_and_refusals():
    assert tta.take_along_form(256, 128, 0) == "lines"
    assert tta.take_along_form(2, 5000, 0) == "lines"
    assert tta.take_along_form(2, 5000, 1) == "passes"
    assert [tta.lines_per_block(2048, 128, d) for d in (0, 1)] == [1, 8]
    x = torch.zeros((4, 4))
    idx = torch.zeros((4, 4), dtype=torch.int32)
    for bad in (dict(x=x.double()), dict(idx=idx.long()),
                dict(idx=idx[:2])):
        with pytest.raises(TypeError):
            tta.take_along(bad.get("x", x), bad.get("idx", idx), 0, 1)
    with pytest.raises(ValueError):
        tta.take_along(x, idx, 2, 1)
    with pytest.raises(ValueError):
        tta.take_along(x, idx, 0, 0)


def test_descend_compact_equals_jax_through_the_fetch(monkeypatch):
    """The port's descent, whose child fetch goes through fetch_fields
    (``fetch="fields"``, the default) or fetch_rows and a copy a field
    (``fetch="rows"``), against the reference's: cand, live and overflow
    exact in both forms, on a deep pyramid with caps tight enough to
    truncate; every level's fetch is made by the form asked for, with its
    clamp, and the plain version is what runs on the CPU."""
    scene = jc.cornell("mesh", mesh_subdiv=3)
    cj = jcl.build_cluster_bvh(scene, tile=16, dense_start=8,
                               frontiers=(2, 5, 8), k_leaf=10)
    ct = convert.cluster_bvh_from_numpy(bvh_dict(cj), "cpu")
    assert len(ct.levels) == 3
    seen = []
    real_rows, real_fields = tcl.fetch_rows, tcl.fetch_fields

    def spy_rows(table, idx, *, clamp=False):
        seen.append(("rows", tuple(table.shape), idx.dtype, clamp))
        return real_rows(table, idx, clamp=clamp)

    def spy_fields(table, cand, fields=6):
        seen.append(("fields", tuple(table.shape), cand.dtype, fields))
        return real_fields(table, cand, fields)

    monkeypatch.setattr(tcl, "fetch_rows", spy_rows)
    monkeypatch.setattr(tcl, "fetch_fields", spy_fields)
    Q = 512
    ro, rd = rays(Q, 5)
    ro = ro * 0.3
    tmin = np.zeros((Q, 1), np.float32)
    tmax = np.full((Q, 1), 1e30, np.float32)
    c1, l1, o1 = jcl._descend_compact(
        jax.tree.map(jnp.asarray, cj), jnp.asarray(ro),
        1.0 / jnp.asarray(rd), jnp.asarray(tmin), jnp.asarray(tmax))
    for fetch in ("fields", "rows"):
        seen.clear()
        c2, l2, o2 = tcl._descend_compact(ct, T(ro), 1.0 / T(rd), T(tmin),
                                          T(tmax), fetch=fetch)
        np.testing.assert_array_equal(np.asarray(c1), c2.numpy())
        np.testing.assert_array_equal(np.asarray(l1), l2.numpy())
        np.testing.assert_array_equal(np.asarray(o1), o2.numpy())
        assert int(o2.sum()) > 0 and bool(l2.any())
        last = {"fields": 6, "rows": True}[fetch]
        assert seen == [(fetch, tuple(ct.child16[l].shape), torch.int64,
                         last) for l in (1, 2)]
    with pytest.raises(ValueError, match="fetch"):
        tcl._descend_compact(ct, T(ro), 1.0 / T(rd), T(tmin), T(tmax),
                             fetch="gather")
    assert tf.fetch_rows.launches == 0 and tf.fetch_fields.launches == 0


def test_ported_tools_run_on_the_cpu_at_a_small_size(capsys):
    lines = microbench_vmem_gather.main(
        ["--device", "cpu", "--rays", "16", "--scene-subdiv", "6"])
    assert [ln["case"] for ln in lines] == ["L1", "L2", "descent_L1"]
    assert lines[-1]["idx_dtype"] == "int64" and lines[-1]["clamp"]
    lines += microbench_fetch_kernel.main(["--device", "cpu", "--rays", "16"])
    assert [(ln["case"], ln["W"]) for ln in lines[3:]] == [
        ("L1", 64), ("L1", 64), ("L2", 64), ("L2", 64), ("grouped", 512)]
    lines += microbench_dyngather.main(["--device", "cpu"])
    assert len(lines) == 8 + len(microbench_dyngather.CASES)
    assert all(ln["exact"] and not ln["timed"] for ln in lines)
    assert len(capsys.readouterr().out.splitlines()) == len(lines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            microbench_dyngather.main([])


@pytest.mark.gpu
def test_fetch_and_take_along_kernels_match_plain_versions_on_the_card():
    """Needs an NVIDIA GPU and nvcc: fetch_rows (int32 and int64, strided,
    with and without clamp, W 64 and 512, a table with infinities, one row,
    P not a multiple of a block), fetch_fields (1, 6 and 8 fields, indices
    out of range, strided; also against fetch_rows rearranged),
    fetch_rows_t and take_along (both forms,
    the longest line the lines form takes, three types, both dims) bit for
    bit against their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    rs = np.random.RandomState(9)
    n0 = (tf.fetch_rows.launches, tf.fetch_rows_t.launches,
          tta.take_along.launches, tf.fetch_fields.launches)
    for n, w, p in ((233, 64, 1000), (1864, 64, 4097), (1, 64, 3),
                    (233, 512, 777)):
        tt = torch.from_numpy(_bf16_bits(rs, n, w, infs=True).view(
            np.int16)).view(torch.bfloat16).to(dev)
        raw = torch.from_numpy(rs.randint(-n - 3, 2 * n + 3, p)).to(dev)
        ok = torch.clamp(raw, 0, n - 1)
        buf = torch.zeros((p, 7), dtype=torch.int64, device=dev)
        buf[:, 2] = ok
        for idx in (ok, ok.int(), buf[:, 1:5]):
            for clamp in (False, True):
                a = tf.fetch_rows(tt, idx, clamp=clamp)
                b = tf.fetch_rows_ref(tt, idx, clamp=clamp)
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        a = tf.fetch_rows(tt, raw, clamp=True)
        assert torch.equal(a.view(torch.int32), tf.fetch_rows_ref(
            tt, raw, clamp=True).view(torch.int32))
        a = tf.fetch_rows_t(tt, ok.int())
        assert torch.equal(a.view(torch.int32), tf.fetch_rows_t_ref(
            tt, ok.int()).view(torch.int32))
        if w == 64:
            # The field fetch against its plain version and against the row
            # fetch rearranged (its twin on the descent).
            cand = buf[:, 1:5].clone()
            cand[:, 0] = raw
            for c in (cand, cand.int(), buf[:, 1:5]):
                for fields in (1, 6, 8):
                    a = tf.fetch_fields(tt, c, fields)
                    b = tf.fetch_fields_ref(tt, c, fields)
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                rows = tf.fetch_rows(tt, c, clamp=True).reshape(p, 4, 8, 8)
                assert torch.equal(
                    tf.fetch_fields(tt, c).view(torch.int32),
                    rows[:, :, :6].permute(2, 0, 1, 3).reshape(
                        6, p, 32).view(torch.int32))
    for dim, M, N, reps, dtype in ((0, 256, 128, 16, torch.float32),
                                   (1, 7, 33, 3, torch.bfloat16),
                                   (1, 256, 512, 4, torch.int32),
                                   (0, 300, 200, 1, torch.float32),
                                   (0, 4096, 3, 2, torch.float32),
                                   (1, 3, 5000, 4, torch.bfloat16)):
        x, idx = microbench_dyngather.inputs(dim, M, N, dtype, 3, dev)
        a, b = tta.take_along(x, idx, dim, reps), tta.take_along_ref(
            x, idx, dim, reps)
        assert a.dtype == b.dtype and torch.equal(a, b), (dim, M, N, dtype)
    torch.cuda.synchronize()
    assert tf.fetch_rows.launches - n0[0] == 4 * 7 + 3 * 3
    assert tf.fetch_fields.launches - n0[3] == 3 * 3 * (3 + 1)
    assert tf.fetch_rows_t.launches - n0[1] == 4
    assert tta.take_along.launches - n0[2] == 1 + 1 + 1 + 1 + 1 + 4
