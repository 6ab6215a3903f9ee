"""Exact repair of capacity overflow in the port — suspect masks and the
packed fallback of the cluster traversal (bvh/cluster.py), suspect-pixel
tracking, ``pix_ids`` and the repair itself (render/wavefront.py) — against
tpu_pt (tests/test_capacity.py:157-236) and within the port.

Set-ups: ``cornell("mesh")`` with deliberately starved capacities (every
frontier cap, the leaf budget and the pair budget cut), carried from the
JAX package with ``cluster_bvh_from_numpy`` so that both hold the same
tree.  Masks, flags, counts and the port's own repairs are held exactly;
hit t against JAX to rtol/atol 1e-6 (prim on > 0.99 of hits), images
against JAX to rtol 2e-4 / atol 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.bvh import cluster as jcl
from tpu_pt.config import RenderConfig as JConfig
from tpu_pt.core.camera import generate_rays, pixel_xy
from tpu_pt.render import wavefront as jwf
from tpu_pt.scene import cornell as jc
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.bvh import packed as tpk
from tpu_pt_torch.config import RenderConfig as TConfig
from tpu_pt_torch.kernels import packed_walk as tpw
from tpu_pt_torch.render import driver as tdriver
from tpu_pt_torch.render import wavefront as twf
from tpu_pt_torch.scene import cornell as tc

from torch_port_util import T, bvh_dict, camera_dict, scene_dict

HIT_FIELDS = ("hit", "t", "prim", "u", "v")


def _starved(tile, div, k_div, leaf_mult):
    """(JAX cluster BVH with starved caps, the port's copy of it on the
    CPU, the port's copy with the fallback attached)."""
    scene = jc.cornell("mesh")
    cb0 = jcl.build_cluster_bvh(scene, tile=tile)
    caps = tuple(max(2, c // div) for c in cb0.frontiers)
    cj = jcl.build_cluster_bvh(scene, tile=tile, frontiers=caps,
                               k_leaf=max(k_div, cb0.k_leaf // div),
                               pair_mults=(8, 8, leaf_mult))
    ct = convert.cluster_bvh_from_numpy(bvh_dict(cj), "cpu")
    return cj, ct, tcl.attach_fallback(ct, tc.cornell("mesh"))


@pytest.fixture(scope="module")
def capacity():
    """The set-up of tests/test_capacity.py:157-214: 2048 primary rays of
    the 64x64 camera, 32-lane tiles (and 128-lane tiles for the dedup
    stage), caps cut to an eighth, one leaf pair per ray."""
    cam = jc.camera(64, 64)
    Q = 2048
    xy = pixel_xy(64, 64, jnp.arange(Q, dtype=jnp.int32),
                  jnp.full((Q, 2), 0.5))
    ro, rd = (np.asarray(x, np.float32) for x in generate_rays(cam, xy))
    return dict(ro=ro, rd=rd,
                scene_t=convert.scene_from_numpy(
                    scene_dict(jc.cornell("mesh")), "cpu"),
                tile32=_starved(32, 8, 2, 1), tile128=_starved(128, 8, 2, 1))


def _bounds(Q, t_max=1e30):
    return np.zeros((Q, 1), np.float32), np.full((Q, 1), t_max, np.float32)


def _jax_suspects(cj, ro, rd, t_min, t_max, any_hit=False):
    sus = []
    if any_hit:
        out, novf = jcl.occluded_counted(cj, None, jnp.asarray(ro),
                                         jnp.asarray(rd), jnp.asarray(t_max),
                                         suspect_out=sus)
    else:
        out, novf = jcl.intersect_counted(cj, None, jnp.asarray(ro),
                                          jnp.asarray(rd), jnp.asarray(t_min),
                                          jnp.asarray(t_max), suspect_out=sus)
    return out, int(novf), np.asarray(sus[0])


@pytest.mark.parametrize("pair_stage", ["fused", "split", "dedup"])
def test_fallback_repairs_overflow(capacity, monkeypatch, pair_stage):
    """tests/test_capacity.py:157-214 in the port, for every pair stage
    (dedup on 128-lane tiles): the suspect mask equals the JAX package's;
    every suspect ray's result is the packed walk's, bit for bit; every
    other ray's is the plain traversal's, bit for bit; the overflow is still
    reported; the repaired hits agree with the JAX package's repaired hits."""
    for mod in (jcl, tcl):
        monkeypatch.setattr(mod, "SPLIT_CLOSEST", 1)
        monkeypatch.setattr(mod, "SPLIT_ANYHIT", 1)
    cj, ct, fb = capacity["tile128" if pair_stage == "dedup" else "tile32"]
    st = capacity["scene_t"]
    ro, rd = capacity["ro"], capacity["rd"]
    Q = ro.shape[0]
    t_min, t_max = _bounds(Q)
    args = (T(ro), T(rd), T(t_min), T(t_max))

    hj, novf_j, sus_j = _jax_suspects(cj, ro, rd, t_min, t_max)
    sus = []
    h_plain, novf = tcl.intersect_counted(ct, st, *args, pair_stage=pair_stage,
                                          suspect_out=sus)
    s = sus[0]
    assert s.dtype == torch.bool and tuple(s.shape) == (Q,)
    np.testing.assert_array_equal(s.numpy(), sus_j)
    assert 0 < int(s.sum()) < Q, "set-up failed to force overflow"
    assert int(novf) == novf_j > 0

    n0 = tpw.packed_walk.launches
    h_fb, novf_fb = tcl.intersect_counted(fb, st, *args, pair_stage=pair_stage)
    assert tpw.packed_walk.launches == n0   # CPU tensors: the plain walk
    assert int(novf_fb) == novf_j           # overflow still reported
    h_pk = tpk.intersect(fb.fallback, st, *args)
    for f in HIT_FIELDS:
        assert torch.equal(getattr(h_fb, f)[s], getattr(h_pk, f)[s]), f
        assert torch.equal(getattr(h_fb, f)[~s], getattr(h_plain, f)[~s]), f

    jfb = jcl.attach_fallback(cj, jc.cornell("mesh"))
    hjf, _ = jcl.intersect_counted(jfb, None, *(jnp.asarray(x) for x in
                                                (ro, rd, t_min, t_max)))
    np.testing.assert_array_equal(h_fb.hit.numpy(), np.asarray(hjf.hit))
    m = h_fb.hit.numpy()[:, 0]
    np.testing.assert_allclose(h_fb.t.numpy()[m], np.asarray(hjf.t)[m],
                               rtol=1e-6, atol=1e-6)
    assert (h_fb.prim.numpy() == np.asarray(hjf.prim))[m].mean() > 0.99

    t5 = np.full((Q, 1), 5.0, np.float32)
    _, novf_oj, sus_oj = _jax_suspects(cj, ro, rd, t_min, t5, any_hit=True)
    sus_o = []
    o_plain, novf_o = tcl.occluded_counted(ct, st, T(ro), T(rd), T(t5),
                                           pair_stage=pair_stage,
                                           suspect_out=sus_o)
    so = sus_o[0]
    np.testing.assert_array_equal(so.numpy(), sus_oj)
    assert int(novf_o) == novf_oj and int(so.sum()) > 0
    o_fb, _ = tcl.occluded_counted(fb, st, T(ro), T(rd), T(t5),
                                   pair_stage=pair_stage)
    o_pk = tpk.occluded(fb.fallback, st, T(ro), T(rd), T(t5))
    assert torch.equal(o_fb[so], o_pk[so])
    assert torch.equal(o_fb[~so], o_plain[~so])


@pytest.mark.parametrize("any_hit", [False, True])
def test_strided_split_suspect_mask_matches_jax(capacity, any_hit):
    """Q = 4096 runs as four strided sub-batches in both packages: the
    interleaved suspect mask and the summed overflow equal the JAX
    package's."""
    cj, ct, _ = capacity["tile32"]
    cam = jc.camera(64, 64)
    Q = 4096
    xy = pixel_xy(64, 64, jnp.arange(Q, dtype=jnp.int32),
                  jnp.full((Q, 2), 0.5))
    ro, rd = (np.asarray(x, np.float32) for x in generate_rays(cam, xy))
    assert tcl._split_batches(Q, tcl.SPLIT_CLOSEST) == 4
    t_min, t_max = _bounds(Q, 5.0 if any_hit else 1e30)
    _, novf_j, sus_j = _jax_suspects(cj, ro, rd, t_min, t_max, any_hit)
    sus = []
    if any_hit:
        _, novf = tcl.occluded_counted(ct, None, T(ro), T(rd), T(t_max),
                                       suspect_out=sus)
    else:
        _, novf = tcl.intersect_counted(ct, None, T(ro), T(rd), T(t_min),
                                        T(t_max), suspect_out=sus)
    np.testing.assert_array_equal(sus[0].numpy(), sus_j)
    assert 0 < int(sus[0].sum()) < Q and int(novf) == novf_j


def test_fallback_moves_with_the_bvh(capacity):
    """attach_fallback puts the packed BVH on the cluster BVH's device (a
    host BVH keeps host arrays), and ``to`` moves it with the rest, also
    where the rest is there already."""
    scene = tc.cornell("mesh")
    host = tcl.build_cluster_bvh(scene, tile=32)
    hfb = tcl.attach_fallback(host, scene)
    assert isinstance(hfb.fallback.table, np.ndarray)
    assert hfb.fallback.table.shape[0] == \
        hfb.fallback.prim_base + hfb.fallback.n_prims
    dev = hfb.to("cpu")
    assert torch.is_tensor(dev.fallback.table) and \
        torch.is_tensor(dev.fallback.prim_gid)
    _, ct, fb = capacity["tile32"]
    assert torch.is_tensor(fb.fallback.table)
    # Already on the device: the short cut keeps the fallback a tensor too.
    moved = ct._replace(fallback=hfb.fallback).to("cpu")
    assert moved.tiles is ct.tiles and torch.is_tensor(moved.fallback.table)
    assert ct.to("cpu") is ct and ct.fallback is None


def test_without_overflow_the_fallback_changes_nothing():
    """Default capacities (no overflow): nothing is suspect and the
    traversal with the fallback attached gives the same bits as without;
    so does a small wavefront render (the headline's case)."""
    scene = tc.cornell("mesh")
    cb = tcl.build_cluster_bvh(scene, tile=32).to("cpu")
    fb = tcl.attach_fallback(cb, scene)
    cam = tc.camera(32, 32)
    cfg = TConfig(width=32, height=32, spp=1, max_depth=3)
    sus = []
    xy = torch.rand((1024, 2), generator=torch.Generator().manual_seed(0))
    from tpu_pt_torch.core.camera import generate_rays as tgen
    ro, rd = tgen(cam.to("cpu"), xy * 32)
    t_min, t_max = torch.zeros((1024, 1)), torch.full((1024, 1), 1e30)
    h0, n0 = tcl.intersect_counted(cb, None, ro, rd, t_min, t_max,
                                   suspect_out=sus)
    h1, n1 = tcl.intersect_counted(fb, None, ro, rd, t_min, t_max)
    assert int(n0) == int(n1) == 0 and not bool(sus[0].any())
    for f in HIT_FIELDS:
        assert torch.equal(getattr(h0, f), getattr(h1, f)), f
    a = twf.render_wavefront_counts(scene, cam, cfg, (0, 1), cb, queue=1024,
                                    backend="cluster", device="cpu")
    b = twf.render_wavefront_counts(scene, cam, cfg, (0, 1), fb, queue=1024,
                                    backend="cluster", device="cpu")
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:] and a[3] == 0


@pytest.fixture(scope="module")
def render24():
    """tests/test_capacity.py:236's set-up in both packages: 24x24, spp 1,
    depth 2, queue 256, key 9, caps cut to a sixth, two leaf pairs a ray;
    the suspect-count render, the repair and the full render on the exact
    BVH."""
    scene_j = jc.cornell("mesh")
    cam_j = jc.camera(24, 24)
    kw = dict(width=24, height=24, spp=1, max_depth=2)
    cfg_j, cfg_t = JConfig(**kw), TConfig(**kw)
    cj, ct, fb = _starved(32, 6, 3, 2)
    out_j = jwf.render_wavefront_suspect_counts(
        scene_j, cam_j, cfg_j, jax.random.key(9), cj, queue=256,
        backend="cluster")
    rep_j, novf_rj = jwf.repair_suspect_pixels(
        scene_j, cam_j, cfg_j, jax.random.key(9),
        jcl.attach_fallback(cj, scene_j), np.asarray(out_j[0]),
        np.asarray(out_j[5]), queue=256, backend="cluster")
    scene_t = tc.cornell("mesh")
    cam_t = convert.camera_from_numpy(camera_dict(cam_j), "cpu")
    common = dict(queue=256, backend="cluster", device="cpu")
    out_t = twf.render_wavefront_suspect_counts(scene_t, cam_t, cfg_t, (0, 9),
                                                ct, **common)
    rep_t, novf_rt = twf.repair_suspect_pixels(
        scene_t, cam_t, cfg_t, (0, 9), fb, out_t[0], out_t[5], **common)
    full_t = twf.render_wavefront(scene_t, cam_t, cfg_t, (0, 9), fb, **common)
    plain_t = twf.render_wavefront_counts(scene_t, cam_t, cfg_t, (0, 9), ct,
                                          **common)
    return dict(out_j=out_j, rep_j=np.asarray(rep_j), novf_rj=int(novf_rj),
                out_t=out_t, rep_t=rep_t, novf_rt=novf_rt, full_t=full_t,
                plain_t=plain_t, cfg=cfg_t)


def test_suspect_counts_render_matches_jax(render24):
    """Suspect flags and counts equal the JAX package's, the image is within
    rtol 2e-4 / atol 2e-5; tracking the suspects changes no bit of the
    port's own render."""
    img_j, nc_j, ns_j, novf_j, it_j, sus_j = render24["out_j"]
    img_t, nc_t, ns_t, novf_t, it_t, sus_t = render24["out_t"]
    assert sus_t.dtype == torch.int32 and tuple(sus_t.shape) == (24 * 24,)
    np.testing.assert_array_equal(sus_t.numpy(), np.asarray(sus_j))
    assert 0 < int(sus_t.sum()) < 24 * 24, "need suspect and clean pixels"
    assert (nc_t, ns_t, novf_t, it_t) == \
        (int(nc_j), int(ns_j), int(novf_j), int(it_j))
    assert novf_t > 0
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), rtol=2e-4,
                               atol=2e-5)
    plain = render24["plain_t"]
    assert torch.equal(plain[0], img_t) and plain[1:] == (nc_t, ns_t, novf_t,
                                                          it_t)


def test_repair_equals_the_full_exact_render_bitwise(render24):
    """Repairing only the suspect pixels gives the full fallback-attached
    render bit for bit (the JAX package's claim, tests/test_capacity.py:236);
    the pixels that were not suspect keep the first render's bits."""
    rep, full = render24["rep_t"], render24["full_t"]
    img, sus = render24["out_t"][0], render24["out_t"][5]
    assert rep.dtype == torch.float32 and tuple(rep.shape) == (24, 24, 3)
    differ = (rep != full).any(-1).reshape(-1)
    assert int(differ.sum()) == 0, \
        f"{int(differ.sum())} pixels differ from the full exact render"
    clean = (sus == 0).reshape(24, 24)
    assert torch.equal(rep[clean], img[clean])
    assert render24["novf_rt"] > 0   # the subset render still overflows


def test_repair_matches_jax(render24):
    np.testing.assert_allclose(render24["rep_t"].numpy(), render24["rep_j"],
                               rtol=2e-4, atol=2e-5)
    assert render24["novf_rt"] == render24["novf_rj"]


def test_repair_without_suspects_returns_the_image():
    scene = tc.cornell("mesh")
    cam = tc.camera(8, 8)
    cfg = TConfig(width=8, height=8, spp=1, max_depth=1)
    img = torch.rand((8, 8, 3))
    out, novf = twf.repair_suspect_pixels(
        scene, cam, cfg, (0, 0), None, img, torch.zeros(64, dtype=torch.int32),
        backend="brute", device="cpu")
    assert torch.equal(out, img) and novf == 0


@pytest.mark.parametrize("backend", ["brute", "cluster"])
def test_pix_ids_subset_equals_the_full_render_bitwise(backend):
    """A subset of pixels rendered through ``pix_ids`` (in shuffled order,
    padded as the repair pads) is those pixels of the full render, bit for
    bit: every draw is keyed by the global sample id."""
    scene = tc.cornell("mesh").to("cpu")
    cam = tc.camera(16, 16).to("cpu")
    cfg = TConfig(width=16, height=16, spp=1, max_depth=3)
    bvh = tcl.build_cluster_bvh(scene, tile=32).to("cpu") \
        if backend == "cluster" else None
    full = twf.wavefront_accum(scene, cam, cfg, (0, 4), bvh, 256, backend, 0,
                               cfg.n_pixels)
    rs = np.random.RandomState(4)
    pick = rs.choice(cfg.n_pixels, 37, replace=False)
    ids = np.concatenate([pick, np.full(64 - 37, pick[0])])
    sub, counts = twf.wavefront_accum(scene, cam, cfg, (0, 4), bvh, 64,
                                      backend, 0, 64, pix_ids=ids,
                                      with_counts=True)
    assert torch.equal(sub[:37], full[torch.from_numpy(pick)])
    assert torch.equal(sub[37:], full[int(pick[0])].expand(27, 3))
    assert int(counts[0]) > 0


def test_global_ray_id():
    cfg = TConfig(width=4, height=4, spp=3, max_depth=1)
    rid = torch.tensor([-1, 0, 2, 3, 7, 11])
    assert twf._global_ray_id(rid, cfg, None) is rid
    ids = torch.tensor([9, 4, 15, 0])
    want = torch.tensor([-1, 27, 29, 12, 46, 2])
    assert torch.equal(twf._global_ray_id(rid, cfg, ids), want)


@pytest.mark.parametrize("backend", ["brute", "packed"])
def test_exact_backends_report_no_suspects(backend):
    scene = tc.cornell("spheres").to("cpu")
    from tpu_pt_torch.bvh import native as tnative
    bvh = tnative.build_packed(scene).to("cpu") if backend == "packed" \
        else None
    isect, occl = tdriver._intersectors_suspect(backend, bvh)
    ro = torch.tensor([[0.0, 1.0, 3.0], [0.0, 1.0, 3.0]])
    rd = torch.tensor([[0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    hit, novf, sus = isect(scene, ro, rd, torch.zeros((2, 1)),
                           torch.full((2, 1), 1e30))
    assert bool(hit.hit[0, 0]) and abs(float(hit.t[0, 0]) - 4.0) < 1e-5
    assert int(novf) == 0 and sus.dtype == torch.bool and not bool(sus.any())
    occ, novf, sus = occl(scene, ro, rd, torch.full((2, 1), 5.0), narrow=True)
    assert bool(occ[0, 0]) and int(novf) == 0 and not bool(sus.any())
