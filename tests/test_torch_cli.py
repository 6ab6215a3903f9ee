"""The port's command line (tpu_pt_torch.cli) against the JAX package's
(tpu_pt.cli) on the CPU: one small loaded scene rendered by both (the JSON
lines agree: overflow equal, mean_radiance within 1e-4; the PNGs within one
8-bit level), the same refusals, ``dump-bvh`` and ``visualize-bvh`` equal;
and the port's repair and progressive flows through the command line."""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from tpu_pt import cli as jcli
from tpu_pt_torch import cli as tcli
from tpu_pt_torch.bvh import cluster as tcl
from tpu_pt_torch.config import RenderConfig
from tpu_pt_torch.render import envmap, film, wavefront
from tpu_pt_torch.scene import cornell, exr

from test_loaders import DAE_TEXT
import torch_port_util  # noqa: F401  (torch threads per xdist worker)

# The loaders' test document with its camera turned down onto the lit
# floor.
DAE = DAE_TEXT.replace('<node id="camnode"><translate>0 2 4</translate>',
                       '<node id="camnode"><translate>0 2 4</translate>'
                       '<rotate>1 0 0 -25</rotate>')


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG written by ``film.write_png`` (8-bit RGB,
    filter 0 on every row), top row first."""
    data = open(path, "rb").read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


def _json_lines(out: str):
    return [json.loads(l) for l in out.splitlines() if l.startswith("{")]


@pytest.fixture
def files(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_PT_NO_CACHE", "1")   # the JAX CLI's XLA cache
    dae = tmp_path / "scene.dae"
    dae.write_text(DAE)
    sky = str(tmp_path / "sky.exr")
    exr.write_exr(sky, envmap.gradient_sky(h=8, w=16, scale=0.5))
    return tmp_path, str(dae), sky


def test_render_matches_the_jax_command_line(files, capsys):
    tmp, dae, sky = files
    args = ["render", dae, "-r", "16", "16", "-s", "1", "-m", "2",
            "--backend", "cluster", "-e", sky, "--seed", "2"]
    assert jcli.main(args + ["-f", str(tmp / "j.png")]) == 0
    (line_j,) = _json_lines(capsys.readouterr().out)
    assert tcli.main(args + ["-f", str(tmp / "t.png"),
                             "--device", "cpu"]) == 0
    (line_t,) = _json_lines(capsys.readouterr().out)
    assert line_t.keys() == line_j.keys()
    for k in ("scene", "width", "height", "spp", "max_depth", "primary_rays",
              "overflow"):
        assert line_t[k] == line_j[k], k
    assert line_t["mean_radiance"] > 0.01
    assert abs(line_t["mean_radiance"] - line_j["mean_radiance"]) <= 1e-4
    pj, pt = read_png(str(tmp / "j.png")), read_png(str(tmp / "t.png"))
    assert np.abs(pj.astype(int) - pt.astype(int)).max() <= 1


def test_refusals_match_the_jax_command_line(files):
    with pytest.raises(SystemExit) as ej:
        jcli.main(["dump-bvh", "no-such-scene"])
    with pytest.raises(SystemExit) as et:
        tcli.main(["render", "no-such-scene", "--device", "cpu"])
    assert str(et.value) == str(ej.value)
    assert "builtins: atrium, big, big-1m, cornell" in str(et.value)
    if not torch.cuda.is_available():
        # The card by default: no silent fall back to the host.
        for cmd in (["render", "cornell-spheres", "-r", "4", "4"],
                    ["visualize-bvh", "cornell-spheres", "-r", "4", "4"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                tcli.main(cmd)


@pytest.mark.parametrize("scene", ["cornell-spheres", "dae"])
def test_dump_bvh_equals_the_jax_command_line(files, capsys, scene):
    scene = files[1] if scene == "dae" else scene
    jcli.main(["dump-bvh", scene])
    out_j = _json_lines(capsys.readouterr().out)
    tcli.main(["dump-bvh", scene])
    assert _json_lines(capsys.readouterr().out) == out_j


def test_visualize_bvh_equals_the_jax_command_line(files, capsys):
    tmp = files[0]
    args = ["visualize-bvh", "cornell-mesh", "-r", "16", "12"]
    jcli.main(args + ["-f", str(tmp / "j.png")])
    out_j = _json_lines(capsys.readouterr().out)
    tcli.main(args + ["-f", str(tmp / "t.png"), "--device", "cpu"])
    assert _json_lines(capsys.readouterr().out) == out_j
    assert open(tmp / "j.png", "rb").read() == open(tmp / "t.png", "rb").read()


def _capped_cluster_build(monkeypatch):
    """Make the command line's cluster build one whose caps overflow."""
    build = tcl.build_cluster_bvh

    def capped(scene, **kw):
        n_lv = len(build(scene, tile=32).levels)
        return build(scene, tile=32, frontiers=(2,) * n_lv, k_leaf=2,
                     pair_mults=(1, 1, 1))

    monkeypatch.setattr(tcl, "build_cluster_bvh", capped)
    return capped


def test_repair_flow_through_the_command_line(files, capsys, monkeypatch):
    """An overflowing cluster BVH: the command line flags the suspect
    pixels, attaches the fallback and renders only those again; the image
    is the fallback-attached render's.  The JSON line's overflow is then
    the subset render's count (each of those candidates re-traced), as in
    the JAX command line."""
    tmp = files[0]
    capped = _capped_cluster_build(monkeypatch)
    out = str(tmp / "t.png")
    tcli.main(["render", "cornell-mesh", "-r", "12", "12", "-s", "2", "-m",
               "2", "--queue", "64", "-f", out, "--device", "cpu"])
    cap = capsys.readouterr()
    (line,) = _json_lines(cap.out)
    assert "suspect pixels" in cap.err and "exact retry done" in cap.err
    assert line["overflow"] > 0
    scene = cornell.cornell("mesh")
    cfg = RenderConfig(width=12, height=12, spp=2, max_depth=2)
    cb = tcl.attach_fallback(capped(scene), scene)
    ref = wavefront.render_wavefront(scene, cornell.camera(12, 12), cfg,
                                     (0, 0), cb, queue=64, backend="cluster",
                                     device="cpu").numpy()
    ref_png = str(tmp / "ref.png")
    film.save(ref_png, ref)
    got, want = read_png(out), read_png(ref_png)
    # Repair and fallback render agree bitwise, or to 2e-4 / 2e-5 where the
    # tile test and the walk's row test round a t apart.
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_progressive_flow_through_the_command_line(files, capsys,
                                                   monkeypatch):
    """``--checkpoint``: the first chunk overflows, so the render stops,
    attaches the fallback and resumes the (empty) checkpoint; the image is
    the progressive render on the fallback-attached BVH, and a second run
    resumes the finished checkpoint without rendering."""
    tmp = files[0]
    capped = _capped_cluster_build(monkeypatch)
    out, ck = str(tmp / "p.png"), str(tmp / "state.npz")
    args = ["render", "cornell-mesh", "-r", "10", "10", "-s", "2", "-m", "1",
            "--queue", "64", "--chunk-spp", "1", "--checkpoint", ck,
            "--preview", str(tmp / "pre.png"), "-f", out, "--device", "cpu"]
    tcli.main(args)
    cap = capsys.readouterr()
    assert "re-rendering with the exact fallback" in cap.err
    assert cap.err.count("progress:") == 2
    from tpu_pt_torch.render.progressive import render_progressive

    scene = cornell.cornell("mesh")
    cfg = RenderConfig(width=10, height=10, spp=2, max_depth=1)
    cb = tcl.attach_fallback(capped(scene), scene)
    ref = render_progressive(scene, cornell.camera(10, 10), cfg, (0, 0), cb,
                             chunk_spp=1, queue=64, backend="cluster",
                             device="cpu")
    ref_png = str(tmp / "ref.png")
    film.save(ref_png, ref)
    assert open(out, "rb").read() == open(ref_png, "rb").read()
    tcli.main(args)
    assert "progress:" not in capsys.readouterr().err
    assert open(out, "rb").read() == open(ref_png, "rb").read()
