"""The port imports torch and numpy only, and its entry points run on the
card unless the caller asks for the CPU."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import tpu_pt_torch

import torch_port_util  # noqa: F401  (torch threads per xdist worker)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _submodules():
    names = ["tpu_pt_torch"]
    for m in pkgutil.walk_packages(tpu_pt_torch.__path__, "tpu_pt_torch."):
        names.append(m.name)
    return sorted(names)


def test_every_module_layout_name_is_present():
    names = set(_submodules())
    for sub in ("core", "scene", "bvh", "render", "kernels", "diff",
                "dist", "tools"):
        assert f"tpu_pt_torch.{sub}" in names
    for mod in ("config", "convert", "core.vecmath", "core.intersect",
                "core.camera", "core.sampling", "core.aabb", "scene.types",
                "scene.meshes", "scene.cornell", "bvh.sah", "bvh.native",
                "bvh.cluster", "bvh.packed", "bvh.flat", "bvh.lbvh",
                "kernels.cluster_isect", "kernels.pair_scan",
                "kernels.pair_fused", "kernels.intersect",
                "kernels.packed_walk", "kernels.flat_walk", "kernels.fetch",
                "kernels.take_along", "tools.microbench_vmem_gather",
                "tools.microbench_fetch_kernel", "tools.microbench_dyngather",
                "tools.walk_windows", "tools.flat_chains", "tools.walk_edges",
                "render.envmap",
                "render.bsdf", "render.lights", "render.brute",
                "render.integrator", "render.driver", "render.wavefront",
                "render.film", "diff.params", "diff.adjoint", "cli",
                "scene.exr", "scene.obj", "scene.collada", "scene.halfedge",
                "scene.graph", "render.progressive", "render.debug",
                "render.metrics", "dist.sharding"):
        assert f"tpu_pt_torch.{mod}" in names, mod


def test_the_last_slice_names_are_present_with_the_reference_defaults():
    """The names the JAX package has and the port took last: the cluster
    BVH's traversal modes (the JAX package's ``TRAVERSAL_MODE`` is here a
    field of the BVH) and their tools, whole-step lane slicing (its
    ``STEP_SLICES`` a keyword of ``wavefront_accum``), and the
    wavefront entry points' default backend (``"bvh"``, as in the JAX
    package; ``repair_suspect_pixels`` keeps ``"cluster"``)."""
    import inspect

    from tpu_pt_torch.bvh import cluster
    from tpu_pt_torch.render import wavefront

    assert cluster.ClusterBVH._field_defaults["traversal_mode"] == "compact"
    assert cluster.TRAVERSAL_MODES == ("compact", "frontier", "pairs")
    for name in ("candidate_stats", "pairs_stats", "_seg_min", "_descend",
                 "_traverse", "_traverse_anyhit", "_descend_pairs",
                 "_traverse_pairs", "_traverse_pairs_anyhit",
                 "_flatten_live"):
        assert callable(getattr(cluster, name)), name
    assert inspect.signature(wavefront.wavefront_accum).parameters[
        "step_slices"].default == 1
    for name in ("render_wavefront", "render_wavefront_checked",
                 "render_wavefront_counts",
                 "render_wavefront_suspect_counts"):
        assert inspect.signature(getattr(wavefront, name)).parameters[
            "backend"].default == "bvh", name
    assert inspect.signature(wavefront.repair_suspect_pixels).parameters[
        "backend"].default == "cluster"


def test_fresh_import_of_every_submodule_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {_submodules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'tpu_pt', 'ml_dtypes', 'triton'))\n"
        "print('LOADED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_no_source_file_mentions_the_jax_package_in_an_import():
    pkg = os.path.dirname(tpu_pt_torch.__file__)
    for dirpath, _, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn)) as fh:
                for line in fh:
                    s = line.strip()
                    if s.startswith(("import ", "from ")):
                        head = s.split()[1].split(".")[0]
                        assert head not in ("jax", "tpu_pt", "ml_dtypes",
                                            "jaxlib"), (fn, s)


def test_command_line_renders_on_the_cpu_only_when_asked(tmp_path):
    """``python -m tpu_pt_torch.cli``: with ``--device cpu`` it writes the
    PNG and the JSON line; without it, where there is no card, it raises
    instead of falling back to the host."""
    out = str(tmp_path / "cb.png")
    cmd = [sys.executable, "-m", "tpu_pt_torch.cli", "render",
           "cornell-spheres", "-r", "16", "16", "-s", "1", "-f", out]
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["width"] == 16 and line["overflow"] == 0
    assert 0.3 < line["mean_radiance"] < 0.7
    assert open(out, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    if torch.cuda.is_available():
        return
    os.remove(out)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA" in proc.stderr
    assert proc.stdout == "" and not os.path.exists(out)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tpu_pt_torch.bvh import cluster
    from tpu_pt_torch.config import RenderConfig
    from tpu_pt_torch.render import wavefront
    from tpu_pt_torch.scene import cornell

    scene = cornell.cornell("spheres")
    cb = cluster.build_cluster_bvh(scene)
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1)
    cam = cornell.camera(8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        wavefront.render_wavefront(scene, cam, cfg, (0, 0), cb, queue=64,
                                   backend="cluster")
    with pytest.raises(RuntimeError, match="CUDA"):
        wavefront.render_wavefront_counts(scene, cam, cfg, (0, 0), cb,
                                          queue=64, backend="cluster")
    # Asked for the CPU, it runs.
    img = wavefront.render_wavefront(scene, cam, cfg, (0, 0), cb, queue=64,
                                     backend="cluster", device="cpu")
    assert tuple(img.shape) == (8, 8, 3)
    # The device builds: on the card by default, on the CPU when asked.
    from tpu_pt_torch.bvh import lbvh

    for build in (lbvh.build_lbvh, cluster.build_cluster_device):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(scene)
    assert lbvh.build_lbvh(scene, device="cpu").table.device.type == "cpu"
    cd = cluster.build_cluster_device(scene, device="cpu")
    assert cd.tiles.device.type == "cpu" and cd.top_soa is not None


def test_oracle_render_and_dense_scene_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import numpy as np

    from tpu_pt_torch import convert
    from tpu_pt_torch.config import RenderConfig
    from tpu_pt_torch.kernels.intersect import PallasScene
    from tpu_pt_torch.render import driver
    from tpu_pt_torch.scene import cornell

    scene = cornell.cornell("spheres")
    ps = PallasScene(scene)
    cfg = RenderConfig(width=8, height=8, spp=1, max_depth=1)
    cam = cornell.camera(8, 8)
    from tpu_pt_torch.bvh.sah import build_bvh

    for backend, bvh in (("brute", None), ("pallas", ps),
                         ("bvh", build_bvh(scene))):
        with pytest.raises(RuntimeError, match="CUDA"):
            driver.render(scene, cam, cfg, (0, 0), backend=backend, bvh=bvh)
        img = driver.render(scene, cam, cfg, (0, 0), backend=backend, bvh=bvh,
                            device="cpu")
        assert tuple(img.shape) == (8, 8, 3) and img.device.type == "cpu"
    d = dict(prims=np.asarray(ps.prims), n_prims=ps.n_prims)
    # torch's own refusal: AssertionError from a CPU-only build, RuntimeError
    # from a CUDA build without a device.
    with pytest.raises((RuntimeError, AssertionError)):
        convert.pallas_scene_from_numpy(d)
    assert convert.pallas_scene_from_numpy(d, "cpu").prims.device.type == "cpu"


def test_gradient_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import numpy as np

    from tpu_pt_torch import convert
    from tpu_pt_torch.bvh import cluster
    from tpu_pt_torch.config import RenderConfig
    from tpu_pt_torch.diff import adjoint, params
    from tpu_pt_torch.render import wavefront
    from tpu_pt_torch.scene import cornell

    scene = cornell.cornell("empty")
    cb = cluster.build_cluster_bvh(scene)
    cfg = RenderConfig(width=4, height=4, spp=1, direct_only=True)
    cam = cornell.camera(4, 4)
    p = {k: np.asarray(v) for k, v in params.split(scene)[0].items()}
    target = np.zeros((cfg.n_pixels, 3), np.float32)
    calls = {
        "render_flat": lambda **kw: adjoint.render_flat(scene, cam, cfg,
                                                        (0, 0), **kw),
        "render_grad": lambda **kw: adjoint.render_grad(
            p, scene, cam, cfg, (0, 0), target, **kw),
        "loss_and_grad": lambda **kw: adjoint.loss_and_grad(
            p, scene, cam, cfg, (0, 0), target, **kw),
        "loss_and_grad_wavefront": lambda **kw:
            adjoint.loss_and_grad_wavefront(p, scene, cam, cfg, (0, 0),
                                            target, cb, queue=16,
                                            steps_hint=8, **kw),
        "render_wavefront(fast=False)": lambda **kw:
            wavefront.render_wavefront(scene, cam, cfg, (0, 0), cb, queue=16,
                                       backend="cluster", fast=False, **kw),
    }
    # The distribution entry points take their device from the mesh.
    from tpu_pt_torch.dist import sharding

    mesh = lambda **kw: sharding.make_mesh(**kw)  # noqa: E731
    calls.update({
        "make_mesh": lambda **kw: mesh(**kw).device,
        "render_sharded": lambda **kw: sharding.render_sharded(
            scene, cam, cfg, (0, 0), cb, mesh(**kw), queue=16,
            backend="cluster"),
        "loss_and_grad_sharded": lambda **kw: sharding.loss_and_grad_sharded(
            p, scene, cam, cfg, (0, 0), target, cb, mesh(**kw), queue=16,
            backend="cluster"),
        "dryrun_multichip": lambda **kw: sharding.dryrun_multichip(1, **kw),
    })
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
        out = call(device="cpu")
        first = out[0] if isinstance(out, tuple) else out
        first = getattr(first, "device", first)
        assert first.type == "cpu", name
    with pytest.raises((RuntimeError, AssertionError)):
        convert.params_from_numpy(p)
    assert convert.params_from_numpy(p, "cpu")["albedo"].requires_grad


def test_kernel_sources_are_all_declared_to_the_loader(tmp_path, monkeypatch):
    """Every ``extern "C"`` launch function of csrc/*.cu has its argtypes
    set in _build.load (a missing one would pass pointers as 32-bit ints),
    and the shared header is part of the library's hash."""
    import re
    import shutil

    from tpu_pt_torch.kernels import _build

    declared = set()
    for src in _build.sources():
        with open(src) as fh:
            declared |= set(re.findall(r'extern "C" int (\w+)\(', fh.read()))
    assert declared == {"pair_tile_isect_launch", "pair_tile_isect_dedup_launch",
                        "pair_segmin_launch", "pair_ray_reduce_launch",
                        "launch_floor_launch", "dense_closest_launch",
                        "dense_anyhit_launch", "packed_walk_launch",
                        "packed_walk_window_launch", "flat_walk_launch",
                        "flat_walk_rows_launch", "flat_walk_rows_attrs",
                        "fetch_rows_launch", "fetch_rows_t_launch",
                        "fetch_fields_launch", "take_along_launch"}
    assert {os.path.basename(p) for p in _build.sources()} == {
        "pair_tile_isect.cu", "pair_tile_isect_dedup.cu", "pair_segmin.cu",
        "pair_ray_reduce.cu", "launch_floor.cu", "dense_isect.cu",
        "packed_walk.cu", "flat_walk.cu", "fetch_rows.cu", "take_along.cu"}
    with open(_build.__file__) as fh:
        loader = fh.read()
    for name in declared:
        assert f"lib.{name}.argtypes" in loader, name
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, copy)
    monkeypatch.setattr(_build, "CSRC_DIR", str(copy))
    before = _build.lib_path()
    assert before == _build.lib_path()
    with open(copy / "pair_isect_common.cuh", "a") as fh:
        fh.write("// edited\n")
    assert _build.lib_path() != before


def test_kernel_library_is_not_built_at_import_and_raises_without_nvcc():
    """No nvcc on a machine without the toolkit: asking for the library
    raises, it never falls back."""
    import shutil

    from tpu_pt_torch.kernels import _build

    assert _build._lib is None or torch.cuda.is_available()
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load()


def test_chip_smoke_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
