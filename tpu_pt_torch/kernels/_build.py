"""Build and load the package's CUDA kernel library.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together), links the objects into one shared library
with a plain C interface under ``tpu_pt_torch/_build/`` and loads it with
``ctypes``.  The library's name carries a hash of the sources (``*.cu`` and
the ``*.cuh`` they include) and flags, so an edit rebuilds and an unchanged
tree reuses the file.  Nothing here is
imported or built at module import; a failure to find ``nvcc``, to compile
or to load raises.

``-fmad=false`` (and no fast-math): every FP32 operation rounds once, as
the plain PyTorch versions of the kernels do, so the two can be compared
bit for bit.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]
_lib = None
build_log = ""   # nvcc's output from the build this process made, if any
_sm_count = {}   # device index -> number of SMs


def sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    exe = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(exe):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of tpu_pt_torch are compiled "
            "on the machine that holds the card")
    return exe


def lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libtpu_pt_kernels_{h.hexdigest()[:12]}.so")


def build(path: str, verbose_ptxas: bool = False) -> None:
    """Compile every source in parallel, then link into ``path``."""
    global build_log
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    flags = NVCC_FLAGS + (["-Xptxas", "-v"] if verbose_ptxas else [])
    tag = f"{os.path.basename(path)}.{os.getpid()}"
    procs = []
    for src in sources():
        obj = os.path.join(
            BUILD_DIR, f"{tag}.{os.path.basename(src)[:-3]}.o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *flags, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(src)
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{build_log}")
    tmp = os.path.join(BUILD_DIR, f"{tag}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in procs)],
        capture_output=True, text=True)
    for _, obj, _ in procs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, path)


def load(verbose_ptxas: bool = False):
    """The loaded library (built first if its file is missing)."""
    global _lib
    if _lib is None:
        path = lib_path()
        if not os.path.exists(path):
            build(path, verbose_ptxas=verbose_ptxas)
        lib = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.pair_tile_isect_launch.restype = ci
        lib.pair_tile_isect_launch.argtypes = [vp, vp, vp, vp, ci, ci, vp]
        lib.pair_tile_isect_dedup_launch.restype = ci
        lib.pair_tile_isect_dedup_launch.argtypes = [vp] * 4 + [ci] * 4 + [vp]
        lib.pair_segmin_launch.restype = ci
        lib.pair_segmin_launch.argtypes = [vp] * 10 + [ci, vp]
        lib.pair_ray_reduce_launch.restype = ci
        lib.pair_ray_reduce_launch.argtypes = (
            [vp] * 16 + [ci, ctypes.c_longlong, ci, ci, ci, ci, vp])
        lib.launch_floor_launch.restype = ci
        lib.launch_floor_launch.argtypes = [ci, ci, vp]
        lib.dense_closest_launch.restype = ci
        lib.dense_closest_launch.argtypes = [vp] * 6 + [ci, ci, vp]
        lib.dense_anyhit_launch.restype = ci
        lib.dense_anyhit_launch.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.packed_walk_launch.restype = ci
        lib.packed_walk_launch.argtypes = [vp] * 11 + [ci] * 6 + [vp]
        lib.packed_walk_window_launch.restype = ci
        lib.packed_walk_window_launch.argtypes = [vp] * 11 + [ci] * 6 + [vp]
        lib.flat_walk_launch.restype = ci
        lib.flat_walk_launch.argtypes = [vp] * 19 + [ci] * 7 + [vp]
        lib.flat_walk_rows_launch.restype = ci
        lib.flat_walk_rows_launch.argtypes = [vp] * 15 + [ci] * 6 + [vp]
        lib.flat_walk_rows_attrs.restype = ci
        lib.flat_walk_rows_attrs.argtypes = [ci, ci] + [
            ctypes.POINTER(ci)] * 3
        lib.fetch_rows_launch.restype = ci
        lib.fetch_rows_launch.argtypes = (
            [vp] * 3 + [ci, ci, ctypes.c_longlong] + [ci] * 4 + [vp])
        lib.fetch_fields_launch.restype = ci
        lib.fetch_fields_launch.argtypes = (
            [vp] * 3 + [ci, ci, ctypes.c_longlong] + [ci] * 3 + [vp])
        lib.fetch_rows_t_launch.restype = ci
        lib.fetch_rows_t_launch.argtypes = [vp] * 3 + [ci] * 4 + [vp]
        lib.take_along_launch.restype = ci
        lib.take_along_launch.argtypes = [vp] * 4 + [ci] * 6 + [vp]
        _lib = lib
    return _lib


def sm_count(device) -> int:
    """Number of SMs of the CUDA ``device`` (asked once per device)."""
    import torch

    n = _sm_count.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_count[device.index] = n
    return n


def refuse_grad(kernel: str, **tensors) -> None:
    """Raise if any of ``tensors`` requires grad.  The kernels and their
    plain versions take no part in autograd (the differentiable renderers
    run every traversal on detached inputs), so a missing detach must fail
    here rather than silently cut a gradient."""
    for name, x in tensors.items():
        if getattr(x, "requires_grad", False):
            raise ValueError(f"{kernel}: {name} requires grad; traversal "
                             "kernels take detached inputs only")


def check_cuda_input(name: str, x, dtype, shape=None) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given; None entries are free) that does not require
    grad (checked first)."""
    refuse_grad("check_cuda_input", **{name: x})
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None:
        if x.dim() != len(shape) or any(
                s is not None and s != d for s, d in zip(shape, x.shape)):
            raise ValueError(
                f"{name}: expected shape {shape}, got {tuple(x.shape)}")
