"""ctypes bridge to the native C++ SAH builder (``native/bvh_builder.cpp``
at the repository root).

The shared library is compiled with ``g++`` at first use into the package's
ignored build directory (``tpu_pt_torch/_build/``).  Where it cannot be
built or loaded, ``build_leaves`` and ``build_packed`` return None and
``load_error`` keeps why (``g++``'s own error text).  The callers then build
with the Python SAH builder (``bvh/sah.py::build_bvh``), whose tree may
differ from the native one, so the switch is never silent: each fallback
taken emits one ``BuilderFallbackWarning`` that names the builder used.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np
import torch

from tpu_pt_torch.bvh.sah import build_bvh, prim_bounds
from tpu_pt_torch.scene.types import Scene, as_tensor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "bvh_builder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)
_lib = None
load_error = None   # why the last attempt to build or load failed, if it did


class BuilderFallbackWarning(UserWarning):
    """A structure was built by the Python SAH builder because the native
    library could not be built or loaded."""


def warn_fallback(what: str) -> None:
    """One warning for one fallback taken: ``what`` was built by the Python
    SAH builder instead of the native one, and why."""
    warnings.warn(
        f"{what} built by the Python SAH builder (bvh/sah.py::build_bvh): "
        f"the native builder is unavailable ({load_error}); the tree may "
        "differ from the native builder's", BuilderFallbackWarning,
        stacklevel=3)


def available() -> bool:
    """Whether the native library can be built (if need be) and loaded."""
    return _load() is not None


def lib_path() -> str:
    """Build-directory path of the library, keyed by the source's content."""
    with open(_SRC, "rb") as fh:
        tag = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libbvh_{tag}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building {_SRC}:\n{proc.stderr}")
    os.replace(tmp, path)   # atomic: concurrent builders never load a partial file


def _load():
    """The loaded library, built first if its file is missing; None where
    either fails (``load_error`` says why)."""
    global _lib, load_error
    if _lib is None:
        try:
            path = lib_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError) as e:
            load_error = str(e)
            return None
        lib.bvh_build.restype = ctypes.c_void_p
        lib.bvh_build.argtypes = [_FP, _FP, ctypes.c_int, ctypes.c_int, _IP]
        lib.bvh_emit.restype = None
        lib.bvh_emit.argtypes = [ctypes.c_void_p, _FP, _IP]
        lib.bvh_count_leaves.restype = ctypes.c_int
        lib.bvh_count_leaves.argtypes = [ctypes.c_void_p]
        lib.bvh_emit_leaves.restype = None
        lib.bvh_emit_leaves.argtypes = [ctypes.c_void_p, _FP, _FP, _IP, _IP,
                                        _IP]
        _lib = lib
    return _lib


def prim_rows(scene: Scene, pid) -> torch.Tensor:
    """Packed 16-wide primitive rows for the primitives ``pid``: triangle
    ``[v0, e1, e2, mat bits, 0, pad]``, sphere ``[centre, r, 0 0, 0 0 0, mat
    bits, 1.0, pad]``.  Column 9 holds the int32 material id's BIT PATTERN
    viewed as f32 (often a denormal): it is carried, never computed on.
    Column 10 is the type.  On the device of the scene's tensors, or on the
    CPU where it holds host arrays (``.numpy()`` them)."""
    v = as_tensor(scene.vertices).detach()
    ti = as_tensor(scene.tri_idx).long()
    pid = torch.as_tensor(pid, device=v.device).long()
    n_tris = ti.shape[0]
    rows = torch.zeros((pid.shape[0], 16), dtype=torch.float32,
                       device=v.device)
    is_tri = pid < n_tris
    tg = pid[is_tri]
    v0 = v[ti[tg, 0]]
    rows[is_tri, 0:3] = v0
    rows[is_tri, 3:6] = v[ti[tg, 1]] - v0
    rows[is_tri, 6:9] = v[ti[tg, 2]] - v0
    rows[is_tri, 9] = as_tensor(scene.tri_mat)[tg].to(
        torch.int32).view(torch.float32)
    sg = pid[~is_tri] - n_tris
    rows[~is_tri, 0:3] = as_tensor(scene.sph_center).detach()[sg]
    rows[~is_tri, 3] = as_tensor(scene.sph_radius).detach()[sg]
    rows[~is_tri, 9] = as_tensor(scene.sph_mat)[sg].to(
        torch.int32).view(torch.float32)
    rows[~is_tri, 10] = 1.0
    return rows


def _build_tree(lib, scene: Scene, max_leaf: int):
    """Run the native SAH build over the scene's primitive bounds.  Returns
    (handle, primitive count, node count); the handle is freed by the one
    emit call that follows (``bvh_emit`` or ``bvh_emit_leaves``)."""
    lo, hi = (x.numpy() for x in prim_bounds(scene))
    n_nodes = ctypes.c_int(0)
    handle = lib.bvh_build(lo.ctypes.data_as(_FP), hi.ctypes.data_as(_FP),
                           lo.shape[0], max_leaf, ctypes.byref(n_nodes))
    return handle, lo.shape[0], n_nodes.value


def build_leaves(scene: Scene, max_leaf: int):
    """Native SAH build -> (start, count, lo, hi, prim_perm) leaf arrays in
    DFS order (the cluster-BVH host build); None where the library cannot
    be built or loaded."""
    lib = _load()
    if lib is None:
        return None
    handle, n, _ = _build_tree(lib, scene, max_leaf)
    n_leaves = lib.bvh_count_leaves(ctypes.c_void_p(handle))
    l_lo = np.empty((n_leaves, 3), np.float32)
    l_hi = np.empty((n_leaves, 3), np.float32)
    start = np.empty((n_leaves,), np.int32)
    count = np.empty((n_leaves,), np.int32)
    perm = np.empty((n,), np.int32)
    lib.bvh_emit_leaves(
        ctypes.c_void_p(handle), l_lo.ctypes.data_as(_FP),
        l_hi.ctypes.data_as(_FP), start.ctypes.data_as(_IP),
        count.ctypes.data_as(_IP), perm.ctypes.data_as(_IP))
    return start, count, l_lo, l_hi, perm


def build_packed(scene: Scene, max_leaf: int = 4):
    """Native SAH build -> ``bvh.packed.PackedBVH`` (host numpy): the eight
    octant-ordered node tables and the primitive rows in leaf order.  None
    where the library cannot be built or loaded, as ``build_leaves``."""
    from tpu_pt_torch.bvh.packed import PackedBVH

    lib = _load()
    if lib is None:
        return None
    handle, n, n_nodes = _build_tree(lib, scene, max_leaf)
    nodes = np.empty((8, n_nodes, 8), np.float32)
    perm = np.empty((n,), np.int32)
    lib.bvh_emit(ctypes.c_void_p(handle), nodes.ctypes.data_as(_FP),
                 perm.ctypes.data_as(_IP))
    return PackedBVH.build(nodes=nodes, prims=prim_rows(scene, perm).numpy(),
                           prim_gid=perm, max_leaf=max_leaf)


def build_packed_any(scene: Scene, max_leaf: int = 4):
    """``build_packed``, or where the library is unavailable the Python
    path ``packed.pack_bvh(sah.build_bvh(scene, max_leaf))``, with a
    ``BuilderFallbackWarning``."""
    out = build_packed(scene, max_leaf)
    if out is not None:
        return out
    from tpu_pt_torch.bvh.packed import pack_bvh

    warn_fallback("the packed BVH")
    return pack_bvh(build_bvh(scene, max_leaf), scene, max_leaf)
