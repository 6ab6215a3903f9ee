"""Carry scenes, cluster BVHs, packed and flat BVHs, dense-sweep scenes,
cameras and differentiable parameters across as plain dicts of numpy arrays
(plus static ints / tuples) and rebuild the port's containers on a given
device.  The dict keys are the containers' field names; nothing here knows
where the arrays came from."""

from __future__ import annotations

import numpy as np
import torch

from tpu_pt_torch.bvh.cluster import ClusterBVH, make_cluster_bvh
from tpu_pt_torch.bvh.packed import PackedBVH
from tpu_pt_torch.bvh.sah import FlatBVH
from tpu_pt_torch.core.camera import Camera
from tpu_pt_torch.diff.params import KEYS as PARAM_KEYS
from tpu_pt_torch.kernels.intersect import PallasScene
from tpu_pt_torch.scene.types import Lights, Materials, Scene


def _np(x, dtype):
    # A writable copy: tensors made from it must not alias a read-only buffer.
    return np.array(x, dtype=dtype, order="C")


def scene_from_numpy(d: dict, device="cuda") -> Scene:
    """d: Scene field names -> arrays, with ``materials`` and ``lights`` as
    nested dicts of their field names."""
    f32, i32 = np.float32, np.int32
    mat = d["materials"]
    lig = d["lights"]
    scene = Scene(
        vertices=_np(d["vertices"], f32), normals=_np(d["normals"], f32),
        tri_idx=_np(d["tri_idx"], i32), tri_mat=_np(d["tri_mat"], i32),
        sph_center=_np(d["sph_center"], f32),
        sph_radius=_np(d["sph_radius"], f32), sph_mat=_np(d["sph_mat"], i32),
        materials=Materials(
            kind=_np(mat["kind"], i32), albedo=_np(mat["albedo"], f32),
            emission=_np(mat["emission"], f32), ior=_np(mat["ior"], f32),
            roughness=_np(mat["roughness"], f32)),
        lights=Lights(
            kind=_np(lig["kind"], i32), position=_np(lig["position"], f32),
            edge_x=_np(lig["edge_x"], f32), edge_y=_np(lig["edge_y"], f32),
            normal=_np(lig["normal"], f32), radiance=_np(lig["radiance"], f32)),
        env_map=_np(d["env_map"], f32),
        env_marg_cdf=_np(d["env_marg_cdf"], f32),
        env_cond_cdf=_np(d["env_cond_cdf"], f32),
    )
    return scene.to(device)


def cluster_bvh_from_numpy(d: dict, device="cuda") -> ClusterBVH:
    """d: ``levels`` (list of (N_l, 8) f32), ``tiles``, ``tile_gid``, the
    static ``frontiers``, ``k_leaf``, ``pair_budget``, ``pair_mults`` (3 or
    4 entries) and optionally ``levels16`` as uint16 bf16 bit patterns
    (derived from ``levels`` when absent)."""
    levels16 = d.get("levels16")
    if levels16 is not None:
        levels16 = [_np(lv, np.uint16) for lv in levels16]
    cb = make_cluster_bvh(
        [_np(lv, np.float32) for lv in d["levels"]],
        _np(d["tiles"], np.float32), _np(d["tile_gid"], np.int32),
        tuple(int(f) for f in d["frontiers"]), int(d["k_leaf"]),
        int(d["pair_budget"]), pair_mults=tuple(d["pair_mults"]),
        levels16=levels16)
    return cb.to(device)


def packed_bvh_from_numpy(d: dict, device="cuda") -> PackedBVH:
    """d: ``table`` ((n_tables * n_nodes + P, 16) f32), ``prim_gid`` ((P,)
    i32) and the static ``max_leaf``, ``n_tables``, ``n_nodes``."""
    return PackedBVH(table=_np(d["table"], np.float32),
                     prim_gid=_np(d["prim_gid"], np.int32),
                     max_leaf=int(d["max_leaf"]), n_tables=int(d["n_tables"]),
                     n_nodes=int(d["n_nodes"])).to(device)


def flat_bvh_from_numpy(d: dict, device="cuda") -> FlatBVH:
    """d: ``node_min``, ``node_max`` ((N, 3) f32), ``skip``, ``prim_start``,
    ``prim_count`` ((N,) i32) and ``prim_ids`` ((P,) i32)."""
    f32, i32 = np.float32, np.int32
    return FlatBVH(node_min=_np(d["node_min"], f32),
                   node_max=_np(d["node_max"], f32), skip=_np(d["skip"], i32),
                   prim_start=_np(d["prim_start"], i32),
                   prim_count=_np(d["prim_count"], i32),
                   prim_ids=_np(d["prim_ids"], i32)).to(device)


def camera_from_numpy(d: dict, device="cuda") -> Camera:
    """d: ``c2w`` (3, 3), ``origin`` (3,), ``hfov``, ``vfov`` (degrees)."""
    return Camera(c2w=_np(d["c2w"], np.float32),
                  origin=_np(d["origin"], np.float32),
                  hfov=np.float32(d["hfov"]),
                  vfov=np.float32(d["vfov"])).to(device)


def pallas_scene_from_numpy(d: dict, device="cuda") -> PallasScene:
    """d: ``prims`` ((P, 16) f32 rows, P a multiple of 128) and ``n_prims``
    (the count of real rows)."""
    return PallasScene(prims=_np(d["prims"], np.float32),
                       n_prims=int(d["n_prims"])).to(device)


def params_from_numpy(d: dict, device="cuda") -> dict:
    """d: the differentiable parameters by ``diff.params.KEYS`` name
    (``vertices`` (V, 3), ``albedo`` (M, 3), ``roughness`` (M,),
    ``emission`` (M, 3), ``light_radiance`` (L, 3)) -> leaf f32 tensors on
    ``device`` with ``requires_grad=True``."""
    return {k: torch.from_numpy(_np(d[k], np.float32)).to(device)
            .requires_grad_(True) for k in PARAM_KEYS}
