"""The program's side of a cell: the benchmark's inputs handed to
``tpu_pt_torch`` through its public constructors, and its BVH built as the
configuration says."""

from __future__ import annotations

_M32 = 0xFFFFFFFF
WARM_UP = -1    # the index of the key of the set-up's warm-up call


def key(seed: int, i: int):
    """The key of the window's call ``i``: two 32-bit words, the seed's
    (folded to 32 bits) and the call's index."""
    return ((seed ^ (seed >> 32)) & _M32, i & _M32)


def host_scene(geo: dict, materials: list):
    """The port's host scene (it derives the vertex normals itself)."""
    from tpu_pt_torch.scene.types import make_lights, make_materials, make_scene

    return make_scene(vertices=geo["vertices"], tri_idx=geo["tri_idx"],
                      tri_mat=geo["tri_mat"],
                      materials=make_materials(materials),
                      lights=make_lights(geo["lights"]))


def camera(cam):
    from tpu_pt_torch.core.camera import Camera

    return Camera(*cam)


def render_config(r: dict):
    from tpu_pt_torch.config import RenderConfig

    return RenderConfig(
        width=r["width"], height=r["height"], spp=r["spp"],
        max_depth=r["max_depth"], ns_area_light=r.get("ns_area_light", 1),
        rr_start=r["rr_start"], rr_prob=r["rr_prob"], dtype=r["dtype"],
        eps=r.get("eps", 1e-4))


def build_bvh(spec: dict, scene, cam, cfg, device):
    """The cluster BVH the configuration names: ``"sah_cluster"`` (the host
    SAH build at its default capacities) or ``"autotune"`` (the command
    line's ``--autotune --queue Q``: capacities sized from probe runs of
    the wavefront, no fallback attached)."""
    from tpu_pt_torch.bvh import cluster

    if spec["build"] == "sah_cluster":
        return cluster.build_cluster_bvh(scene)
    if spec["build"] == "autotune":
        return cluster.autotune_for_render(
            scene, cam, cfg, queue=int(spec["queue"]), exact_fallback=False,
            device=device)
    raise ValueError(f"unknown BVH build {spec['build']!r}")


def seeded(seed: int, device):
    """A generator on ``device`` seeded from the run's seed."""
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    return g
