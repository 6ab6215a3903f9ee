"""Structured render metrics: scene and BVH statistics, the wavefront
queue's occupancy step by step, and a JSON record of one render (config,
statistics, phase timings).  Host arrays or tensors in; plain Python values
out.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import torch

from tpu_pt_torch.config import RenderConfig


def _nbytes(x) -> int:
    """Bytes of an array or tensor, summed over nested NamedTuples."""
    if hasattr(x, "_fields"):
        return sum(_nbytes(y) for y in x)
    if torch.is_tensor(x):
        return x.numel() * x.element_size()
    return int(x.nbytes)


def scene_stats(scene) -> dict:
    return dict(
        tris=int(scene.n_tris),
        spheres=int(scene.n_spheres),
        vertices=int(scene.vertices.shape[0]),
        lights=int(scene.lights.count),
        materials=int(scene.materials.kind.shape[0]),
        scene_bytes=_nbytes(scene),
    )


def bvh_stats(packed) -> dict:
    return dict(
        nodes=int(packed.n_nodes),
        tables=int(packed.n_tables),
        max_leaf=int(packed.max_leaf),
        table_bytes=_nbytes(packed.table),
    )


@torch.no_grad()
def queue_occupancy(scene, cam, cfg: RenderConfig, key, bvh,
                    queue: int = 4096, backend: str = "packed",
                    device="cuda") -> dict:
    """Run the wavefront step for the loop's static step bound
    (``wavefront.n_steps``), recording the live lanes after each step: the
    compacted queue's size per step."""
    from tpu_pt_torch.render.driver import _intersectors_counted, _on_device
    from tpu_pt_torch.render.wavefront import _step, init_queue, n_steps

    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    Q = min(queue, cfg.n_pixels * cfg.spp)
    steps = n_steps(cfg, Q)
    intersect_fn, occluded_fn = _intersectors_counted(backend, bvh)
    st = init_queue(Q, cfg.n_pixels, device, spp_count=cfg.spp)
    occ = []
    for _ in range(steps):
        st, _counts = _step(scene, cam, cfg, key, intersect_fn, occluded_fn,
                            st, 0, cfg.n_pixels, 0, cfg.spp)
        occ.append(torch.sum(st.alive))
    occ = [int(x) for x in torch.stack(occ).cpu()]
    return dict(
        queue=Q,
        steps=int(steps),
        occupancy=occ,
        mean_occupancy=float(sum(occ) / len(occ) / Q),
    )


@dataclass
class RenderReport:
    """Accumulates one render's observability record."""

    cfg: RenderConfig
    scene_info: dict = field(default_factory=dict)
    bvh_info: dict = field(default_factory=dict)
    timings: dict = field(default_factory=dict)
    t0: float = field(default_factory=time.time)

    def phase(self, name: str):
        rep = self

        class _Timer:
            def __enter__(self):
                self.t = time.time()

            def __exit__(self, *a):
                rep.timings[name] = round(time.time() - self.t, 4)

        return _Timer()

    def to_json(self, **extra) -> str:
        return json.dumps(dict(
            config=json.loads(self.cfg.to_json()),
            scene=self.scene_info,
            bvh=self.bvh_info,
            timings=self.timings,
            wall_s=round(time.time() - self.t0, 3),
            **extra,
        ))
