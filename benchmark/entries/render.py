"""Whole images back to back through the port's wavefront renderer.

Traffic (the workload file's ``traffic``): ``queue`` (the wavefront's lanes)
and ``flow``: ``"counts"`` renders each image with
``render_wavefront_counts``; ``"repair"`` runs the command line's flow,
``render_wavefront_suspect_counts`` and, where the image overflowed, the
fallback-attached ``repair_suspect_pixels`` of its suspect pixels (the
exact fallback is built in set-up).  The window's call i renders key
(seed, i).

Check: one image of the window, drawn from the seed, against the
reference's render of every pixel and its counts; in the repair flow also
every repaired image (up to ``MAX_REPAIRED`` of them, drawn from the
seed), pixel for pixel.  In the counts flow a call whose traversals
overflowed fails: ``render_wavefront_counts`` drops the truncated
candidates, and the configuration guarantees overflow 0 on every image.
In the repair flow an overflowing image is repaired, and the repair's own
overflow count (``overflow_left``) is no fault: the fallback attached
re-traces those candidates exactly.  There the counts are compared where
the drawn image did not overflow, since the counted pass of an
overflowing image is the truncated one and its repair is not counted.
"""

from __future__ import annotations

import random
import time

import torch

import checks
import program
import scenes
from reference import pathtracer as ref

MAX_REPAIRED = 2    # the repaired images judged besides the drawn one


class Entry:
    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic
        self.images, self.counts = [], []

    def setup(self) -> dict:
        from tpu_pt_torch.bvh import cluster

        spans = {}
        t = time.perf_counter()
        cfgj = self.cell.config
        self.geo, self.cam = scenes.make(cfgj)
        host = program.host_scene(self.geo, cfgj["materials"])
        cam = program.camera(self.cam)
        self.cfg = program.render_config(cfgj["render"])
        spans["scene_s"] = time.perf_counter() - t
        t = time.perf_counter()
        bvh = program.build_bvh(cfgj["bvh"], host, cam, self.cfg,
                                self.device)
        self._sync()
        spans["bvh_build_s"] = time.perf_counter() - t
        self.fallback = None
        if self.traffic["flow"] == "repair":
            t = time.perf_counter()
            self.fallback = cluster.attach_fallback(bvh, host).to(self.device)
            spans["fallback_build_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.scene = host.to(self.device)
        self.camera = cam.to(self.device)
        self.bvh = bvh.to(self.device)
        self._sync()
        spans["to_device_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self._render(program.key(self.seed, program.WARM_UP))
        self._sync()
        spans["warmup_s"] = time.perf_counter() - t
        return spans

    def _sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def _render(self, key):
        from tpu_pt_torch.render import wavefront

        kw = dict(queue=int(self.traffic["queue"]), backend="cluster",
                  device=self.device, pair_stage="fused")
        rec = {}
        if self.traffic["flow"] == "counts":
            img, nc, ns, novf, steps = wavefront.render_wavefront_counts(
                self.scene, self.camera, self.cfg, key, self.bvh, **kw)
        else:
            img, nc, ns, novf, steps, sus = \
                wavefront.render_wavefront_suspect_counts(
                    self.scene, self.camera, self.cfg, key, self.bvh, **kw)
            t = time.perf_counter()
            if novf:
                img, left = wavefront.repair_suspect_pixels(
                    self.scene, self.camera, self.cfg, key, self.fallback,
                    img, sus, **kw)
                rec["overflow_left"] = left
                rec["repaired_pixels"] = int(sus.sum())
            rec["repair_s"] = time.perf_counter() - t
        rec.update(rays=nc + ns, n_closest=nc, n_shadow=ns, overflow=novf,
                   steps=steps)
        rec["failed"] = bool(novf) and self.traffic["flow"] == "counts"
        return img, rec

    def call(self, i: int, traced: bool = False) -> dict:
        img, rec = self._render(program.key(self.seed, i))
        self.images.append(img.reshape(-1, 3).cpu())
        self.counts.append((rec["n_closest"], rec["n_shadow"],
                            rec["overflow"]))
        return rec

    def release(self):
        del self.scene, self.camera, self.bvh, self.fallback
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        cfgj = self.cell.config
        sc = ref.make_scene(self.geo, cfgj["materials"], self.device)
        acc = ref.Accel(sc.vertices, sc.tri_idx)
        cam = ref.make_camera(self.cam, self.device)

        def render(j):
            return ref.render_image(sc, acc, cam, cfgj["render"],
                                    program.key(self.seed, j))

        # The image judged, drawn from the seed among the window's, and the
        # repaired ones.
        rng = random.Random(self.seed)
        j = rng.randrange(len(self.images))
        repaired = [i for i, (_, _, novf) in enumerate(self.counts)
                    if novf and i != j and self.traffic["flow"] == "repair"]
        judged = [j] + sorted(rng.sample(repaired,
                                         min(MAX_REPAIRED, len(repaired))))
        refs = {i: render(i) for i in judged}
        nums = {"pixels_off": max(
            checks.image_numbers(self.images[i], r.radiance.cpu())
            ["pixels_off"] for i, r in refs.items())}
        nc, ns, novf = self.counts[j]
        if novf == 0 or self.traffic["flow"] == "counts":
            nums.update(checks.count_numbers(nc, ns, refs[j].n_closest,
                                             refs[j].n_shadow))
        return checks.with_limits(nums, self.cell.workload["limits"])
