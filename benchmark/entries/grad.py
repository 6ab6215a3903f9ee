"""An inverse-rendering loop: gradient steps back to back through the
port's differentiable wavefront.

Each call is one step: the two calls ``loss_and_grad_wavefront`` makes
(``wavefront_loss``, the forward through the differentiable loop with its
recomputed chunks, then ``torch.autograd.grad``), made here because that
entry does not return the forward's ray counts; then a plain SGD step on
the materials' albedo, roughness and emission and the lights' radiance.
The vertices get their gradient and do not move (moving them would need a
BVH rebuild).  The window's step i takes key (seed, i); the target image
and the starting materials are drawn from the seed (traffic:
``queue``, ``lr``, ``target_scale``, ``albedo_jitter``).

Check (the training rule): the reference follows the window's first three
steps from the same start, and the steps' losses, the first step's
gradient of every leaf and each moved leaf's change after three steps are
compared by their norms.
"""

from __future__ import annotations

import time

import torch

import checks
import program
import scenes
from reference import pathtracer as ref

MOVED = ("albedo", "roughness", "emission", "light_radiance")
FOLLOWED = 3     # the steps the reference follows


class Entry:
    def __init__(self, cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, device
        self.traffic = cell.traffic
        self.losses, self.first_grad, self.start, self.after = [], None, None, None

    def setup(self) -> dict:
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
        t = time.perf_counter()
        self.scene = host.to(self.device)
        self.camera = cam.to(self.device)
        self.bvh = bvh.to(self.device)
        self._sync()
        spans["to_device_s"] = time.perf_counter() - t
        self.inputs()
        self.params = {k: v.clone() for k, v in self.start.items()}
        t = time.perf_counter()
        self._step(program.key(self.seed, program.WARM_UP), update=False)
        self._sync()
        spans["warmup_s"] = time.perf_counter() - t
        return spans

    def inputs(self):
        """The starting parameters and the target, made from the
        configuration and drawn from the seed on the device: each
        material's albedo jittered by up to ``albedo_jitter`` of itself,
        the rest as the configuration has them; the target uniform in [0,
        ``target_scale``).  Sets ``start`` and ``target``."""
        cfgj, dev = self.cell.config, self.device
        g = program.seeded(self.seed, dev)
        r = cfgj["render"]
        self.target = float(self.traffic["target_scale"]) * torch.rand(
            (r["width"] * r["height"], 3), generator=g, device=dev)

        def rows(key, default):
            return torch.tensor([m.get(key, default)
                                 for m in cfgj["materials"]],
                                dtype=torch.float32, device=dev)

        alb = rows("albedo", (0.5, 0.5, 0.5))
        jit = float(self.traffic["albedo_jitter"])
        alb = alb * (1.0 + jit * (2.0 * torch.rand(
            alb.shape, generator=g, device=dev) - 1.0))
        self.start = {
            "vertices": torch.as_tensor(self.geo["vertices"]).to(dev),
            "albedo": alb, "roughness": rows("roughness", 0.0),
            "emission": rows("emission", (0.0, 0.0, 0.0)),
            "light_radiance": torch.tensor(
                [lt["radiance"] for lt in self.geo["lights"]],
                dtype=torch.float32, device=dev)}

    def _sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def _step(self, key, update: bool = True, traced: bool = False):
        from tpu_pt_torch.diff.adjoint import wavefront_loss

        rec = {}
        if traced and self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        t0 = time.perf_counter()
        loss, _, (nc, ns, novf, steps), done = wavefront_loss(
            leaves, self.scene, self.camera, self.cfg, key, self.target,
            self.bvh, backend="cluster", queue=int(self.traffic["queue"]),
            pair_stage="fused", remat=None)
        if traced:
            self._sync()
        t1 = time.perf_counter()
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
        grads = {k: torch.zeros_like(x) if g is None else g
                 for (k, x), g in zip(leaves.items(), gs)}
        if traced:
            self._sync()
        t2 = time.perf_counter()
        if update:
            lr = float(self.traffic["lr"])
            with torch.no_grad():
                for k in MOVED:
                    self.params[k] = self.params[k] - lr * grads[k]
        rec.update(loss=float(loss.detach()), n_closest=int(nc), n_shadow=int(ns),
                   overflow=int(novf), steps=int(steps), done=bool(done))
        rec["rays"] = rec["n_closest"] + rec["n_shadow"]
        # The configuration guarantees overflow 0: a forward whose
        # traversals dropped candidates is not the step it claims to be.
        rec["failed"] = not done or rec["overflow"] > 0
        if traced:
            rec["fwd_s"], rec["bwd_s"] = t1 - t0, t2 - t1
            if self.device != "cpu":
                rec["step_mem_bytes"] = torch.cuda.max_memory_allocated() - base
        return rec, grads

    def call(self, i: int, traced: bool = False) -> dict:
        rec, grads = self._step(program.key(self.seed, i), traced=traced)
        if i < FOLLOWED:
            self.losses.append(rec["loss"])
        if i == 0:
            self.first_grad = {k: v.detach().cpu() for k, v in grads.items()}
        if i == FOLLOWED - 1:
            self.after = {k: self.params[k].detach().cpu() for k in MOVED}
        return rec

    def release(self):
        self.start = {k: v.detach().cpu() for k, v in self.start.items()}
        self.target = self.target.cpu()
        del self.scene, self.camera, self.bvh, self.params
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float32, keep=None) -> dict:
        """The reference's first ``FOLLOWED`` steps from the same start:
        {"loss", "grad", "change"}.  ``keep`` leaves pixels out of its loss
        (a planted fault of the control)."""
        sc = ref.make_scene(self.geo, self.cell.config["materials"],
                            self.device, dtype)
        acc = ref.Accel(sc.vertices, sc.tri_idx)
        cam = ref.make_camera(self.cam, self.device, dtype)
        target = self.target.to(self.device, dtype)
        p = {k: v.to(self.device, dtype) for k, v in self.start.items()}
        lr = float(self.traffic["lr"])
        out = {"loss": []}
        for i in range(FOLLOWED):
            loss, g = ref.loss_and_grad(sc, p, acc, cam,
                                        self.cell.config["render"],
                                        program.key(self.seed, i), target,
                                        keep=keep)
            out["loss"].append(loss)
            if i == 0:
                out["grad"] = {k: v.float().cpu() for k, v in g.items()}
            p = {k: (v - lr * g[k] if k in MOVED else v).detach()
                 for k, v in p.items()}
        out["change"] = {k: (p[k].float().cpu() - self.start[k].float())
                         for k in MOVED}
        return out

    def check(self) -> dict:
        prog = {"loss": self.losses, "grad": self.first_grad,
                "change": {k: self.after[k] - self.start[k] for k in MOVED}}
        nums = checks.training_numbers(prog, self.reference())
        return checks.with_limits(nums, self.cell.workload["limits"])
