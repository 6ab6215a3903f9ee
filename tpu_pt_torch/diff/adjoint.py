"""Differentiable rendering: detached-sampling reparameterized gradients.

Gradients of an image, or of an L2 loss on it, with respect to the scene's
parameters (``diff/params.py``: vertices, albedo, roughness, emission,
light radiance).

Estimator scope, as in the JAX package:
  - Every Monte-Carlo sampling decision (pixel jitter, light-sample
    uniforms, BSDF lobe choice and direction, Russian roulette) is
    detached: the integrand is differentiated, the sampler is not.  That
    gives unbiased gradients of the expected radiance for every parameter
    dependence that is continuous in the integrand:
      * albedo, roughness, emission, light radiance: fully;
      * vertex positions: through the hit point recomputed from the
        detached barycentrics, p = (1-u-v)·v0 + u·v1 + v·v2, the shading
        normals, the light-sample geometry and the BSDF.
  - Visibility is not differentiated (no edge sampling): gradients flow
    through the shading geometry, not through occlusion boundaries.
  - No traversal is differentiated.  Every intersector call runs under
    ``torch.no_grad()`` on detached rays; autograd keeps only its hit and
    occlusion records, and backward launches no kernel.

Each entry point takes ``device`` (default ``"cuda"``; raises without a
card) and ``use_kernels`` as the renderers do.  The functions that return
gradients take the parameters as values: they make leaf tensors of them on
``device`` and return the gradients as a dict with the same keys.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pt_torch.config import RenderConfig
from tpu_pt_torch.diff.params import merge
from tpu_pt_torch.render.driver import _intersectors, _on_device
from tpu_pt_torch.render.integrator import render_chunk
from tpu_pt_torch.render.wavefront import wavefront_accum
from tpu_pt_torch.scene.types import Scene


def _render_flat(scene: Scene, cam, cfg: RenderConfig, key, backend, bvh,
                 use_kernels):
    isect, occl = _intersectors(backend, bvh, use_kernels)
    dev = scene.vertices.device
    pixel_ids = torch.arange(cfg.n_pixels, device=dev).repeat_interleave(
        cfg.spp)
    sample_ids = torch.arange(cfg.spp, device=dev).repeat(cfg.n_pixels)
    L = render_chunk(scene, cam, cfg, key, pixel_ids, sample_ids, isect, occl)
    return L.reshape(cfg.n_pixels, cfg.spp, 3).mean(dim=1)


def render_flat(scene: Scene, cam, cfg: RenderConfig, key,
                backend: str = "brute", bvh=None, device="cuda",
                use_kernels: bool = True):
    """Differentiable whole-image render -> (n_pixels, 3) on ``device``.

    One pass of the unrolled integrator over every (pixel, sample) at once,
    so autograd sees the whole image; meant for the small images a
    gradient check uses (the wavefront loop is the large-image path:
    :func:`loss_and_grad_wavefront`).  ``backend`` is ``"brute"``,
    ``"pallas"`` (``bvh`` a ``PallasScene``), ``"cluster"`` or
    ``"packed"``.  The image carries the graph back to whatever tensors of
    ``scene`` require grad."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    return _render_flat(scene, cam, cfg, key, backend, bvh, use_kernels)


def _f32(x, device):
    """A tensor or an array as an f32 tensor on ``device`` (an array is
    copied: it may be read-only)."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32)


def _leaves(params, device):
    """Fresh leaf tensors of ``params`` on ``device`` that require grad."""
    return {k: _f32(v, device).detach().requires_grad_(True)
            for k, v in params.items()}


def _grads(out, leaves, grad_out=None):
    """d(out)/d(leaves) as a dict; a parameter ``out`` does not reach gets
    zeros."""
    gs = torch.autograd.grad(out, list(leaves.values()), grad_out,
                             allow_unused=True)
    return {k: torch.zeros_like(x) if g is None else g
            for (k, x), g in zip(leaves.items(), gs)}


def render_grad(params, scene: Scene, cam, cfg: RenderConfig, key, grad_image,
                backend: str = "brute", bvh=None, device="cuda",
                use_kernels: bool = True):
    """Pull a cotangent image back onto the parameters.

    grad_image: (n_pixels, 3), e.g. dLoss/dPixel.  Returns (image, grads):
    the :func:`render_flat` image (detached) and a dict matching
    ``params``."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    leaves = _leaves(params, device)
    img = _render_flat(merge(leaves, scene), cam, cfg, key, backend, bvh,
                       use_kernels)
    return img.detach(), _grads(img, leaves, _f32(grad_image, device))


def loss_and_grad(params, scene: Scene, cam, cfg: RenderConfig, key, target,
                  backend: str = "brute", bvh=None, device="cuda",
                  use_kernels: bool = True):
    """Inverse-rendering step on :func:`render_flat`: the L2 image loss
    ``mean((img - target)²)`` and its parameter gradients.  target:
    (n_pixels, 3).  Returns (loss (0-d tensor), grads dict)."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    leaves = _leaves(params, device)
    img = _render_flat(merge(leaves, scene), cam, cfg, key, backend, bvh,
                       use_kernels)
    loss = torch.mean((img - _f32(target, device)) ** 2)
    return loss.detach(), _grads(loss, leaves)


def wavefront_loss(params, scene: Scene, cam, cfg: RenderConfig, key, target,
                   bvh, backend: str = "cluster", queue: int = 1 << 14,
                   steps_hint=None, use_kernels: bool = True,
                   pair_stage: str = "fused", remat=None):
    """The forward half of :func:`loss_and_grad_wavefront`, for tensors
    already on one device: ``params`` (tensors that require grad, or not)
    are merged into ``scene`` and the image renders through the
    differentiable wavefront loop.  Returns (loss, image (n_pixels, 3),
    (n_closest, n_shadow, n_overflow, steps_run), done); loss and image
    carry the graph back to ``params``.  ``remat`` as
    :func:`loss_and_grad_wavefront`'s.  ``cfg.debug_checks`` is ignored,
    as the JAX package's ``loss_and_grad_wavefront`` ignores it: no check
    runs under its gradient."""
    accum, counts, done = wavefront_accum(
        merge(params, scene), cam, cfg.replace(debug_checks=False), key, bvh,
        queue, backend, 0, cfg.n_pixels, with_counts=True,
        use_kernels=use_kernels, pair_stage=pair_stage, differentiable=True,
        steps_hint=steps_hint, with_done=True, remat=remat)
    img = accum / cfg.spp
    return torch.mean((img - target) ** 2), img, counts, done


def loss_and_grad_wavefront(params, scene: Scene, cam, cfg: RenderConfig,
                            key, target, bvh, backend: str = "cluster",
                            queue: int = 1 << 14, steps_hint=None,
                            device="cuda", use_kernels: bool = True,
                            pair_stage: str = "fused", remat=None):
    """Differentiable step through the production path: the wavefront loop
    on ``backend`` (the cluster BVH by default) with the L2 loss
    ``mean((img - target)²)``.  target: (n_pixels, 3).

    The eager loop leaves as soon as the sample budget is spent, under
    autograd too.  Past 16 steps it runs in chunks of about sqrt(steps)
    steps, each recomputed in backward from its lanes at its start and the
    traversal records the forward kept (``remat=None``, the JAX package's
    √steps-chunked rematerialization): the tape holds the records of every
    step (about 0.1 MB a step at queue 4096), the lanes at each chunk
    boundary and one chunk's shading, O(sqrt(steps) x queue), so a 1024²
    gradient fits on one card.  ``remat=False`` is the twin that keeps
    every step's shading on the tape (memory grows with steps x queue), the
    same loss and gradients bit for bit.  ``steps_hint`` caps the loop as
    the JAX package's static scan length does; with a hint the result is
    (loss, grads, done), and done=False means the hint was too small and
    samples were dropped (redo without it).  Without one it is (loss,
    grads)."""
    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    leaves = _leaves(params, device)
    loss, _, _, done = wavefront_loss(
        leaves, scene, cam, cfg, key, _f32(target, device), bvh, backend,
        queue, steps_hint, use_kernels, pair_stage, remat)
    grads = _grads(loss, leaves)
    if steps_hint is not None:
        return loss.detach(), grads, done
    return loss.detach(), grads
