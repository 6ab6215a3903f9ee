"""Progressive, checkpointable rendering: spp-chunked accumulation.

The accumulator, the sample count done and a state key are written to an
``.npz`` after every chunk, so a long render resumes after a crash and can
show a preview.  The wavefront's random numbers are counter-based over
(pixel, sample, bounce), so each chunk's sums are the samples a one-shot
render takes for them; the image is the sum of the per-chunk sums (on the
host, in chunk order), which matches the one-shot render to float rounding
and a resumed render bit for bit.  Chunking also bounds the wavefront's
per-sample accumulator to n_pix x chunk_spp x 12 bytes.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Optional

import numpy as np
import torch

from tpu_pt_torch.config import RenderConfig
from tpu_pt_torch.render.driver import _on_device
from tpu_pt_torch.render.wavefront import wavefront_accum
from tpu_pt_torch.scene.types import Scene


def _state_key(cfg: RenderConfig, seed_key, bvh, backend: str) -> str:
    """Checkpoint identity: the config, the key's two 32-bit words, the
    backend and the BVH's traversal budgets and core shapes.  Two runs with
    other caps or pair budgets truncate differently, so their chunks must
    not mix; the geometry itself is not hashed (the shapes are the cheap
    proxy).  The same bytes as the JAX package's key for the same render:
    ``jax.random.key(s)``'s words are ``(0, s)``.

    The exact-retrace fallback is not part of the key: on chunks that
    reported overflow 0 a fallback-attached traversal gives the same bits,
    so the fallback-attached retry resumes a clean checkpoint.  A
    checkpoint that recorded overflow is refused on resume instead."""
    h = hashlib.sha256()
    h.update(cfg.to_json().encode())
    h.update(np.asarray([int(w) for w in seed_key], np.uint32).tobytes())
    h.update(backend.encode())
    if hasattr(bvh, "frontiers"):  # ClusterBVH: budgets + core shapes only
        sig = (bvh.frontiers, bvh.k_leaf, bvh.pair_budget, bvh.pair_mults,
               tuple(tuple(np.shape(lv)) for lv in bvh.levels),
               tuple(np.shape(bvh.tiles)))
    else:
        sig = tuple(tuple(x.shape) for x in bvh if hasattr(x, "shape"))
    h.update(repr(sig).encode())
    return h.hexdigest()[:16]


def render_progressive(
    scene: Scene,
    cam,
    cfg: RenderConfig,
    key,
    bvh,
    checkpoint: Optional[str] = None,
    chunk_spp: Optional[int] = None,
    queue: int = 1 << 17,
    backend: str = "packed",
    on_chunk: Optional[Callable] = None,
    return_counts: bool = False,
    stop_on_overflow: bool = False,
    overflow_is_exact: bool = False,
    device="cuda",
):
    """Render cfg.spp samples in chunks of ``chunk_spp`` (default
    cfg.spp_chunk) on ``device``, checkpointing to ``checkpoint`` (npz)
    after each chunk and resuming from it if present.  ``key`` is two
    32-bit ints.  Returns the (H, W, 3) radiance as a numpy array, or
    (image, n_overflow) with ``return_counts`` (the summed
    capacity-contract truncations, for the command line's
    verify-then-retry).

    ``on_chunk(spp_done, image_so_far)`` is the progressive-preview hook.

    ``stop_on_overflow`` stops after the first chunk that reports
    truncations: the caller retries with the exact fallback anyway.  No
    checkpoint is written for that chunk, so the stored accumulator stays
    exact and the fallback-attached retry resumes it.

    ``overflow_is_exact`` declares that ``bvh`` corrects overflow in the run
    (the exact fallback attached): overflow then neither stops the render
    nor taints the checkpoint."""
    chunk_spp = chunk_spp or cfg.spp_chunk
    state_key = _state_key(cfg, key, bvh, backend)
    accum = np.zeros((cfg.n_pixels, 3), np.float32)
    spp_done = 0
    n_ovf = 0

    if checkpoint and os.path.exists(checkpoint):
        data = np.load(checkpoint, allow_pickle=False)
        ck_ovf = int(data["n_ovf"]) if "n_ovf" in data else 0
        ck_exact = bool(data["exact"]) if "exact" in data else ck_ovf == 0
        # Only exact accumulators resume: a run that truncated may have
        # dropped hits.
        if str(data["state_key"]) == state_key and ck_exact:
            accum = data["accum"]
            spp_done = int(data["spp_done"])
            n_ovf = ck_ovf

    device, scene, cam, bvh = _on_device(device, scene, cam, bvh)
    while spp_done < cfg.spp:
        n = min(chunk_spp, cfg.spp - spp_done)
        with torch.no_grad():
            part, (_, _, novf, _) = wavefront_accum(
                scene, cam, cfg, key, bvh, queue, backend, 0, cfg.n_pixels,
                spp_lo=spp_done, spp_count=n, with_counts=True)
        accum = accum + part.cpu().numpy()
        n_ovf += int(novf)
        spp_done += n
        if stop_on_overflow and n_ovf and not overflow_is_exact:
            img = (accum / max(spp_done, 1)).reshape(cfg.height, cfg.width, 3)
            return (img, n_ovf) if return_counts else img
        if checkpoint:
            tmp = checkpoint + ".tmp.npz"
            np.savez(tmp, accum=accum, spp_done=spp_done,
                     state_key=state_key, n_ovf=n_ovf,
                     exact=(n_ovf == 0 or overflow_is_exact))
            os.replace(tmp, checkpoint)
        if on_chunk is not None:
            preview = (accum / spp_done).reshape(cfg.height, cfg.width, 3)
            on_chunk(spp_done, preview)

    img = (accum / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return (img, n_ovf) if return_counts else img
