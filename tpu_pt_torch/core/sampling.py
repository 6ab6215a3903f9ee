"""Counter-based RNG + Monte-Carlo samplers.

Every draw is a pure function of ``(key words, ray_id, draw_id, i)``, so
renderers that reorder rays consume identical random numbers.  The hash is
three murmur3-finalizer rounds on 32-bit words.  PyTorch has no shifts or
wrapping multiplies on ``uint32``, so the words ride in ``int64`` and are
masked to 32 bits after every step; the multiply is split into 16-bit
halves of the constant so no intermediate exceeds 2^48 (no reliance on
signed overflow, same bits on the CPU and on the card).

A key is two 32-bit words ``(k0, k1)``; a JAX ``jax.random.key(i)`` has the
words ``(0, i)``.
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x):
    """murmur3 finalizer on 32-bit words held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def _hash_uniforms(key, ray_ids, draw_ids, n: int):
    """uniforms[r, i] = f(key, ray_ids[r], draw_ids[r], i) in [0, 1), f32."""
    k0, k1 = int(key[0]) & _M32, int(key[1]) & _M32
    dev = ray_ids.device
    r = (ray_ids.to(torch.int64) & _M32)[:, None]
    d = (draw_ids.to(torch.int64) & _M32)[:, None]
    i = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    ig = torch.tensor([(j * 0x9E3779B9) & _M32 for j in range(n)],
                      dtype=torch.int64, device=dev)[None, :]
    h = _mix(d ^ k1 ^ ig)
    h = _mix(r ^ h ^ k0)
    h = _mix((h + i) & _M32)
    # 24 high-entropy bits -> [0, 1) float32 (exact).
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def draws(key, ray_ids, draw_id: int, n: int):
    """n uniforms per ray, shape (R, n); ``draw_id`` is one static int."""
    return _hash_uniforms(key, ray_ids, torch.full_like(ray_ids, draw_id), n)


def draws_lane(key, ray_ids, draw_ids, n: int):
    """Like :func:`draws` with a per-lane draw id tensor."""
    return _hash_uniforms(key, ray_ids, draw_ids, n)


def cosine_hemisphere(u):
    """Cosine-weighted hemisphere sample (z = normal).  u: (..., 2).
    Returns (dir (..., 3), pdf (..., 1) = cos/pi)."""
    phi = 2.0 * math.pi * u[..., 0:1]
    cos_t = torch.sqrt(torch.clamp_min(1.0 - u[..., 1:2], 0.0))
    sin_t = torch.sqrt(torch.clamp_min(u[..., 1:2], 0.0))
    d = torch.cat([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, cos_t], dim=-1)
    return d, cos_t / math.pi


def uniform_hemisphere(u):
    """Uniform hemisphere sample.  pdf = 1/(2*pi)."""
    z = u[..., 0:1]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u[..., 1:2]
    d = torch.cat([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, torch.full_like(z, 1.0 / (2.0 * math.pi))


def uniform_sphere(u):
    """Uniform sphere sample.  pdf = 1/(4*pi)."""
    z = 1.0 - 2.0 * u[..., 0:1]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u[..., 1:2]
    d = torch.cat([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return d, torch.full_like(z, 1.0 / (4.0 * math.pi))
