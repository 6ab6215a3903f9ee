"""Batched 3-D vector math on tensors whose LAST axis is xyz."""

from __future__ import annotations

import torch


def dot(a, b, keepdims: bool = True):
    """Batched dot product over the last axis."""
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def length(v, keepdims: bool = True):
    return torch.sqrt(torch.clamp_min(dot(v, v, keepdims=keepdims), 0.0))


def normalize(v, eps: float = 1e-20):
    """Safe normalize: v/|v|, zero where |v|^2 <= eps."""
    n2 = dot(v, v)
    inv = torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp_min(n2, eps)),
                      torch.zeros_like(n2))
    return v * inv


def reflect(wo, n):
    """Mirror reflection of outgoing direction ``wo`` about normal ``n``."""
    return -wo + 2.0 * dot(wo, n) * n


def make_coord_space(n):
    """Orthonormal basis (tangent, bitangent) from unit normal ``n``
    (branchless Duff/Frisvad construction)."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(nz >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + nz)
    bcoef = nx * ny * a
    t = torch.cat([1.0 + sign * nx * nx * a, sign * bcoef, -sign * nx], dim=-1)
    b = torch.cat([bcoef, sign + ny * ny * a, -ny], dim=-1)
    return t, b


def to_local(w, t, b, n):
    """World direction -> local shading frame (z = normal)."""
    return torch.cat([dot(w, t), dot(w, b), dot(w, n)], dim=-1)


def to_world(w, t, b, n):
    """Local shading-frame direction -> world."""
    return w[..., 0:1] * t + w[..., 1:2] * b + w[..., 2:3] * n


def luminance(rgb):
    """Rec.709 luma."""
    return rgb[..., 0:1] * 0.2126 + rgb[..., 1:2] * 0.7152 + rgb[..., 2:3] * 0.0722
