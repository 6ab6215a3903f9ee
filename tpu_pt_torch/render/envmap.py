"""Environment (lat-long) light map: evaluation, importance sampling.

A scene with no environment uses a (1, 1, 3) zero map.  Miss rays fetch
radiance along their direction; next-event estimation uses a LIGHT_ENV row.
Lat-long convention: u = phi / 2pi with phi = atan2(x, -z); v = theta / pi,
theta from +y.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def eval_env(env_map, d):
    """Radiance of the environment along unit directions d (..., 3).
    Bilinear texel filter — wraps in phi, clamps at the poles."""
    h, w = env_map.shape[0], env_map.shape[1]
    phi = torch.atan2(d[..., 0], -d[..., 2])
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    u = torch.remainder(phi / (2.0 * math.pi) + 0.5, 1.0)
    v = theta / math.pi
    x = u * w - 0.5                       # texel-center continuous coords
    y = torch.clamp(v * h - 0.5, 0.0, h - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = torch.remainder(x0f.to(torch.int64), w)
    x1 = torch.remainder(x0 + 1, w)       # phi wraps around the seam
    y0 = torch.clamp(y0f.to(torch.int64), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)    # theta clamps at the poles
    top = env_map[y0, x0] * (1 - fx) + env_map[y0, x1] * fx
    bot = env_map[y1, x0] * (1 - fx) + env_map[y1, x1] * fx
    return top * (1 - fy) + bot * fy


def build_env_tables(env_map: np.ndarray):
    """Luminance CDF tables for environment importance sampling.

    Texel weights are luminance x sin(theta_row) (the solid angle of a
    lat-long texel shrinks toward the poles).  Returns
    (marg_cdf (H,), cond_cdf (H, W)) float32 numpy arrays; a zero or
    constant map degenerates to (area-corrected) uniform sampling.
    """
    env = np.asarray(env_map, np.float32)
    h, w = env.shape[0], env.shape[1]
    lum = env @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    # 3x3 box blur (wrap in phi, clamp in theta) so the pmf covers the
    # BILINEAR tent of every bright texel: eval_env spreads a texel's
    # radiance into its 8 neighbours, and sampling those at a bare dim-texel
    # probability gives rare huge-weight samples (unbiased but terrible
    # variance).  Blurring the table changes only the sampling density —
    # the pdf is derived from these same tables, so the estimator stays
    # exactly unbiased.
    padded = np.concatenate([lum[:1], lum, lum[-1:]], axis=0)
    padded = np.concatenate(
        [padded[:, -1:], padded, padded[:, :1]], axis=1)
    lum = sum(padded[dy:dy + h, dx:dx + w]
              for dy in range(3) for dx in range(3)) / 9.0
    sin_t = np.sin((np.arange(h, dtype=np.float32) + 0.5) / h * np.pi)
    wgt = lum * sin_t[:, None]
    if wgt.sum() <= 0.0:
        wgt = np.broadcast_to(sin_t[:, None], (h, w)).copy()
    row_w = wgt.sum(axis=1)
    marg_cdf = np.cumsum(row_w / row_w.sum()).astype(np.float32)
    marg_cdf[-1] = 1.0
    cond = wgt / np.maximum(row_w[:, None], 1e-30)
    cond = np.where(row_w[:, None] > 0, cond, 1.0 / w)
    cond_cdf = np.cumsum(cond, axis=1).astype(np.float32)
    cond_cdf[:, -1] = 1.0
    return marg_cdf, cond_cdf


def _pmf_from_cdfs(marg_cdf, cond_cdf, yi, xi):
    """Per-texel probability mass from the two CDF tables (gathered)."""
    zero = torch.zeros((), dtype=marg_cdf.dtype, device=marg_cdf.device)
    m_hi = marg_cdf[yi]
    m_lo = torch.where(yi > 0, marg_cdf[torch.clamp_min(yi - 1, 0)], zero)
    c_hi = cond_cdf[yi, xi]
    c_lo = torch.where(xi > 0, cond_cdf[yi, torch.clamp_min(xi - 1, 0)], zero)
    return (m_hi - m_lo) * (c_hi - c_lo)


def sample_env(marg_cdf, cond_cdf, u):
    """Importance-sample the environment map.  u: (..., 2) uniforms.

    Inverse-CDF over rows then columns, with the CDF remainder reused as
    the in-texel jitter.  Returns (d (..., 3) unit world directions,
    pdf (..., 1) solid-angle pdf = pmf * H * W / (2 pi^2 sin theta))."""
    h = marg_cdf.shape[0]
    w = cond_cdf.shape[1]
    zero = torch.zeros((), dtype=marg_cdf.dtype, device=marg_cdf.device)
    u1 = u[..., 0]
    u2 = u[..., 1]
    # Row: first index with cdf > u1 (dense compare; maps are small).
    yi = torch.sum((marg_cdf <= u1[..., None]).to(torch.int64), dim=-1)
    yi = torch.clamp(yi, 0, h - 1)
    m_lo = torch.where(yi > 0, marg_cdf[torch.clamp_min(yi - 1, 0)], zero)
    m_hi = marg_cdf[yi]
    fy = torch.clamp((u1 - m_lo) / torch.clamp_min(m_hi - m_lo, 1e-12), 0.0, 1.0)
    # Column within the chosen row.
    row_cdf = cond_cdf[yi]                              # (..., W) gather
    xi = torch.sum((row_cdf <= u2[..., None]).to(torch.int64), dim=-1)
    xi = torch.clamp(xi, 0, w - 1)
    c_lo = torch.where(xi > 0, cond_cdf[yi, torch.clamp_min(xi - 1, 0)], zero)
    c_hi = cond_cdf[yi, xi]
    fx = torch.clamp((u2 - c_lo) / torch.clamp_min(c_hi - c_lo, 1e-12), 0.0, 1.0)

    v = (yi.to(torch.float32) + fy) / h                 # theta / pi
    uu = (xi.to(torch.float32) + fx) / w                # phi / 2pi + .5
    theta = v * math.pi
    phi = (uu - 0.5) * (2.0 * math.pi)
    sin_t = torch.sin(theta)
    d = torch.stack([sin_t * torch.sin(phi), torch.cos(theta),
                     -sin_t * torch.cos(phi)], dim=-1)
    pmf = _pmf_from_cdfs(marg_cdf, cond_cdf, yi, xi)
    pdf = pmf * (h * w) / (2.0 * math.pi ** 2 * torch.clamp_min(sin_t, 1e-6))
    return d, pdf[..., None]


def env_pdf(marg_cdf, cond_cdf, d):
    """Solid-angle pdf sample_env would assign to directions d (..., 3)."""
    h = marg_cdf.shape[0]
    w = cond_cdf.shape[1]
    phi = torch.atan2(d[..., 0], -d[..., 2])
    theta = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0))
    uu = torch.remainder(phi / (2.0 * math.pi) + 0.5, 1.0)
    v = theta / math.pi
    xi = torch.clamp((uu * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    pmf = _pmf_from_cdfs(marg_cdf, cond_cdf, yi, xi)
    sin_t = torch.clamp_min(torch.sin(theta), 1e-6)
    return (pmf * (h * w) / (2.0 * math.pi ** 2 * sin_t))[..., None]


def load_envmap(path: str) -> np.ndarray:
    """Load a lat-long radiance map by extension: ``.exr`` (scanline
    NONE / ZIP / ZIPS, ``scene/exr.py``) or ``.pfm``.  Returns (H, W, 3)
    float32, top row first: the command line's ``-e`` input."""
    low = path.lower()
    if low.endswith(".exr"):
        from tpu_pt_torch.scene.exr import read_exr

        return read_exr(path)
    if low.endswith(".pfm"):
        return load_pfm(path)
    raise ValueError(f"unsupported environment map format: {path} "
                     "(.exr or .pfm)")


def load_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> (H, W, 3) float32 (top row first)."""
    with open(path, "rb") as fh:
        header = fh.readline().strip()
        if header not in (b"PF", b"Pf"):
            raise ValueError(f"not a PFM file: {path}")
        dims = fh.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(fh.readline().strip())
        data = np.frombuffer(fh.read(), "<f4" if scale < 0 else ">f4")
    c = 3 if header == b"PF" else 1
    img = data.reshape(h, w, c)[::-1]  # PFM stores bottom-up
    if c == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img.astype(np.float32))


def write_pfm(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float data as a little-endian colour PFM."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as fh:
        fh.write(b"PF\n")
        fh.write(f"{w} {h}\n".encode())
        fh.write(b"-1.0\n")
        fh.write(np.ascontiguousarray(img[::-1]).astype("<f4").tobytes())


def gradient_sky(h: int = 32, w: int = 64, horizon=(0.8, 0.85, 1.0),
                 zenith=(0.2, 0.35, 0.8), ground=(0.25, 0.2, 0.15),
                 scale: float = 1.0) -> np.ndarray:
    """Procedural sky map (numpy, (h, w, 3) f32) for tests and demos."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    t = np.cos(theta)[:, None, None]  # +1 at zenith → -1 at nadir
    up = np.clip(t, 0, 1)
    down = np.clip(-t, 0, 1)
    mid = 1.0 - up - down
    img = (up * np.asarray(zenith) + mid * np.asarray(horizon)
           + down * np.asarray(ground))
    return np.broadcast_to(img, (h, w, 3)).astype(np.float32) * scale
