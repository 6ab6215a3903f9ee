"""Host-side primitive bounds for the SAH builders."""

from __future__ import annotations

import numpy as np

from tpu_pt_torch.scene.types import Scene


def prim_bounds(scene: Scene):
    """(P, 3) mins/maxs for the combined triangle+sphere index space
    (numpy; ``scene`` holds host arrays)."""
    v = np.asarray(scene.vertices)
    ti = np.asarray(scene.tri_idx)
    p0, p1, p2 = v[ti[:, 0]], v[ti[:, 1]], v[ti[:, 2]]
    tri_min = np.minimum(np.minimum(p0, p1), p2)
    tri_max = np.maximum(np.maximum(p0, p1), p2)
    c = np.asarray(scene.sph_center)
    r = np.asarray(scene.sph_radius)[:, None]
    lo = np.concatenate([tri_min, c - r], axis=0)
    hi = np.concatenate([tri_max, c + r], axis=0)
    return lo.astype(np.float32), hi.astype(np.float32)
