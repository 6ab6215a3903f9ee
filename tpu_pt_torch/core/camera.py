"""Pinhole camera.  Looks down its -z axis; x right, y up; screen
coordinates (x, y) in [0,1]^2 with (0,0) the bottom-left corner; fov in
degrees."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pt_torch.core.vecmath import normalize


class Camera(NamedTuple):
    """c2w rotation (3,3) (columns = x,y,z axes), position (3,), fov in
    degrees.  ``look_at`` builds host (numpy) fields; ``to`` gives tensors."""

    c2w: object
    origin: object
    hfov: object
    vfov: object

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), hfov=50.0, vfov=None, aspect=None):
        """If vfov is None it is derived from hfov and aspect (w/h)."""
        eye = np.asarray(eye, np.float32)
        target = np.asarray(target, np.float32)
        up = np.asarray(up, np.float32)
        z = eye - target
        z = z / np.linalg.norm(z)            # camera looks down -z
        x = np.cross(up, z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        c2w = np.stack([x, y, z], axis=1)
        if vfov is None:
            if aspect is None:
                vfov = hfov
            else:
                vfov = float(
                    2.0
                    * np.degrees(np.arctan(np.tan(np.radians(hfov) / 2.0) / aspect))
                )
        return Camera(c2w=c2w.astype(np.float32), origin=eye,
                      hfov=np.float32(hfov), vfov=np.float32(vfov))

    def to(self, device) -> "Camera":
        """Tensors on ``device``: f32, or a tensor's own float dtype."""
        return Camera(*(x.to(device) if torch.is_tensor(x)
                        and x.is_floating_point() else torch.as_tensor(
                            np.asarray(x), dtype=torch.float32).to(device)
                        for x in self))


def generate_rays(cam: Camera, xy):
    """Rays through screen coords xy (..., 2) -> (ro, rd) (..., 3), rd unit,
    in the camera's dtype."""
    xy = xy.to(cam.c2w.dtype)
    tan_h = torch.tan(torch.deg2rad(cam.hfov) * 0.5)
    tan_v = torch.tan(torch.deg2rad(cam.vfov) * 0.5)
    dx = (2.0 * xy[..., 0:1] - 1.0) * tan_h
    dy = (2.0 * xy[..., 1:2] - 1.0) * tan_v
    d_cam = torch.cat([dx, dy, -torch.ones_like(dx)], dim=-1)
    d_world = d_cam @ cam.c2w.T
    rd = normalize(d_world)
    ro = cam.origin.expand_as(rd)
    return ro, rd


def pixel_xy(width: int, height: int, pixel_ids, jitter):
    """Screen coords for flat row-major pixel ids (row 0 = bottom) with
    sub-pixel jitter (R, 2) in [0,1)."""
    px = (pixel_ids % width).to(torch.float32)
    py = torch.div(pixel_ids, width, rounding_mode="floor").to(torch.float32)
    x = (px[..., None] + jitter[..., 0:1]) / width
    y = (py[..., None] + jitter[..., 1:2]) / height
    return torch.cat([x, y], dim=-1)
