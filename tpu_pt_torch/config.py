"""Render configuration (a frozen dataclass of plain Python values) and the
check every entry point makes of the device it is asked for."""

from __future__ import annotations

import dataclasses
import json

import torch


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs for one render."""

    width: int = 512
    height: int = 512
    spp: int = 16                    # samples per pixel
    max_depth: int = 4               # max ray bounces
    ns_area_light: int = 1           # samples per area light
    direct_only: bool = False        # no indirect bounces
    rr_start: int = 2                # bounce index where Russian roulette kicks in
    rr_prob: float = 0.7             # continuation probability for RR
    spp_chunk: int = 4               # spp rendered per device pass (memory knob)
    dtype: str = "float32"
    eps: float = 1e-4                # shadow/secondary ray offset
    debug_checks: bool = False       # the sanitizer: render_wavefront_checked

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "RenderConfig":
        return cls(**json.loads(s))


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  The package runs on the card by
    default: asking for CUDA where there is none raises, it never falls
    back to the host."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_pt_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return device
