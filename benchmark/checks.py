"""The numbers that decide ``correct``: each output of the window against
the plain reference's, reduced to one number with its limit."""

from __future__ import annotations

import statistics

import torch

# The repository's image tolerance (relative / absolute per channel).
IMAGE_RTOL, IMAGE_ATOL = 2e-4, 2e-5
# A leaf whose reference gradient lies under this share of the median
# leaf's is nought to rounding: it is left out of the gradient and change
# comparisons.
NOUGHT = 1e-3


def image_numbers(img, ref) -> dict:
    """``pixels_off``: the share of pixels with a channel outside the image
    tolerance of the reference (or not finite)."""
    img = torch.as_tensor(img, dtype=torch.float32).reshape(-1, 3)
    ref = torch.as_tensor(ref, dtype=torch.float32).reshape(-1, 3)
    off = ~torch.isfinite(img) | (
        (img - ref).abs() > IMAGE_ATOL + IMAGE_RTOL * ref.abs())
    return {"pixels_off": float(off.any(-1).float().mean())}


def count_numbers(n_closest, n_shadow, ref_closest, ref_shadow) -> dict:
    """Relative gaps of the closest-hit segments and shadow rays counted."""
    return {"closest_gap": abs(n_closest - ref_closest) / max(ref_closest, 1),
            "shadow_gap": abs(n_shadow - ref_shadow) / max(ref_shadow, 1)}


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.norm(torch.as_tensor(v).double()))
            for k, v in leaves.items()}


def _worst_gap(prog: dict, ref: dict, keep) -> float:
    """max over kept leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)."""
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    gaps = [abs(pn[k] - rn[k]) / max(rn[k], med) for k in rn if keep(k)]
    return max(gaps) if gaps else 0.0


def kept_leaves(ref_grad: dict) -> set:
    """The leaves that move in the reference: gradient norm at least
    ``NOUGHT`` of the median leaf's."""
    rn = _norms(ref_grad)
    med = statistics.median(rn.values())
    return {k for k, v in rn.items() if v >= NOUGHT * med}


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"loss": [first steps' losses], "grad": {leaf:
    first gradient}, "change": {moved leaf: change after the steps}}.
    ``loss_gap``: the worst step's relative loss gap; ``grad_gap`` and
    ``change_gap``: the worst kept leaf's gap of norms."""
    keep = kept_leaves(ref["grad"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                        ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss_gap = float("inf")
    moved = {k: v for k, v in ref["change"].items() if k in keep}
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_gap(prog["grad"], ref["grad"],
                                   lambda k: k in keep),
            "change_gap": _worst_gap(
                {k: prog["change"][k] for k in moved}, moved,
                lambda k: True)}


def with_limits(numbers: dict, limits: dict) -> dict:
    return {k: {"value": float(v), "limit": float(limits[k])}
            for k, v in numbers.items()}
