"""What the fetch probes share: arguments, inputs from a numpy seed, the
timing of a call on the card, and the JSON line of a case."""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

ITERS = 30   # calls captured in one CUDA graph


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu runs the plain versions and checks them, "
                         "without timing")
    ap.add_argument("--seed", type=int, default=1)
    return ap


def device_of(args) -> torch.device:
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "checks on the host")
    return torch.device(args.device)


def bf16_table(rs: np.random.RandomState, rows: int, width: int, device):
    """Standard normal values rounded to bf16 (round to nearest even)."""
    x = rs.normal(size=(rows, width)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16).to(device)


def index(rs: np.random.RandomState, n: int, shape, device):
    return torch.from_numpy(rs.randint(0, n, shape).astype(np.int32)).to(
        device)


def graph_ms(fn, iters: int = ITERS) -> float:
    """Milliseconds a call of ``fn`` takes on the card: ``iters`` calls
    captured in one CUDA graph (no host launch time between them, as the
    JAX probes' ``lax.scan`` of calls has none), the best of three
    replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / iters)
    del g
    return best


def times(device, kernel, torch_fn, nbytes: int) -> dict:
    """The kernel's and the torch counterpart's time and rate on the card;
    nothing on the host (a CPU run times no device)."""
    if device.type != "cuda":
        return {"timed": False}
    k_ms, t_ms = graph_ms(kernel), graph_ms(torch_fn)
    return {"timed": True, "kernel_ms": k_ms, "torch_ms": t_ms,
            "kernel_GBps": nbytes / k_ms / 1e6,
            "torch_GBps": nbytes / t_ms / 1e6,
            "torch_over_kernel": t_ms / k_ms}


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def device_name(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"


def bitwise_equal(a, b) -> bool:
    """Same shape and the same bits (NaN and signed zeros included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = {4: torch.int32, 2: torch.int16}.get(a.element_size())
    return bool(torch.equal(a.view(view), b.view(view))) if view else \
        bool(torch.equal(a, b))


def fetch_bytes(idx, n_rows: int, width: int) -> int:
    """Bytes a row fetch must move: each index read once, each output row
    written once (4 bytes a field), each table row that an index names
    read once (2 bytes a field)."""
    distinct = int(torch.unique(torch.clamp(idx, 0, n_rows - 1)).numel())
    return idx.numel() * (idx.element_size() + width * 4) \
        + distinct * width * 2


def fields_bytes(cand, n_rows: int, fields: int) -> int:
    """Bytes the descent's field fetch (``fetch_fields``) must move: each
    index read once, each of its ``fields`` 8-wide words written once as f32
    (32 bytes), and those words of each table row an index names read once
    (16 bytes each)."""
    distinct = int(torch.unique(torch.clamp(cand, 0, n_rows - 1)).numel())
    return cand.numel() * (cand.element_size() + fields * 32) \
        + distinct * fields * 16
