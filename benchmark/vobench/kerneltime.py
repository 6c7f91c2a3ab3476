"""A kernel alone on the card, against the H100's published peaks.

As chip_smoke.device_ms times it: before each timed call a spin kernel
holds the card while the host enqueues the call (the launch is not
counted) and a write of FLUSH_BYTES evicts the 50 MB L2 (the main path
finds each input cold); CUDA events around the call, median of REPS.
A roofline share is the least time the chip could take (the larger of
bytes over peak bandwidth and operations over peak rate) over that time.
"""

from __future__ import annotations

import subprocess

import numpy as np
import torch

# NVIDIA's H100 SXM data sheet, dense rates at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12

FLUSH_BYTES = 128 * 2**20
SPIN_CYCLES = 4_000_000  # about 2 ms at 1.98 GHz
REPS = 10
WARMUP = 2


def device_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        flush.zero_()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(the least time in ms, "bytes" or "operations")."""
    b = bytes_moved / HBM_BYTES_PER_S * 1e3
    o = ops / ops_per_s * 1e3
    return max(b, o), ("bytes" if b >= o else "operations")


def card() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        out = []
    name, _, limit = (out[0].partition(",") if out else ("", "", ""))
    return {"name": name.strip() or torch.cuda.get_device_name(0), "power_limit": limit.strip() or "unknown"}
