"""The port's device rule, shared by its entry points: they run on the card
unless the caller asks for the CPU, and "cuda" without a GPU raises (the
reference's utils/device.py probes and falls back; the port never falls
back)."""

from __future__ import annotations

import functools

import torch


def resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    return dev


@functools.lru_cache(maxsize=None)
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor, built once per (values, dtype, device) and
    kept: a step that a CUDA graph captures must not copy from the host, and
    an eager step then skips the copy too. Callers never write to it."""
    return torch.tensor(values, dtype=dtype, device=device)
