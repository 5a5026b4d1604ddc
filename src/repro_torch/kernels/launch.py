"""What every kernel wrapper of the port does around a launch.

A wrapper given CPU tensors computes its kernel's plain PyTorch version
(that is how the CPU tests run); given CUDA tensors it launches the kernel
or raises, and never falls back. `on_card` makes that choice, `check`
turns a launch's CUDA error code into an exception, `aligned` hands a
kernel that loads 16 bytes at a time a 16-byte-aligned tensor, and
`stream_counter` gives a kernel that synchronises its blocks through device
memory its counter words.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["on_card", "check", "aligned", "stream_counter"]


def on_card(device: torch.device, name: str) -> bool:
    """True to launch the kernel (CUDA), False for the plain version (CPU)."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {device}")
    return True


def check(code: int, name: str, error_string: Callable[[int], bytes]) -> None:
    """Raise if the launch returned a CUDA error (``code`` != 0)."""
    if code:
        msg = error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(error {code}: {msg})")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its data is 16-byte aligned, else a copy (fresh
    allocations are)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_COUNTERS: dict[tuple[str, int, int], torch.Tensor] = {}


def stream_counter(kernel: str, dev: torch.device, stream,
                   size: int = 1) -> torch.Tensor:
    """The int32 counters of ``kernel``'s cross-block synchronisation on
    this device and stream, at least ``size`` of them (one per seed of a
    batched launch): zeroed when first used, and replaced by a larger zeroed
    array when a launch needs more; every launch of the kernel leaves its
    counters ready for the next (its source says how), so no call pays a
    memset. One array per stream, so concurrent calls on two streams never
    share one; calls on one stream run in order (and the caching allocator
    hands a replaced array's memory only to later work on that stream)."""
    key = (kernel, dev.index, stream.cuda_stream)
    counter = _COUNTERS.get(key)
    if counter is None or counter.numel() < size:
        counter = _COUNTERS[key] = torch.zeros(size, dtype=torch.int32,
                                               device=dev)
    return counter
