"""The port's device rule: CUDA unless the caller asks for the CPU.

Every entry point (`repro_torch.run`, `Algorithm1.init`, the streams)
resolves its ``device`` argument here. The default is ``"cuda"``; with no
CUDA device that raises instead of quietly running on the CPU. The CPU
path — plain PyTorch versions of every kernel — is taken only when the
caller passes ``device="cpu"``, as the tests do.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` as a torch.device, refusing CUDA when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
