"""The port's device rule: CUDA unless the caller asks for the CPU.

Every entry point (`repro_torch.run`, `Algorithm1.init`, the streams)
resolves its ``device`` argument here. The default is ``"cuda"``; with no
CUDA device that raises instead of quietly running on the CPU. The CPU
path — plain PyTorch versions of every kernel — is taken only when the
caller passes ``device="cpu"``, as the tests do.

The LM dry-run counts on ``meta`` tensors (shapes and dtypes, no
storage): `shape_device` is `resolve_device`'s rule plus "meta", for the
constructors that build a counted state (`repro_torch.models.build_model`,
`GossipDP.init`), and a `MetaGenerator` stands in for a generator there.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize", "shape_device",
           "MetaGenerator"]


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


def shape_device(device: str | torch.device | None = "cuda") -> torch.device:
    """`resolve_device`'s rule, plus "meta" (shapes and dtypes only)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


class MetaGenerator(torch.Generator):
    """A CPU generator that reports the ``meta`` device: a sampler that
    draws on ``generator.device`` (`repro_torch.api.mechanisms`) makes
    shape-only draws with it, through the same ops as on a card."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")
