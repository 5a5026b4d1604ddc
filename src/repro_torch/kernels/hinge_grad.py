"""The fused hinge loss + subgradient on the card: ``hinge_grad``.

Counterpart of the Pallas TPU kernel `repro.kernels.hinge_grad`; the CUDA
C++ lives in ``src/repro_torch/csrc/hinge_grad.cu`` (its header says what
bounds it on an H100 and what the design does about it). For a batch x
(B, n), labels y (B,) and a linear model w (n,):

    margin = y * (x @ w);  loss = max(1 - margin, 0)
    g      = mean_b( -[margin_b < 1] * y_b * x_b )

The wrapper refuses what the reference refuses (n not a multiple of 128)
and casts the inputs to float32, as the reference does (bf16 included).
Given CPU tensors it computes the plain PyTorch version
(`hinge_grad_plain`, beside it); given CUDA tensors it launches the kernels
on the current stream and raises if a launch failed, never falling back.
``hinge_grad.launches`` counts calls that launched (one call launches the
row kernel and the kernel that sums its per-block partials).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.launch import aligned, check, on_card

__all__ = ["hinge_grad", "hinge_grad_plain", "reset_launches", "library",
           "SOURCE", "LANE"]

SOURCE = "hinge_grad.cu"
LANE = 128


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(SOURCE)
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    IP = ctypes.POINTER(ctypes.c_int)
    lib.hg_plan.argtypes = [I64, I, IP, IP, IP, ctypes.POINTER(I64)]
    lib.hg_plan.restype = I
    lib.hg_hinge_grad.argtypes = [P, P, P, I64, I, I, I, I, I64, P, P, P, P,
                                  P]
    lib.hg_hinge_grad.restype = I
    lib.hg_error_string.argtypes = [I]
    lib.hg_error_string.restype = ctypes.c_char_p
    return lib


def reset_launches() -> None:
    hinge_grad.launches = 0


def hinge_grad_plain(x, y, w):
    """Plain PyTorch version of `hinge_grad`: (loss, grad, margin)."""
    x, y, w = (t.to(torch.float32) for t in (x, y, w))
    margin = y * (x @ w)
    loss = torch.clamp_min(1.0 - margin, 0.0)
    coeff = torch.where(margin < 1.0, -y, torch.zeros_like(y))
    grad = (coeff[:, None] * x).mean(dim=0)
    return loss, grad, margin


def hinge_grad(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
    """Fused hinge loss + subgradient. Returns ``(loss (B,), grad (n,),
    margin (B,))``, float32; grad is the mean over the batch."""
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError("x must be a (B, n) tensor")
    B, n = x.shape
    if n % LANE:
        raise ValueError(f"n must be a multiple of {LANE}, got {n}")
    if B < 1:
        raise ValueError("hinge_grad needs a batch of at least one row")
    dev = x.device
    for name, t, shape in (("y", y, (B,)), ("w", w, (n,))):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if not on_card(dev, "hinge_grad"):
        return hinge_grad_plain(x, y, w)
    x, y, w = (aligned(t.to(torch.float32).contiguous()) for t in (x, y, w))
    lib = library()
    rows, grid, staged = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_int64()
    with torch.cuda.device(dev):
        code = lib.hg_plan(B, n, ctypes.byref(rows), ctypes.byref(grid),
                           ctypes.byref(staged), ctypes.byref(smem))
        check(code, "hinge_grad", lib.hg_error_string)
        part = torch.empty((grid.value, n), dtype=torch.float32, device=dev)
        loss, margin = (torch.empty(B, dtype=torch.float32, device=dev)
                        for _ in range(2))
        g = torch.empty(n, dtype=torch.float32, device=dev)
        code = lib.hg_hinge_grad(
            x.data_ptr(), y.data_ptr(), w.data_ptr(), B, n, rows.value,
            grid.value, staged.value, smem.value, part.data_ptr(),
            loss.data_ptr(), margin.data_ptr(), g.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(code, "hinge_grad", lib.hg_error_string)
    hinge_grad.launches += 1
    return loss, g, margin


reset_launches()
