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

The kernel library picks one of two paths from B, n and the card
(``hg_plan``, asked once per device, B and n and kept here): batches of up
to 128 rows take the slab path, one cooperative launch whose grid barrier
counts on an int32 counter per device and stream
(`launch.stream_counter`); larger ones the row path, a row kernel and a
second kernel that sums its per-block partials. ``hinge_grad.launches``
counts calls that launched, ``hinge_grad.slab_launches`` those that took
the slab path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.launch import aligned, check, on_card, stream_counter

__all__ = ["hinge_grad", "hinge_grad_plain", "reset_launches", "library",
           "SOURCE", "LANE"]

SOURCE = "hinge_grad.cu"
LANE = 128
_SLAB_PATH = 2         # _Plan.path of the slab path (kPathSlabs)


class _Plan(ctypes.Structure):
    """``HgPlan`` of the kernel library: the path and launch shape."""
    _fields_ = [("path", ctypes.c_int32), ("unit", ctypes.c_int32),
                ("width", ctypes.c_int32), ("grid", ctypes.c_int32),
                ("block", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("smem", ctypes.c_int64), ("scratch", ctypes.c_int64)]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(SOURCE)
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.hg_plan.argtypes = [I64, I, ctypes.POINTER(_Plan)]
    lib.hg_plan.restype = I
    lib.hg_hinge_grad.argtypes = [P, P, P, I64, I, ctypes.POINTER(_Plan), P,
                                  P, P, P, P, P]
    lib.hg_hinge_grad.restype = I
    lib.hg_error_string.argtypes = [I]
    lib.hg_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1024)
def _plan(index: int, B: int, n: int) -> _Plan:
    """``hg_plan`` for a (B, n) batch on CUDA device ``index``. It depends
    on B, n and the device alone, so it is asked once and kept."""
    lib = library()
    out = _Plan()
    with torch.cuda.device(index):
        code = lib.hg_plan(B, n, ctypes.byref(out))
    check(code, "hinge_grad", lib.hg_error_string)
    return out


def reset_launches() -> None:
    hinge_grad.launches = 0
    hinge_grad.slab_launches = 0


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
    with work.scope("hinge_grad", B, n):
        if not on_card(dev, "hinge_grad"):
            return hinge_grad_plain(x, y, w)
        x, y, w = (aligned(t.to(torch.float32).contiguous())
                   for t in (x, y, w))
        lib = library()
        p = _plan(dev.index, B, n)
        part = torch.empty(p.scratch, dtype=torch.float32, device=dev)
        # one allocation for the outputs; g first, so it is 16-byte aligned
        out = torch.empty(n + 2 * B, dtype=torch.float32, device=dev)
        g, loss, margin = out[:n], out[n:n + B], out[n + B:]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            slab = p.path == _SLAB_PATH
            counter = stream_counter("hinge_grad", dev, stream).data_ptr() \
                if slab else None
            code = lib.hg_hinge_grad(
                x.data_ptr(), y.data_ptr(), w.data_ptr(), B, n,
                ctypes.byref(p), part.data_ptr(), counter,
                loss.data_ptr(), margin.data_ptr(), g.data_ptr(),
                stream.cuda_stream)
        check(code, "hinge_grad", lib.hg_error_string)
        hinge_grad.launches += 1
        hinge_grad.slab_launches += int(slab)
        return loss, g, margin


reset_launches()
