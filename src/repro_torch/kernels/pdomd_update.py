"""The fused mix + OMD step + L1 prox on the card: ``pdomd_update``.

Counterpart of the Pallas TPU kernel `repro.kernels.pdomd_update`; the CUDA
C++ lives in ``src/repro_torch/csrc/pdomd_update.cu`` (its header says what
bounds it on an H100 and what the design does about it). On (rows, 128)
tiles of a node's parameters (`kernels.ops.tree_to_tiles`):

    theta_new = sw*theta_self + nw*theta_prev + nw*theta_next - alpha*g
    w         = sign(theta_new) * max(|theta_new| - lam, 0)

The wrapper refuses what the reference refuses (a last dim other than 128,
rows not a multiple of 8) and casts the inputs to float32, as the reference
does (bf16 included). Given CPU tensors it computes the plain PyTorch
version (`pdomd_update_plain`, beside it); given CUDA tensors it launches
the kernel on the current stream and raises if the launch failed, never
falling back. ``pdomd_update.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.launch import aligned, check, on_card

__all__ = ["pdomd_update", "pdomd_update_plain", "reset_launches",
           "library", "SOURCE", "LANE", "SUBLANE"]

SOURCE = "pdomd_update.cu"
LANE = 128
SUBLANE = 8


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(SOURCE)
    P, F = ctypes.c_void_p, ctypes.c_float
    lib.pu_pdomd_update.argtypes = [P, P, P, P, F, F, F, F, ctypes.c_int64,
                                    P, P, P]
    lib.pu_pdomd_update.restype = ctypes.c_int
    lib.pu_error_string.argtypes = [ctypes.c_int]
    lib.pu_error_string.restype = ctypes.c_char_p
    return lib


def reset_launches() -> None:
    pdomd_update.launches = 0


def _f32(v) -> float:
    """A scalar as the float32 value the kernel receives."""
    return float(np.float32(v))


def pdomd_update_plain(theta_self, theta_prev, theta_next, grad, alpha, lam,
                       self_weight=0.5, nbr_weight=0.25):
    """Plain PyTorch version of `pdomd_update`: (w, theta_new)."""
    f = lambda t: t.to(torch.float32)  # noqa: E731
    sw, nw = _f32(self_weight), _f32(nbr_weight)
    mixed = sw * f(theta_self) + nw * f(theta_prev) + nw * f(theta_next)
    theta_new = mixed - _f32(alpha) * f(grad)
    w = torch.sign(theta_new) * torch.clamp_min(theta_new.abs() - _f32(lam),
                                                0.0)
    return w, theta_new


def pdomd_update(theta_self: torch.Tensor, theta_prev: torch.Tensor,
                 theta_next: torch.Tensor, grad: torch.Tensor, alpha, lam,
                 self_weight=0.5, nbr_weight=0.25):
    """Fused ring mix + OMD step + L1 prox on (rows, 128) tiles.

    ``theta_self`` is the node's own theta~, ``theta_prev``/``theta_next``
    its ring neighbours', ``grad`` the clipped subgradient; ``alpha`` is
    alpha_t and ``lam`` lambda_t. Returns ``(w, theta_new)``, both
    (rows, 128) float32.
    """
    if not isinstance(theta_self, torch.Tensor) or theta_self.dim() != 2:
        raise ValueError("theta_self must be a (rows, 128) tensor")
    rows, lanes = theta_self.shape
    if lanes != LANE:
        raise ValueError(f"last dim must be {LANE}, got {lanes}")
    if rows % SUBLANE:
        raise ValueError(f"rows must be a multiple of {SUBLANE}, got {rows}")
    dev = theta_self.device
    for name, t in (("theta_prev", theta_prev), ("theta_next", theta_next),
                    ("grad", grad)):
        if not isinstance(t, torch.Tensor) or t.shape != theta_self.shape:
            raise ValueError(f"{name} must have shape {tuple(theta_self.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    with work.scope("pdomd_update", rows, LANE):
        if not on_card(dev, "pdomd_update"):
            return pdomd_update_plain(theta_self, theta_prev, theta_next,
                                      grad, alpha, lam, self_weight,
                                      nbr_weight)
        ins = [aligned(t.to(torch.float32).contiguous())
               for t in (theta_self, theta_prev, theta_next, grad)]
        w = torch.empty((rows, LANE), dtype=torch.float32, device=dev)
        theta_new = torch.empty((rows, LANE), dtype=torch.float32,
                                device=dev)
        if rows == 0:
            return w, theta_new
        lib = library()
        with torch.cuda.device(dev):
            code = lib.pu_pdomd_update(
                *(t.data_ptr() for t in ins), _f32(alpha), _f32(lam),
                _f32(self_weight), _f32(nbr_weight), rows * LANE,
                w.data_ptr(), theta_new.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        check(code, "pdomd_update", lib.pu_error_string)
        pdomd_update.launches += 1
        return w, theta_new


reset_launches()
