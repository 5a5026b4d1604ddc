"""The gossip step's update of one leaf on the card: ``gossip_update``.

Replaces no TPU kernel: the reference runs `GossipDP.update` as XLA ops.
On the card it is one pass a leaf in place of the eager chain of clip,
noise, mix, dual step and sparsity count (`repro_torch.core.gossip`, which
takes it when its stages are the paper's: a synchronous fault-free
`RingRollMixer`, the port's `LaplaceMechanism` noising every copy,
`OMDLassoRule` with the l1 prox and `PerNodeL2Clipper`; its counters
``gossip.fused_leaves`` and ``gossip.eager_leaves`` say which path each
leaf took). The CUDA C++ lives in ``src/repro_torch/csrc/gossip_update.cu``
(its header says what bounds it on an H100, what the design does about it
and why each rounding matches the eager op). For a node-stacked leaf
``theta`` (m, ...) float32, its uniform draw ``u`` (one ``torch.rand`` of
theta's shape), its gradient (bfloat16 or float32, theta's shape), the (m,)
clip factors and the ring mixer ``ring``:

    g     = (grad * factor[i]).to(grad.dtype)        the per-node L2 clip
    tilde = theta + scale * laplace_transform(u)     Laplace noise
    mixed = sw*tilde + nw*tilde[i-1] + nw*tilde[i+1] the ring mix
    next  = mixed - alpha * g                        the OMD dual step
    zeros = #(soft_threshold(next, lam) == 0)        the L1 primal's zeros

It returns ``next``, a new float32 tensor (theta stays as it was), and adds
the zero count to ``zeros``, a one-element int64 tensor. Given CPU (or
meta) tensors it computes the plain PyTorch version (`gossip_update_plain`,
the same stages' own ops); given CUDA tensors it launches the kernel on the
current stream and raises if the launch failed, never falling back.
``gossip_update.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.api.clippers import scale_nodes
from repro_torch.api.mixers import RingRollMixer
from repro_torch.api.rules import OMDLassoRule, StepContext
from repro_torch.core.privacy import U_LO, U_SPAN, laplace_transform
from repro_torch.kernels import build, work
from repro_torch.kernels.launch import check, on_card

__all__ = ["gossip_update", "gossip_update_plain", "reset_launches",
           "library", "SOURCE"]

SOURCE = "gossip_update.cu"
GRAD_DTYPES = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(SOURCE)
    P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.gu_gossip_update.argtypes = [P, P, P, I, P, I, ctypes.c_int64, I,
                                     F, F, F, F, F, F, F, P, P, P]
    lib.gu_gossip_update.restype = I
    lib.gu_error_string.argtypes = [I]
    lib.gu_error_string.restype = ctypes.c_char_p
    return lib


def reset_launches() -> None:
    gossip_update.launches = 0


def _f32(v) -> float:
    """A scalar as the float32 value a torch op (and the kernel) uses."""
    return float(np.float32(v))


def gossip_update_plain(theta, u, grad, factor, scale, alpha, lam,
                        ring: RingRollMixer):
    """Plain PyTorch version of `gossip_update`: (next, zero count), by the
    stages' own ops in the eager chain's order."""
    rule = OMDLassoRule(prox_kind="l1")
    tilde = theta + float(scale) * laplace_transform(u)
    nxt = rule.dual_step(ring.apply(tilde, 0), scale_nodes(grad, factor),
                         StepContext(t=0, alpha_t=alpha, lam_t=0.0, lam=0.0))
    primal = rule.primal(nxt, StepContext(t=0, alpha_t=0.0, lam_t=lam,
                                          lam=0.0))
    return nxt, (primal.abs() <= 0.0).sum()


def _vec(n: int, *tensors: torch.Tensor) -> int:
    """4 where every node row starts 16-byte aligned (a bf16 row 8), else
    1."""
    ok = n % 4 == 0 and all(t.data_ptr() % (4 * t.element_size()) == 0
                            for t in tensors)
    return 4 if ok else 1


def gossip_update(theta: torch.Tensor, u: torch.Tensor, grad: torch.Tensor,
                  factor: torch.Tensor, scale, alpha, lam,
                  ring: RingRollMixer, zeros: torch.Tensor) -> torch.Tensor:
    """Clip, noise, ring-mix and dual-step one node-stacked leaf in one
    pass; add its L1 primal's zero count to ``zeros``; return next.

    ``scale`` is the Laplace scale, ``alpha`` alpha_t, ``lam`` the lam_t
    the next primal thresholds with, ``ring`` the synchronous ring whose
    weights mix the noised copies."""
    if not isinstance(theta, torch.Tensor) or theta.dim() < 1 \
            or theta.dtype != torch.float32:
        raise ValueError("theta must be an (m, ...) float32 tensor")
    dev, shape = theta.device, tuple(theta.shape)
    m = shape[0]
    for name, t, dtypes in (("u", u, (torch.float32,)),
                            ("grad", grad, GRAD_DTYPES)):
        if not isinstance(t, torch.Tensor) or tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(factor.shape) != (m,) or factor.dtype != torch.float32:
        raise ValueError(f"factor must be ({m},) float32")
    if zeros.numel() != 1 or zeros.dtype != torch.int64:
        raise ValueError("zeros must be one int64")
    for name, t in (("u", u), ("grad", grad), ("factor", factor),
                    ("zeros", zeros)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    n = theta.numel() // m if m else 0
    with work.scope("gossip_update", m, n, grad_bytes=grad.element_size()):
        if not on_card(dev, "gossip_update"):
            nxt, count = gossip_update_plain(theta, u, grad, factor, scale,
                                             alpha, lam, ring)
            zeros += count
            return nxt
        theta, u, grad = (t.contiguous() for t in (theta, u, grad))
        factor = factor.contiguous()
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        if theta.numel() == 0:
            return out
        lib = library()
        with torch.cuda.device(dev):
            code = lib.gu_gossip_update(
                theta.data_ptr(), u.data_ptr(), grad.data_ptr(),
                int(grad.dtype == torch.bfloat16), factor.data_ptr(), m, n,
                _vec(n, theta, u, grad, out), U_SPAN, U_LO, _f32(scale),
                _f32(ring.self_weight), _f32(ring.nbr_weight), _f32(alpha),
                _f32(lam), out.data_ptr(), zeros.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        check(code, "gossip_update", lib.gu_error_string)
        gossip_update.launches += 1
        return out


reset_launches()
