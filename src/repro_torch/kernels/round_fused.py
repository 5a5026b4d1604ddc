"""The round kernels on the card: ``round_stats``, ``round_update``,
``dual_step``.

Counterparts of the Pallas TPU kernels of `repro.kernels.round_fused`; the
CUDA C++ lives in ``src/repro_torch/csrc/round_fused.cu`` (its header says
what bounds each kernel on an H100 and what the design does about it). The
round body of the fused backend is two of them:

    round_stats   w = soft_threshold(theta, lam_t) (or theta); per node
                  dot = sum w*x, xsq = sum x^2, nnz = sum [w != 0],
                  wbdot = sum (wsum/m)*x; per column wsum = sum_i w
    round_update  tilde = theta + delta; r = recv (use_recv) or tilde;
                  s = tilde (noise_self) or theta;
                  next = A @ r + diag*(s - r) - alpha*(coeff*x), dead rows
                  frozen -> (next, tilde)

and the hybrid backend mixes with torch ops between ``round_stats`` and

    dual_step     next = mixed - alpha*(coeff*x), dead rows frozen.

Each wrapper checks device, dtype (float32), shape and contiguity and raises
on anything its kernel does not take. Given CPU tensors it computes its
plain PyTorch version (``*_plain``, beside it) — that is how the CPU tests
run the fused backend. Given CUDA tensors it allocates its outputs with
``torch.empty``, launches the kernel on the current stream and raises if the
launch failed; it never falls back. ``<wrapper>.launches`` counts kernel
launches (``reset_launches()`` zeroes them), so a run can show that it went
through the kernels. Unlike the TPU kernels, nothing is padded to (8, 128):
the kernels mask their ragged edges, and ``nnz`` is an exact int32 count.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.prox import soft_threshold
from repro_torch.kernels import build
from repro_torch.kernels.launch import check, on_card

__all__ = ["round_stats", "round_update", "dual_step", "round_stats_plain",
           "round_update_plain", "dual_step_plain", "reset_launches",
           "library", "SOURCE"]

SOURCE = "round_fused.cu"
_INT32_MAX = 2**31 - 1


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(SOURCE)
    P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.rf_stats_scratch_floats.argtypes = [I, I]
    lib.rf_stats_scratch_floats.restype = ctypes.c_int64
    lib.rf_round_stats.argtypes = [P, P, F, F, I, I, I, P, P, P, P, P, P, P]
    lib.rf_round_stats.restype = I
    lib.rf_round_update.argtypes = [P, P, P, P, P, P, P, P, F, I, I, I, I,
                                    P, P, P]
    lib.rf_round_update.restype = I
    lib.rf_dual_step.argtypes = [P, P, P, P, P, F, I, I, P, P]
    lib.rf_dual_step.restype = I
    lib.rf_error_string.argtypes = [I]
    lib.rf_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on_error(code: int, name: str) -> None:
    check(code, name, library().rf_error_string)


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _node_shape(name: str, t: torch.Tensor) -> tuple[int, int]:
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name} must be an (m, n) tensor")
    m, n = t.shape
    if not (1 <= m <= _INT32_MAX and 1 <= n <= _INT32_MAX):
        raise ValueError(f"{name} shape {tuple(t.shape)} out of range")
    return int(m), int(n)


def reset_launches() -> None:
    """Zero the launch counts of all three wrappers."""
    for fn in (round_stats, round_update, dual_step):
        fn.launches = 0


# ---------------------------------------------------------------------------
# round_stats
# ---------------------------------------------------------------------------

def round_stats_plain(theta, x, lam_t, m_real, *, prox_l1: bool = True):
    """Plain PyTorch version of `round_stats` (same outputs and types)."""
    w = soft_threshold(theta, lam_t) if prox_l1 else theta
    wsum = w.sum(dim=0)
    return ((w * x).sum(dim=1), (x * x).sum(dim=1),
            (w != 0).sum(dim=1, dtype=torch.int32),
            ((wsum / float(m_real)) * x).sum(dim=1), wsum)


def round_stats(theta: torch.Tensor, x: torch.Tensor, lam_t: float,
                m_real: int, *, prox_l1: bool = True):
    """Per-node round statistics in one pass over theta and x.

    Returns ``(dot, xsq, nnz, wbdot, wsum)``: four (m,) per-node reductions
    (``nnz`` int32, the others float32) and the (n,) column sums of w.
    ``m_real`` is the node count w_bar averages over (m on this path).
    """
    m, n = _node_shape("theta", theta)
    dev = theta.device
    _check("theta", theta, (m, n), dev)
    _check("x", x, (m, n), dev)
    if not on_card(dev, "round_stats"):
        return round_stats_plain(theta, x, lam_t, m_real, prox_l1=prox_l1)
    lib = library()
    scratch = torch.empty(int(lib.rf_stats_scratch_floats(m, n)),
                          dtype=torch.float32, device=dev)
    dot, xsq, wbdot = (torch.empty(m, dtype=torch.float32, device=dev)
                       for _ in range(3))
    nnz = torch.empty(m, dtype=torch.int32, device=dev)
    wsum = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.rf_round_stats(
            theta.data_ptr(), x.data_ptr(), float(lam_t), float(m_real),
            int(bool(prox_l1)), m, n, scratch.data_ptr(), dot.data_ptr(),
            xsq.data_ptr(), nnz.data_ptr(), wbdot.data_ptr(),
            wsum.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(code, "round_stats")
    round_stats.launches += 1
    return dot, xsq, nnz, wbdot, wsum


# ---------------------------------------------------------------------------
# round_update
# ---------------------------------------------------------------------------

def round_update_plain(A, theta, delta, x, recv, coeff, diag, alive,
                       alpha_t, use_recv, noise_self):
    """Plain PyTorch version of `round_update`: (theta_next, tilde)."""
    tilde = theta + delta
    r = recv if use_recv else tilde
    s = tilde if noise_self else theta
    mixed = A @ r + diag[:, None] * (s - r)
    nxt = mixed - float(alpha_t) * (coeff[:, None] * x)
    return torch.where(alive[:, None] > 0, nxt, theta), tilde


def round_update(A: torch.Tensor, theta: torch.Tensor, delta: torch.Tensor,
                 x: torch.Tensor, recv: torch.Tensor, coeff: torch.Tensor,
                 diag: torch.Tensor, alive: torch.Tensor, alpha_t: float,
                 use_recv: int, noise_self: bool):
    """Fused noise-add + dense gossip mix + dual step + crash freeze.

    ``A`` is the (m, m) mixing matrix, ``recv`` the stale broadcast block
    read when ``use_recv`` is set (any (m, n) tensor otherwise), ``coeff``
    the clipped hinge coefficient (grad = coeff * x), ``alive`` 1.0 except
    on frozen rows. Returns ``(theta_next, tilde)``.
    """
    m, n = _node_shape("theta", theta)
    dev = theta.device
    _check("A", A, (m, m), dev)
    for name, t in (("theta", theta), ("delta", delta), ("x", x),
                    ("recv", recv)):
        _check(name, t, (m, n), dev)
    for name, t in (("coeff", coeff), ("diag", diag), ("alive", alive)):
        _check(name, t, (m,), dev)
    if not on_card(dev, "round_update"):
        return round_update_plain(A, theta, delta, x, recv, coeff, diag,
                                  alive, alpha_t, use_recv, noise_self)
    lib = library()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    tilde = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.rf_round_update(
            A.data_ptr(), theta.data_ptr(), delta.data_ptr(), x.data_ptr(),
            recv.data_ptr(), coeff.data_ptr(), diag.data_ptr(),
            alive.data_ptr(), float(alpha_t), int(bool(use_recv)),
            int(bool(noise_self)), m, n, out.data_ptr(), tilde.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(code, "round_update")
    round_update.launches += 1
    return out, tilde


# ---------------------------------------------------------------------------
# dual_step
# ---------------------------------------------------------------------------

def dual_step_plain(mixed, x, theta, coeff, alive, alpha_t):
    """Plain PyTorch version of `dual_step`."""
    nxt = mixed - float(alpha_t) * (coeff[:, None] * x)
    return torch.where(alive[:, None] > 0, nxt, theta)


def dual_step(mixed: torch.Tensor, x: torch.Tensor, theta: torch.Tensor,
              coeff: torch.Tensor, alive: torch.Tensor,
              alpha_t: float) -> torch.Tensor:
    """Hybrid-mode pass 2: OMD dual step + crash freeze after a torch mix."""
    m, n = _node_shape("mixed", mixed)
    dev = mixed.device
    for name, t in (("mixed", mixed), ("x", x), ("theta", theta)):
        _check(name, t, (m, n), dev)
    for name, t in (("coeff", coeff), ("alive", alive)):
        _check(name, t, (m,), dev)
    if not on_card(dev, "dual_step"):
        return dual_step_plain(mixed, x, theta, coeff, alive, alpha_t)
    lib = library()
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = lib.rf_dual_step(
            mixed.data_ptr(), x.data_ptr(), theta.data_ptr(),
            coeff.data_ptr(), alive.data_ptr(), float(alpha_t), m, n,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on_error(code, "dual_step")
    dual_step.launches += 1
    return out


reset_launches()
