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

The schedule scalars (``lam_t`` of ``round_stats``, ``alpha_t`` of
``round_update``) are numbers, or one-element float32 tensors on the card
that the kernel reads: a round captured in a CUDA graph
(`repro_torch.api.round_graph`) points them into its row of the run's
constants table, so one capture serves every round.

``round_stats`` is one launch: each block stages its slab of theta and x
with all loads in flight at once, and the last block to finish (an int32
ticket counter, one per seed, device and stream, from
`launch.stream_counter`, reset by that block) sums every block's per-node
partials in a fixed order — no float atomics, bit-stable from run to run.

A seed axis: ``round_stats`` and ``round_update`` take theta, x (and
delta, recv, coeff, alive) either for one run, (m, n) and (m,), or for S
runs of one configuration stacked, (S, m, n) and (S, m) — the batch of
`repro_torch.api.run_batch`. The mix (A, its CSR form, diag) is shared by
the seeds. A batch is one launch, the seed a grid axis, and each seed's
outputs equal those of a call on its rows alone, bit for bit (kernel and
plain version alike).

``round_update`` mixes one of two ways. Given ``csr`` (a `MixCSR`, A's
non-zeros; `sparse_mix` builds one from a `SparseGraph` when no row holds
more than ``SPARSE_MAX_ROW_NNZ`` = 16 of them, as for the ring) it sums
only the non-zeros in the order they are stored, with neighbours' r from
shared memory; given only A it runs the dense tiled product. Both add with
fmaf from 0, the dense path in ascending k, so on the same A and a CSR
form in ascending columns they agree bit for bit.

Each wrapper checks device, dtype (float32), shape and contiguity and raises
on anything its kernel does not take. Given CPU tensors it computes its
plain PyTorch version (``*_plain``, beside it; ``round_update_plain``
mixes with ``A @ r``, or adds each row in the CSR form's order when given
one, as the sparse path does) — that is how the CPU tests run the fused
backend. Given CUDA tensors it allocates its outputs with ``torch.empty``, launches the kernel on the current stream and raises if the
launch failed; it never falls back. ``<wrapper>.launches`` counts kernel
launches (``round_update.sparse_launches`` those of the sparse path;
``reset_launches()`` zeroes them), so a run can show that it went through
the kernels. Unlike the TPU kernels, nothing is padded to (8, 128): the
kernels mask their ragged edges, and ``nnz`` is an exact int32 count.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.prox import soft_threshold
from repro_torch.kernels import build, work
from repro_torch.kernels.launch import check, on_card, stream_counter

__all__ = ["round_stats", "round_update", "dual_step", "round_stats_plain",
           "round_update_plain", "dual_step_plain", "reset_launches",
           "MixCSR", "sparse_mix", "SPARSE_MAX_ROW_NNZ", "SPARSE_MAX_NODES",
           "library", "SOURCE"]

SOURCE = "round_fused.cu"
_INT32_MAX = 2**31 - 1
_MAX_SEEDS = 65_535          # the seed is a grid axis (y or z)
# the sparse mix wins while a row's non-zeros are < ~0.6 m (csrc header);
# 16 keeps it there from m = 27 up, and the ring has 3
SPARSE_MAX_ROW_NNZ = 16
# the sparse path's block holds all m rows of its column slab
SPARSE_MAX_NODES = 2048
# the cuda backend's dense-A cap for the fused mode (``max_fused_nodes``):
# past it ``mode="auto"`` takes the hybrid path and ``"fused"`` raises
MAX_FUSED_NODES = 1024


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(SOURCE)
    P, F, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    lib.rf_stats_scratch_float4s.argtypes = [I, I, I]
    lib.rf_stats_scratch_float4s.restype = ctypes.c_int64
    lib.rf_round_stats.argtypes = [P, P, P, F, F, I, I, I, I, I, P, P, P, P,
                                   P, P, P, P]
    lib.rf_round_stats.restype = I
    lib.rf_round_update.argtypes = [P, P, P, P, P, P, P, P, P, F, I, I, I,
                                    I, I, I, P, P, P]
    lib.rf_round_update.restype = I
    lib.rf_round_update_sparse.argtypes = [P, P, P, I, P, P, P, P, P, P, P,
                                           P, F, I, I, I, I, I, I, P, P, P]
    lib.rf_round_update_sparse.restype = I
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


def _seed_shape(name: str, t: torch.Tensor) -> tuple[tuple, int, int, int]:
    """(lead, S, m, n) of an (m, n) tensor (lead = (), S = 1) or of an
    (S, m, n) seed batch (lead = (S,))."""
    if isinstance(t, torch.Tensor) and t.dim() == 3:
        S = int(t.shape[0])
        if not 1 <= S <= _MAX_SEEDS:
            raise ValueError(f"{name}: {S} seeds, the kernels take 1 to "
                             f"{_MAX_SEEDS}")
        return (S,), S, *_node_shape(name, t[0])
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name} must be an (m, n) or (S, m, n) tensor")
    return (), 1, *_node_shape(name, t)


def _scalar(name: str, v, device: torch.device) -> tuple[int | None, float]:
    """(pointer, value) of a schedule scalar: a Python number goes by value;
    a one-element float32 tensor on ``device`` (a captured round's row of its
    constants table) by pointer, its value read by the kernel."""
    if not isinstance(v, torch.Tensor):
        return None, float(v)
    if v.device != device or v.dtype != torch.float32 or v.numel() != 1:
        raise ValueError(f"{name} must be a number or a one-element float32 "
                         f"tensor on {device}, got {v.dtype} {tuple(v.shape)} "
                         f"on {v.device}")
    return v.data_ptr(), 0.0


def _vec(n: int, *ts: torch.Tensor) -> int:
    """4 when rows can be read as float4 (n % 4 == 0, 16-byte aligned
    data), else 1."""
    return 4 if n % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in ts) \
        else 1


def reset_launches() -> None:
    """Zero the launch counts of all three wrappers."""
    for fn in (round_stats, round_update, dual_step):
        fn.launches = 0
    round_update.sparse_launches = 0


# ---------------------------------------------------------------------------
# round_stats
# ---------------------------------------------------------------------------

def _per_seed(fn, *ts):
    """``fn`` on each seed's slices of (S, ...) tensors, its outputs
    stacked on a leading seed axis: a batch computes what S calls do."""
    outs = [fn(*row) for row in zip(*ts)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def round_stats_plain(theta, x, lam_t, m_real, *, prox_l1: bool = True):
    """Plain PyTorch version of `round_stats` (same outputs and types; a
    seed batch seed by seed)."""
    if theta.dim() == 3:
        return _per_seed(lambda t, xx: round_stats_plain(
            t, xx, lam_t, m_real, prox_l1=prox_l1), theta, x)
    w = soft_threshold(theta, lam_t) if prox_l1 else theta
    wsum = w.sum(dim=0)
    return ((w * x).sum(dim=1), (x * x).sum(dim=1),
            (w != 0).sum(dim=1, dtype=torch.int32),
            ((wsum / float(m_real)) * x).sum(dim=1), wsum)


def round_stats(theta: torch.Tensor, x: torch.Tensor, lam_t,
                m_real: int, *, prox_l1: bool = True,
                counter: torch.Tensor | None = None):
    """Per-node round statistics in one pass over theta and x.

    Returns ``(dot, xsq, nnz, wbdot, wsum)``: four (m,) per-node reductions
    (``nnz`` int32, the others float32) and the (n,) column sums of w —
    for an (S, m, n) seed batch, (S, m) and (S, n), one launch.
    ``m_real`` is the node count w_bar averages over (m on this path).
    ``lam_t`` is a number, or a one-element float32 tensor on theta's
    device that the kernel reads (a captured round's constants row).
    ``counter``: the kernel's int32 ticket counters (at least S, zeroed) in
    place of the stream's (`launch.stream_counter`): a captured round owns
    its own.
    """
    lead, S, m, n = _seed_shape("theta", theta)
    dev = theta.device
    _check("theta", theta, (*lead, m, n), dev)
    _check("x", x, (*lead, m, n), dev)
    with work.scope("round_stats", m, n, seeds=S):
        if not on_card(dev, "round_stats"):
            return round_stats_plain(theta, x, lam_t, m_real, prox_l1=prox_l1)
        lib = library()
        lam_p, lam_v = _scalar("lam_t", lam_t, dev)
        vec = _vec(n, theta, x)
        scratch = torch.empty(4 * S * int(lib.rf_stats_scratch_float4s(m, n,
                                                                       vec)),
                              dtype=torch.float32, device=dev)
        dot, xsq, wbdot = (torch.empty((*lead, m), dtype=torch.float32,
                                       device=dev) for _ in range(3))
        nnz = torch.empty((*lead, m), dtype=torch.int32, device=dev)
        wsum = torch.empty((*lead, n), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            if counter is None:
                counter = stream_counter("round_stats", dev, stream, S)
            code = lib.rf_round_stats(
                theta.data_ptr(), x.data_ptr(), lam_p, lam_v, float(m_real),
                int(bool(prox_l1)), S, m, n, vec, scratch.data_ptr(),
                counter.data_ptr(),
                dot.data_ptr(), xsq.data_ptr(), nnz.data_ptr(),
                wbdot.data_ptr(), wsum.data_ptr(), stream.cuda_stream)
        _raise_on_error(code, "round_stats")
        round_stats.launches += 1
        return dot, xsq, nnz, wbdot, wsum


# ---------------------------------------------------------------------------
# round_update
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MixCSR:
    """CSR form of a fixed (m, m) mixing matrix, for ``round_update``'s
    sparse path: row i's non-zeros are ``weights[indptr[i]:indptr[i+1]]``
    at columns ``indices[...]``. The kernel adds a row's terms in the
    order they are stored: with ``order="ascending"`` (`from_graph`) the
    columns rise strictly in each row, the order of a dense product; with
    ``order="stored"`` (`ring_roll`: the order of the ring's torch-op
    mixer) no column repeats in a row. Built once per run; construction
    checks the types and shapes and, on one host copy, the values, and
    raises on anything malformed."""

    indptr: torch.Tensor     # (m + 1,) int32
    indices: torch.Tensor    # (nnz,) int32
    weights: torch.Tensor    # (nnz,) float32
    order: str = "ascending"

    def __post_init__(self):
        for name, dtype in (("indptr", torch.int32), ("indices", torch.int32),
                            ("weights", torch.float32)):
            t = getattr(self, name)
            if not isinstance(t, torch.Tensor):
                raise TypeError(f"MixCSR.{name} must be a torch.Tensor, got "
                                f"{type(t).__name__}")
            if t.dtype != dtype:
                raise TypeError(f"MixCSR.{name} must be {dtype}, got "
                                f"{t.dtype}")
            if t.dim() != 1 or not t.is_contiguous():
                raise ValueError(f"MixCSR.{name} must be a contiguous 1-D "
                                 f"tensor, got shape {tuple(t.shape)}")
            if t.device != self.indptr.device:
                raise ValueError(f"MixCSR.{name} is on {t.device}, indptr "
                                 f"on {self.indptr.device}")
        if self.indptr.numel() < 2:
            raise ValueError("MixCSR.indptr needs m + 1 >= 2 entries")
        if self.indices.numel() != self.weights.numel():
            raise ValueError(f"MixCSR: {self.indices.numel()} indices but "
                             f"{self.weights.numel()} weights")
        ptr = self.indptr.cpu().numpy().astype(np.int64)
        idx = self.indices.cpu().numpy().astype(np.int64)
        nnz, m = idx.size, ptr.size - 1
        if ptr[0] != 0 or ptr[-1] != nnz or np.any(np.diff(ptr) < 0):
            raise ValueError(f"MixCSR.indptr must rise from 0 to nnz={nnz}, "
                             f"got {ptr[0]} .. {ptr[-1]}")
        if nnz and (idx.min() < 0 or idx.max() >= m):
            raise ValueError(f"MixCSR.indices out of range for m={m}")
        rows = np.repeat(np.arange(m), np.diff(ptr))
        if self.order == "ascending":
            if np.any(np.diff(rows * m + idx) <= 0):
                raise ValueError("MixCSR.indices must rise strictly in each "
                                 "row")
        elif self.order == "stored":
            if np.unique(rows * m + idx).size != nnz:
                raise ValueError("MixCSR.indices must not repeat a column "
                                 "in a row")
        else:
            raise ValueError(f"MixCSR.order must be 'ascending' or 'stored',"
                             f" got {self.order!r}")

    @property
    def m(self) -> int:
        return self.indptr.numel() - 1

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @classmethod
    def from_graph(cls, graph, device) -> "MixCSR":
        """The CSR form of a `SparseGraph` (edges sorted by (dst, src),
        duplicates merged): exactly the non-zeros ``graph.to_dense()``
        holds, in ascending column order."""
        dev = torch.device(device)
        return cls(
            indptr=torch.as_tensor(graph.indptr.astype(np.int32), device=dev),
            indices=torch.as_tensor(graph.src.astype(np.int32), device=dev),
            weights=torch.as_tensor(graph.weight.astype(np.float32),
                                    device=dev))


    @classmethod
    def ring_roll(cls, m: int, self_weight: float, device) -> "MixCSR":
        """The ring's CSR form (m >= 3) with each row's terms in the order
        `RingRollMixer` adds them — self, then node i-1, then node i+1 —
        so the kernel rounds as the reference backend's ring (a row added
        in ascending columns rounds its wrap-around rows 0 and m-1
        otherwise)."""
        if m < 3:
            raise ValueError(f"the ring's roll order needs m >= 3, got {m}")
        i = np.arange(m)
        nw = np.float32((1.0 - self_weight) / 2.0)
        dev = torch.device(device)
        return cls(
            indptr=torch.as_tensor(3 * np.arange(m + 1, dtype=np.int32),
                                   device=dev),
            indices=torch.as_tensor(np.stack(
                [i, (i - 1) % m, (i + 1) % m], axis=1).ravel().astype(
                    np.int32), device=dev),
            weights=torch.as_tensor(np.tile(np.asarray(
                [self_weight, nw, nw], np.float32), m), device=dev),
            order="stored")


def sparse_mix(graph, device) -> MixCSR | None:
    """``graph``'s CSR form when no row holds more than
    ``SPARSE_MAX_ROW_NNZ`` non-zeros (the sparse path pays then) and the
    sparse path takes its m, else None (the dense path)."""
    if graph.m > SPARSE_MAX_NODES or \
            int(np.max(np.diff(graph.indptr))) > SPARSE_MAX_ROW_NNZ:
        return None
    return MixCSR.from_graph(graph, device)


def _csr_product(csr: MixCSR, r: torch.Tensor) -> torch.Tensor:
    """``A @ r`` from A's CSR form, each row's terms added in their stored
    order (the sparse path's order), one multiply-add per term."""
    ptr = csr.indptr.long()
    idx, w = csr.indices.long(), csr.weights
    deg = ptr[1:] - ptr[:-1]
    out = torch.zeros_like(r)
    for k in range(int(deg.max())):
        rows = torch.nonzero(deg > k).flatten()
        e = ptr[rows] + k
        out[rows] = torch.addcmul(out[rows], w[e][:, None], r[idx[e]])
    return out


def round_update_plain(A, theta, delta, x, recv, coeff, diag, alive,
                       alpha_t, use_recv, noise_self, csr=None):
    """Plain PyTorch version of `round_update`: (theta_next, tilde). With
    ``csr`` the mix adds each row in the CSR form's order, as the sparse
    path does; without it, ``A @ r``. A seed batch seed by seed."""
    if theta.dim() == 3:
        return _per_seed(lambda th, d, xx, rv, cf, al: round_update_plain(
            A, th, d, xx, rv, cf, diag, al, alpha_t, use_recv, noise_self,
            csr), theta, delta, x, recv, coeff, alive)
    tilde = theta + delta
    r = recv if use_recv else tilde
    s = tilde if noise_self else theta
    mixed = (A @ r if csr is None else _csr_product(csr, r)) \
        + diag[:, None] * (s - r)
    nxt = mixed - float(alpha_t) * (coeff[:, None] * x)
    return torch.where(alive[:, None] > 0, nxt, theta), tilde


def round_update(A: torch.Tensor, theta: torch.Tensor, delta: torch.Tensor,
                 x: torch.Tensor, recv: torch.Tensor, coeff: torch.Tensor,
                 diag: torch.Tensor, alive: torch.Tensor, alpha_t,
                 use_recv: int, noise_self: bool,
                 csr: MixCSR | None = None):
    """Fused noise-add + gossip mix + dual step + crash freeze.

    ``A`` is the (m, m) mixing matrix, ``recv`` the stale broadcast block
    read when ``use_recv`` is set (any (m, n) tensor otherwise), ``coeff``
    the clipped hinge coefficient (grad = coeff * x), ``alive`` 1.0 except
    on frozen rows. ``alpha_t`` is a number, or a one-element float32
    tensor on theta's device that the kernel reads. ``csr``, A's CSR form,
    selects the sparse path on the card (m <= ``SPARSE_MAX_NODES``);
    without it the dense path runs.
    Returns ``(theta_next, tilde)``. For a seed batch theta, delta, x,
    recv are (S, m, n), coeff and alive (S, m), and so are the outputs; A,
    ``csr`` and diag are shared.
    """
    lead, S, m, n = _seed_shape("theta", theta)
    dev = theta.device
    _check("A", A, (m, m), dev)
    _check("diag", diag, (m,), dev)
    for name, t in (("theta", theta), ("delta", delta), ("x", x),
                    ("recv", recv)):
        _check(name, t, (*lead, m, n), dev)
    for name, t in (("coeff", coeff), ("alive", alive)):
        _check(name, t, (*lead, m), dev)
    if csr is not None:
        if not isinstance(csr, MixCSR):
            raise TypeError(f"csr must be a MixCSR, got {type(csr).__name__}")
        if csr.m != m:
            raise ValueError(f"csr is for m={csr.m}, theta has m={m}")
        if csr.device != dev:
            raise ValueError(f"csr is on {csr.device}, expected {dev}")
    nnz = None if csr is None else csr.indices.numel()
    with work.scope("round_update", m, n, nnz=nnz, seeds=S):
        if not on_card(dev, "round_update"):
            return round_update_plain(A, theta, delta, x, recv, coeff, diag,
                                      alive, alpha_t, use_recv, noise_self,
                                      csr=csr)
        if csr is not None and m > SPARSE_MAX_NODES:
            raise ValueError(
                f"round_update's sparse path holds all m rows of a column "
                f"slab in a block: m <= {SPARSE_MAX_NODES}, got m={m}")
        lib = library()
        out = torch.empty((*lead, m, n), dtype=torch.float32, device=dev)
        tilde = torch.empty((*lead, m, n), dtype=torch.float32, device=dev)
        vec = _vec(n, theta, delta, x, recv)
        flags = (*_scalar("alpha_t", alpha_t, dev), int(bool(use_recv)),
                 int(bool(noise_self)), S, m, n, vec, out.data_ptr(),
                 tilde.data_ptr())
        rows = (theta.data_ptr(), delta.data_ptr(), x.data_ptr(),
                recv.data_ptr(), coeff.data_ptr(), diag.data_ptr(),
                alive.data_ptr())
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            if csr is not None:
                code = lib.rf_round_update_sparse(
                    csr.indptr.data_ptr(), csr.indices.data_ptr(),
                    csr.weights.data_ptr(), csr.indices.numel(), *rows, *flags,
                    stream)
            else:
                code = lib.rf_round_update(A.data_ptr(), *rows, *flags, stream)
        _raise_on_error(code, "round_update")
        round_update.launches += 1
        if csr is not None:
            round_update.sparse_launches += 1
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
    with work.scope("dual_step", m, n):
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
