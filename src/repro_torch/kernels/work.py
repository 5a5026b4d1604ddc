"""The work of each kernel, from its shapes, and its report to an op count.

`work` gives the bytes a kernel must move (each input read once, each
output written once) and the flops it does, at the flags the main path
uses. It is the one count of a kernel's work in the repository: the
roofline bound of ``chip_smoke.py``'s kernels line and the kernel rows of
`repro_torch.launch.op_cost` both read it.

Each kernel wrapper runs its body inside `scope`, which is also its
``kernel.<name>`` span (`repro_torch.obs.span`): the wrapper's host time,
output allocations, ``stream_counter`` and the ``ctypes`` launch, while
telemetry is on or a profiler records. With neither, and no op count active
on the calling thread (every run but a traced or counting one), that is a
shared null context. Under `repro_torch.launch.op_cost.count` the wrapper
adds its kernel's `work` to the count as one row, and the count ignores
the ops inside: the plain version's torch ops on the CPU, the output
allocations beside the ``ctypes`` launch on the card (which the dispatcher
never sees). So a round counts the same on either device.

>>> work("round_stats", 64, 10_000)
(5161024, 7680000)
>>> work("round_update", 64, 10_000, nnz=192)       # the ring's CSR form
(12802564, 8960000)
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.obs import NULL_SPAN, span

__all__ = ["work", "scope", "counting", "active"]


def work(name: str, m: int, n: int, nnz: int | None = None,
         seeds: int = 1, grad_bytes: int = 4, k: int = 0) -> tuple[int, int]:
    """(bytes, flops) of one launch at the main path's flags: each input
    read once, each output written once. For ``round_update`` the mix is
    the dense (m, m) A (m^2 floats in, 2 m^2 n flops) unless ``nnz`` is
    given: then A's CSR form with nnz non-zeros (m + 1 + 2 nnz words in,
    2 nnz n flops) — the ring's 3 m on the main path. ``seeds`` > 1: a
    batched launch, every per-seed array S times, the mix and diag once
    (the seeds share them). ``pdomd_update`` takes (rows, 128) as (m, n),
    ``hinge_grad`` (B, n), ``dual_step`` its (m, n) rows, ``gossip_update``
    a leaf's m nodes of n coordinates, its gradient ``grad_bytes`` an
    element. The tied unembedding's products (``unembed_gemm``) take their
    (m, n) output and depth ``k``: x (M, d) and table (V, d) bf16, g (M, V)
    f32; the flops are the bf16 MMA they run, three passes a gradient."""
    mn, S = m * n, seeds
    if name == "round_stats":      # theta, x in; dot, xsq, nnz, wbdot, wsum
        return S * 4 * (2 * mn + 4 * m + n), S * 12 * mn
    if name.startswith("round_update"):   # A, diag shared; theta, delta, x,
        a_words, mix_flops = ((m * m, 2 * m * m * n) if nnz is None  # coeff,
                              else (m + 1 + 2 * nnz, 2 * nnz * n))   # alive
        return (4 * (a_words + m + S * (3 * mn + 2 * m + 2 * mn)),   # in;
                S * (mix_flops + 8 * mn))       # next, tilde out per seed
    if name == "pdomd_update":     # four (rows, 128) in; w, theta_new out
        return 4 * 6 * mn, 10 * mn
    if name == "hinge_grad":       # x, y, w in; loss, margin, g out
        return 4 * (mn + 3 * m + 2 * n), 4 * mn
    if name == "dual_step":        # mixed, x, theta, coeff, alive in; out
        return 4 * (3 * mn + 2 * m + mn), 3 * mn
    if name == "gossip_update":    # theta, u, grad, factor in; next, zeros
        return (12 + grad_bytes) * mn + 4 * m + 8, 25 * mn
    if name == "unembed_logits":      # (M, V) out: x, table in; logits out
        return 2 * (m + n) * k + 4 * mn, 2 * mn * k
    if name == "unembed_grad_x":      # (M, d) out: g, table in; dx out
        return 4 * m * k + 2 * k * n + 2 * mn, 6 * mn * k
    if name == "unembed_grad_table":  # (V, d) out: g, x in; dtable out
        return 4 * k * m + 2 * k * n + 2 * mn, 6 * mn * k
    raise ValueError(f"no work count for kernel {name!r}")


_LOCAL = threading.local()
_NULL = NULL_SPAN           # the shared null context: no count, no span


def active():
    """The op count active on this thread (`op_cost`'s), or None."""
    return getattr(_LOCAL, "counter", None)


@contextlib.contextmanager
def counting(counter):
    """Make ``counter`` this thread's active op count for the block.

    ``counter`` takes ``kernel(name, nbytes, flops)`` and has an integer
    ``mask``: while it is above 0 the count ignores the ops it sees."""
    prev = active()
    _LOCAL.counter = counter
    try:
        yield counter
    finally:
        _LOCAL.counter = prev


@contextlib.contextmanager
def _report(counter, name: str, args: tuple, kw: dict):
    if not counter.mask:
        counter.kernel(name, *work(name, *args, **kw))
    counter.mask += 1
    try:
        yield
    finally:
        counter.mask -= 1


@contextlib.contextmanager
def _spanned(sp, report):
    with sp, report:
        yield


def scope(name: str, *args, **kw):
    """The context a kernel wrapper runs its body in: its ``kernel.<name>``
    span (the shared null span while no sink is live) and, under an active
    op count, the kernel's `work` (``work(name, *args, **kw)``) reported as
    one row with the body's own ops masked."""
    sp = span("kernel." + name)
    counter = active()
    if counter is None:
        return sp
    report = _report(counter, name, args, kw)
    return report if sp is _NULL else _spanned(sp, report)
