"""Op-count cost model: flops and memory bytes of one eager call.

Counterpart of `repro.launch.hlo_cost.analyze`, which rolls flops, HBM
bytes and collective bytes out of a compiled program's HLO text. The port
has no compiled program to read: its chunk is a Python loop of eager torch
ops and kernel launches. So `count` runs the function once under a
``TorchDispatchMode`` and sums what every aten op does, by `hlo_cost`'s own
rules:

  flops      matmul-family ops (mm, addmm, bmm, mv, dot, ...): 2 * result
             elements * contracted elements (plus the add of an
             ``add*`` op); pointwise ops (and the random fills): 1 an
             output element, transcendentals weighted as `hlo_cost`'s
             ``_ELEMWISE_TRANS``; reductions: their input elements.
  hbm bytes  every op's tensor operands and results. In eager mode every
             op does read and write memory, so no fusion discount applies.
             Views (``view``, ``t``, ``expand``, ``select``, ``slice``, ...)
             and bare allocations count nothing.
  kernels    a kernel wrapper of `repro_torch.kernels` reports its
             `kernels.work.work` numbers as one row and hides its inside
             (the plain version on the CPU, the launch's allocations on the
             card), so one call counts the same on either device.
  collective bytes
             0: the port runs on one card.

The mode is entered only around the counted call, on the calling thread
(dispatch modes are thread-local), so another thread's ops are never
counted.

Fixed-trip loops (`repro_torch.core.loops.loop`): a count is a
`loops.tracking` scope, so a loop over ``meta`` tensors inside it runs its
representative iterations, each op weighted by the iterations it stands
for; over a real tensor every iteration runs, and counts the same.

>>> import torch
>>> a = torch.ones(64, 32)
>>> _, c = count(lambda x: x @ x.t() + 1.0, a)
>>> c.flops == 2 * 64 * 64 * 32 + 64 * 64
True
>>> c.hbm_bytes == 4 * (64 * 32 * 2 + 64 * 64) + 4 * (64 * 64 * 2)
True
>>> sorted(c.ops)
['aten.add', 'aten.mm']
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import loops
from repro_torch.kernels import work as kernel_work

__all__ = ["OpCost", "count"]

# hlo_cost._ELEMWISE_TRANS, by aten name
_ELEMWISE_TRANS = {"exp": 4, "exp2": 4, "log": 4, "log2": 4, "log10": 4,
                   "log1p": 4, "tanh": 6, "rsqrt": 2, "sqrt": 2, "pow": 8,
                   "sigmoid": 6, "expm1": 4, "sin": 6, "cos": 6, "atan2": 8,
                   "erf": 6}
# ops whose result is the product of two operands, and the operand whose
# last dimension is contracted (a vector's only one)
_MATMUL = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "vdot": 0, "addmm": 1,
           "baddbmm": 1, "addmv": 1, "_addmm_activation": 1}
# not views by the dispatcher's schema, but they move no data
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "_unsafe_view", "detach",
         "alias", "_reshape_alias", "resize_", "set_"}


@dataclasses.dataclass
class OpCost:
    """What one counted call does. ``ops`` has one row an op name
    (``aten.<name>``, or ``kernel.<name>`` for a kernel wrapper):
    ``{"calls", "flops", "bytes"}``."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    ops: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, flops: float, nbytes: float,
            weight: int = 1) -> None:
        """One call of ``name`` (``weight`` alike calls)."""
        row = self.ops.setdefault(name, {"calls": 0, "flops": 0.0,
                                         "bytes": 0.0})
        row["calls"] += weight
        row["flops"] += flops * weight
        row["bytes"] += nbytes * weight
        self.flops += flops * weight
        self.hbm_bytes += nbytes * weight

    def scaled(self, k: int) -> "OpCost":
        """The count of ``k`` such calls (a chunk of ``k`` rounds)."""
        return OpCost(flops=self.flops * k, hbm_bytes=self.hbm_bytes * k,
                      collective_bytes=self.collective_bytes * k,
                      ops={name: {key: v * k for key, v in row.items()}
                           for name, row in self.ops.items()})

    def share(self, prefix: str) -> tuple[float, float]:
        """(flops, bytes) of the rows whose name starts with ``prefix``
        (``"kernel."``: the kernels' share; ``"aten."``: the torch ops')."""
        rows = [r for name, r in self.ops.items() if name.startswith(prefix)]
        return (sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows))

    def top(self, k: int = 10) -> list:
        """The ``k`` rows that move the most bytes: (name, row)."""
        return sorted(self.ops.items(), key=lambda kv: -kv[1]["bytes"])[:k]

    def summary(self) -> dict:
        kf, kb = self.share("kernel.")
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "kernel_flops": kf, "kernel_bytes": kb,
                "ops": {name: dict(row) for name, row in self.ops.items()}}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _op_flops(name: str, func, args, outs) -> float:
    out_elems = sum(t.numel() for t in outs)
    if name in _MATMUL:
        ins = _tensors(args)
        lhs = ins[_MATMUL[name]] if len(ins) > _MATMUL[name] else None
        contracted = lhs.shape[-1] if lhs is not None and lhs.dim() else 1
        extra = out_elems if _MATMUL[name] else 0      # the add of add*
        return 2.0 * out_elems * contracted + extra
    tags = func.tags
    if torch.Tag.reduction in tags:
        ins = _tensors(args)
        return float(ins[0].numel()) if ins else 0.0
    if torch.Tag.pointwise in tags or torch.Tag.nondeterministic_seeded in \
            tags:
        return float(out_elems * _ELEMWISE_TRANS.get(name, 1))
    return 0.0


class _Counter:
    """The running count: aten ops from the dispatch mode, kernel rows from
    the wrappers (`kernels.work.scope`); ``mask`` > 0 inside a wrapper.
    ``loops`` weighs each op by the loop iterations it stands for."""

    def __init__(self):
        self.cost = OpCost()
        self.mask = 0
        self.loops = None

    def weight(self) -> int:
        return self.loops.weight()

    def kernel(self, name: str, nbytes: int, flops: int) -> None:
        self.cost.add(f"kernel.{name}", float(flops), float(nbytes),
                      self.weight())

    def op(self, func, args, kwargs, out) -> None:
        if func.is_view:
            return
        name = func.overloadpacket.__name__
        if name in _FREE:
            return
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        self.cost.add(f"aten.{name}", _op_flops(name, func, args, outs),
                      float(_nbytes(ins) + _nbytes(outs)), self.weight())


class _CountingMode(TorchDispatchMode):
    def __init__(self, counter: _Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.counter.mask:
            self.counter.op(func, args, kwargs, out)
        return out


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), OpCost)``: run ``fn`` once and count what
    it does (see the module docstring)."""
    counter = _Counter()
    with loops.tracking(counter.op) as tracker, \
            kernel_work.counting(counter), _CountingMode(counter):
        counter.loops = tracker
        out = fn(*args, **kwargs)
    return out, counter.cost
