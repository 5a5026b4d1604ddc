"""Fixed-trip loops that an op count may shorten.

The models' layer, time-step and chunk loops, and the train steps' node
and micro-batch loops, are written ``for i in loop(n, like): ...``. Outside
an op count, or over a tensor that is not on ``meta``, that is
``range(n)`` and changes nothing. Inside a count (`tracking`, entered by
`repro_torch.launch.op_cost.count`) over a ``meta`` tensor, where nothing is
stored and only the count matters, the loop runs a few representative
iterations instead, each weighted by the iterations it stands for, as
`hlo_cost` multiplies a ``while`` body by its ``known_trip_count``: the
first (weight 1), one of each group of alike middle iterations (``key``),
and the last two (weight 1 each); with ``independent=True`` one iteration
weighted ``n``.

Every op is multiplied by the weights of the iterations it runs in
(`Tracker.weight`): the forward's by the iterations active when it runs;
the backward's by those active when its autograd node was created (nodes
are told apart by their sequence numbers); a rematerialised forward
(`replayed`) by those of its first run. The first and last ones stand
alone because they differ from the rest under autograd: the first's
carried input may need no gradient, the last's carried output may get
none (so the gradients the last iteration sends out of the loop may start
one iteration earlier), and the gradients a loop sends to a tensor outside
it are summed in the backward's order, last iteration first: the first to
arrive is stored, and the engine's accumulation adds land on the
iterations before it, with their weights, as in the full loop.
`Loop.full` pads a list of per-iteration results to ``n`` entries with
free ``empty_like`` stand-ins, so what follows the loop sees the full
loop's shapes; `Loop.stand_in` marks the tensors of iterations that did
not run (per-layer parameters), whose gradients the counted step then
makes free (`stands_in`).

The weights read three private autograd hooks of torch:
``torch._C._autograd._get_sequence_nr()``,
``torch._C._current_autograd_node()`` and a node's ``_sequence_nr()``
(the tests hold their behaviour, so an upgrade that changes them fails
there, not silently in a count).

>>> list(loop(3, torch.ones(2)))
[0, 1, 2]
"""
from __future__ import annotations

import bisect
import contextlib
import math
import threading

import torch

from repro_torch.core import tree

__all__ = ["Loop", "Tracker", "loop", "replayed", "stands_in", "tracking"]

_LOCAL = threading.local()


class _Iteration:
    """One representative iteration of a loop: the iterations it stands
    for. Compared by identity."""

    __slots__ = ("weight",)

    def __init__(self, weight: int):
        self.weight = weight


def _product(*groups) -> int:
    """The product of the weights of the iterations in ``groups``, each
    iteration once however many groups hold it."""
    seen = {}
    for group in groups:
        for it in group:
            seen[id(it)] = it.weight
    return math.prod(seen.values())


class Tracker:
    """The iterations of the shortened loops, for one count on one thread.

    ``active`` is the stack of representatives running now;
    ``starts``/``tags`` map autograd sequence numbers to the stack that was
    active when each node was made (the weights its backward runs under).
    ``record(func, args, kwargs, out)`` adds one op to the count (`Loop.stack`
    makes its output by shape and records the full stack's op)."""

    def __init__(self, record):
        self.record = record
        self.thread = threading.get_ident()
        self.active: list = []
        self.replay: list = []          # `replayed` forwards being re-run
        self.starts = [torch._C._autograd._get_sequence_nr()]
        self.tags = [()]
        self.stand_ins: set = set()     # ids of tensors `Loop.stand_in`
        self.keep: list = []            # ... kept alive while counted

    def mark(self) -> None:
        """The nodes made from now on carry the active iterations."""
        if not torch.is_grad_enabled() or \
                threading.get_ident() != self.thread:
            return
        seq = torch._C._autograd._get_sequence_nr()
        if seq == self.starts[-1]:
            self.tags[-1] = tuple(self.active)
        else:
            self.starts.append(seq)
            self.tags.append(tuple(self.active))

    def _tag(self, node) -> tuple:
        i = bisect.bisect_right(self.starts, node._sequence_nr()) - 1
        return self.tags[i] if i >= 0 else ()

    def weight(self) -> int:
        """The iterations the op running now stands for."""
        node = torch._C._current_autograd_node()
        if node is None:
            context = ()
        elif torch.is_grad_enabled() and self.replay:
            context = self.replay[-1]   # a rematerialised forward
        else:
            context = self._tag(node)   # the backward of ``node``
        if not context and not self.active:
            return 1
        return _product(self.active, context)


def _tracker() -> Tracker | None:
    return getattr(_LOCAL, "tracker", None)


@contextlib.contextmanager
def tracking(record):
    """A `Tracker` on this thread for the block: the loops over ``meta``
    tensors in it are shortened."""
    prev = _tracker()
    _LOCAL.tracker = Tracker(record)
    try:
        yield _LOCAL.tracker
    finally:
        _LOCAL.tracker = prev


class Loop:
    """``for i in loop: ...`` over the indices that run (see the module
    docstring); `full` pads the per-iteration results."""

    def __init__(self, n: int, reps=None, tracker=None):
        self.n = n
        self.reps = reps            # [(index, weight, members)] or None
        self.tracker = tracker

    def __len__(self) -> int:
        return self.n

    def __iter__(self):
        if self.reps is None:
            yield from range(self.n)
            return
        tracker = self.tracker
        for index, weight, _ in self.reps:
            it = _Iteration(weight)
            tracker.active.append(it)
            tracker.mark()
            try:
                yield index
            finally:
                tracker.active.remove(it)
                tracker.mark()

    def stand_in(self, items: list) -> None:
        """Mark the tensors of ``items`` (one an iteration) whose iteration
        a representative stands for: their gradients are stand-ins too
        (`stands_in`)."""
        if self.reps is None:
            return
        for _, _, members in self.reps:
            for j in members[1:]:
                for t in tree.leaves(items[j]):
                    self.tracker.stand_ins.add(id(t))
                    self.tracker.keep.append(t)

    def stack(self, items: list, dim: int = 0) -> torch.Tensor:
        """``torch.stack`` of the full loop's list (`full`), ``dim`` >= 0:
        shortened, its count, with the output made by shape."""
        if self.reps is None:
            return torch.stack(items, dim)
        return _StackByShape.apply(self, dim, *items)

    def full(self, items: list) -> list:
        """``items``, one a representative iteration in order, as the list
        the full loop makes: the other iterations' entries an
        ``empty_like`` of their representative's (the same shapes, no
        storage, no op; one for the group, needing no gradient)."""
        if self.reps is None:
            return items
        out = [None] * self.n
        for item, (_, _, members) in zip(items, self.reps):
            out[members[0]] = item
            if len(members) > 1:        # one stand-in serves the group
                filler = tree.tree_map(torch.empty_like, item)
                for j in members[1:]:
                    out[j] = filler
        return out


class _StackByShape(torch.autograd.Function):
    """`Loop.stack` shortened: the full stack's count, its output made by
    shape (an n-way stack on meta runs slowly in Python); the backward
    hands each representative its slice, as a stack's does."""

    @staticmethod
    def forward(ctx, loop, dim, *reps):
        full = loop.full(list(reps))
        shape = list(reps[0].shape)
        shape.insert(dim, loop.n)
        out = reps[0].new_empty(shape)
        loop.tracker.record(torch.ops.aten.stack.default, (full, dim), {},
                            out)
        ctx.dim = dim
        ctx.index = [index for index, _, _ in loop.reps]
        return out

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *[grad.select(ctx.dim, i) for i in ctx.index])


def loop(n: int, like: torch.Tensor, *, key=None,
         independent: bool = False) -> Loop:
    """The iterations ``0 .. n-1`` of a fixed-trip loop over ``like``.

    Inside a count (`tracking`) with ``like`` on ``meta``, the loop runs
    representatives: the first and the last two iterations alone, and of
    the others the first of each group with one ``key(i)`` (all one group
    without ``key``), each weighted by the iterations it stands for;
    ``independent=True`` (iterations that share no autograd graph) runs
    iteration 0 weighted ``n``. Otherwise every iteration runs."""
    tracker = _tracker()
    if tracker is None or n <= 1 or like.device.type != "meta":
        return Loop(n)
    if independent:
        return Loop(n, [(0, n, list(range(n)))], tracker)
    if n <= 4:
        return Loop(n)
    groups: dict = {}
    for i in range(1, n - 2):
        groups.setdefault(None if key is None else key(i), []).append(i)
    reps = [(0, 1, [0])] + [(m[0], len(m), m) for m in groups.values()] + \
        [(n - 2, 1, [n - 2]), (n - 1, 1, [n - 1])]
    return Loop(n, reps, tracker)


def stands_in(t: torch.Tensor) -> bool:
    """Whether ``t`` belongs to an iteration a representative stood for
    (`Loop.stand_in`) in the active count."""
    tracker = _tracker()
    return tracker is not None and id(t) in tracker.stand_ins


def replayed(fn):
    """``fn`` for `torch.utils.checkpoint`: inside a count, its re-run in
    the backward is weighted by the iterations active at its first run
    (the backward's own node tells nothing about it); else ``fn``
    itself."""
    tracker = _tracker()
    if tracker is None:
        return fn
    first: list = []

    def wrapped(*args, **kwargs):
        if not first:
            first.append(tuple(tracker.active))
            return fn(*args, **kwargs)
        tracker.replay.append(first[0])
        try:
            return fn(*args, **kwargs)
        finally:
            tracker.replay.pop()
    return wrapped
