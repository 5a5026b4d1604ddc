"""Mixer — the gossip topology stage of the round pipeline.

Counterpart of `repro.api.mixers`. A Mixer applies the doubly-stochastic
A(t) of Assumption 1 along axis 0 (the node axis) of an (m, n) tensor. The
mix signature carries both the clean theta and the noised broadcast copy
theta~, so the mixer owns the noise-placement algebra: with
``noise_self=True`` (Algorithm 1 line 10) the self-term uses theta~; with
False the own-noise contribution ``diag(A) * (theta~ - theta)`` is removed.

Delayed (WAN) mixing: the engine keeps a (depth, m, n) ring of past theta~
broadcasts and hands it to :meth:`MixerBase.mix_history`. Round t writes
slot t % depth, so the copy from d rounds ago lives at slot (t - d) % depth.
The round counter is a host int here, so the ring primitives index
directly; ``ring_write`` writes in place (the ring belongs to the engine
state, which the round replaces).

Every topology of the reference is here: the ring (``torch.roll``), the
complete and disconnected graphs, the alternating ring, any (possibly
time-varying) dense schedule (`DenseMatrixMixer`, behind ``dense``,
``torus``, ``hypercube``, ``random`` and ``time_varying``), any fixed
edge list (`SparseMixer`, O(edges)), the uniform delay wrapper and per-edge
heterogeneous delays (`HeterogeneousDelayMixer`). A mixer keeps its
constant tensors on the host and copies them to a device once, the first
time it mixes there.

>>> import torch
>>> from repro_torch.api.mixers import MIXERS
>>> mixer = MIXERS.build("ring", m=4, self_weight=0.5)
>>> mixer.apply(torch.arange(4.0).reshape(4, 1), 0)[:, 0].tolist()
[1.0, 1.0, 2.0, 2.0]
>>> MIXERS.build("delayed", m=4, inner="ring", delay=2).delay
2
>>> x = torch.arange(4.0)[:, None]
>>> MIXERS.build("complete", m=4).apply(x, 0)[:, 0].tolist()
[1.5, 1.5, 1.5, 1.5]
"""
from __future__ import annotations

import dataclasses
from typing import Any, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.api.registry import MIXERS
from repro_torch.core.graph import GossipGraph, SparseGraph

__all__ = ["Mixer", "MixerBase", "DenseMatrixMixer", "SparseMixer",
           "RingRollMixer", "CompleteMixer", "DisconnectedMixer",
           "AlternatingRingMixer", "DelayedMixer", "HeterogeneousDelayMixer",
           "ring_write", "ring_read", "sample_edge_delays"]


def _bcast(d: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The (m,) per-node vector ``d`` shaped to broadcast over ``like``'s
    trailing axes (a node-stacked pytree leaf may have any of them)."""
    return d.to(like.device).reshape((-1,) + (1,) * (like.dim() - 1))


def _on(mixer, name: str, device: torch.device):
    """The mixer's host tensor (or tuple of tensors) ``name`` on
    ``device``, copied there once (the copies live beside the mixer's
    fields, outside its equality)."""
    copies = mixer.__dict__.setdefault("_device_copies", {})
    key = (name, torch.device(device))
    if key not in copies:
        host = getattr(mixer, name)
        copies[key] = (tuple(t.to(device) for t in host)
                       if isinstance(host, tuple) else host.to(device))
    return copies[key]


def ring_write(hist: torch.Tensor, t: int, value: torch.Tensor) -> torch.Tensor:
    """Write this round's broadcast copy into slot t % depth, in place."""
    hist[t % hist.shape[0]] = value
    return hist


def ring_read(hist: torch.Tensor, t: int, d: int,
              fallback: torch.Tensor) -> torch.Tensor:
    """The broadcast copy from ``d`` rounds ago, AFTER this round's write.

    During warm-up (t < d) returns ``fallback`` (the current theta~), so the
    engine mixes synchronously until the pipe is full; d == 0 reads back the
    slot ``ring_write`` just filled.
    """
    if t < d:
        return fallback
    return hist[(t - d) % hist.shape[0]]


@runtime_checkable
class Mixer(Protocol):
    """Topology stage: mixes (m, ...) tensors with A(t) along axis 0."""

    m: int
    delay: int  # rounds of staleness for neighbor terms (0 = synchronous)

    def apply(self, x: torch.Tensor, t: int) -> torch.Tensor: ...

    def diag(self, t: int) -> torch.Tensor: ...

    def mix(self, clean, tilde, noise_self: bool, t: int) -> torch.Tensor: ...

    def mix_delayed(self, clean, tilde, recv, noise_self: bool,
                    t: int) -> torch.Tensor: ...

    def mix_history(self, clean, tilde, hist, noise_self: bool,
                    t: int) -> torch.Tensor: ...


class MixerBase:
    """Noise-placement algebra shared by all mixers (subclasses implement
    :meth:`apply` and :meth:`diag`):

      mix         = A x~                      (noise_self)
                  = A x~ - diag * (x~ - x)    (own-noise removed)
      mix_delayed = A r - diag * r + diag * s where s = x~ or x
      mix_history = mix_delayed with r read from the ring at self.delay
    """

    m: int = 0
    delay: int = 0

    def apply(self, x, t):
        raise NotImplementedError

    def diag(self, t):
        raise NotImplementedError

    def mix(self, clean, tilde, noise_self, t):
        mixed = self.apply(tilde, t)
        if not noise_self:
            mixed = mixed - _bcast(self.diag(t), tilde) * (tilde - clean)
        return mixed

    def mix_delayed(self, clean, tilde, recv, noise_self, t):
        d = _bcast(self.diag(t), recv)
        self_term = tilde if noise_self else clean
        return self.apply(recv, t) - d * recv + d * self_term

    def mix_history(self, clean, tilde, hist, noise_self, t):
        if not self.delay:
            return self.mix(clean, tilde, noise_self, t)
        if hist is None:
            raise ValueError(
                f"{type(self).__name__} declares delay={self.delay} but no "
                "history ring was provided (engine state missing .history)")
        recv = ring_read(hist, t, self.delay, tilde)
        return self.mix_delayed(clean, tilde, recv, noise_self, t)


@dataclasses.dataclass(frozen=True)
class DenseMatrixMixer(MixerBase):
    """Any (possibly time-varying) doubly-stochastic schedule as dense A(t).

    The (k, m, m) matrix stack and its diagonals are built once, at
    construction; A(t) is ``stack[t % k]``. ``apply`` contracts the node
    axis with tensordot, so it also mixes node-stacked pytree leaves of any
    trailing shape.
    """

    stack: Any               # (k, m, m) float32 (a numpy array or tensor)
    name: str = "dense"
    delay: int = 0

    def __post_init__(self):
        stack = torch.as_tensor(np.asarray(self.stack, np.float32))
        if stack.dim() == 2:
            stack = stack[None]
        object.__setattr__(self, "stack", stack)
        object.__setattr__(self, "_diags",
                           torch.stack([torch.diagonal(A) for A in stack]))

    @property
    def m(self) -> int:
        return int(self.stack.shape[-1])

    @classmethod
    def from_graph(cls, graph: GossipGraph,
                   delay: int = 0) -> "DenseMatrixMixer":
        return cls(stack=np.stack([np.asarray(A) for A in graph.matrices]),
                   name=graph.name, delay=delay)

    @classmethod
    def from_topology(cls, topology: str, m: int, seed: int = 0,
                      **kw) -> "DenseMatrixMixer":
        return cls.from_graph(GossipGraph.make(topology, m, seed=seed, **kw))

    def matrix(self, t: int, device) -> torch.Tensor:
        """A(t) on ``device``."""
        return _on(self, "stack", device)[t % self.stack.shape[0]]

    def apply(self, x, t):
        A = self.matrix(t, x.device)
        return torch.tensordot(A, x.to(A.dtype), dims=1).to(x.dtype)

    def diag(self, t):
        return self._diags[t % self.stack.shape[0]]


@dataclasses.dataclass(frozen=True)
class SparseMixer(MixerBase):
    """Any FIXED doubly-stochastic topology as an edge list.

    ``apply`` is the sparse matvec ``out[i] = sum_j A[i,j] x[j]`` over the
    (dst, src)-sorted edges of a `core.graph.SparseGraph`: slot k holds the
    k-th edge of every row that has one, and each slot adds its weighted
    sources with one multiply-add (``torch.addcmul``) — each row summed from
    0 in ascending source order, as ``round_update``'s sparse path and a
    dense product sum it, so the three agree bit for bit where the device's
    multiply-add is fused (a card). O(edges) work, never the dense A, and
    no atomics: sim and dist stay bit-identical on any device.
    """

    graph: Any               # core.graph.SparseGraph (fixed topology)
    delay: int = 0
    name: str = "sparse"

    def __post_init__(self):
        g = self.graph
        for field in ("dst", "src", "weight", "m"):
            if not hasattr(g, field):
                raise TypeError(
                    "SparseMixer needs a repro_torch.core.graph.SparseGraph "
                    f"(got {type(g).__name__} without .{field})")
        dst = np.asarray(g.dst, np.int64)
        order = np.lexsort((np.asarray(g.src, np.int64), dst))
        dst = dst[order]
        src = np.asarray(g.src, np.int64)[order]
        w = np.asarray(g.weight, np.float32)[order]
        deg = np.bincount(dst, minlength=g.m)
        start = np.concatenate([[0], np.cumsum(deg)[:-1]])
        slots = [np.flatnonzero(deg > k) for k in range(int(deg.max()))]
        # slot k's edges, as indices into the (dst, src)-sorted edge list
        edges = [start[rows] + k for k, rows in enumerate(slots)]
        set_ = lambda k, v: object.__setattr__(self, k, v)  # noqa: E731
        set_("_sorted", (dst, src, w))
        set_("_slot_edges", tuple(torch.as_tensor(e) for e in edges))
        set_("_rows", tuple(torch.as_tensor(rows) for rows in slots))
        set_("_srcs", tuple(torch.as_tensor(src[e]) for e in edges))
        set_("_weights", tuple(torch.as_tensor(w[e]) for e in edges))
        set_("_diag", torch.as_tensor(np.asarray(g.diag(), np.float32)))

    @property
    def m(self) -> int:
        return int(self.graph.m)

    @classmethod
    def from_topology(cls, topology: str, m: int, seed: int = 0,
                      delay: int = 0, **kw) -> "SparseMixer":
        return cls(graph=SparseGraph.make(topology, m, seed=seed, **kw),
                   delay=delay, name=topology)

    def apply(self, x, t):
        return self.slot_sum(_on(self, "_weights", x.device), x)

    def slot_sum(self, weights: tuple, x: torch.Tensor) -> torch.Tensor:
        """``out[i] = sum_j A[i, j] x[j]`` with slot k's edge weights
        ``weights[k]``, added slot by slot in ascending source order."""
        dev = x.device
        flat = x.to(torch.float32).reshape(self.m, x[0].numel())
        out = torch.zeros_like(flat)
        for rows, src, w in zip(_on(self, "_rows", dev),
                                _on(self, "_srcs", dev), weights):
            if rows.numel() == self.m:      # every row has a k-th edge
                out = torch.addcmul(out, w[:, None], flat[src])
            else:
                out[rows] = torch.addcmul(out[rows], w[:, None], flat[src])
        return out.reshape(x.shape).to(x.dtype)

    def diag(self, t):
        return self._diag


@dataclasses.dataclass(frozen=True)
class RingRollMixer(MixerBase):
    """Bidirectional ring via torch.roll; numerically the same map as
    ``core.graph.ring_matrix``."""

    m: int
    self_weight: float = 0.5
    delay: int = 0

    @property
    def nbr_weight(self) -> float:
        """Each ring neighbour's weight, (1 - self_weight) / 2."""
        return (1.0 - self.self_weight) / 2.0

    def apply(self, x, t):
        nw = self.nbr_weight
        return (self.self_weight * x
                + nw * torch.roll(x, 1, dims=0)
                + nw * torch.roll(x, -1, dims=0))

    def diag(self, t):
        return torch.full((self.m,), self.self_weight, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class CompleteMixer(MixerBase):
    """Fully connected graph: exact consensus (the node mean) every round."""

    m: int
    delay: int = 0

    def apply(self, x, t):
        return torch.mean(x, dim=0, keepdim=True).expand_as(x)

    def diag(self, t):
        return torch.full((self.m,), 1.0 / self.m, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DisconnectedMixer(MixerBase):
    """No communication: every node keeps its own CLEAN state.

    Nothing leaves the node, so nothing needs the broadcast noise — the
    ``mix*`` methods ignore theta~ (local-only ablation baseline).
    """

    m: int
    delay: int = 0

    def apply(self, x, t):
        return x

    def diag(self, t):
        return torch.ones((self.m,), dtype=torch.float32)

    def mix(self, clean, tilde, noise_self, t):
        return clean

    def mix_delayed(self, clean, tilde, recv, noise_self, t):
        return clean

    def mix_history(self, clean, tilde, hist, noise_self, t):
        return clean


@dataclasses.dataclass(frozen=True)
class AlternatingRingMixer(MixerBase):
    """Time-varying graph: even rounds pair with the +1 ring neighbor, odd
    rounds with the -1 neighbor; each A(t) is a (1/2, 1/2) circulant."""

    m: int
    delay: int = 0

    def apply(self, x, t):
        return 0.5 * x + 0.5 * torch.roll(x, 1 if t % 2 == 0 else -1, dims=0)

    def diag(self, t):
        return torch.full((self.m,), 0.5, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class DelayedMixer(MixerBase):
    """Any mixer with a uniform WAN delay: neighbor terms arrive ``delay``
    rounds late; the algebra is the inner mixer's."""

    inner: Mixer
    delay: int = 1

    def __post_init__(self):
        if self.delay < 1:
            raise ValueError("DelayedMixer needs delay >= 1")

    @property
    def m(self) -> int:
        return self.inner.m

    def apply(self, x, t):
        return self.inner.apply(x, t)

    def diag(self, t):
        return self.inner.diag(t)

    def mix(self, clean, tilde, noise_self, t):
        return self.inner.mix(clean, tilde, noise_self, t)

    def mix_delayed(self, clean, tilde, recv, noise_self, t):
        return self.inner.mix_delayed(clean, tilde, recv, noise_self, t)


def sample_edge_delays(m: int, max_delay: int, dist: str = "uniform",
                       seed: int = 0,
                       support: np.ndarray | None = None) -> np.ndarray:
    """Draw an (m, m) int matrix of per-edge staleness values (numpy's
    ``default_rng(seed)``, the reference's draws bit for bit).

    dist: 'constant'  — every edge lags exactly max_delay rounds;
          'uniform'   — integer delays uniform on [0, max_delay];
          'geometric' — mostly-fresh links with a heavy tail (p=0.5),
                        clipped to max_delay.
    The diagonal is always 0 (a node's own state needs no network hop) and
    delays outside ``support`` (the union of edges with nonzero A weight)
    are zeroed so they cannot inflate the ring depth.
    """
    rng = np.random.default_rng(seed)
    if dist == "constant":
        D = np.full((m, m), max_delay, np.int32)
    elif dist == "uniform":
        D = rng.integers(0, max_delay + 1, size=(m, m)).astype(np.int32)
    elif dist == "geometric":
        D = np.clip(rng.geometric(0.5, size=(m, m)) - 1, 0,
                    max_delay).astype(np.int32)
    else:
        raise ValueError(
            f"unknown delay_dist {dist!r}; expected "
            "'constant' | 'uniform' | 'geometric'")
    np.fill_diagonal(D, 0)
    if support is not None:
        D = np.where(support, D, 0).astype(np.int32)
        np.fill_diagonal(D, 0)
    return D


@dataclasses.dataclass(frozen=True)
class HeterogeneousDelayMixer(MixerBase):
    """Per-edge WAN delays: edge (i, j) delivers node j's broadcast to node
    i ``delays[i, j]`` rounds late, the lags drawn once at construction
    (``sample_edge_delays``).

    Needs the dense form of A(t): the mix is one masked matrix-apply per
    non-empty delay class d,

        out_i = A_ii * s_i + sum_d sum_{j != i, delays[i,j]=d} A_ij(t) * r_j(d)

    where r(d) is the ring entry from d rounds ago and s the current theta~
    (or the clean theta when noise_self=False). The class masks are built
    once, at construction.
    """

    inner: DenseMatrixMixer
    delays: Any = None           # (m, m) np.int32; diagonal forced to 0
    name: str = "het_delayed"

    def __post_init__(self):
        D = np.asarray(self.delays, np.int32)
        if D.shape != (self.inner.m, self.inner.m):
            raise ValueError(
                f"delays must be ({self.inner.m}, {self.inner.m}), got "
                f"{D.shape}")
        if (D < 0).any():
            raise ValueError("per-edge delays must be >= 0")
        D = D.copy()
        np.fill_diagonal(D, 0)
        object.__setattr__(self, "delays", D)
        offdiag = ~np.eye(self.m, dtype=bool)
        masks = np.stack([(D == d) & offdiag
                          for d in range(int(D.max()) + 1)])
        # an empty delay class needs no tensordot
        object.__setattr__(self, "_classes", tuple(
            d for d in range(masks.shape[0]) if masks[d].any()))
        object.__setattr__(self, "_masks",
                           torch.as_tensor(masks.astype(np.float32)))

    @classmethod
    def from_topology(cls, topology: str, m: int, delay: int = 1,
                      delay_dist: str = "uniform", seed: int = 0,
                      **kw) -> "HeterogeneousDelayMixer":
        inner = DenseMatrixMixer.from_topology(topology, m, seed=seed, **kw)
        support = (inner.stack.numpy() > 0).any(axis=0)
        np.fill_diagonal(support, False)
        return cls(inner=inner,
                   delays=sample_edge_delays(m, delay, delay_dist, seed,
                                             support=support))

    @property
    def m(self) -> int:
        return self.inner.m

    @property
    def delay(self) -> int:
        return int(self.delays.max())

    def apply(self, x, t):
        return self.inner.apply(x, t)

    def diag(self, t):
        return self.inner.diag(t)

    def mix_delayed(self, clean, tilde, recv, noise_self, t):
        raise NotImplementedError(
            "HeterogeneousDelayMixer has no single stale view — MixerBase's "
            "uniform-recv algebra would silently ignore the per-edge delays; "
            "use mix_history with the engine's ring")

    def mix_history(self, clean, tilde, hist, noise_self, t):
        if hist is None:
            if self.delay:
                raise ValueError(
                    "HeterogeneousDelayMixer needs the engine's history ring "
                    "(GossipState/SimState.history); got None")
            hist = tilde[None]
        A = self.inner.matrix(t, tilde.device)
        masks = _on(self, "_masks", tilde.device)
        self_term = tilde if noise_self else clean
        out = _bcast(self.diag(t), tilde) * self_term
        for d in self._classes:
            Ad = A * masks[d]
            recv = ring_read(hist, t, d, tilde)
            out = out + torch.tensordot(Ad, recv.to(Ad.dtype),
                                        dims=1).to(tilde.dtype)
        return out


# -- registry entries --------------------------------------------------------

@MIXERS.register("ring")
def _ring(m: int, self_weight: float = 0.5, delay: int = 0) -> Mixer:
    """Bidirectional ring of data centres (torch.roll)."""
    return RingRollMixer(m=m, self_weight=self_weight, delay=delay)


@MIXERS.register("complete")
def _complete(m: int, delay: int = 0) -> Mixer:
    """Fully connected graph: exact consensus every round."""
    return CompleteMixer(m=m, delay=delay)


@MIXERS.register("disconnected")
def _disconnected(m: int, delay: int = 0) -> Mixer:
    """No communication (local-only baseline)."""
    return DisconnectedMixer(m=m, delay=delay)


@MIXERS.register("ring_alternating")
def _ring_alternating(m: int, delay: int = 0) -> Mixer:
    """Time-varying ring: +1 neighbour on even rounds, -1 on odd ones."""
    return AlternatingRingMixer(m=m, delay=delay)


@MIXERS.register("dense")
def _dense(m: int, matrices=None, topology: str = "ring", seed: int = 0,
           delay: int = 0, **kw) -> Mixer:
    """Any doubly-stochastic schedule as dense A(t): `matrices=` or a
    GossipGraph `topology=`."""
    if matrices is not None:
        mixer = DenseMatrixMixer(stack=np.stack([np.asarray(A)
                                                 for A in matrices]))
    else:
        mixer = DenseMatrixMixer.from_topology(topology, m, seed=seed, **kw)
    return dataclasses.replace(mixer, delay=delay)


@MIXERS.register("sparse")
def _sparse(m: int, graph=None, topology: str = "ring", seed: int = 0,
            delay: int = 0, **kw) -> Mixer:
    """Edge-list topology via SparseMixer: `graph=` takes a prebuilt
    SparseGraph; otherwise `topology=` builds one (ring/torus natively
    sparse, other fixed topologies via their dense form)."""
    if graph is not None:
        return SparseMixer(graph=graph, delay=delay,
                           name=getattr(graph, "name", "sparse"))
    return SparseMixer.from_topology(topology, m, seed=seed, delay=delay, **kw)


# The graph-backed topologies of the paper's Fig. 3 sweep, exposed directly.
for _name in ("torus", "hypercube", "random", "time_varying"):
    @MIXERS.register(_name)
    def _graph_mixer(m: int, seed: int = 0, delay: int = 0,
                     _topology: str = _name, **kw) -> Mixer:
        """A GossipGraph topology as a dense A(t) (DenseMatrixMixer)."""
        mixer = DenseMatrixMixer.from_topology(_topology, m, seed=seed, **kw)
        return dataclasses.replace(mixer, delay=delay)


@MIXERS.register("delayed")
def _delayed(m: int, inner: str | Mixer = "ring", delay: int = 1,
             seed: int = 0, **kw) -> Mixer:
    """Any mixer with a uniform WAN delay of `delay` rounds."""
    return DelayedMixer(inner=MIXERS.build(inner, m=m, seed=seed, **kw),
                        delay=delay)


@MIXERS.register("het_delayed")
def _het_delayed(m: int, inner: str = "ring", delay: int = 1,
                 delay_dist: str = "uniform", seed: int = 0, **kw) -> Mixer:
    """Per-edge heterogeneous delays over a dense topology."""
    return HeterogeneousDelayMixer.from_topology(inner, m, delay=delay,
                                                 delay_dist=delay_dist,
                                                 seed=seed, **kw)
