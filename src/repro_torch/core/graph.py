"""Communication graphs for gossip learning (paper §II-A), in numpy.

The port's own copy of `repro.core.graph` (that module is numpy-only, but
importing it runs `repro.core.__init__`, which imports the JAX engines).
Every builder here makes the same float32 matrices and edge arrays as the
reference's, bit for bit, the seeded ones (``random``, ``random_matching``)
included: both draw from numpy's ``default_rng(seed)`` in the same order.

The paper requires a doubly-stochastic mixing matrix A (Assumption 1):
  (1) a_ij > 0 on edges, (2) rows and columns sum to 1, (3) positive entries >= eta.

These are the topologies of the paper's Fig. 3 (topology invariance) plus
the ring and torus. Every dense constructor returns an (m, m) float32
matrix satisfying Assumption 1; `assert_doubly_stochastic` verifies it.
Time-varying graphs (the paper allows A(t)) are a finite cycle of matrices
indexed by ``t % len(schedule)``.

>>> from repro_torch.core.graph import GossipGraph, SparseGraph
>>> GossipGraph.make("time_varying", 6).at(3).tolist()[0]
[0.5, 0.0, 0.0, 0.0, 0.0, 0.5]
>>> g = SparseGraph.make("hypercube", 8)
>>> g.degree().tolist(), g.is_symmetric()
([4, 4, 4, 4, 4, 4, 4, 4], True)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "ring_matrix",
    "torus_matrix",
    "complete_matrix",
    "hypercube_matrix",
    "random_regular_matrix",
    "disconnected_matrix",
    "metropolis_hastings",
    "time_varying_schedule",
    "assert_doubly_stochastic",
    "spectral_gap",
    "GossipGraph",
    "SparseGraph",
    "ring_edges",
    "torus_edges",
    "ring_neighbor_weights",
    "torus_neighbor_weights",
]


def assert_doubly_stochastic(A: np.ndarray, eta: float = 1e-6, atol: float = 1e-6) -> None:
    """Check the paper's Assumption 1 on a mixing matrix."""
    A = np.asarray(A)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"A must be square, got {A.shape}")
    if np.any(A < -atol):
        raise ValueError("A has negative entries")
    rows = A.sum(axis=1)
    cols = A.sum(axis=0)
    if not np.allclose(rows, 1.0, atol=atol):
        raise ValueError(f"rows do not sum to 1: {rows}")
    if not np.allclose(cols, 1.0, atol=atol):
        raise ValueError(f"cols do not sum to 1: {cols}")
    pos = A[A > atol]
    if pos.size and pos.min() < eta - atol:
        raise ValueError(f"positive entries below eta={eta}: min={pos.min()}")


def ring_matrix(m: int, self_weight: float = 0.5) -> np.ndarray:
    """Bidirectional ring: each node mixes with its two ring neighbors.

    Doubly stochastic by symmetry. ``self_weight`` in (0, 1); the remainder is
    split equally between the two neighbors. m == 1 and m == 2 degenerate
    gracefully.
    """
    if m == 1:
        return np.ones((1, 1), dtype=np.float32)
    A = np.zeros((m, m), dtype=np.float64)
    nbr = (1.0 - self_weight) / 2.0
    for i in range(m):
        A[i, i] += self_weight
        A[i, (i - 1) % m] += nbr
        A[i, (i + 1) % m] += nbr
    return A.astype(np.float32)


def torus_matrix(rows: int, cols: int, self_weight: float = 1.0 / 3.0) -> np.ndarray:
    """2D torus: 4 neighbors per node."""
    m = rows * cols
    if m == 1:
        return np.ones((1, 1), dtype=np.float32)
    A = np.zeros((m, m), dtype=np.float64)
    nbr = (1.0 - self_weight) / 4.0

    def idx(r: int, c: int) -> int:
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            A[i, i] += self_weight
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                A[i, idx(r + dr, c + dc)] += nbr
    return A.astype(np.float32)


def complete_matrix(m: int) -> np.ndarray:
    """Fully connected: exact consensus every round (upper bound on mixing)."""
    return np.full((m, m), 1.0 / m, dtype=np.float32)


def hypercube_matrix(m: int, self_weight: float = 0.5) -> np.ndarray:
    """Hypercube graph; m must be a power of two. log2(m) neighbors per node."""
    d = int(np.log2(m))
    if 2**d != m:
        raise ValueError(f"hypercube needs power-of-two m, got {m}")
    if m == 1:
        return np.ones((1, 1), dtype=np.float32)
    A = np.zeros((m, m), dtype=np.float64)
    nbr = (1.0 - self_weight) / d
    for i in range(m):
        A[i, i] = self_weight
        for b in range(d):
            A[i, i ^ (1 << b)] = nbr
    return A.astype(np.float32)


def random_regular_matrix(m: int, degree: int = 4, seed: int = 0) -> np.ndarray:
    """Random regular graph via repeated perfect matchings; Metropolis weights.

    Used for the paper's Fig. 3 'random topology' curve.
    """
    rng = np.random.default_rng(seed)
    adj = np.zeros((m, m), dtype=bool)
    attempts = 0
    while adj.sum(axis=1).min() < degree and attempts < 200:
        perm = rng.permutation(m)
        for a, b in zip(perm[::2], perm[1::2]):
            if a != b and not adj[a, b] and adj[a].sum() < degree and adj[b].sum() < degree:
                adj[a, b] = adj[b, a] = True
        attempts += 1
    # Guarantee connectivity by overlaying a ring.
    for i in range(m):
        adj[i, (i + 1) % m] = adj[(i + 1) % m, i] = True
    np.fill_diagonal(adj, False)
    return metropolis_hastings(adj)


def disconnected_matrix(m: int) -> np.ndarray:
    """Identity = no communication. Baseline for 'local only' ablation."""
    return np.eye(m, dtype=np.float32)


def metropolis_hastings(adj: np.ndarray) -> np.ndarray:
    """Doubly-stochastic weights from an undirected adjacency matrix.

    a_ij = 1 / (1 + max(deg_i, deg_j)) on edges; diagonal takes the slack.
    Symmetric + rows sum to 1 => doubly stochastic.
    """
    adj = np.asarray(adj, dtype=bool)
    m = adj.shape[0]
    deg = adj.sum(axis=1)
    A = np.zeros((m, m), dtype=np.float64)
    for i in range(m):
        for j in range(m):
            if adj[i, j]:
                A[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        A[i, i] = 1.0 - A[i].sum()
    return A.astype(np.float32)


def time_varying_schedule(m: int, kind: str = "ring_alternating", seed: int = 0) -> list[np.ndarray]:
    """A finite cycle of doubly-stochastic matrices, used as A(t % k).

    The paper proves topology (fixed or time-variant) does not change the
    regret order; Fig. 3 compares them empirically.
    """
    if kind == "ring_alternating":
        # Alternate between even-edge and odd-edge pairwise averaging on a ring.
        mats = []
        for parity in (0, 1):
            A = np.eye(m, dtype=np.float64)
            for i in range(parity, m - (m % 2 == 1), 2):
                j = (i + 1) % m
                if i == j:
                    continue
                A[i, i] = A[j, j] = 0.5
                A[i, j] = A[j, i] = 0.5
            mats.append(A.astype(np.float32))
        return mats
    if kind == "random_matching":
        rng = np.random.default_rng(seed)
        mats = []
        for _ in range(4):
            A = np.eye(m, dtype=np.float64)
            perm = rng.permutation(m)
            for a, b in zip(perm[::2], perm[1::2]):
                A[a, a] = A[b, b] = 0.5
                A[a, b] = A[b, a] = 0.5
            mats.append(A.astype(np.float32))
        return mats
    raise ValueError(f"unknown time-varying kind: {kind}")


def spectral_gap(A: np.ndarray) -> float:
    """1 - |lambda_2(A)|: governs gossip mixing speed (consensus rate)."""
    ev = np.sort(np.abs(np.linalg.eigvals(np.asarray(A, dtype=np.float64))))
    return float(1.0 - (ev[-2] if len(ev) > 1 else 0.0))


# ---------------------------------------------------------------------------
# Sparse (edge-list / CSR) topologies — the social-big-data regime.
# A dense (m, m) mixing matrix caps m at a few thousand nodes; the paper's
# "distributed data centers" setting needs m in the 10^5..10^6 range, where
# only the O(edges) form fits. SparseGraph is the canonical sparse view the
# segment-sum mixer (`repro_torch.api.mixers.SparseMixer`) and the fused
# backend's CSR form (`repro_torch.kernels.round_fused.MixCSR`) consume.
# ---------------------------------------------------------------------------

def ring_edges(m: int, self_weight: float = 0.5) -> "SparseGraph":
    """Edge-list form of :func:`ring_matrix`, built natively in O(m).

    Never materialises the dense matrix, so it scales to millions of nodes
    (``SparseGraph.from_dense(ring_matrix(m))`` would need O(m^2) memory).
    ``to_dense()`` of the result equals ``ring_matrix(m, self_weight)``
    exactly for m >= 3; m in {1, 2} degenerate the same way (neighbor
    weights fold onto the single/self edge).
    """
    if m == 1:
        return SparseGraph(dst=np.zeros(1, np.int64), src=np.zeros(1, np.int64),
                           weight=np.ones(1, np.float32), m=1, name="ring")
    i = np.arange(m, dtype=np.int64)
    nbr = np.float32((1.0 - self_weight) / 2.0)
    dst = np.concatenate([i, i, i])
    src = np.concatenate([i, (i - 1) % m, (i + 1) % m])
    w = np.concatenate([np.full(m, np.float32(self_weight)),
                        np.full(m, nbr), np.full(m, nbr)])
    # m == 2: the two "neighbors" are the same node; duplicates merge in
    # the canonical sort below exactly like the dense constructor's +=
    return SparseGraph(dst=dst, src=src, weight=w.astype(np.float32), m=m,
                       name="ring")


def torus_edges(rows: int, cols: int,
                self_weight: float = 1.0 / 3.0) -> "SparseGraph":
    """Edge-list form of :func:`torus_matrix`, built natively in O(m)."""
    m = rows * cols
    if m == 1:
        return SparseGraph(dst=np.zeros(1, np.int64), src=np.zeros(1, np.int64),
                           weight=np.ones(1, np.float32), m=1, name="torus")
    r, c = np.divmod(np.arange(m, dtype=np.int64), cols)
    nbr = np.float32((1.0 - self_weight) / 4.0)
    dsts, srcs, ws = [np.arange(m, dtype=np.int64)], [np.arange(m, dtype=np.int64)], \
        [np.full(m, np.float32(self_weight))]
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        dsts.append(np.arange(m, dtype=np.int64))
        srcs.append(((r + dr) % rows) * cols + (c + dc) % cols)
        ws.append(np.full(m, nbr))
    return SparseGraph(dst=np.concatenate(dsts), src=np.concatenate(srcs),
                       weight=np.concatenate(ws).astype(np.float32), m=m,
                       name="torus")


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """Edge-list / CSR view of a (fixed) mixing matrix.

    Edges are (dst, src, weight) triples meaning ``A[dst, src] = weight``;
    ``apply`` semantics are ``out[i] = sum_j A[i, j] x[j]`` — exactly the
    dense matvec, restricted to stored entries. Construction canonicalizes:
    edges are sorted by (dst, src) and DUPLICATE (dst, src) pairs are summed
    into one edge, which is precisely what the dense form does when the same
    entry is written twice — so conversions and aggregations stay
    dense-equivalent by construction. Entries with weight exactly 0.0 are
    kept (they round-trip from a dense matrix's explicit zeros as absent —
    ``from_dense`` drops them — but a caller may store them).

    ``validate()`` checks the paper's Assumption 1 (doubly stochastic,
    nonneg, entries >= eta) in O(edges); a zero-degree (isolated) node makes
    its row sum 0 and is rejected there with a clear message.
    """

    dst: np.ndarray       # (E,) int — destination / row index
    src: np.ndarray       # (E,) int — source / column index
    weight: np.ndarray    # (E,) float32 — A[dst, src]
    m: int
    name: str = "sparse"

    def __post_init__(self):
        dst = np.asarray(self.dst, np.int64).ravel()
        src = np.asarray(self.src, np.int64).ravel()
        w = np.asarray(self.weight, np.float32).ravel()
        if not (dst.shape == src.shape == w.shape):
            raise ValueError(
                f"edge arrays disagree: dst {dst.shape}, src {src.shape}, "
                f"weight {w.shape}")
        if self.m < 1:
            raise ValueError(f"m must be >= 1, got {self.m}")
        if dst.size and (dst.min() < 0 or dst.max() >= self.m
                         or src.min() < 0 or src.max() >= self.m):
            raise ValueError(
                f"edge indices out of range for m={self.m}: "
                f"dst in [{dst.min()}, {dst.max()}], "
                f"src in [{src.min()}, {src.max()}]")
        # canonical form: sort by (dst, src), merge duplicate edges by
        # summing their weights (the dense-equivalent reading of a repeated
        # (i, j) entry). float32 sums of float32 duplicates match the dense
        # np.add.at accumulation exactly.
        flat = dst * self.m + src
        order = np.argsort(flat, kind="stable")
        flat, dst, src, w = flat[order], dst[order], src[order], w[order]
        uniq, first = np.unique(flat, return_index=True)
        if uniq.size != flat.size:
            w = np.add.reduceat(w.astype(np.float32), first)
            dst, src = dst[first], src[first]
        object.__setattr__(self, "dst", dst)
        object.__setattr__(self, "src", src)
        object.__setattr__(self, "weight", w.astype(np.float32))

    # -- shape/views ---------------------------------------------------------

    @property
    def edges(self) -> int:
        return int(self.dst.size)

    @property
    def indptr(self) -> np.ndarray:
        """(m + 1,) CSR row pointers: edges of row i live in
        ``[indptr[i], indptr[i+1])`` of the (dst, src)-sorted edge arrays."""
        counts = np.bincount(self.dst, minlength=self.m)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def diag(self) -> np.ndarray:
        """(m,) self-weights A[i, i] (0 where no self-loop is stored)."""
        d = np.zeros(self.m, np.float32)
        loop = self.dst == self.src
        d[self.dst[loop]] = self.weight[loop]
        return d

    def degree(self) -> np.ndarray:
        """(m,) number of stored in-edges per destination node."""
        return np.bincount(self.dst, minlength=self.m).astype(np.int64)

    # -- conversions (exact round trips) -------------------------------------

    @classmethod
    def from_dense(cls, A: np.ndarray, name: str | None = None) -> "SparseGraph":
        """Edge list of every nonzero entry; float32 values are preserved
        exactly, so ``to_dense()`` round-trips bit-for-bit."""
        A = np.asarray(A, np.float32)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"A must be square, got {A.shape}")
        dst, src = np.nonzero(A)
        return cls(dst=dst.astype(np.int64), src=src.astype(np.int64),
                   weight=A[dst, src], m=A.shape[0],
                   name=name or "sparse")

    def to_dense(self) -> np.ndarray:
        """(m, m) float32 dense form (duplicates were already merged)."""
        A = np.zeros((self.m, self.m), np.float32)
        np.add.at(A, (self.dst, self.src), self.weight)
        return A

    # -- checks --------------------------------------------------------------

    def validate(self, eta: float = 1e-6, atol: float = 1e-6) -> "SparseGraph":
        """Assumption 1 in O(edges): nonneg entries >= eta, every row and
        column sums to 1 (a zero-degree node fails its row sum). Returns
        self so construction sites can chain ``SparseGraph(...).validate()``."""
        if np.any(self.weight < -atol):
            raise ValueError("sparse A has negative entries")
        pos = self.weight[self.weight > atol]
        if pos.size and pos.min() < eta - atol:
            raise ValueError(
                f"positive entries below eta={eta}: min={pos.min()}")
        rows = np.zeros(self.m, np.float64)
        cols = np.zeros(self.m, np.float64)
        np.add.at(rows, self.dst, self.weight.astype(np.float64))
        np.add.at(cols, self.src, self.weight.astype(np.float64))
        bad_r = np.flatnonzero(~np.isclose(rows, 1.0, atol=atol))
        if bad_r.size:
            raise ValueError(
                f"rows do not sum to 1 (isolated/underweighted nodes?): "
                f"rows {bad_r[:8].tolist()} sum to "
                f"{rows[bad_r[:8]].tolist()}")
        bad_c = np.flatnonzero(~np.isclose(cols, 1.0, atol=atol))
        if bad_c.size:
            raise ValueError(
                f"cols do not sum to 1: cols {bad_c[:8].tolist()} sum to "
                f"{cols[bad_c[:8]].tolist()}")
        return self

    def is_symmetric(self, atol: float = 0.0) -> bool:
        """True iff A[i, j] == A[j, i] for every stored edge (O(E log E))."""
        fwd = {(int(d), int(s)): float(w)
               for d, s, w in zip(self.dst, self.src, self.weight)}
        return all(abs(w - fwd.get((s, d), 0.0)) <= atol
                   for (d, s), w in fwd.items())

    # -- constructors --------------------------------------------------------

    @classmethod
    def make(cls, topology: str, m: int, seed: int = 0,
             **kw) -> "SparseGraph":
        """Sparse mixing graph by topology name.

        'ring' and 'torus' build natively in O(m) (any m, including the
        n >= 10^5 regime); every other fixed GossipGraph topology goes
        through its dense form (small m only). Time-varying schedules have
        no sparse form here — the sparse path assumes one fixed A.
        """
        if topology == "ring":
            return ring_edges(m, **kw).validate()
        if topology == "torus":
            rows = kw.pop("rows", int(np.sqrt(m)))
            if rows * (m // rows) != m:
                raise ValueError(f"torus needs factorable m, got {m}")
            return torus_edges(rows, m // rows, **kw).validate()
        if topology == "time_varying":
            raise ValueError(
                "time_varying schedules have no sparse form — the sparse "
                "gossip path assumes one fixed topology (use the dense "
                "mixer for A(t) schedules)")
        graph = GossipGraph.make(topology, m, seed=seed, **kw)
        return cls.from_dense(graph.at(0), name=topology).validate()


# ---------------------------------------------------------------------------
# Neighbor-weight views: a ring/torus row of A is fully described by
# (shift -> weight), which a node-sharded exchange consumes instead of the
# dense matrix (the reference's shard_map gossip does).
# ---------------------------------------------------------------------------

def ring_neighbor_weights(self_weight: float = 0.5) -> dict[int, float]:
    """Shift->weight map matching :func:`ring_matrix` (shift along the axis)."""
    nbr = (1.0 - self_weight) / 2.0
    return {0: self_weight, 1: nbr, -1: nbr}


def torus_neighbor_weights(self_weight: float = 1.0 / 3.0) -> dict[tuple[int, int], float]:
    """(dr, dc)->weight map matching :func:`torus_matrix` on a 2D mesh."""
    nbr = (1.0 - self_weight) / 4.0
    return {(0, 0): self_weight, (1, 0): nbr, (-1, 0): nbr, (0, 1): nbr, (0, -1): nbr}


@dataclasses.dataclass(frozen=True)
class GossipGraph:
    """A (possibly time-varying) communication graph for m gossip nodes."""

    matrices: tuple  # tuple[np.ndarray, ...]; len 1 => fixed topology
    name: str = "ring"

    def __post_init__(self):
        for A in self.matrices:
            assert_doubly_stochastic(A)

    @property
    def m(self) -> int:
        return self.matrices[0].shape[0]

    def at(self, t: int) -> np.ndarray:
        return self.matrices[t % len(self.matrices)]

    @classmethod
    def make(cls, topology: str, m: int, seed: int = 0, **kw) -> "GossipGraph":
        builders: dict[str, Callable[..., Sequence[np.ndarray]]] = {
            "ring": lambda: [ring_matrix(m, **kw)],
            "complete": lambda: [complete_matrix(m)],
            "hypercube": lambda: [hypercube_matrix(m, **kw)],
            "random": lambda: [random_regular_matrix(m, seed=seed, **kw)],
            "disconnected": lambda: [disconnected_matrix(m)],
            "time_varying": lambda: time_varying_schedule(m, seed=seed, **kw),
        }
        if topology == "torus":
            rows = kw.pop("rows", int(np.sqrt(m)))
            if rows * (m // rows) != m:
                raise ValueError(f"torus needs factorable m, got {m}")
            return cls(matrices=(torus_matrix(rows, m // rows, **kw),), name="torus")
        if topology not in builders:
            raise ValueError(f"unknown topology {topology!r}; options: {sorted(builders)} + torus")
        return cls(matrices=tuple(builders[topology]()), name=topology)
