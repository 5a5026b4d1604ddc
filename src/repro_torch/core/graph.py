"""Communication graphs for gossip learning (paper §II-A), in numpy.

The port's own copy of the ring pieces of `repro.core.graph` (that module is
numpy-only, but importing it runs `repro.core.__init__`, which imports the
JAX engines). The paper requires a doubly-stochastic mixing matrix A
(Assumption 1): a_ij > 0 on edges, rows and columns sum to 1, positive
entries >= eta. The ring is the paper's data-centre topology; the rest of
the topologies wait in ROADMAP queue 1.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ring_matrix", "ring_edges", "SparseGraph"]


def ring_matrix(m: int, self_weight: float = 0.5) -> np.ndarray:
    """Bidirectional ring: each node mixes with its two ring neighbors.

    Doubly stochastic by symmetry; ``self_weight`` in (0, 1), the remainder
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


def ring_edges(m: int, self_weight: float = 0.5) -> "SparseGraph":
    """Edge-list form of :func:`ring_matrix`, built natively in O(m);
    ``to_dense()`` of the result equals ``ring_matrix(m, self_weight)``."""
    if m == 1:
        return SparseGraph(dst=np.zeros(1, np.int64), src=np.zeros(1, np.int64),
                           weight=np.ones(1, np.float32), m=1, name="ring")
    i = np.arange(m, dtype=np.int64)
    nbr = np.float32((1.0 - self_weight) / 2.0)
    dst = np.concatenate([i, i, i])
    src = np.concatenate([i, (i - 1) % m, (i + 1) % m])
    w = np.concatenate([np.full(m, np.float32(self_weight)),
                        np.full(m, nbr), np.full(m, nbr)])
    # m == 2: both "neighbors" are the same node; the duplicates merge in
    # the canonical sort below exactly like the dense constructor's +=
    return SparseGraph(dst=dst, src=src, weight=w.astype(np.float32), m=m,
                       name="ring")


@dataclasses.dataclass(frozen=True)
class SparseGraph:
    """Edge-list view of a fixed mixing matrix: ``A[dst, src] = weight``.

    Construction canonicalizes: edges sorted by (dst, src), duplicate pairs
    summed into one edge (what the dense form does when an entry is written
    twice). ``validate()`` checks Assumption 1 in O(edges).
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

    def to_dense(self) -> np.ndarray:
        """(m, m) float32 dense form (duplicates were already merged)."""
        A = np.zeros((self.m, self.m), np.float32)
        np.add.at(A, (self.dst, self.src), self.weight)
        return A

    def validate(self, eta: float = 1e-6, atol: float = 1e-6) -> "SparseGraph":
        """Assumption 1 in O(edges): nonneg entries >= eta, every row and
        column sums to 1. Returns self."""
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
