"""Plain reference of the paper's Algorithm 1 (arXiv:1602.06489, §II-D).

m data-centre nodes on a ring learn a sparse linear classifier online. Each
round t = 1..T every node i:

1. recovers its primal from its dual by the Lasso prox:
   w_i = sign(theta_i) * max(|theta_i| - alpha_t * lam, 0);
2. predicts on its sample x_i, suffers the hinge loss
   [1 - y_i <w_i, x_i>]_+ and takes the subgradient -y_i x_i where the
   margin is below 1;
3. clips that subgradient to L2 norm L;
4. broadcasts theta_i + Laplace(2 alpha_t L / eps) noise (the coordinate
   calibration), one unit draw per coordinate, inverse-CDF from one uniform
   of the run's noise generator, round after round;
5. mixes the noisy copies with its ring weights (1/2 itself, 1/4 each
   neighbour) and steps: theta_i <- mixed_i - alpha_t g_i,
   with alpha_t = alpha0 / sqrt(t).

Under a fault scenario (the ``faults`` dict: link, crash and straggler
rates, drawn from its own seed) each round drops links, heals the dropped
weight onto the receiving node's own weight, delays the stragglers' copies
and freezes crashed nodes. The scenario's draws are numpy's
``default_rng``: crash windows from ``[seed, 1]``, stragglers from
``[seed, 2]``, and round t's link coins from ``[seed, 3, t]``, one float32
uniform per undirected link in ascending order of ``min * m + max``.

Plain torch on one device, in ``dtype`` (float32 as the configuration
states; the control passes a lower precision), with TF32 off. It imports
nothing of the program.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

__all__ = ["FaultPlan", "fault_plan", "run_reference"]

U_MIN = np.float32(-0.5 + 1e-7)   # lower bound of the Laplace uniforms


@contextlib.contextmanager
def no_tf32():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def unit_laplace(gen: torch.Generator, shape) -> torch.Tensor:
    """Laplace(0, 1) by the inverse CDF of u ~ U[-1/2 + 1e-7, 1/2)."""
    span = float(np.float32(0.5) - U_MIN)
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    u = torch.clamp_min(u * span + float(U_MIN), float(U_MIN))
    return -torch.sign(u) * torch.log1p(-2.0 * u.abs())


def ring_weights(m: int, self_weight: float = 0.5) -> np.ndarray:
    """(m, m) ring: self_weight on the diagonal, the rest split evenly
    between the two neighbours."""
    nbr = np.float32((1.0 - self_weight) / 2.0)
    A = np.zeros((m, m), np.float32)
    for i in range(m):
        A[i, i] += np.float32(self_weight)
        A[i, (i - 1) % m] += nbr
        A[i, (i + 1) % m] += nbr
    return A


class FaultPlan:
    """A fault scenario drawn for m nodes over T rounds."""

    def __init__(self, faults: dict, m: int, T: int, base: np.ndarray):
        seed = int(faults.get("seed", 0))
        self.seed = seed
        self.link_rate = np.float32(faults.get("link_rate", 0.0))
        crash_rate = float(faults.get("crash_rate", 0.0))
        self.alive = np.ones((T, m), bool)
        self.windows = []
        if crash_rate > 0.0:
            length = int(faults.get("crash_rounds", 0)) or max(T // 8, 1)
            rng = np.random.default_rng([seed, 1])
            hit = rng.random(m) < crash_rate
            starts = rng.integers(0, max(T - length, 1), size=m)
            for node in np.flatnonzero(hit):
                s = int(starts[node])
                self.windows.append((int(node), s, s + length))
                self.alive[s:s + length, node] = False
        self.lag = np.zeros(m, np.int64)
        rate = float(faults.get("straggler_rate", 0.0))
        delay = int(faults.get("straggler_delay", 0))
        if rate > 0.0 and delay > 0:
            rng = np.random.default_rng([seed, 2])
            self.lag[rng.random(m) < rate] = delay
        # undirected links of the graph, in ascending min * m + max
        off = (base > 0) & ~np.eye(m, dtype=bool)
        dst, src = np.nonzero(off)
        pair = np.minimum(dst, src) * m + np.maximum(dst, src)
        self.links = np.unique(pair)
        self.link_of = np.zeros((m, m), np.int64)
        self.link_of[dst, src] = np.searchsorted(self.links, pair)
        self.off = off
        self.has_crashes = bool(self.windows)

    def weights(self, base: np.ndarray, t: int) -> np.ndarray:
        """Round t's (m, m) weights: kept links at their weight, the lost
        weight of each row added to its diagonal."""
        coins = np.random.default_rng([self.seed, 3, int(t)]).random(
            max(self.links.size, 1), dtype=np.float32)
        keep = (coins >= self.link_rate).astype(np.float32)[self.link_of]
        if self.has_crashes:
            keep = keep * self.alive[t][None, :].astype(np.float32)
        keep = np.where(self.off, keep, np.float32(1.0))
        A = base * keep
        lost = (base * (np.float32(1.0) - keep)).sum(axis=1)
        A[np.arange(base.shape[0]), np.arange(base.shape[0])] += lost
        return A


def fault_plan(faults: dict | None, m: int, T: int) -> FaultPlan | None:
    return None if not faults else FaultPlan(faults, m, T, ring_weights(m))


def run_reference(cfg: dict, xs: torch.Tensor, ys: torch.Tensor, seed: int,
                  faults: dict | None = None,
                  dtype: torch.dtype = torch.float32) -> dict:
    """Algorithm 1 over the stream xs (T, m, n), ys (T, m) from the zero
    state, its noise drawn from a generator seeded with ``seed`` on the
    stream's device. Returns numpy arrays: per-round ``loss`` and
    ``correct`` (T, m), ``sparsity`` (T,), ``connectivity`` (T,) (the share
    of off-diagonal weight delivered), ``eps_ledger`` (T,) and ``final_w``
    (m, n), the primal after the last round."""
    with no_tf32():
        return _run(cfg, xs, ys, seed, faults, dtype)


def _run(cfg, xs, ys, seed, faults, dtype):
    T, m, n = xs.shape
    dev = xs.device
    f32 = np.float32
    alpha0, lam, L = f32(cfg["alpha0"]), f32(cfg["lam"]), f32(cfg["clip_norm"])
    eps = float(cfg["eps"])
    base = ring_weights(m, cfg.get("self_weight", 0.5))
    plan = fault_plan(faults, m, T)
    base_off = float((base * ~np.eye(m, dtype=bool)).sum())
    A_clean = torch.as_tensor(base, device=dev).to(dtype)

    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    theta = torch.zeros((m, n), dtype=dtype, device=dev)
    past = []                                  # earlier noisy copies
    depth = int(plan.lag.max()) if plan is not None else 0
    loss = torch.empty((T, m), dtype=torch.float32, device=dev)
    correct = torch.empty((T, m), dtype=torch.float32, device=dev)
    sparsity = torch.empty(T, dtype=torch.float32, device=dev)
    conn = np.ones(T, np.float64)

    def alpha(t):
        return alpha0 / np.sqrt(f32(max(t, 1)))

    def primal(th, t):
        lam_t = float(f32(alpha(t)) * lam)
        return torch.sign(th) * torch.clamp_min(th.abs() - lam_t, 0.0)

    for k in range(T):
        t = k + 1
        a_t = alpha(t)
        x, y = xs[k].to(dtype), ys[k].to(dtype)
        w = primal(theta, t)
        score = torch.sum(w * x, dim=1)
        margin = y * score
        loss[k] = torch.clamp_min(1.0 - margin, 0.0).float()
        correct[k] = (torch.sign(score) == y).float()
        sparsity[k] = (w == 0).sum().float() / float(m * n)
        g = -((margin < 1.0).to(dtype) * y)[:, None] * x
        norm = torch.sqrt(torch.sum(g.float() ** 2, dim=1))
        g = g * torch.clamp_max(float(L) / torch.clamp_min(norm, 1e-12),
                                1.0).to(dtype)[:, None]
        scale = float(f32(2.0) * f32(a_t) * L / f32(eps))
        tilde = theta + (scale * unit_laplace(gen, (m, n))).to(dtype)
        if plan is None:
            mixed = A_clean @ tilde
        else:
            A = plan.weights(base, k)
            conn[k] = float((A * plan.off).sum()) / base_off
            At = torch.as_tensor(A, device=dev).to(dtype)
            diag = torch.diagonal(At).clone()
            mixed = diag[:, None] * tilde
            past.insert(0, tilde)
            del past[depth + 1:]
            for lag in np.unique(plan.lag):
                cols = torch.as_tensor(plan.lag == lag, device=dev)
                # a straggler's copy arrives ``lag`` rounds late; until then
                # its neighbours read its current one
                recv = past[lag] if k >= lag else tilde
                Acls = (At * cols[None, :].to(dtype)).fill_diagonal_(0.0)
                mixed = mixed + Acls @ recv
        nxt = mixed - float(a_t) * g
        if plan is not None and plan.has_crashes:
            alive = torch.as_tensor(plan.alive[k], device=dev)
            nxt = torch.where(alive[:, None], nxt, theta)
        theta = nxt
    final_w = primal(theta, T)
    return {
        "loss": loss.cpu().numpy(),
        "correct": correct.cpu().numpy(),
        "sparsity": sparsity.cpu().numpy(),
        "connectivity": conn,
        "eps_ledger": np.full(T, eps if not math.isinf(eps) else math.inf),
        "final_w": final_w.float().cpu().numpy(),
    }
