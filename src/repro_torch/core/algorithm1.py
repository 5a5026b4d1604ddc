"""Algorithm 1, faithful simulator (paper §II-D), in torch ops.

Counterpart of `repro.core.algorithm1`: m virtual data-centre nodes in one
device, theta an (m, n) tensor. It is a thin composition over the stage
protocols — Clipper -> Mechanism -> Mixer -> LocalRule — and is the port's
``"reference"`` backend: plain torch ops, the oracle the fused CUDA backend
is held to. Where the reference runs the horizon under one ``lax.scan``,
the port loops over rounds in Python (`repro_torch.api.runner`).

The JAX state carries a PRNG key; `SimState` carries a `torch.Generator`
on the run's device, from which each round draws its noise. A mixer with
``delay > 0`` makes the state carry a (delay+1, m, n) history ring of past
theta~ broadcasts.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.api.clippers import Clipper, PerNodeL2Clipper
from repro_torch.api.mechanisms import Mechanism
from repro_torch.api.mixers import Mixer, ring_write
from repro_torch.api.rules import LocalRule, OMDLassoRule, StepContext
from repro_torch.core import prox
from repro_torch.core.omd import OMDConfig
from repro_torch.device import resolve_device

__all__ = ["Algorithm1", "SimState", "RoundOutput", "hinge_loss_and_grad"]


def hinge_loss_and_grad(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """Paper's loss: f = [1 - y <w,x>]_+ ; subgradient -y x when margin<1.

    Shapes: w (m,n), x (m,n), y (m,) -> loss (m,), grad (m,n).
    """
    margin = y * torch.sum(w * x, dim=1)
    loss = torch.clamp_min(1.0 - margin, 0.0)
    active = (margin < 1.0).to(w.dtype)
    grad = -(active * y)[:, None] * x
    return loss, grad


class SimState(NamedTuple):
    theta: torch.Tensor                # (m, n) dual parameters
    t: int                             # rounds done
    generator: torch.Generator         # noise draws (the JAX state's key)
    history: torch.Tensor | None = None  # (delay+1, m, n) ring of theta~


class RoundOutput(NamedTuple):
    loss: torch.Tensor        # (m,) per-node losses this round
    w_bar_loss: torch.Tensor  # scalar: loss of the averaged parameter
    sparsity: torch.Tensor    # scalar: zero-fraction of w across nodes
    correct: torch.Tensor     # (m,) prediction correctness (sign match)


@dataclasses.dataclass
class Algorithm1:
    """Private Distributed Online Learning (paper Algorithm 1).

    Stages (usually built via RunSpec): mixer (doubly-stochastic A(t)),
    mechanism (noise scale + sampler for the theta~ broadcast), local_rule
    (primal recovery + dual step), clipper (Assumption 2.3 before noising).
    omd supplies the alpha_t / lambda_t schedules (Theorem 2); n is the
    feature dimension; loss_and_grad defaults to the paper's hinge loss.
    The reference's ``delay=`` constructor kwarg is not carried: the
    staleness comes from the mixer.
    """

    omd: OMDConfig
    n: int
    mixer: Mixer | None = None
    mechanism: Mechanism | None = None
    local_rule: LocalRule | None = None
    clipper: Clipper | None = None
    loss_and_grad: Callable = staticmethod(hinge_loss_and_grad)

    def __post_init__(self):
        if self.mixer is None:
            raise ValueError("Algorithm1 needs mixer= (a repro_torch Mixer)")
        if self.mechanism is None:
            raise ValueError(
                "Algorithm1 needs mechanism= (a repro_torch Mechanism)")
        if self.clipper is None:
            # default to the bound the mechanism's sensitivity is calibrated
            # against — a mismatch would silently void the DP guarantee
            self.clipper = PerNodeL2Clipper(
                max_norm=getattr(self.mechanism, "L", 1.0))
        if self.local_rule is None:
            self.local_rule = OMDLassoRule(prox_kind=self.omd.prox_kind)

    @property
    def delay(self) -> int:
        """WAN staleness in rounds, declared by the mixer (RunSpec.delay
        wraps it in DelayedMixer; a faulty mixer adds its stragglers'
        deepest lag); the history ring is delay + 1 deep."""
        return int(getattr(self.mixer, "delay", 0))

    @property
    def m(self) -> int:
        return self.mixer.m

    def init(self, seed: int = 0, device: str | torch.device = "cuda") -> SimState:
        """Zero state on ``device`` (CUDA unless the caller asks for the
        CPU), with the noise generator seeded from ``seed``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        hist = (torch.zeros((self.delay + 1, self.m, self.n),
                            dtype=torch.float32, device=dev)
                if self.delay else None)
        return SimState(
            theta=torch.zeros((self.m, self.n), dtype=torch.float32,
                              device=dev),
            t=0, generator=gen, history=hist)

    def _ctx(self, t: int) -> StepContext:
        return self.omd.step_context(t)

    def round(self, state: SimState, batch) -> tuple[SimState, RoundOutput]:
        """One synchronous round across all m nodes.

        batch: (x, y) with x (m, n), y (m,) — node i sees only row i
        (disjoint streams => parallel composition, Thm 1).
        """
        x, y = batch
        ctx = self._ctx(state.t + 1)

        # Steps 6-7: primal recovery (the paper's rule = Lasso prox).
        w = self.local_rule.primal(state.theta, ctx)

        # Steps 8-9: predict, receive label, suffer loss.
        loss, grad = self.loss_and_grad(w, x, y)
        correct = (torch.sign(torch.sum(w * x, dim=1)) == y).to(torch.float32)

        # Clip to enforce Assumption 2.3 (||g|| <= L) — required for Lemma 1.
        grad, _ = self.clipper.clip(grad)

        # Step 11 (previous round's broadcast): perturb the egress copies.
        scale = self.mechanism.scale(ctx.alpha_t, self.n)
        delta = self.mechanism.sample(state.generator, (self.m, self.n),
                                      scale)
        theta_tilde = state.theta + delta

        # Step 10: gossip mixing with doubly-stochastic A(t).
        history = state.history
        if self.delay:
            history = ring_write(history, state.t, theta_tilde)
            mixed = self.mixer.mix_history(state.theta, theta_tilde, history,
                                           self.mechanism.noise_self, state.t)
        else:
            mixed = self.mixer.mix(state.theta, theta_tilde,
                                   self.mechanism.noise_self, state.t)
        theta_next = self.local_rule.dual_step(mixed, grad, ctx)

        # Fault injection (repro_torch.faults): a crashed node freezes its
        # local update and rejoins from this very state once its window
        # ends. Specs without crash windows pay nothing.
        fault_sched = getattr(self.mixer, "schedule", None)
        if fault_sched is not None and fault_sched.has_crashes:
            alive = fault_sched.alive_mask(state.t, theta_next.device)
            theta_next = torch.where(alive[:, None], theta_next, state.theta)

        # Definition 3 regret is w.r.t. the average parameter w_bar.
        w_bar = torch.mean(w, dim=0, keepdim=True)
        wb_loss = torch.mean(torch.clamp_min(
            1.0 - y * torch.sum(w_bar * x, dim=-1), 0.0))

        out = RoundOutput(loss=loss, w_bar_loss=wb_loss,
                          sparsity=prox.sparsity(w), correct=correct)
        return SimState(theta=theta_next, t=state.t + 1,
                        generator=state.generator, history=history), out

    # -- a whole horizon ---------------------------------------------------------

    def _scan(self, seed: int, xs, ys, device):
        dev = resolve_device(device)
        state = self.init(seed, dev)
        outs = []
        for k in range(xs.shape[0]):
            state, out = self.round(state, (torch.as_tensor(xs[k]).to(dev),
                                            torch.as_tensor(ys[k]).to(dev)))
            outs.append(out)
        return state, RoundOutput(*(torch.stack(f) for f in zip(*outs)))

    def run(self, seed: int, xs, ys,
            device: str | torch.device = "cuda") -> RoundOutput:
        """Run T rounds from the zero state on ``device`` (CUDA unless the
        caller asks for the CPU). xs (T, m, n), ys (T, m). Returns the
        stacked per-round outputs."""
        return self._scan(seed, xs, ys, device)[1]

    def final_params(self, seed: int, xs, ys,
                     device: str | torch.device = "cuda"):
        """Like run() but also returns the final primal parameters (m, n),
        recovered with the schedule of the last round."""
        state, outs = self._scan(seed, xs, ys, device)
        w = self.local_rule.primal(state.theta, self._ctx(state.t))
        return w, outs
