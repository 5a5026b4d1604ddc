"""GossipDP — Algorithm 1 as a distribution strategy over node-stacked pytrees.

Counterpart of `repro.core.gossip`. Every parameter leaf carries a leading
node axis of size m (the gossip "data centres"); the engine composes the
same stages as the simulator (`core.algorithm1`) — Clipper -> Mechanism ->
Mixer -> LocalRule — leaf by leaf, with no topology, mechanism or rule
branching of its own. Build it with ``RunSpec.build_distributed()``.

The reference's state carries a PRNG key; `GossipState` carries a
`torch.Generator` on the run's device. Leaves are walked in JAX's order
(`core.tree`: dict keys sorted), and each leaf draws its noise block from
the generator in that order. A single-leaf tree therefore consumes the
round's draw exactly as the simulator's one (m, n) draw does, which is what
keeps ``run(engine="sim")`` and ``run(engine="dist")`` bit-identical.

A mixer with ``delay > 0`` makes the state carry a history ring per leaf,
(delay+1, m, ...), written in place each round.

``update`` with the paper's stages exactly (a synchronous `RingRollMixer`
with no fault schedule, the port's own `LaplaceMechanism` noising every
copy at a scale above 0, `OMDLassoRule` with the l1 prox,
`PerNodeL2Clipper`) makes one `kernels.gossip_update` call a leaf: the same
draw from the generator, then noise, mix, clipped dual step and the
primal's zero count, one kernel pass on the card and the wrapper's plain
version on the CPU (and on the dry-run's ``meta`` tensors, where an op
count takes the kernel's work as one row on any device), bit for bit the
eager chain. Any other stage, or a subclass of one, keeps the eager
chain. The ambient telemetry counts the leaves of each path
(``gossip.fused_leaves``, ``gossip.eager_leaves``).

>>> import torch
>>> from repro_torch.api import RunSpec
>>> gdp = RunSpec(nodes=4, alpha0=0.5, lam=1e-3).build_distributed()
>>> state = gdp.init({"w": torch.zeros(4, 8)}, seed=1, device="cpu")
>>> state, metrics = gdp.update(state, {"w": torch.ones(4, 8)})
>>> state.t, sorted(metrics)
(1, ['alpha_t', 'grad_norm_mean', 'noise_scale', 'theta_sparsity'])
"""
from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Any, NamedTuple

import torch

from repro_torch.api.clippers import Clipper, PerNodeL2Clipper
from repro_torch.api.mechanisms import LaplaceMechanism, Mechanism
from repro_torch.api.mixers import Mixer, RingRollMixer, ring_write
from repro_torch.api.rules import LocalRule, OMDLassoRule, StepContext
from repro_torch.core import privacy, prox, tree
from repro_torch.core.omd import OMDConfig
from repro_torch.device import MetaGenerator, shape_device
from repro_torch.kernels.gossip_update import GRAD_DTYPES, gossip_update
from repro_torch.obs import active, span

__all__ = ["GossipState", "GossipDP", "gossip_mix_tree", "per_node_clip"]


class GossipState(NamedTuple):
    theta: Any                         # pytree; every leaf (m, ...) float32
    t: int                             # rounds done
    generator: torch.Generator         # noise draws (the JAX state's key)
    history: Any = None                # pytree like theta with leaves
    #                                    (delay+1, m, ...): the ring of past
    #                                    theta~ broadcasts; None when the
    #                                    mixer is synchronous


def gossip_mix_tree(theta: Any, generator: torch.Generator, noise_scale,
                    mixer: Mixer, noise_self: bool = True, t: int = 0,
                    mechanism: Mechanism | None = None,
                    history: Any = None) -> Any:
    """Noise + mix every (m, ...) leaf of a node-stacked pytree.

    With a ``mechanism`` its own ``noise_self`` wins; without one the
    Laplace sampler at ``noise_scale`` is used with the flag as passed.
    Each leaf draws its noise from ``generator`` in leaf order.

    ``history`` is the per-leaf ring of past broadcasts (leaves
    (delay+1, m, ...)). When given, each leaf's theta~ is written into its
    ring slot (in place) and the mixer's ``mix_history`` reads the ring; the
    return value is then ``(mixed, history)``. Without it the mix is
    synchronous and only the mixed pytree is returned.
    """
    if mechanism is not None:
        mech, noise_self = mechanism, mechanism.noise_self
    else:
        mech = LaplaceMechanism(noise_self=noise_self)
    leaves, spec = tree.flatten(theta)
    hist_leaves = (tree.leaves(history) if history is not None
                   else [None] * len(leaves))
    mixed = []
    for leaf, hist in zip(leaves, hist_leaves):
        delta = mech.sample(generator, tuple(leaf.shape), noise_scale)
        tilde = leaf + delta.to(leaf.dtype)
        if hist is not None:
            ring_write(hist, t, tilde)
        # mix_history == mix for a synchronous mixer, and raises for a
        # delayed one whose ring the caller forgot to pass
        mixed.append(mixer.mix_history(leaf, tilde, hist, noise_self, t))
    mixed = tree.unflatten(spec, mixed)
    return mixed if history is None else (mixed, history)


def _count(name: str, leaves: int) -> None:
    tel = active()
    if tel.enabled:
        tel.metrics.counter(name).inc(leaves)


def per_node_clip(grads: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """Clip each node's gradient slice (axis 0 of every leaf) to L2 norm
    <= max_norm; returns (clipped, (m,) pre-clip norms)."""
    return PerNodeL2Clipper(max_norm=max_norm).clip(grads)


@dataclasses.dataclass(frozen=True)
class GossipDP:
    """The per-round update: clip -> noise -> gossip-mix -> local rule.

    Works on node-stacked pytrees of tensors. The caller computes per-node
    gradients and calls :meth:`update`. Stages come from `repro_torch.api`,
    usually via ``RunSpec.build_distributed()``.
    """

    omd: OMDConfig
    mixer: Mixer | None = None
    mechanism: Mechanism | None = None
    local_rule: LocalRule | None = None
    clipper: Clipper | None = None

    def __post_init__(self):
        if self.mixer is None:
            raise ValueError("GossipDP needs mixer= (a repro_torch Mixer)")
        if self.mechanism is None:
            raise ValueError(
                "GossipDP needs mechanism= (a repro_torch Mechanism)")
        set_ = lambda k, v: object.__setattr__(self, k, v)  # noqa: E731
        if self.clipper is None:
            # default to the bound the mechanism's sensitivity is calibrated
            # against — a mismatch would silently void the DP guarantee
            set_("clipper", PerNodeL2Clipper(
                max_norm=getattr(self.mechanism, "L", 1.0)))
        if self.local_rule is None:
            set_("local_rule", OMDLassoRule(prox_kind=self.omd.prox_kind))

    @property
    def delay(self) -> int:
        """Staleness depth declared by the mixer (0 = synchronous)."""
        return int(getattr(self.mixer, "delay", 0))

    def init(self, node_params: Any, seed: int = 0,
             device: str | torch.device = "cuda") -> GossipState:
        """State at round 0 on ``device`` (CUDA unless the caller asks for
        the CPU): theta from the node-stacked ``node_params`` as float32,
        the noise generator seeded from ``seed``. ``device="meta"`` builds
        a state of shapes for the dry-run's count, its generator a
        `MetaGenerator` (shape-only noise)."""
        dev = shape_device(device)
        theta = tree.tree_map(
            lambda p: self.local_rule.init_state(
                torch.as_tensor(p).to(device=dev, dtype=torch.float32)),
            node_params)
        history = None
        if self.delay:
            depth = self.delay + 1
            history = tree.tree_map(
                lambda th: torch.zeros((depth,) + tuple(th.shape),
                                       dtype=th.dtype, device=dev), theta)
        gen = MetaGenerator() if dev.type == "meta" else \
            torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        return GossipState(theta=theta, t=0, generator=gen, history=history)

    def param_count_per_node(self, theta: Any) -> int:
        return sum(int(leaf.numel() // leaf.shape[0])
                   for leaf in tree.leaves(theta))

    def _ctx(self, t: int) -> StepContext:
        return self.omd.step_context(t)

    def primal(self, state: GossipState) -> Any:
        """w_t from theta_t (steps 6-7) via the local rule, per leaf."""
        ctx = self._ctx(state.t + 1)
        return tree.tree_map(lambda th: self.local_rule.primal(th, ctx),
                             state.theta)

    def _fusable(self, grads: Any, scale: float) -> bool:
        """Whether ``update`` takes `kernels.gossip_update`: the paper's
        stages exactly (no subclass: one may draw, mix or clip another way;
        a faulty or delayed ring is a mixer of another type), noise drawn
        (scale > 0) and bfloat16 or float32 gradients."""
        mixer, mech, rule = self.mixer, self.mechanism, self.local_rule
        return (type(mixer) is RingRollMixer and mixer.delay == 0
                and type(mech) is LaplaceMechanism and mech.noise_self
                and float(scale) > 0.0
                and type(rule) is OMDLassoRule and rule.prox_kind == "l1"
                and type(self.clipper) is PerNodeL2Clipper
                and all(g.dtype in GRAD_DTYPES for g in tree.leaves(grads)))

    def update(self, state: GossipState,
               grads: Any) -> tuple[GossipState, dict]:
        """Steps 10-11 for every node at once."""
        ctx = self._ctx(state.t + 1)
        n = self.param_count_per_node(state.theta)
        scale = self.mechanism.scale(ctx.alpha_t, n)
        path = (self._fused_update if self._fusable(grads, scale)
                else self._eager_update)
        new_state, gnorms, sparsity = path(state, grads, ctx, scale)
        metrics = {
            "alpha_t": ctx.alpha_t,
            "noise_scale": scale,
            "grad_norm_mean": torch.mean(gnorms),
            "theta_sparsity": sparsity,
        }
        return new_state, metrics

    def _eager_update(self, state: GossipState, grads: Any, ctx: StepContext,
                      scale: float) -> tuple[GossipState, torch.Tensor,
                                             torch.Tensor]:
        """``update``'s stages one torch op at a time: (next state, (m,)
        gradient norms, the next primal's zero fraction)."""
        _count("gossip.eager_leaves", len(tree.leaves(state.theta)))
        with span("gossip.clip"):
            grads, gnorms = self.clipper.clip(grads)

        with span("gossip.mix"):
            new_history = state.history
            if self.delay:
                mixed, new_history = gossip_mix_tree(
                    state.theta, state.generator, scale, self.mixer,
                    t=state.t, mechanism=self.mechanism,
                    history=state.history)
            else:
                mixed = gossip_mix_tree(state.theta, state.generator, scale,
                                        self.mixer, t=state.t,
                                        mechanism=self.mechanism)
        with span("gossip.dual_step"):
            theta_next = tree.tree_map(
                lambda th, g: self.local_rule.dual_step(th, g, ctx), mixed,
                grads)
            del mixed, grads        # a full theta's worth of memory each
            # crashed nodes (a fault schedule on the mixer) freeze every
            # leaf of their local state until the crash window ends
            fault_sched = getattr(self.mixer, "schedule", None)
            if fault_sched is not None and fault_sched.has_crashes:
                alive = fault_sched.alive_mask(
                    state.t, tree.leaves(theta_next)[0].device)
                theta_next = tree.tree_map(
                    lambda nxt, cur: torch.where(
                        alive.reshape((-1,) + (1,) * (nxt.dim() - 1)), nxt,
                        cur),
                    theta_next, state.theta)
        new_state = GossipState(theta=theta_next, t=state.t + 1,
                                generator=state.generator,
                                history=new_history)
        with span("gossip.sparsity"):
            sparsity = self._primal_sparsity(new_state)
        return new_state, gnorms, sparsity

    def _fused_update(self, state: GossipState, grads: Any, ctx: StepContext,
                      scale: float) -> tuple[GossipState, torch.Tensor,
                                             torch.Tensor]:
        """`_eager_update` as one `kernels.gossip_update` call a leaf: each
        leaf's uniform draw as the eager chain draws it, in leaf order; the
        clip factors from torch's per-node norms; the next primal's zeros
        counted into an exact integer."""
        leaves = tree.leaves(state.theta)
        _count("gossip.fused_leaves", len(leaves))
        with span("gossip.clip"):
            factor, gnorms = self.clipper.factor(grads)
        lam_next = self._ctx(state.t + 2).lam_t
        zeros = torch.zeros(1, dtype=torch.int64, device=leaves[0].device)

        def one(th, g):
            u = privacy.uniform(state.generator, tuple(th.shape))
            return gossip_update(th, u, g, factor, scale, ctx.alpha_t,
                                 lam_next, self.mixer, zeros)

        with span("gossip.mix"):
            theta_next = tree.tree_map(one, state.theta, grads)
        new_state = GossipState(theta=theta_next, t=state.t + 1,
                                generator=state.generator,
                                history=state.history)
        with span("gossip.sparsity"):
            sparsity = prox.zero_fraction(
                zeros[0], sum(th.numel() for th in leaves))
        return new_state, gnorms, sparsity

    def _primal_sparsity(self, state: GossipState) -> torch.Tensor:
        """`prox.sparsity_tree` of :meth:`primal`, the primal made and
        counted one leaf at a time (the same counts, added in leaf order):
        never a whole primal tree beside theta."""
        ctx = self._ctx(state.t + 1)
        leaves = tree.leaves(state.theta)
        zeros = functools.reduce(operator.add, [
            (self.local_rule.primal(th, ctx).abs() <= 0.0).sum()
            for th in leaves])
        return prox.zero_fraction(zeros, sum(th.numel() for th in leaves))
