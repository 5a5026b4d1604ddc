"""RunSpec — one declarative description of a private-gossip run.

Counterpart of `repro.api.spec.RunSpec`, with the same field names and
defaults. Fields accept registry names or constructed stage instances; every
registry name of the reference resolves here, the fault scenarios
(``faults=``, `repro_torch.faults`) included.

>>> from repro_torch.api import RunSpec
>>> spec = RunSpec(nodes=4, dim=8, mixer="ring", eps=float("inf"))
>>> type(spec.build_simulator()).__name__
'Algorithm1'
>>> spec.replace(delay=3).resolve_mixer().delay     # uniform WAN staleness
3
>>> het = spec.replace(delay=2, delay_dist="uniform").resolve_mixer()
>>> type(het).__name__, 0 <= het.delay <= 2
('HeterogeneousDelayMixer', True)
>>> faulty = spec.replace(faults="links").resolve_mixer()
>>> type(faulty).__name__, faulty.schedule.spec.link_rate
('FaultySparseMixer', 0.05)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.api.clippers import Clipper
from repro_torch.api.mechanisms import Mechanism
from repro_torch.api.mixers import (DelayedMixer, HeterogeneousDelayMixer,
                                    Mixer)
from repro_torch.api.registry import (BACKENDS, CLIPPERS, LOCAL_RULES,
                                      MECHANISMS, MIXERS, STREAMS)
from repro_torch.api.rules import LocalRule
from repro_torch.api.streams import Stream
from repro_torch.core.omd import OMDConfig

__all__ = ["RunSpec"]


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Declarative description of one private-gossip-learning run.

    nodes:   m data centers (the node axis).
    dim:     feature dimension n.
    mixer / mechanism / local_rule / clipper:
             registry name or stage instance; *_options are forwarded to
             the registry factory (ignored when an instance is given).
    eps, clip_norm, noise_self, calibration:
             shared privacy knobs injected into the default mechanism and
             clipper factories (explicit *_options win).
    alpha0, schedule, lam, horizon, prox_kind:
             the OMD schedule (Theorem 2).
    stream / stream_options:
             data scenario for `repro_torch.run` (STREAMS name or a Stream
             instance), built with n=dim, nodes, rounds=horizon, seed.
    delay:   WAN staleness in rounds — wraps the mixer in DelayedMixer (the
             engine allocates a delay+1 deep history ring).
    delay_dist:
             per-edge heterogeneous staleness: 'constant' | 'uniform' |
             'geometric' builds a HeterogeneousDelayMixer over the dense
             form of ``mixer`` with per-edge delays drawn from the seeded
             distribution, capped at ``delay``. None keeps the uniform
             delay.
    faults / faults_options:
             fault scenario (`repro_torch.faults`): a FAULTS name or a
             FaultSpec; the resolved mixer is wrapped onto its schedule.
    backend / backend_options:
             how the round body executes (BACKENDS name or instance):
             'reference' (default) is torch ops; 'cuda' the fused Hopper
             kernels of `repro_torch.kernels.round_fused`.
    seed:    seeds the stream and the noise generator.
    """

    nodes: int
    dim: int | None = None
    mixer: str | Mixer = "ring"
    mixer_options: dict = dataclasses.field(default_factory=dict)
    mechanism: str | Mechanism = "laplace"
    mechanism_options: dict = dataclasses.field(default_factory=dict)
    local_rule: str | LocalRule = "omd"
    local_rule_options: dict = dataclasses.field(default_factory=dict)
    clipper: str | Clipper = "l2"
    clipper_options: dict = dataclasses.field(default_factory=dict)
    # shared knobs
    eps: float = 1.0
    clip_norm: float = 1.0
    noise_self: bool = True
    calibration: str = "global"
    alpha0: float = 0.1
    schedule: str = "sqrt_t"
    lam: float = 0.01
    horizon: int | None = None
    prox_kind: str = "l1"
    delay: int = 0
    delay_dist: str | None = None
    seed: int = 0
    loss_and_grad: Callable | None = None
    stream: str | Stream = "social_sparse"
    stream_options: dict = dataclasses.field(default_factory=dict)
    faults: Any = None
    faults_options: dict = dataclasses.field(default_factory=dict)
    backend: Any = "reference"
    backend_options: dict = dataclasses.field(default_factory=dict)

    # -- stage resolution ----------------------------------------------------

    def resolve_faults(self):
        """Compiled `repro_torch.faults.FaultSchedule`, or None without
        faults."""
        if self.faults is None:
            return None
        from repro_torch.faults import FAULTS
        fault_spec = FAULTS.build(self.faults, self.faults_options)
        return fault_spec.compile(m=self.nodes, horizon=self.horizon)

    def resolve_mixer(self) -> Mixer:
        if self.delay_dist is not None:
            if self.faults is not None:
                raise ValueError(
                    "faults do not compose with delay_dist (per-edge "
                    "heterogeneous delays) — model slow links as FaultSpec "
                    "stragglers instead")
            if not isinstance(self.mixer, str):
                raise ValueError(
                    "delay_dist needs a topology NAME for the dense per-edge "
                    "decomposition (got a constructed mixer instance); build "
                    "a HeterogeneousDelayMixer directly instead")
            if self.delay < 1:
                raise ValueError("delay_dist needs delay >= 1 (the cap on "
                                 "per-edge staleness)")
            try:
                return HeterogeneousDelayMixer.from_topology(
                    self.mixer, self.nodes, delay=self.delay,
                    delay_dist=self.delay_dist, seed=self.seed,
                    **self.mixer_options)
            except ValueError as err:
                # e.g. mixer='ring_alternating' is a MIXERS name but not a
                # dense GossipGraph topology: name the knob at fault
                raise ValueError(
                    f"delay_dist={self.delay_dist!r} (per-edge delays need "
                    f"the dense GossipGraph form of mixer={self.mixer!r}): "
                    f"{err}") from None
        mixer = MIXERS.build(self.mixer, self.mixer_options,
                             m=self.nodes, seed=self.seed)
        if getattr(mixer, "m", self.nodes) != self.nodes:
            raise ValueError(
                f"mixer is built for m={mixer.m} nodes but RunSpec.nodes="
                f"{self.nodes}")
        mixer_delay = getattr(mixer, "delay", 0)
        if self.delay and mixer_delay and mixer_delay != self.delay:
            raise ValueError(
                f"conflicting delays: RunSpec.delay={self.delay} but the "
                f"mixer already carries delay={mixer_delay}")
        if self.delay and not mixer_delay:
            mixer = DelayedMixer(inner=mixer, delay=self.delay)
        faults = self.resolve_faults()
        if faults is not None:
            from repro_torch.faults import wrap_mixer
            mixer = wrap_mixer(mixer, faults)
        return mixer

    def resolve_mechanism(self) -> Mechanism:
        return MECHANISMS.build(
            self.mechanism, self.mechanism_options,
            eps=self.eps, L=self.clip_norm, noise_self=self.noise_self,
            calibration=self.calibration)

    def resolve_local_rule(self) -> LocalRule:
        return LOCAL_RULES.build(self.local_rule, self.local_rule_options,
                                 prox_kind=self.prox_kind)

    def resolve_clipper(self) -> Clipper:
        return CLIPPERS.build(self.clipper, self.clipper_options,
                              max_norm=self.clip_norm)

    def resolve_stream(self, device: str | torch.device = "cuda") -> Stream:
        """The data scenario `repro_torch.run` drives (STREAMS registry);
        a stream built by name makes its data on ``device``."""
        if isinstance(self.stream, str):
            if self.dim is None:
                raise ValueError("RunSpec.dim is required to build a stream "
                                 "by name")
            if self.horizon is None:
                raise ValueError("RunSpec.horizon is required to build a "
                                 "stream by name (the stream length)")
            return STREAMS.build(self.stream, self.stream_options,
                                 n=self.dim, nodes=self.nodes,
                                 rounds=self.horizon, seed=self.seed,
                                 device=str(device))
        stream = self.stream
        if getattr(stream, "nodes", self.nodes) != self.nodes:
            raise ValueError(
                f"stream is built for {stream.nodes} nodes but RunSpec.nodes="
                f"{self.nodes}")
        if self.dim is not None and getattr(stream, "n", self.dim) != self.dim:
            raise ValueError(
                f"stream has n={stream.n} features but RunSpec.dim={self.dim}")
        return stream

    def resolve_backend(self):
        """The execution backend (BACKENDS registry, entries registered by
        importing `repro_torch.api.backends`)."""
        from repro_torch.api import backends  # noqa: F401  (registers)
        return BACKENDS.build(self.backend, self.backend_options)

    def omd_config(self) -> OMDConfig:
        return OMDConfig(alpha0=self.alpha0, schedule=self.schedule,
                         lam=self.lam, T=self.horizon,
                         prox_kind=self.prox_kind)

    def build_simulator(self):
        """The (m, n) torch-ops engine (`core.algorithm1.Algorithm1`)."""
        from repro_torch.core.algorithm1 import Algorithm1, hinge_loss_and_grad
        if self.dim is None:
            raise ValueError("RunSpec.dim is required for the simulator")
        return Algorithm1(
            omd=self.omd_config(),
            n=self.dim,
            mixer=self.resolve_mixer(),
            mechanism=self.resolve_mechanism(),
            local_rule=self.resolve_local_rule(),
            clipper=self.resolve_clipper(),
            loss_and_grad=self.loss_and_grad or hinge_loss_and_grad,
        )

    def build_distributed(self):
        """The node-stacked pytree engine (`core.gossip.GossipDP`)."""
        from repro_torch.core.gossip import GossipDP
        return GossipDP(
            omd=self.omd_config(),
            mixer=self.resolve_mixer(),
            mechanism=self.resolve_mechanism(),
            local_rule=self.resolve_local_rule(),
            clipper=self.resolve_clipper(),
        )

    def replace(self, **kw: Any) -> "RunSpec":
        return dataclasses.replace(self, **kw)
