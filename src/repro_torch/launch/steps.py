"""Training-launch knobs: `TrainRecipe` and its `RunSpec`.

Counterpart of the `TrainRecipe` of `repro.launch.steps` (a copy). The
rest of that module — the LM step functions, shard specs and the
all-reduce baseline — belongs to the LM stack, which waits in ROADMAP
queue 1 item 5.

>>> spec = TrainRecipe(eps=0.5, topology="torus").to_runspec(16)
>>> spec.nodes, spec.mixer, spec.eps, spec.calibration
(16, 'torus', 0.5, 'coordinate')
"""
from __future__ import annotations

import dataclasses

from repro_torch.api import RunSpec

__all__ = ["TrainRecipe"]


@dataclasses.dataclass(frozen=True)
class TrainRecipe:
    """Training-launch knobs; the gossip path materialises as a
    `repro_torch.api.RunSpec` (see :meth:`to_runspec`), so every
    registry-backed mixer / mechanism / local rule is reachable from the
    CLI."""

    strategy: str = "gossip"        # 'gossip' (the paper) | 'allreduce' (baseline)
    eps: float = 1.0                # DP budget per round (gossip only)
    L: float = 1.0                  # clip norm
    lam: float = 1e-4               # Lasso strength
    alpha0: float = 0.01
    topology: str = "ring"          # repro_torch.api MIXERS registry name
    lr: float = 3e-4                # allreduce baseline LR
    noise_self: bool = True
    microbatches: int = 1           # grad-accumulation chunks per round
    # Laplace calibration: 'coordinate' (2*alpha*L/eps per coordinate) is the
    # deployable default at transformer scale; the paper's exact Lemma-1
    # 'global' scale carries a sqrt(n) factor — selectable for the
    # paper-faithful linear workload.
    clip_style: str = "coordinate"
    mechanism: str = "laplace"      # repro_torch.api MECHANISMS registry name
    local_rule: str = "omd"         # repro_torch.api LOCAL_RULES registry name
    clipper: str = "l2"             # repro_torch.api CLIPPERS registry name
    # WAN staleness (rounds): delay > 0 gives the state a (delay+1)-deep
    # history ring; delay_dist ('constant'|'uniform'|'geometric') draws
    # per-edge delays <= delay from a seeded distribution instead of one
    # uniform lag.
    delay: int = 0
    delay_dist: str | None = None

    def to_runspec(self, nodes: int) -> RunSpec:
        return RunSpec(
            nodes=nodes,
            mixer=self.topology,
            mechanism=self.mechanism,
            local_rule=self.local_rule,
            clipper=self.clipper,
            eps=self.eps,
            clip_norm=self.L,
            noise_self=self.noise_self,
            calibration=self.clip_style,
            alpha0=self.alpha0,
            schedule="sqrt_t",
            lam=self.lam,
            delay=self.delay,
            delay_dist=self.delay_dist,
        )
