"""social-linear — the PAPER'S OWN workload (§V Simulations).

100,000 social data points, dimensionality n = 10,000, hinge loss,
m = 64 data-center nodes, Laplace-private gossip. Not a transformer — this
config parameterizes `repro_torch.core.Algorithm1` / the GossipDP linear
model that `repro_torch.figures` and `chip_smoke.py` run. Counterpart of
`repro.configs.social_linear`, field for field.

>>> CONFIG.rounds, smoke().rounds
(1562, 250)
"""
from __future__ import annotations

import dataclasses

__all__ = ["SocialLinearConfig", "CONFIG", "smoke"]


@dataclasses.dataclass(frozen=True)
class SocialLinearConfig:
    n: int = 10_000            # feature dimensionality (paper: 10,000)
    total_samples: int = 100_000  # paper: 100,000 social data points
    nodes: int = 64            # paper Figs 2-4 use 64 nodes
    topology: str = "ring"
    eps: float = 1.0           # per-round privacy budget
    L: float = 1.0             # subgradient bound (enforced by clipping)
    alpha0: float = 1.0
    schedule: str = "sqrt_t"
    lam: float = 1e-3          # Lasso strength (sparsity knob, Fig. 4 sweep)
    sparsity_true: float = 0.05  # ground-truth sparse support fraction
    seed: int = 0

    @property
    def rounds(self) -> int:
        return self.total_samples // self.nodes


CONFIG = SocialLinearConfig()


def smoke() -> SocialLinearConfig:
    return dataclasses.replace(CONFIG, n=256, total_samples=2_000, nodes=8)
