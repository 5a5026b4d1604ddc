"""Shared harness of the paper-figure modules, on the port.

Counterpart of ``benchmarks/common.py``. Every figure is one
`repro_torch.sweep` call — the figure modules own WHAT to sweep (the axes and the
JSON rows), never HOW to drive runs: the sweep engine runs a point's seeds
as one `run_batch` (one launch of each round kernel a round for all of
them), and every (point, seed) record persists in the port's sweep store,
so ``from_store=True`` regenerates a figure's JSON without running
anything.

The port's figures keep their own store root (``STORE``) and output
directory (``FIGURES``): a spec record of the port can equal one of the
JAX package's, and neither package serves or overwrites the other's runs.

Three scales:
  default   n=512, m=16, T=500
  paper()   configs/social_linear.py: n=10,000, m=64, T=1,562 (100k samples)
  smoke()   n=64, m=8, T=120 — seconds on a CPU, every code path

>>> spec = make_spec(Scale.smoke(), eps=1.0)
>>> (spec.nodes, spec.dim, spec.horizon, spec.backend)
(8, 64, 120, 'cuda')
>>> (Scale.paper().n, Scale.paper().m, Scale.paper().T)
(10000, 64, 1562)
"""
from __future__ import annotations

import dataclasses

from repro_torch.api import RunSpec
from repro_torch.configs.social_linear import CONFIG
from repro_torch.sweep import SweepResult, SweepSpec, sweep

__all__ = ["SEEDS", "STORE", "FIGURES", "Scale", "make_spec",
           "figure_sweep"]

# every figure averages over these seeds (mean±std in its JSON rows)
SEEDS = (0, 1, 2)
STORE = "experiments/torch_store"
FIGURES = "experiments/torch_figures"


@dataclasses.dataclass
class Scale:
    n: int = 512
    m: int = 16
    T: int = 500
    alpha0: float = 1.0
    L: float = 1.0

    @classmethod
    def paper(cls) -> "Scale":
        """The paper's §V scale, from `configs.social_linear.CONFIG`."""
        return cls(n=CONFIG.n, m=CONFIG.nodes, T=CONFIG.rounds,
                   alpha0=CONFIG.alpha0, L=CONFIG.L)

    @classmethod
    def smoke(cls) -> "Scale":
        """Tiny smoke scale (seconds): exercises every code path."""
        return cls(n=64, m=8, T=120)


def make_spec(scale: Scale, *, eps: float, lam: float = 1e-3,
              topology: str = "ring", seed: int = 0,
              clip_style: str = "coordinate", stream: str = "social_sparse",
              stream_options: dict | None = None, backend: str = "cuda",
              **kw) -> RunSpec:
    """The shared declarative description all figure sweeps build from —
    the reference's, on ``backend`` (the hand-written kernels by default;
    their plain versions on the CPU).

    clip_style='coordinate' is the tighter per-coordinate Laplace
    calibration; 'global' is the paper's exact Lemma-1 scale (sqrt(n)
    larger — with n=10^4 it drowns learning entirely).
    """
    return RunSpec(
        nodes=scale.m, dim=scale.n, mixer=topology, seed=seed,
        eps=eps, clip_norm=scale.L, calibration=clip_style,
        alpha0=scale.alpha0, schedule="sqrt_t", lam=lam, horizon=scale.T,
        stream=stream, stream_options=stream_options or {}, backend=backend,
        **kw)


def figure_sweep(name: str, scale: Scale, axes: dict, *,
                 seeds: tuple = SEEDS, engine: str = "sim",
                 compute_regret: bool = True, from_store: bool = False,
                 store: str | None = STORE,
                 devices: int | str | None = None, device: str = "cuda",
                 **spec_kw) -> SweepResult:
    """One figure = one sweep: axes over `make_spec`, the seeds of a point
    as one batch, records persisted under the figure's name in the store.

    ``from_store=True`` reuses matching stored records instead of running;
    with a point missing it raises `SweepStoreMiss` before any run.
    """
    base = make_spec(scale, **spec_kw)
    spec = SweepSpec(base=base, axes=axes, seeds=tuple(seeds), engine=engine,
                     name=name, chunk_rounds=scale.T,
                     compute_regret=compute_regret, devices=devices)
    return sweep(spec, store=store, reuse=from_store,
                 require_store=from_store, device=device)
