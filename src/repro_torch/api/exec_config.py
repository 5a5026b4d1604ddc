"""ExecConfig — the execution knobs of `run`, as one object.

Counterpart of `repro.api.exec_config` for the fields this slice carries.
WHAT to run stays on `RunSpec`; HOW to execute it lives here.

>>> from repro_torch.api import ExecConfig
>>> cfg = ExecConfig(chunk_rounds=64, warmup=False)
>>> cfg.chunk_rounds, cfg.resume
(64, False)
>>> cfg.replace(resume=True).resume
True
"""
from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["ExecConfig"]


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """How a run executes.

    chunk_rounds:       rounds per stream chunk (the stream is generated
                        and the outputs gathered chunk by chunk).
    compute_regret:     post-hoc Definition-3 regret vs the best fixed w.
    warmup:             run one throwaway round on a copy of the state
                        before the timed loop, so ``rounds_per_sec`` leaves
                        out one-time set-up (library load, allocator).
    checkpoint_every / checkpoint_dir / resume:
                        periodic engine-state checkpoints and bit-identical
                        resume (`repro_torch.checkpoint`).
    """

    chunk_rounds: int = 512
    compute_regret: bool = True
    warmup: bool = True
    checkpoint_every: int | None = None
    checkpoint_dir: str | None = None
    resume: bool = False

    def __post_init__(self):
        if self.chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1")

    def replace(self, **kw: Any) -> "ExecConfig":
        return dataclasses.replace(self, **kw)
