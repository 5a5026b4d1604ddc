"""ExecConfig — the execution knobs of `run`, as one object.

Counterpart of `repro.api.exec_config` for the fields the port carries
(`run` and `run_batch`). WHAT to run stays on `RunSpec`; HOW to execute it
lives here.

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

from repro_torch.api.spec import not_ported

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
    check_vectorizable: `run_batch` refuses a spec whose resolved mixer
                        depends on the seed (`seed_vectorizable`); False
                        skips the check for a caller that already made it
                        (`repro_torch.sweep`).
    devices / mesh:     the reference's seed-axis sharding of a batch over
                        several devices; not ported (one card here) — any
                        value but None raises.
    """

    chunk_rounds: int = 512
    compute_regret: bool = True
    warmup: bool = True
    checkpoint_every: int | None = None
    checkpoint_dir: str | None = None
    resume: bool = False
    devices: Any = None
    mesh: Any = None
    check_vectorizable: bool = True

    def __post_init__(self):
        if self.chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1")
        for name in ("devices", "mesh"):
            if getattr(self, name) is not None:
                raise not_ported(
                    f"ExecConfig.{name} (sharding a seed batch over several "
                    f"devices, ROADMAP queue 1 item 4: multi-device)")

    def replace(self, **kw: Any) -> "ExecConfig":
        return dataclasses.replace(self, **kw)
