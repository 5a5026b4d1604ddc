"""ExecConfig — the execution knobs of `run`/`run_batch`, as one object.

Counterpart of `repro.api.exec_config`. WHAT to run stays on `RunSpec`
(and `run`'s own horizon/on_chunk/step_fn params); HOW to execute it lives
here, as one frozen dataclass passed as ``run(spec, exec=ExecConfig(...))``.

The old keyword arguments keep working through the reference's deprecation
shim (`resolve_exec`): legacy kwargs are forwarded into an ExecConfig and a
DeprecationWarning fires once per process. Passing both ``exec=`` and legacy
kwargs is an error, and so is a typo.

>>> from repro_torch.api import ExecConfig
>>> cfg = ExecConfig(chunk_rounds=64, warmup=False)
>>> cfg.chunk_rounds, cfg.resume
(64, False)
>>> cfg.replace(resume=True).resume
True
>>> ExecConfig(chunk=3)
Traceback (most recent call last):
    ...
TypeError: ...chunk...

Migration table (old kwarg -> ExecConfig field):

    run(spec, chunk_rounds=64)      -> run(spec, exec=ExecConfig(chunk_rounds=64))
    run(spec, checkpoint_every=256,
             checkpoint_dir=d)      -> ExecConfig(checkpoint_every=256, checkpoint_dir=d)
    run(spec, resume=True)          -> ExecConfig(resume=True)
    run(spec, log_path=p)           -> ExecConfig(log_path=p)
    run(spec, compute_regret=False) -> ExecConfig(compute_regret=False)
    run(spec, warmup=False)         -> ExecConfig(warmup=False)
    run(spec, print_every=10)       -> ExecConfig(print_every=10)
    run(spec, node_devices=4)       -> ExecConfig(node_devices=4)
    run(spec, node_mesh=mesh)       -> ExecConfig(node_mesh=mesh)
    run(spec, obs=tel)              -> ExecConfig(obs=tel)
    run_batch(spec, seeds,
              devices="auto")       -> ExecConfig(devices="auto")
    run_batch(spec, seeds, mesh=mesh) -> ExecConfig(mesh=mesh)
    run_batch(..., check_vectorizable=False)
                                    -> ExecConfig(check_vectorizable=False)

The multi-device fields shard a run over a `repro_torch.launch.mesh.Mesh`
of torch devices: ``node_devices``/``node_mesh`` the node axis (`run`, and
`run_batch`'s ("seed", "node") grid), ``devices``/``mesh`` the seed axis of
`run_batch`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any

__all__ = ["ExecConfig", "resolve_exec"]


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """How a run executes (see the module docstring for the migration
    table).

    chunk_rounds:       rounds per stream chunk (the stream is generated
                        and the outputs gathered chunk by chunk).
    checkpoint_every / checkpoint_dir / resume:
                        periodic engine-state checkpoints and bit-identical
                        resume (`repro_torch.checkpoint`).
    log_path:           `repro_torch.metrics.CSVLogger` per-round (stream
                        mode) or per-step (custom mode) rows (run() only).
    compute_regret:     post-hoc Definition-3 regret vs the best fixed w.
    warmup:             run one throwaway round on a copy of the state
                        before the timed loop, so ``rounds_per_sec`` leaves
                        out one-time set-up (library load, allocator).
    print_every:        custom-mode (step_fn=) progress prints (run() only).
    node_devices / node_mesh:
                        shard the node axis over a ("node",) mesh
                        (`repro_torch.api.shard_node`); ``node_devices``
                        also makes run_batch()'s ("seed", "node") grid.
                        ``node_mesh`` is run() only.
    devices / mesh:     run_batch() only — shard the seed axis over a
                        ("seed",) mesh (or a prebuilt grid).
    check_vectorizable: run_batch() only — refuse a spec whose resolved
                        mixer depends on the seed (`seed_vectorizable`);
                        False skips the check for a caller that already
                        made it (`repro_torch.sweep`).
    obs:                a `repro_torch.obs.Telemetry` (default: the ambient
                        `repro_torch.obs.active()`).
    """

    chunk_rounds: int = 512
    checkpoint_every: int | None = None
    checkpoint_dir: str | None = None
    resume: bool = False
    log_path: str | None = None
    compute_regret: bool = True
    warmup: bool = True
    print_every: int | None = None
    node_devices: int | str | None = None
    node_mesh: Any = None
    devices: int | str | None = None
    mesh: Any = None
    check_vectorizable: bool = True
    obs: Any = None

    def __post_init__(self):
        if self.chunk_rounds < 1:
            raise ValueError("chunk_rounds must be >= 1")

    def replace(self, **kw: Any) -> "ExecConfig":
        return dataclasses.replace(self, **kw)


_FIELDS = tuple(f.name for f in dataclasses.fields(ExecConfig))
_BATCH_ONLY = ("devices", "mesh")
_RUN_ONLY = ("log_path", "print_every", "node_mesh")

# one warning per process, not one per call site — a sweep making thousands
# of legacy calls should nag exactly once
_warned_legacy = False


def resolve_exec(exec_cfg: ExecConfig | None, legacy: dict,
                 *, caller: str) -> ExecConfig:
    """The ExecConfig a run/run_batch call resolved to.

    ``legacy`` holds the caller's ``**legacy`` catch-all: deprecated
    execution kwargs forwarded into an ExecConfig (warning once), with
    typos rejected by name exactly like a real keyword argument would be;
    run-only fields in `run_batch` and batch-only fields in `run` raise
    ValueError.
    """
    global _warned_legacy
    if legacy:
        unknown = sorted(k for k in legacy if k not in _FIELDS)
        if unknown:
            raise TypeError(
                f"{caller}() got unexpected keyword arguments {unknown}; "
                f"execution options: {sorted(_FIELDS)}")
        if exec_cfg is not None:
            raise TypeError(
                f"{caller}() got both exec= and legacy execution kwargs "
                f"{sorted(legacy)}; pass everything via exec=ExecConfig(...)")
        if not _warned_legacy:
            warnings.warn(
                f"passing execution options to {caller}() as keyword "
                f"arguments ({sorted(legacy)}) is deprecated; use "
                f"{caller}(spec, ..., exec=ExecConfig(...)) — see "
                f"repro_torch.api.exec_config for the migration table",
                DeprecationWarning, stacklevel=3)
            _warned_legacy = True
        exec_cfg = ExecConfig(**legacy)
    cfg = exec_cfg if exec_cfg is not None else ExecConfig()
    if not isinstance(cfg, ExecConfig):
        raise TypeError(f"{caller}() exec= expects an ExecConfig, got "
                        f"{type(cfg).__name__}")
    only = _BATCH_ONLY if caller == "run" else _RUN_ONLY
    bad = [f for f in only
           if getattr(cfg, f) != getattr(ExecConfig, f, None)
           and getattr(cfg, f) is not None]
    if bad:
        other = "run_batch" if caller == "run" else "run"
        raise ValueError(f"ExecConfig fields {bad} apply to {other}(), "
                         f"not {caller}()")
    return cfg
