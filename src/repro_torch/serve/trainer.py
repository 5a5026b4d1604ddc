"""Background trainer: continuous gossip rounds -> published snapshots.

Counterpart of `repro.serve.trainer`. Wraps `repro_torch.run`'s chunk loop
in a thread and hangs on its ``on_chunk`` hook: after every
``chunk_rounds`` gossip/update rounds the engine state (the card
synchronised) becomes an immutable :class:`~repro_torch.serve.state.Snapshot`
published to the predictor — the serving side keeps answering against the
previous snapshot until the swap, so training never blocks a prediction
and a prediction never sees a half-updated model. The thread runs on the
ServeState's device (CUDA unless the caller asked for the CPU), never on
whatever device happens to be current.

Privacy accounting for SERVING is explicit about composition across
publications:

  * ``composition='parallel'`` (default, faithful to Theorem 1 when the
    stream declares disjoint rounds): the cumulative guarantee stays flat
    at eps_per_round — the broadcasts the accountant already covers are the
    only releases.
  * ``composition='sequential'`` is the pessimistic stance that every
    published snapshot is a separate eps-DP release: the ledger grows by
    eps_per_round per ROUND, so a finite ``eps_budget`` is eventually
    SPENT. The trainer then stops advancing, refuses to publish the
    over-budget snapshot, and flips ``exhausted`` — the admission layer
    refuses every later request.

>>> from repro_torch.api import RunSpec
>>> from repro_torch.serve.state import ServeState
>>> from repro_torch.serve.trainer import BackgroundTrainer
>>> spec = RunSpec(nodes=2, dim=8, horizon=12, eps=1.0, alpha0=0.5, lam=0.01,
...                stream="bursty")
>>> state = ServeState(spec, device="cpu")
>>> _ = state.publish_initial()
>>> tr = BackgroundTrainer(spec, state, chunk_rounds=4, warmup=False)
>>> tr.run_blocking()                  # inline (no thread): 12 rounds
>>> tr.round, state.current.round, state.published
(12, 12, 4)
>>> budget = BackgroundTrainer(spec, ServeState(spec, device="cpu"),
...                            chunk_rounds=4, composition="sequential",
...                            eps_budget=5.0, warmup=False)
>>> budget.run_blocking()              # 4 rounds cost 4.0, 8 would cost 8.0
>>> budget.round, budget.exhausted
(4, True)
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable

import torch

from repro_torch import obs as obslib
from repro_torch.api.exec_config import ExecConfig
from repro_torch.api.runner import RunResult, run
from repro_torch.api.spec import RunSpec
from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.core.privacy import PrivacyAccountant
from repro_torch.serve.state import ServeState, Snapshot, snapshot_from_state

__all__ = ["BackgroundTrainer", "TrainerCrash"]


class TrainerCrash(RuntimeError):
    """Injected trainer failure (repro_torch.faults): raised inside the chunk
    hook at ``crash_at_round`` to sever the training run mid-horizon. The
    trainer catches it, replays from its last async checkpoint and finishes
    the horizon bit-identically (streams are keyed per absolute round, and
    the checkpoint carries the noise generator's state)."""

    def __init__(self, round_end: int):
        super().__init__(f"injected trainer crash at round {round_end}")
        self.round_end = round_end


class BackgroundTrainer:
    """Advance gossip rounds in fixed chunks; publish snapshots atomically.

    spec / engine / chunk_rounds: what `repro_torch.run` drives —
        publication happens at every chunk boundary, so ``chunk_rounds`` IS
        the publication cadence (and the upper bound on served staleness
        while the trainer keeps up).
    composition / eps_budget: the serving-side privacy ledger (see module
        docstring). ``eps_budget=None`` never refuses.
    on_publish: optional callback fired with each published Snapshot —
        the service uses it for async checkpointing.
    checkpoint_dir: directory for the trainer's OWN engine-state
        checkpoints (async, one per chunk) — the recovery substrate for
        crash restarts, separate from the service's snapshot checkpoints.
    crash_at_round: fault injection: raise :class:`TrainerCrash` at the
        first chunk boundary >= this round, then restart from the last
        checkpoint and resume bit-identically. Requires
        ``checkpoint_dir``; ``restarts`` counts recoveries.

    The rounds run on the ServeState's device, where the snapshots live.
    """

    def __init__(self, spec: RunSpec, state: ServeState, *,
                 engine: str = "sim", chunk_rounds: int = 64,
                 composition: str = "parallel",
                 eps_budget: float | None = None,
                 warmup: bool = True,
                 on_publish: Callable[[Snapshot], None] | None = None,
                 checkpoint_dir: str | None = None,
                 crash_at_round: int | None = None):
        if composition not in ("parallel", "sequential"):
            raise ValueError(f"unknown composition {composition!r}")
        if crash_at_round is not None and checkpoint_dir is None:
            raise ValueError(
                "crash_at_round needs checkpoint_dir= — without a "
                "checkpoint there is nothing to restart from")
        self.spec = spec
        self.state = state
        self.engine = engine
        self.chunk_rounds = chunk_rounds
        self.composition = composition
        self.eps_budget = eps_budget
        self.warmup = warmup
        self.on_publish = on_publish
        self.device = state.device
        stream = spec.resolve_stream(device=self.device)
        mech = spec.resolve_mechanism()
        self._accountant = PrivacyAccountant(
            eps_per_round=spec.eps if mech.is_private else math.inf,
            disjoint_streams=(composition == "parallel"
                              and getattr(stream, "disjoint", False)))
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._round = 0
        self._exhausted = False
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.result: RunResult | None = None
        self.checkpoint_dir = checkpoint_dir
        self.crash_at_round = crash_at_round
        self.restarts = 0
        self._crashed_once = False
        self._checkpointer = (AsyncCheckpointer(checkpoint_dir)
                              if checkpoint_dir else None)

    # -- ledger --------------------------------------------------------------

    def eps_at(self, rounds: int) -> float:
        """Cumulative guarantee charged for serving a snapshot at ``rounds``
        under this trainer's composition policy."""
        return self._accountant.guarantee_at(rounds)

    @property
    def eps_spent(self) -> float:
        return self.eps_at(self.round)

    @property
    def round(self) -> int:
        with self._lock:
            return self._round

    @property
    def exhausted(self) -> bool:
        with self._lock:
            return self._exhausted

    # -- the on_chunk hook ---------------------------------------------------

    def _on_chunk(self, round_end: int, eng_state, accountant) -> bool:
        eps = self.eps_at(round_end)
        if self.eps_budget is not None and eps > self.eps_budget:
            # publishing this snapshot would overspend the ledger: drop it,
            # stop training, and flip the flag the admission layer refuses on
            with self._lock:
                self._exhausted = True
            return True
        if (self.crash_at_round is not None and not self._crashed_once
                and round_end >= self.crash_at_round):
            # crash BEFORE checkpointing or publishing this chunk: recovery
            # must come from the previous boundary, like a real process death
            self._crashed_once = True
            raise TrainerCrash(round_end)
        if self._checkpointer is not None:
            self._checkpointer.save(round_end, eng_state)
        tel = obslib.active()
        with tel.span("serve.publish", round=round_end):
            snap = snapshot_from_state(
                self.spec, self.engine, eng_state,
                version=self.state.published, eps_spent=eps)
            self.state.publish(snap)
        with self._lock:
            self._round = round_end
        if tel.enabled:
            tel.metrics.gauge("serve.train_round").set(round_end)
            tel.metrics.counter("serve.published").inc()
            tel.emit("publish", round=round_end, version=snap.version,
                     eps=eps)
        if self.on_publish is not None:
            self.on_publish(snap)
        return self._stop.is_set()

    def _drive(self) -> None:
        dev = self.device
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                while True:
                    try:
                        # resume= replays from the last trainer checkpoint —
                        # a no-op on the first pass of an empty directory
                        self.result = run(
                            self.spec, engine=self.engine,
                            on_chunk=self._on_chunk, device=dev,
                            exec=ExecConfig(
                                chunk_rounds=self.chunk_rounds,
                                compute_regret=False, warmup=self.warmup,
                                resume=self._checkpointer is not None,
                                checkpoint_dir=self.checkpoint_dir))
                        return
                    except TrainerCrash:
                        # the injected death: flush pending writes, then
                        # restart from the latest checkpoint. Streams are
                        # keyed per absolute round and the checkpoint holds
                        # the generator, so the replayed rounds are
                        # bit-identical to the uncrashed run.
                        self._checkpointer.wait()
                        with self._lock:
                            self.restarts += 1
        except Exception as err:            # surfaced by join()
            self._error = err

    # -- lifecycle -----------------------------------------------------------

    def run_blocking(self) -> None:
        """Drive the whole horizon inline (tests, doctests, measurements
        that want training isolated from serving)."""
        self._drive()
        if self._checkpointer is not None:
            self._checkpointer.close()
        if self._error is not None:
            raise self._error

    def start(self) -> "BackgroundTrainer":
        if self._thread is not None:
            raise RuntimeError("trainer already started")
        self._thread = threading.Thread(target=self._drive, daemon=True,
                                        name="repro-torch-serve-trainer")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Request a stop at the next chunk boundary."""
        self._stop.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("trainer did not stop within timeout")
        if self._checkpointer is not None:
            self._checkpointer.close()
        if self._error is not None:
            raise self._error

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
