"""ServeService — the assembled predict-while-learning loop.

Counterpart of `repro.serve.service`. Wires the four serving pieces
together behind one object:

    ServeState      current snapshot + the batched predict step
    BackgroundTrainer   continuous gossip rounds -> atomic publications
    AdmissionQueue/Batcher   bounded queue, max-batch/max-wait batching,
                             shedding, eps-exhaustion refusal
    AsyncCheckpointer   threaded `repro_torch.checkpoint` writes of the
                        serving state (never blocks a publication on disk)

Everything runs on ``ServeConfig.device``: CUDA unless the caller asks for
the CPU. On the card the service loads the round kernels' library on the
thread that starts it, before the trainer thread exists.

>>> from repro_torch.serve import ServeConfig, ServeService
>>> from repro_torch.api import RunSpec
>>> spec = RunSpec(nodes=2, dim=8, horizon=8, eps=1.0, alpha0=0.5, lam=0.01,
...                stream="bursty")
>>> svc = ServeService(ServeConfig(spec=spec, chunk_rounds=4, max_batch=4,
...                                max_wait_ms=0.5, train=False,
...                                warmup=False, device="cpu"))
>>> svc = svc.start()                  # round-0 snapshot, no trainer
>>> r = svc.predict([1.0] * 8, node=0, timeout=10.0)
>>> r.status, r.margin, r.snapshot_round
('ok', 0.0, 0)
>>> svc.stop()
>>> svc.stats()["admission"]["served"]
1
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch import obs as obslib
from repro_torch.api.spec import RunSpec
from repro_torch.checkpoint import AsyncCheckpointer
from repro_torch.serve.admission import (AdmissionQueue, Batcher, Request,
                                         ServeStats)
from repro_torch.serve.state import ServeState, verify_snapshot
from repro_torch.serve.trainer import BackgroundTrainer

__all__ = ["ServeConfig", "ServeService"]


@dataclasses.dataclass
class ServeConfig:
    """Everything the serving loop needs, declaratively.

    spec:           the RunSpec the background trainer advances (its
                    ``stream`` also seeds the replay client's arrivals).
    engine:         'sim' | 'dist' — which engine trains.
    mode:           'node' (per-data-center model) | 'average' (w_bar).
    chunk_rounds:   trainer publication cadence in rounds.
    max_batch / max_wait_ms / queue_capacity: the admission layer.
    max_age_s:      request deadline — a request older than this at dequeue
                    is shed with reason 'timeout' (None never expires).
    crash_at_round: fault injection: kill the trainer at the first chunk
                    boundary >= this round; it restarts from its last async
                    checkpoint (needs checkpoint_dir).
    eps_budget / composition: serving-side privacy ledger (see
                    `repro_torch.serve.trainer`); budget None never refuses.
    checkpoint_dir / checkpoint_every: async-checkpoint every N
                    publications into the directory (None = off).
    keep_snapshots: history ring depth for by-version verification.
    train:          False serves the round-0 model only (tests/doctests).
    warmup:         run one throwaway round before the trainer's timed loop.
    device:         where the trainer and the predictor run ("cuda" unless
                    the caller asks for "cpu").
    """

    spec: RunSpec
    engine: str = "sim"
    mode: str = "node"
    chunk_rounds: int = 64
    max_batch: int = 32
    max_wait_ms: float = 2.0
    max_age_s: float | None = None
    queue_capacity: int = 1024
    crash_at_round: int | None = None
    eps_budget: float | None = None
    composition: str = "parallel"
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    keep_snapshots: int = 8
    train: bool = True
    warmup: bool = True
    device: str = "cuda"


class ServeService:
    """start() -> submit()/predict() under load -> stop() -> stats()."""

    def __init__(self, config: ServeConfig):
        if config.crash_at_round is not None and not config.checkpoint_dir:
            raise ValueError("crash_at_round needs checkpoint_dir= (the "
                             "trainer restarts from its last checkpoint)")
        self.config = config
        self.stats_ = ServeStats()
        self.state = ServeState(config.spec, engine=config.engine,
                                mode=config.mode, keep=config.keep_snapshots,
                                device=config.device)
        self.device = self.state.device
        self.admission = AdmissionQueue(config.queue_capacity, self.stats_)
        self.checkpointer = (
            AsyncCheckpointer(config.checkpoint_dir)
            if config.checkpoint_dir else None)
        # the trainer's engine-state checkpoints live in a subdirectory so
        # they never collide with the service's theta-only snapshot files
        trainer_ckpt = (os.path.join(config.checkpoint_dir, "trainer")
                        if config.checkpoint_dir else None)
        self.trainer = BackgroundTrainer(
            config.spec, self.state, engine=config.engine,
            chunk_rounds=config.chunk_rounds, composition=config.composition,
            eps_budget=config.eps_budget, warmup=config.warmup,
            on_publish=self._on_publish,
            checkpoint_dir=trainer_ckpt,
            crash_at_round=config.crash_at_round) if config.train else None
        self.batcher = Batcher(
            self.state, self.admission, self.stats_,
            max_batch=config.max_batch,
            max_wait_s=config.max_wait_ms / 1e3,
            max_age_s=config.max_age_s,
            exhausted=self.exhausted,
            train_round=lambda: (self.trainer.round if self.trainer else None))
        self._started = False

    # -- trainer-side hooks --------------------------------------------------

    def _on_publish(self, snapshot) -> None:
        if (self.checkpointer is not None
                and snapshot.version % self.config.checkpoint_every == 0):
            # the engine-agnostic serving state: theta at the published round
            self.checkpointer.save(snapshot.round, {"theta": snapshot.theta})

    def exhausted(self) -> bool:
        return self.trainer is not None and self.trainer.exhausted

    def eps_spent(self) -> float:
        if self.trainer is not None:
            return self.trainer.eps_spent
        snap = self.state.current
        return snap.eps_spent if snap is not None else 0.0

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServeService":
        if self._started:
            raise RuntimeError("service already started")
        self._started = True
        if self.device.type == "cuda":
            self._load_kernels()
        self.state.publish_initial()
        self.batcher.start()
        if self.trainer is not None:
            self.trainer.start()
        return self

    def _load_kernels(self) -> None:
        """Build and load the round kernels here, on the starting thread,
        when the spec's backend runs them: the trainer thread then finds
        them loaded."""
        from repro_torch.api.backends import CudaBackend
        from repro_torch.kernels import round_fused
        if isinstance(self.config.spec.resolve_backend(), CudaBackend):
            round_fused.library()

    def stop(self, timeout: float = 120.0) -> None:
        """Stop the trainer at its next chunk boundary, drain the queue,
        stop the batcher and flush pending checkpoints. A failure of the
        trainer or the batcher thread is raised here."""
        if self.trainer is not None:
            self.trainer.stop()
            self.trainer.join(timeout)
        self.batcher.stop()
        self.batcher.join(timeout)
        if self.batcher.is_alive():
            raise TimeoutError("batcher did not drain within timeout")
        if self.checkpointer is not None:
            self.checkpointer.close()
        if self.batcher.error is not None:
            raise RuntimeError("the serving batcher failed") \
                from self.batcher.error
        tel = obslib.active()
        if tel.enabled:
            # durable exit record: the full serving summary (served / shed
            # with reasons / refused / latencies) lands in the event stream
            # so `obs report` can render it after the service is gone
            tel.emit("serve_summary", **self.stats())

    # -- request path --------------------------------------------------------

    def submit(self, features, node: int,
               max_age_s: float | None = None) -> Request:
        """Non-blocking admission; the returned Request resolves to
        'ok' | 'shed' | 'refused' (wait()/done()). ``max_age_s`` overrides
        the service-wide deadline for this request."""
        req = Request(features=features, node=int(node), max_age_s=max_age_s)
        return self.admission.submit(req, refuse=self.exhausted())

    def predict(self, features, node: int,
                timeout: float | None = 30.0) -> Request:
        """Submit and wait — the synchronous convenience path."""
        return self.submit(features, node).wait(timeout)

    # -- introspection -------------------------------------------------------

    def verify(self, request: Request) -> bool:
        """Re-derive ``request``'s prediction from a fresh run at its
        recorded snapshot round; True iff bit-identical.

        Proves the publication contract end to end: the snapshot the
        response names is exactly `repro_torch.run(spec, horizon=round)`'s
        model, and the served margin and label are exactly what the predict
        step says on that model (the request alone in a padded batch).
        """
        if request.status != "ok":
            raise ValueError(f"cannot verify a {request.status!r} request")
        snap = self.state.snapshot(request.snapshot_version)
        if snap is None:
            return False        # pruned past keep_snapshots
        if not verify_snapshot(self.config.spec, self.config.engine, snap,
                               chunk_rounds=self.config.chunk_rounds):
            return False
        feats = np.zeros((self.config.max_batch, self.config.spec.dim),
                         np.float32)
        feats[0] = np.asarray(request.features, np.float32)
        nodes = np.zeros((self.config.max_batch,), np.int64)
        nodes[0] = request.node
        margins, labels = self.state.predict_fn(
            snap.w, snap.w_bar, torch.as_tensor(feats, device=self.device),
            torch.as_tensor(nodes, device=self.device))
        return (float(margins[0].item()) == request.margin
                and float(labels[0].item()) == request.label)

    def stats(self) -> dict:
        out = {"admission": self.stats_.summary()}
        snap = self.state.current
        out["serving"] = {
            "snapshot_round": None if snap is None else snap.round,
            "snapshot_version": None if snap is None else snap.version,
            "snapshots_published": self.state.published,
            "eps_spent": self.eps_spent(),
            "exhausted": self.exhausted(),
            "queue_depth": self.admission.qsize(),
        }
        if self.trainer is not None:
            out["trainer"] = {
                "round": self.trainer.round,
                "running": self.trainer.running,
                "composition": self.trainer.composition,
                "eps_budget": self.config.eps_budget,
                "restarts": self.trainer.restarts,
            }
        return out
