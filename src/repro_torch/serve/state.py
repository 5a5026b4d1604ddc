"""Published model snapshots and the batched predict step.

Counterpart of `repro.serve.state`. The serving layer never reads the
trainer's live engine state: the trainer PUBLISHES immutable
:class:`Snapshot` objects (per-node primal models ``w``, the running
average ``w_bar``, the round they were trained to and the eps spent
releasing them) into a :class:`ServeState`, and every prediction is served
against exactly one published snapshot — a reference swap under a lock, so
a request never observes half of round t and half of round t+k.

A snapshot's tensors stay on the device the trainer runs on. No later
round writes them: each round of either backend allocates its next theta
(only the delay ring is written in place, and a snapshot holds none of
it), and the primal recovery allocates ``w``.

A snapshot at round r is bit-identical to ``repro_torch.run(spec,
horizon=r)``'s final state (streams are keyed per absolute round and
chunking never changes a round's math), which `verify_snapshot` checks.

>>> import torch
>>> from repro_torch.api import RunSpec
>>> from repro_torch.serve.state import ServeState
>>> spec = RunSpec(nodes=2, dim=4, horizon=8, eps=1.0, alpha0=0.5, lam=0.01)
>>> state = ServeState(spec, device="cpu")
>>> snap = state.publish_initial()        # round-0 model: w == 0
>>> snap.round, snap.version, snap.eps_spent
(0, 0, 0.0)
>>> margins, labels, used = state.predict(torch.ones((3, 4)), [0, 1, 0])
>>> margins.tolist(), labels.tolist(), used.version
([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], 0)
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable

import torch

from repro_torch.api.spec import RunSpec
from repro_torch.device import resolve_device

__all__ = ["Snapshot", "ServeState", "make_predict_fn", "snapshot_from_state",
           "verify_snapshot"]


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One immutable published model: what a prediction is served against.

    version:   monotone publication counter (0 = the initial round-0 model).
    round:     absolute training round the snapshot was taken at.
    theta:     (m, n) dual parameters at ``round`` (kept for audit/resume).
    w:         (m, n) per-node primal models (local rule's Lasso prox).
    w_bar:     (n,) running-average model (Definition-3's comparator view).
    eps_spent: cumulative privacy guarantee charged for releasing this
               snapshot (see `repro_torch.serve.trainer` for the
               composition policy).
    """

    version: int
    round: int
    theta: torch.Tensor
    w: torch.Tensor
    w_bar: torch.Tensor
    eps_spent: float


def snapshot_from_state(spec: RunSpec, engine: str, state, *, version: int,
                        eps_spent: float) -> Snapshot:
    """Snapshot of one engine state — the primal recovery of the runner's
    ``RunResult.final_w`` (`repro_torch.api.runner._final_primal`), so a
    published snapshot and a run to the same round agree to the bit."""
    rule = spec.resolve_local_rule()
    ctx = spec.omd_config().step_context(state.t)
    theta = state.theta if engine == "sim" else state.theta["w"]
    w = rule.primal(theta, ctx)
    return Snapshot(version=version, round=int(state.t), theta=theta, w=w,
                    w_bar=torch.mean(w, dim=0), eps_spent=float(eps_spent))


def make_predict_fn(mode: str = "node") -> Callable:
    """The batched predict step: (w, w_bar, features, node_ids) -> (margins,
    labels) for a (B, n) feature batch, on the batch's device.

    mode='node' serves each request against its data center's own model
    row ``w[node]``; mode='average' serves everyone the consensus ``w_bar``.
    Labels follow the stream convention: +1 iff margin >= 0. A row gather
    and a row-wise dot product, as torch ops (the reference's is plain XLA,
    no Pallas kernel).
    """
    if mode == "node":
        def predict(w, w_bar, features, node_ids):
            rows = torch.index_select(w, 0, node_ids)          # (B, n)
            margins = torch.sum(rows * features, dim=-1)
            return margins, torch.where(margins >= 0, 1.0, -1.0)
    elif mode == "average":
        def predict(w, w_bar, features, node_ids):
            margins = torch.sum(w_bar[None, :] * features, dim=-1)
            return margins, torch.where(margins >= 0, 1.0, -1.0)
    else:
        raise ValueError(f"unknown predict mode {mode!r}; "
                         "expected 'node' or 'average'")
    return predict


class ServeState:
    """Current snapshot + a bounded history ring of recent publications.

    ``publish`` swaps the current-snapshot reference under a lock (readers
    see the old model or the new one, never a mix); the last ``keep``
    snapshots stay reachable by version so a response recorded against
    version v can be re-verified after later publications, each with the
    perf_counter time it was published (`published_at`). ``device`` is
    where the models live and predictions run: CUDA unless the caller asks
    for the CPU.
    """

    def __init__(self, spec: RunSpec, engine: str = "sim",
                 mode: str = "node", keep: int = 8,
                 device: str | torch.device = "cuda"):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.spec = spec
        self.engine = engine
        self.mode = mode
        self.keep = keep
        self.device = resolve_device(device)
        self.predict_fn = make_predict_fn(mode)
        self._lock = threading.Lock()
        self._current: Snapshot | None = None
        self._history: collections.OrderedDict[int, Snapshot] = \
            collections.OrderedDict()
        self._published_at: dict[int, float] = {}
        self._published = 0

    # -- publication ---------------------------------------------------------

    def publish(self, snapshot: Snapshot) -> None:
        with self._lock:
            self._current = snapshot
            self._history[snapshot.version] = snapshot
            self._published_at[snapshot.version] = time.perf_counter()
            while len(self._history) > self.keep:
                version, _ = self._history.popitem(last=False)
                self._published_at.pop(version, None)
            self._published += 1

    def publish_initial(self) -> Snapshot:
        """Publish the round-0 model (w = 0, eps 0) so the service answers
        from the first request, before the trainer's first chunk lands."""
        from repro_torch.api.program import reference_round_program
        init_fn = reference_round_program(self.spec, self.engine,
                                          self.device)[1]
        snap = snapshot_from_state(self.spec, self.engine,
                                   init_fn(self.spec.seed), version=0,
                                   eps_spent=0.0)
        self.publish(snap)
        return snap

    # -- reads ---------------------------------------------------------------

    @property
    def current(self) -> Snapshot | None:
        with self._lock:
            return self._current

    @property
    def published(self) -> int:
        with self._lock:
            return self._published

    def snapshot(self, version: int) -> Snapshot | None:
        """A recent snapshot by version (None once pruned past ``keep``)."""
        with self._lock:
            return self._history.get(version)

    def published_at(self, version: int) -> float | None:
        """perf_counter time a recent snapshot was published (None once
        pruned past ``keep``)."""
        with self._lock:
            return self._published_at.get(version)

    def predict(self, features, node_ids):
        """(margins, labels, snapshot) for one feature batch against the
        CURRENT snapshot — one snapshot read per batch. The outputs stay on
        the device, their work queued; the caller reads them."""
        snap = self.current
        if snap is None:
            raise RuntimeError("no snapshot published yet — call "
                               "publish_initial() (ServeService.start does)")
        feats = torch.as_tensor(features, dtype=torch.float32,
                                device=self.device)
        nodes = torch.as_tensor(node_ids, dtype=torch.int64,
                                device=self.device)
        margins, labels = self.predict_fn(snap.w, snap.w_bar, feats, nodes)
        return margins, labels, snap


def verify_snapshot(spec: RunSpec, engine: str, snapshot: Snapshot, *,
                    chunk_rounds: int = 128,
                    node_devices: int | str | None = None,
                    atol: float = 0.0) -> bool:
    """True iff ``snapshot`` is bit-identical to a fresh run to its round.

    Re-runs ``repro_torch.run(spec, horizon=snapshot.round)`` from scratch
    (any chunking — a round's math does not depend on it) on the
    snapshot's device and compares the recovered primal models bit for
    bit: a served prediction is exactly what the model at the recorded
    round says. ``atol`` > 0 bounds the difference instead.

    A NODE-SHARDED trainer (``run(..., exec=ExecConfig(node_devices=D))``,
    see `repro_torch.api.shard_node`) is verified by replaying under the
    same ``node_devices`` (D shards of the snapshot's device type): the
    sharded program is deterministic, so the replay is bit for bit.
    Across layouts (a sharded snapshot against an unsharded replay, or the
    other way) only float32 reduction order differs; pass ``atol``.
    """
    from repro_torch.api.exec_config import ExecConfig
    from repro_torch.api.runner import run
    if snapshot.round == 0:
        return bool(torch.all(torch.as_tensor(snapshot.w) == 0.0))
    ref = run(spec, engine=engine, horizon=snapshot.round,
              device=torch.as_tensor(snapshot.w).device,
              exec=ExecConfig(chunk_rounds=chunk_rounds,
                              compute_regret=False, warmup=False,
                              node_devices=node_devices))
    ref_snap = snapshot_from_state(spec, engine, ref.final_state,
                                   version=-1, eps_spent=0.0)
    pairs = [(torch.as_tensor(snapshot.w).cpu(), ref_snap.w.cpu()),
             (torch.as_tensor(snapshot.w_bar).cpu(), ref_snap.w_bar.cpu())]
    if atol:
        return all(bool((a - b).abs().max() <= atol) for a, b in pairs)
    return all(torch.equal(a, b) for a, b in pairs)
