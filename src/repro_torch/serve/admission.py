"""Admission control: bounded queue, max-batch/max-wait batcher, shedding.

Counterpart of `repro.serve.admission`. The front door of the serving
layer. Requests enter a BOUNDED queue — a full queue sheds the request
immediately (counted, never silently dropped) instead of letting latency
grow without bound under a burst. A batcher thread drains the queue into
fixed-size batches: it waits at most ``max_wait_s`` after the first
request of a batch (latency bound) and never packs more than ``max_batch``
(compute bound), then pads the batch to exactly ``max_batch`` rows, so the
predict step always sees one shape and a re-run of a served batch reduces
in the same order.

Requests are also REFUSED (distinct from shed) when the privacy ledger is
exhausted — `repro_torch.serve.trainer` flips the shared flag once the eps
budget is spent, and from that point the service returns
``status='refused'`` rather than serving a model whose release the budget
no longer covers.

>>> from repro_torch.serve.admission import Request, ServeStats
>>> stats = ServeStats()
>>> stats.shed_total, stats.served_total
(0, 0)
>>> r = Request(features=[1.0, 0.0], node=0)
>>> r.status, r.done()
('pending', False)
"""
from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs as obslib
from repro_torch.serve.state import ServeState

__all__ = ["Request", "ServeStats", "AdmissionQueue", "Batcher"]


@dataclasses.dataclass
class Request:
    """One prediction request and, once fulfilled, its response.

    status: 'pending' -> 'ok' | 'shed' (queue full, or deadline expired) |
    'refused' (eps spent). A shed request says WHY in ``shed_reason``:
    'full' (no queue room at submit) vs 'timeout' (sat in the queue past its
    ``max_age_s`` deadline — the degraded-fabric signature, where a crashed
    trainer or a compute stall ages the queue instead of overflowing it).
    Timing: ``submitted_at``/``completed_at`` are perf_counter stamps; a
    served request's completion is stamped after its batch's margins and
    labels reached the host, so ``latency_s`` measures admission wait +
    batching wait + compute on the card — not the launch alone.

    Freshness: ``staleness_rounds`` is the reference's publication lag
    (the trainer's last published round less the served snapshot's), and
    stays 0 while the trainer publishes nothing; ``snapshot_age_s`` is the
    time from the served snapshot's publication to the answer, and grows
    while the trainer stalls.
    """

    features: Any
    node: int
    max_age_s: float | None = None       # per-request deadline override
    shed_reason: str | None = None       # 'full' | 'timeout' once shed
    status: str = "pending"
    margin: float | None = None
    label: float | None = None
    snapshot_version: int | None = None
    snapshot_round: int | None = None
    train_round: int | None = None       # trainer progress at completion
    snapshot_age_s: float | None = None  # publication -> answer, seconds
    eps_spent: float | None = None
    submitted_at: float | None = None
    completed_at: float | None = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> "Request":
        if not self._event.wait(timeout):
            raise TimeoutError(f"request not served within {timeout}s")
        return self

    @property
    def latency_s(self) -> float | None:
        if self.completed_at is None or self.submitted_at is None:
            return None
        return self.completed_at - self.submitted_at

    @property
    def staleness_rounds(self) -> int | None:
        """How many rounds the served snapshot lagged the trainer."""
        if self.train_round is None or self.snapshot_round is None:
            return None
        return self.train_round - self.snapshot_round

    def _finish(self, status: str, reason: str | None = None,
                at: float | None = None) -> None:
        self.status = status
        if reason is not None:
            self.shed_reason = reason
        self.completed_at = time.perf_counter() if at is None else at
        self._event.set()


class ServeStats:
    """Thread-safe serving counters + latency/staleness/age samples."""

    def __init__(self, max_samples: int = 200_000):
        self._lock = threading.Lock()
        self.max_samples = max_samples
        self.served_total = 0
        self.shed_total = 0
        self.shed_reasons: dict[str, int] = {}
        self.refused_total = 0
        self.batches_total = 0
        self.latencies_s: list[float] = []
        self.staleness: list[int] = []
        self.snapshot_ages_s: list[float] = []

    def record_served(self, requests: list[Request]) -> None:
        with self._lock:
            self.served_total += len(requests)
            self.batches_total += 1
            room = self.max_samples - len(self.latencies_s)
            for r in requests[:max(room, 0)]:
                if r.latency_s is not None:
                    self.latencies_s.append(r.latency_s)
                if r.staleness_rounds is not None:
                    self.staleness.append(r.staleness_rounds)
                if r.snapshot_age_s is not None:
                    self.snapshot_ages_s.append(r.snapshot_age_s)
        # mirror into the ambient obs registry (repro_torch.obs) — a no-op
        # unless telemetry is enabled, so the serving hot path stays one check
        tel = obslib.active()
        if tel.enabled:
            tel.metrics.counter("serve.served").inc(len(requests))
            tel.metrics.counter("serve.batches").inc()
            hist = tel.metrics.histogram("serve.latency_s")
            for r in requests:
                if r.latency_s is not None:
                    hist.observe(r.latency_s)

    def record_shed(self, n: int = 1, reason: str | None = None) -> None:
        with self._lock:
            self.shed_total += n
            if reason is not None:
                self.shed_reasons[reason] = (self.shed_reasons.get(reason, 0)
                                             + n)
        tel = obslib.active()
        if tel.enabled:
            name = f"serve.shed.{reason}" if reason else "serve.shed"
            tel.metrics.counter(name).inc(n)

    def record_refused(self, n: int = 1) -> None:
        with self._lock:
            self.refused_total += n
        tel = obslib.active()
        if tel.enabled:
            tel.metrics.counter("serve.refused").inc(n)

    def summary(self) -> dict:
        with self._lock:
            lat = np.asarray(self.latencies_s, np.float64)
            stale = np.asarray(self.staleness, np.float64)
            out = {
                "served": self.served_total,
                "shed": self.shed_total,
                "shed_reasons": dict(self.shed_reasons),
                "refused": self.refused_total,
                "batches": self.batches_total,
                "mean_batch": (self.served_total / self.batches_total
                               if self.batches_total else None),
            }
        out["p50_latency_ms"] = (round(float(np.percentile(lat, 50)) * 1e3, 3)
                                 if lat.size else None)
        out["p99_latency_ms"] = (round(float(np.percentile(lat, 99)) * 1e3, 3)
                                 if lat.size else None)
        out["staleness_mean_rounds"] = (round(float(stale.mean()), 2)
                                        if stale.size else None)
        out["staleness_max_rounds"] = (int(stale.max()) if stale.size
                                       else None)
        return out

    def snapshot_age_ms(self) -> dict:
        """Mean and max age of the served snapshots at answer time, in ms
        (kept out of `summary`, whose keys are the reference's)."""
        with self._lock:
            age = np.asarray(self.snapshot_ages_s, np.float64) * 1e3
        return {"mean": round(float(age.mean()), 3) if age.size else None,
                "max": round(float(age.max()), 3) if age.size else None}


class AdmissionQueue:
    """Bounded FIFO with shed-on-full and refuse-on-exhaustion semantics."""

    def __init__(self, capacity: int, stats: ServeStats):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._q: queue.Queue[Request] = queue.Queue(maxsize=capacity)
        self.capacity = capacity
        self.stats = stats

    def submit(self, request: Request, *, refuse: bool = False) -> Request:
        request.submitted_at = time.perf_counter()
        if refuse:
            self.stats.record_refused()
            request._finish("refused")
            return request
        try:
            self._q.put_nowait(request)
        except queue.Full:
            self.stats.record_shed(reason="full")
            request._finish("shed", reason="full")
        return request

    def get(self, timeout: float) -> Request | None:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def empty(self) -> bool:
        return self._q.empty()

    def qsize(self) -> int:
        return self._q.qsize()


class Batcher(threading.Thread):
    """Drains the admission queue into padded fixed-shape predict batches.

    One batch = the first waiting request plus whatever else arrives within
    ``max_wait_s`` of it (up to ``max_batch``). Features are packed, in
    numpy, into one (max_batch, n) host buffer — rows beyond the real batch
    are zero — that goes to the device with the node ids in ONE copy (the
    buffer is pinned when the device is a card), so the predict step sees
    one shape for the whole lifetime of the service. The batch's margins
    and labels come back to the host before any request of it is stamped
    done.

    ``max_age_s`` is the request DEADLINE: a request dequeued more than
    ``max_age_s`` (or its own ``Request.max_age_s``) after submission is
    shed with reason 'timeout' instead of served — a stale prediction to a
    client that already gave up wastes a predict-batch slot. None (default)
    never expires.
    """

    def __init__(self, state: ServeState, admission: AdmissionQueue,
                 stats: ServeStats, *, max_batch: int = 32,
                 max_wait_s: float = 0.002, max_age_s: float | None = None,
                 exhausted=None, train_round=None, poll_s: float = 0.05):
        super().__init__(daemon=True, name="repro-torch-serve-batcher")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if max_age_s is not None and max_age_s < 0:
            raise ValueError("max_age_s must be >= 0 (None disables)")
        self.state = state
        self.admission = admission
        self.stats = stats
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_age_s = max_age_s
        self.poll_s = poll_s
        self._exhausted = exhausted or (lambda: False)
        self._train_round = train_round or (lambda: None)
        self._stopping = threading.Event()
        self._dim = state.spec.dim
        self.error: BaseException | None = None
        # one host buffer for every batch: the (max_batch, n) float32
        # features, then the (max_batch,) int64 node ids at an 8-byte
        # aligned offset, so one copy moves both
        self._feat_bytes = -(-max_batch * self._dim * 4 // 8) * 8
        self._host = torch.zeros(
            self._feat_bytes + 8 * max_batch, dtype=torch.uint8,
            pin_memory=state.device.type == "cuda")

    def stop(self) -> None:
        self._stopping.set()

    def _admit(self, request: Request) -> bool:
        """False (and shed with reason 'timeout') iff the request's deadline
        passed while it waited in the queue."""
        limit = (request.max_age_s if request.max_age_s is not None
                 else self.max_age_s)
        if (limit is not None and request.submitted_at is not None
                and time.perf_counter() - request.submitted_at > limit):
            self.stats.record_shed(reason="timeout")
            request._finish("shed", reason="timeout")
            return False
        return True

    def run(self) -> None:
        dev = self.state.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            try:
                self._loop()
            except Exception as err:        # surfaced by ServeService.stop
                self.error = err
                raise

    def _loop(self) -> None:
        while True:
            first = self.admission.get(timeout=self.poll_s)
            if first is None:
                if self._stopping.is_set() and self.admission.empty():
                    return
                continue
            if not self._admit(first):
                continue
            batch = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                nxt = self.admission.get(timeout=remaining)
                if nxt is None:
                    break
                if self._admit(nxt):
                    batch.append(nxt)
            self._serve(batch)

    def pack(self, batch: list[Request]) -> tuple[torch.Tensor, torch.Tensor]:
        """(features, node_ids) of a batch, padded to ``max_batch`` rows with
        zeros, on the state's device: packed in numpy into the host buffer,
        then one copy."""
        B, n, k = self.max_batch, self._dim, len(batch)
        host = self._host.numpy()
        feats = host[:self._feat_bytes].view(np.float32)[:B * n].reshape(B, n)
        nodes = host[self._feat_bytes:].view(np.int64)
        # one numpy copy for the batch, not one a row: each call may drop
        # the interpreter lock, and the trainer and clients wait on it
        np.stack([np.asarray(r.features, np.float32) for r in batch],
                 out=feats[:k])
        nodes[:k] = [r.node for r in batch]
        feats[k:] = 0.0
        nodes[k:] = 0
        dev = self.state.device
        buf = (self._host.to(dev, non_blocking=True) if dev.type == "cuda"
               else self._host)
        return (buf[:self._feat_bytes].view(torch.float32)[:B * n].view(B, n),
                buf[self._feat_bytes:].view(torch.int64))

    def _serve(self, batch: list[Request]) -> None:
        if self._exhausted():
            # the budget ran out while these sat in the queue: refuse late
            # rather than serve a release the ledger no longer covers
            self.stats.record_refused(len(batch))
            for r in batch:
                r._finish("refused")
            return
        with obslib.active().span("serve.batch", size=len(batch)):
            feats, nodes = self.pack(batch)
            margins, labels, snap = self.state.predict(feats, nodes)
            # latency must cover the card's work, not the launch: bring the
            # outputs to the host before stamping completion times
            margins = margins.cpu().numpy()
            labels = labels.cpu().numpy()
        done_at = time.perf_counter()
        train_round = self._train_round()
        published_at = self.state.published_at(snap.version)
        for i, r in enumerate(batch):
            r.margin = float(margins[i])
            r.label = float(labels[i])
            r.snapshot_version = snap.version
            r.snapshot_round = snap.round
            r.train_round = (train_round if train_round is not None
                             else snap.round)
            r.snapshot_age_s = (done_at - published_at
                                if published_at is not None else None)
            r.eps_spent = snap.eps_spent
            r._finish("ok", at=done_at)
        self.stats.record_served(batch)
