"""repro_torch.serve — online prediction while the model keeps learning.

Counterpart of `repro.serve`. The paper's premise is serving social
predictions to millions of users from distributed data centers while the
model trains online under differential privacy; this subsystem closes that
loop on top of `repro_torch.api`, on the card unless the caller asks for
the CPU:

  `ServeState`     — published model snapshots + the batched predict step
                     (per-node ``w`` or the running average ``w_bar``).
  `BackgroundTrainer` — continuous gossip/update rounds in fixed chunks
                     (the runner's ``on_chunk`` hook), each chunk boundary
                     publishing a fresh snapshot; serving-side eps ledger
                     with an optional budget that, once spent, refuses
                     further requests.
  `AdmissionQueue`/`Batcher` — bounded queue, max-batch/max-wait batching,
                     load shedding with counters.
  `BurstyReplay`   — heavy-tailed request arrivals derived from the
                     `bursty` stream's seeded Pareto burst process.
  `ServeService`   — the assembled service (plus threaded checkpointing of
                     the serving state via `repro_torch.checkpoint`).

>>> from repro_torch.serve import ServeConfig, ServeService
>>> from repro_torch.api import RunSpec
>>> spec = RunSpec(nodes=2, dim=4, horizon=8, eps=1.0, alpha0=0.5, lam=0.01,
...                stream="bursty")
>>> svc = ServeService(ServeConfig(spec=spec, train=False, warmup=False,
...                                max_wait_ms=0.5, device="cpu")).start()
>>> svc.predict([0.5] * 4, node=1).status
'ok'
>>> svc.stop()
"""
from repro_torch.serve.admission import (AdmissionQueue, Batcher, Request,
                                         ServeStats)
from repro_torch.serve.replay import BurstyReplay
from repro_torch.serve.service import ServeConfig, ServeService
from repro_torch.serve.state import (ServeState, Snapshot, make_predict_fn,
                                     snapshot_from_state, verify_snapshot)
from repro_torch.serve.trainer import BackgroundTrainer, TrainerCrash

__all__ = [
    "AdmissionQueue", "Batcher", "Request", "ServeStats",
    "BurstyReplay",
    "ServeConfig", "ServeService",
    "ServeState", "Snapshot", "make_predict_fn", "snapshot_from_state",
    "verify_snapshot",
    "BackgroundTrainer", "TrainerCrash",
]
