"""repro_torch.sweep — batched experiment orchestration.

Counterpart of `repro.sweep`. The paper's §V evidence is sweep-shaped
(accuracy/regret vs eps, sparsity, node count, topology); this subsystem
makes a sweep a declarative object instead of a hand-rolled loop:

  `SweepSpec`   — named axes over any `RunSpec` field (grid, or comma-zipped
                  fields) plus a batched ``seeds`` axis.
  `sweep()`     — runs every point; the seed axis goes through
                  `repro_torch.api.run_batch` (the seeds in step: on the
                  cuda backend one launch of each round kernel a round for
                  all of them) with a sequential fallback when a stage
                  resolves seed-dependently.
  `SweepStore`  — persistent JSONL records under experiments/store/
                  (resolved spec, seed, trajectories, eps ledger,
                  wall-clock, git SHA) with load/query/aggregate helpers,
                  so figures regenerate without re-running (``reuse=True``).

>>> from repro_torch.sweep import SweepSpec, SweepResult, sweep, SweepStore
>>> from repro_torch.api import RunSpec
>>> spec = SweepSpec(base=RunSpec(nodes=2, dim=8, horizon=4, eps=1.0),
...                  axes={"eps": (0.1, 1.0)}, seeds=(0, 1, 2))
>>> len(spec.points()), spec.store_name
(2, 'sweep_eps')
"""
from repro_torch.sweep.spec import SweepPoint, SweepSpec
from repro_torch.sweep.store import (DEFAULT_STORE, SweepStore, aggregate_records,
                               git_sha, record_key, result_from_record,
                               spec_from_record, spec_record)
from repro_torch.sweep.engine import SweepResult, SweepStoreMiss, sweep

__all__ = [
    "SweepSpec", "SweepPoint", "SweepResult", "SweepStoreMiss", "sweep",
    "SweepStore", "DEFAULT_STORE", "aggregate_records", "git_sha",
    "record_key", "result_from_record", "spec_record", "spec_from_record",
]
