"""Degradation metrics — how much did the faults actually cost?

Counterpart of `repro.faults.metrics` (numpy, the same functions).
`degradation` compares a faulty `RunResult` against its clean twin (same
RunSpec minus the faults) and reports the regret / loss / accuracy gaps
plus the connectivity profile the faulty run recorded.
`rounds_to_recover` measures healing after a transient partition: how many
rounds past the heal point until the faulty trajectory re-enters (and
stays within) a tolerance band around the clean one.

>>> from repro_torch.faults.metrics import rounds_to_recover
>>> rounds_to_recover([0., 0., 0., 0.], [1., 1., 0., 0.], heal_round=1)
1
>>> rounds_to_recover([0., 0., 0.], [1., 1., 1.], heal_round=0)
-1
"""
from __future__ import annotations

import numpy as np

__all__ = ["degradation", "rounds_to_recover"]


def degradation(clean, faulty) -> dict:
    """Clean-vs-faulty gap metrics from two `RunResult`s (same spec shape).

    Keys: ``regret_gap`` (final faulty - clean regret, None when either run
    skipped regret), ``loss_gap`` (mean per-round loss delta),
    ``accuracy_drop``, and ``mean_connectivity`` / ``min_connectivity``
    from the faulty run's per-round connectivity trace (None when the run
    carried no fault schedule).
    """
    out = {
        "loss_gap": float(np.mean(faulty.loss) - np.mean(clean.loss)),
        "accuracy_drop": float(clean.accuracy - faulty.accuracy),
        "regret_gap": None,
        "mean_connectivity": None,
        "min_connectivity": None,
    }
    if clean.regret is not None and faulty.regret is not None:
        out["regret_gap"] = float(faulty.regret[-1] - clean.regret[-1])
    conn = getattr(faulty, "connectivity", None)
    if conn is not None and np.asarray(conn).size:
        conn = np.asarray(conn, np.float64)
        out["mean_connectivity"] = float(conn.mean())
        out["min_connectivity"] = float(conn.min())
    return out


def rounds_to_recover(clean_curve, faulty_curve, heal_round: int,
                      tol: float = 1e-3, window: int = 4) -> int:
    """Rounds after ``heal_round`` until ``|faulty - clean| <= tol`` holds
    for ``window`` consecutive rounds (-1 if the curves never re-join).

    Feed it per-round trajectories of the same metric — ``w_bar_loss`` is
    the natural choice since it tracks the consensus iterate the partition
    disturbs.
    """
    a = np.asarray(clean_curve, np.float64).ravel()
    b = np.asarray(faulty_curve, np.float64).ravel()
    if a.shape != b.shape:
        raise ValueError(f"curve lengths differ: {a.shape} vs {b.shape}")
    diff = np.abs(a - b)
    for t in range(max(int(heal_round), 0), diff.size):
        if (diff[t:min(t + int(window), diff.size)] <= tol).all():
            return t - int(heal_round)
    return -1
