#!/usr/bin/env python3
"""Time the main path's ``run`` of two checkouts of this repository on one
card, in turns.

    python3 tools/run_ab.py OTHER_ROOT

OTHER_ROOT is another checkout (for example ``git archive`` of an earlier
commit, unpacked). In turns OTHER, THIS, THIS, OTHER, a fresh process in
each checkout's root runs that checkout's ``chip_smoke.py`` main path
(``paper_spec()``: m = 64, n = 10,000, T = 1,562, ring, Laplace eps = 1,
the fused kernels; chunks of 256 rounds with regret, no warm-up round)
once to build and load the kernels, then REPS times: the round loop's
rounds/s (``RunResult.rounds_per_sec``) and the whole call's seconds.
Prints each run, then one JSON line with every sample and the card's name
and power limit. Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import sys

from hinge_ab import in_turns

REPS = 5

CHILD = f"""
import json, sys, time
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as c
c.card_check()
from repro_torch import ExecConfig, run
spec = c.paper_spec()
cfg = ExecConfig(chunk_rounds=256, compute_regret=True, warmup=False)
run(spec, exec=cfg, device="cuda")
res = {{"rounds_per_sec": [], "call_s": []}}
for _ in range({REPS}):
    t0 = time.perf_counter()
    out = run(spec, exec=cfg, device="cuda")
    res["call_s"].append(time.perf_counter() - t0)
    res["rounds_per_sec"].append(out.rounds_per_sec)
print("RESULT " + json.dumps(res))
"""


def _show(res: dict, what: str) -> str:
    return (f"rounds/s {[round(x, 1) for x in res['rounds_per_sec']]}, "
            f"run() s {[round(x, 3) for x in res['call_s']]}")


if __name__ == "__main__":
    sys.exit(in_turns(sys.argv, CHILD, what="run", doc=__doc__, show=_show))
