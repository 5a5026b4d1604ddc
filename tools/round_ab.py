#!/usr/bin/env python3
"""Time the round kernels of two checkouts of this repository on one card,
in turns.

    python3 tools/round_ab.py OTHER_ROOT

OTHER_ROOT is another checkout (for example ``git archive`` of an earlier
commit, unpacked). In turns OTHER, THIS, THIS, OTHER, a fresh process in
each checkout's root builds that checkout's ``round_fused.cu`` and times
its ``dual_step``, ``round_update`` on the sparse path (the ring's CSR
form) and on the dense path (a softmax A) at the main path's shape
(m = 64, n = 10,000) with that checkout's ``chip_smoke.py`` helpers: the
device time per call (profiler, inputs rotated past the L2) and the time
per back-to-back wrapper call (host included). Prints each run, then one
JSON line with every sample and the card's name and power limit. Needs one
CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import sys

from hinge_ab import in_turns

KERNELS = ("dual_step", "round_update", "round_update_dense")

CHILD = f"""
import json, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as c
c.card_check()
from repro_torch.kernels import build
from repro_torch.kernels import round_fused as rf
build.build(rf.SOURCE)
rf.library()
dev = torch.device("cuda")
sets = [c._inputs(c.MAIN_M, c.MAIN_N, seed=s, dev=dev) for s in range(10)]
res = {{}}
for name in {KERNELS!r}:
    fns = [c._calls(rf, d)[name][0] for d in sets]
    res[name] = dict(ms=c._device_ms(c._rotate(fns)),
                     call_ms=c._call_ms(c._rotate(fns)))
print("RESULT " + json.dumps(res))
"""

if __name__ == "__main__":
    sys.exit(in_turns(sys.argv, CHILD, what="kernel", doc=__doc__))
