#!/usr/bin/env python3
"""Time qwen2-7b's greedy decode and prefill of two checkouts of this
repository on one card, in turns.

    python3 tools/decode_ab.py OTHER_ROOT

OTHER_ROOT is another checkout (for example ``git archive`` of an earlier
commit, unpacked). In turns OTHER, THIS, THIS, OTHER, a fresh process in
each checkout's root runs that checkout's ``chip_smoke.py`` card check
(and with it whatever process settings the checkout makes there) and
builds qwen2-7b at its published config (bf16, random weights, seed 0);
then REPS times: 64 tokens of ``decode_step`` at B = 1 (launch-bound: the
host's issue rate sets it) and one prefill through ``apply(last_only=
True)`` at B = 1, T = 2,048, each between two synchronisations. Prints
each run, then one JSON line with every sample and the card's name and
power limit. Needs one CUDA card, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import sys

from hinge_ab import in_turns

REPS = 3

CHILD = f"""
import json, sys, time
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as c
c.card_check()
import torch
from repro_torch.device import synchronize
from repro_torch.models import build_model
dev = torch.device("cuda")
cfg = c._lm_config(c.QWEN)
model = build_model(cfg, "cuda")
params = model.init(0)
gen = torch.Generator(device=dev)
gen.manual_seed(0)
short = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen, device=dev)
long = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device=dev)
res = {{"decode_tokens_per_s": [], "prefill_ms": []}}
with torch.inference_mode():
    c._decode_all(model, params, short[:, :2])
    model.apply(params, long, last_only=True)
    for _ in range({REPS}):
        synchronize(dev)
        t0 = time.perf_counter()
        c._decode_all(model, params, short)
        synchronize(dev)
        res["decode_tokens_per_s"].append(64 / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        model.apply(params, long, last_only=True)
        synchronize(dev)
        res["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
print("RESULT " + json.dumps(res))
"""


def _show(res: dict, what: str) -> str:
    return (f"decode tokens/s "
            f"{[round(x, 1) for x in res['decode_tokens_per_s']]}, "
            f"prefill T=2,048 ms {[round(x, 1) for x in res['prefill_ms']]}")


if __name__ == "__main__":
    sys.exit(in_turns(sys.argv, CHILD, what="decode", doc=__doc__,
                      show=_show))
