#!/usr/bin/env python3
"""Time ``hinge_grad`` of two checkouts of this repository on one card, in
turns.

    python3 tools/hinge_ab.py OTHER_ROOT

OTHER_ROOT is another checkout (for example ``git archive`` of an earlier
commit, unpacked). In turns OTHER, THIS, THIS, OTHER, a fresh process in
each checkout's root builds that checkout's kernels and times its
``hinge_grad`` at (1, 10,112) (the ops round's per-node launch),
(64, 10,112) (one ring round) and (128, 10,112) (the slab path's largest
batch) with that checkout's ``chip_smoke.py``
helpers: the device time per call (profiler, inputs rotated past the L2)
and the time per back-to-back wrapper call (host included). Prints each
run, then one JSON line with every sample and the card's name and power
limit. Needs one CUDA card and nvcc, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[1]
SHAPES = (1, 64, 128)     # batch sizes, at chip_smoke.N_PAD columns

CHILD = f"""
import functools, json, math, sys
sys.path.insert(0, "src")
sys.path.insert(0, ".")
import torch
import chip_smoke as c
c.card_check()
from repro_torch.kernels import build
from repro_torch.kernels import hinge_grad as hg
build.build(hg.SOURCE)
hg.library()
dev = torch.device("cuda")
res = {{}}
for B in {SHAPES!r}:
    n = c.N_PAD
    nbytes = c._work("hinge_grad", B, n)[0]
    sets = [c._hinge_inputs(B, n, seed=s, dev=dev) for s in
            range(max(10, math.ceil(3 * c.L2_BYTES / nbytes)))]
    fns = [functools.partial(hg.hinge_grad, *a) for a in sets]
    res[B] = dict(ms=c._device_ms(c._rotate(fns)),
                  call_ms=c._call_ms(c._rotate(fns)))
    del sets, fns
print("RESULT " + json.dumps(res))
"""


def run(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise SystemExit(f"hinge_ab: the run in {root} failed:\n"
                         f"{proc.stdout}\n{proc.stderr}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = Path(sys.argv[1]).resolve()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    samples = {"other": [], "this": []}
    for label, root in (("other", other), ("this", THIS), ("this", THIS),
                        ("other", other)):
        res = run(root)
        samples[label].append(res)
        print(f"{label} ({root}): " + "; ".join(
            f"B={B}: {r['ms'] * 1e3:.2f} us device, "
            f"{r['call_ms'] * 1e3:.2f} us per call" for B, r in res.items()),
            flush=True)
    print(smi)
    print(json.dumps({"card": smi, "other": str(other), "this": str(THIS),
                      "samples": samples}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
