"""The readings a cell's limits are set from, at the cell's own size:

    python3 perfbench/calibrate.py --workload <cell> --seed <base> \
        [--program 12] [--control 3] [--faults 3]

Each reading is the cell's checked work at one seed (base + i), judged
against the configuration's reference as a measuring run judges it: a
whole run for the linear cells, the first training steps for the LM
cells. ``--control`` seeds put the reference one precision lower in the
program's place; ``--faults`` seeds plant each of the cell's faults of
`perfbench.breakers` underneath the program. Prints one JSON line a
reading, then for each number the largest reading of the sound runs and
the smallest of the control and of each fault. Not part of a measuring
run.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--program", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from perfbench import breakers, harness
    harness.cache_env()
    files = harness.cell_files(harness.load_manifest(), args.workload)
    workload = files["workload"]
    driver = harness.load_module(
        harness.HERE / "drivers" / f"{workload['driver']}.py",
        f"perfbench_driver_{workload['driver']}")
    plan = ([("program", i) for i in range(args.program)]
            + [("control", 100 + i) for i in range(args.control)]
            + [(f, 200 + i) for f in driver.faults(workload["params"])
               for i in range(args.faults)])
    readings = {}
    for kind, i in plan:
        seed = args.seed + i
        box, _, _ = harness.make_cell(args.workload, seed, False,
                                      device=args.device,
                                      control=kind == "control")
        planted = (breakers.fault(kind) if kind in breakers.FAULTS
                   else contextlib.nullcontext())
        t = time.perf_counter()
        with planted:
            box.setup()
            nums = box.calibration_reading()
        wall = time.perf_counter() - t
        del box
        readings.setdefault(kind, []).append(nums)
        print(json.dumps({"kind": kind, "seed": seed, "wall_s": wall,
                          **nums}), flush=True)
    summary = {}
    for kind, rows in readings.items():
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
