"""The comparison that decides ``correct`` fails what it must.

A toy size on the CPU, the harness's look for a card skipped and the rest
of a run driven as a measuring run drives it: with the configuration's
reference in bfloat16 put in the program's place (the control), and with
each fault of `perfbench.breakers` planted underneath the timed path,
``correct`` comes out false. The same readings at the cells' own size come
from ``perfbench/calibrate.py`` on the chip."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import breakers, harness  # noqa: E402
from toy_sizes import toy as toy_of  # noqa: E402

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]


def toy(cell):
    return toy_of(harness, cell)


def driver_faults(cell):
    wl = harness.cell_files(harness.load_manifest(), cell)["workload"]
    mod = harness.load_module(harness.HERE / "drivers"
                              / f"{wl['driver']}.py",
                              f"perfbench_driver_{wl['driver']}")
    return mod.faults(wl["params"])


PAIRS = [(c, f) for c in CELLS for f in driver_faults(c)]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(cell):
    out = harness.run_cell(cell, 31, 0.2, False, device="cpu",
                           overrides=toy(cell))
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    out = harness.run_cell(cell, 32, 0.2, False, device="cpu",
                           overrides=toy(cell), control=True)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell,fault", PAIRS)
def test_each_fault_underneath_is_not_correct(cell, fault):
    with breakers.fault(fault):
        out = harness.run_cell(cell, 33, 0.2, False, device="cpu",
                               overrides=toy(cell))
    assert out["correct"] is False, out["checks"]


# the faulty DCN of the paper's title, as a linear cell's traffic data alone
DCN = {"workload": {"params": {"faults": {
    "name": "dcn", "link_rate": 0.02, "crash_rate": 0.05, "crash_rounds": 8,
    "straggler_rate": 0.1, "straggler_delay": 1}},
    "limits": {"connectivity_max_gap": 0.0}}}


@pytest.mark.parametrize("control", [False, True])
def test_faulty_dcn_traffic_is_judged_like_the_clean_ring(control):
    over = harness.merge(toy("ring_online"), DCN)
    out = harness.run_cell("ring_online", 34, 0.2, False, device="cpu",
                           overrides=over, control=control)
    assert "connectivity_max_gap" in out["checks"]
    assert out["correct"] is (not control), out["checks"]
