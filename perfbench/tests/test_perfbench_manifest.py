"""``BENCHMARK.json`` and the harness that it drives, on the CPU.

The manifest's names, units and keys; every cell's and metric's files; a
cell added by files and entries alone; each cell's result line at a toy
size through the plain path; and a measuring run that finds no card."""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402
from toy_sizes import toy  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]


def e2e_of(cell):
    return {m["name"] for m in MANIFEST["end_to_end"]
            if cell in m.get("workloads", CELLS)}


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert MANIFEST["paths"] == ["perfbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_only_the_allowed_characters():
    entries = (MANIFEST["configs"] + MANIFEST["workloads"]
               + MANIFEST["end_to_end"] + MANIFEST["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in MANIFEST["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[section]]
        assert len(names) == len(set(names))


def test_entries_have_just_the_contract_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert "setup_s" in {m["name"] for m in MANIFEST["end_to_end"]}


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    for m in MANIFEST["per_layer"]:
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert m["moves"] in e2e_of(cell), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        assert "setup_s" in e2e_of(cell) and len(e2e_of(cell)) >= 2
        assert any(cell in m["workloads"] for m in MANIFEST["per_layer"])


def test_every_name_has_its_files():
    for c in MANIFEST["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/configs/")
        assert (BENCH / "reference" / f"{c['name']}.py").is_file()
    for cell in CELLS:
        files = harness.cell_files(MANIFEST, cell)
        assert (BENCH / "drivers"
                / f"{files['workload']['driver']}.py").is_file()
    for m in MANIFEST["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_file_names_do_not_collide_with_the_repo_tests():
    ours = {p.name for p in (BENCH / "tests").iterdir()}
    theirs = {p.name for p in (ROOT / "tests").iterdir()}
    assert not (ours - {"__pycache__"}) & theirs


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_prints_its_result_line_at_a_toy_size(cell, trace,
                                                        capsys):
    out = harness.run_cell(cell, 2**31 + 17, 0.2, trace, device="cpu",
                           overrides=toy(harness, cell))
    harness.emit(out)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    extra = ["breakdown", "checks"] if trace else ["checks"]
    assert list(line) == REQUIRED + extra
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2
    if trace:
        assert set(line["metrics"]) <= {m["name"]
                                        for m in MANIFEST["per_layer"]}
    else:
        assert set(line["metrics"]) == e2e_of(cell)
    assert line["device"]["platform"] == "cpu"


def test_a_cell_added_by_files_alone_is_found(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads(json.dumps(MANIFEST))
    new = dict(manifest["workloads"][0], name="ring_online_added",
               traffic="paper_runs_added")
    manifest["workloads"].append(new)
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "ring_online" in m.get("workloads", []):
            m["workloads"].append("ring_online_added")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = json.loads((BENCH / "workloads" / "ring_online.json").read_text())
    cell["traffic"] = "paper_runs_added"
    (tmp_path / "perfbench" / "workloads"
     / "ring_online_added.json").write_text(json.dumps(cell))
    out = harness.run_cell("ring_online_added", 5, 0.2, False, device="cpu",
                           overrides=toy(harness, "ring_online"),
                           bench=tmp_path / "perfbench")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}


def test_a_measuring_run_without_a_card_fails():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.');"
            "from perfbench import harness;"
            f"harness.run_cell({CELLS[0]!r}, 1, 0.1, False, device='cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
