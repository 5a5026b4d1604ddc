"""The benchmark's reading of the program's spans (`perfbench.spans`).

On hand-built traces: each device event goes to the spans open when its
launch began (the innermost for the table, every one for a span's
device time), by interval, so a launch from another thread while the
caller waits inside a span goes to that span; a launch outside all spans
goes to "outside any span"; a trace whose launches and device events do
not pair has no answer; the device's idle gaps go to the innermost span
open at their start. At the tests' toy size on the CPU, a traced run of
each LM cell holds the program's spans and its device-side span metrics
read nothing (the CPU has no device events); `tools/span_table.py` reads
the ring's host-side numbers from a spans-only run."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src"), str(ROOT / "perfbench" / "tests")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness, spans  # noqa: E402
from perfbench.trace import Trace  # noqa: E402

P = spans.PREFIX
METRICS = ("grad_device_ms_per_step", "update_device_ms_per_step",
           "primal_device_ms_per_step")


def hand_built(launch_memset="cudaMemsetAsync"):
    """step.grad [10, 100] holding step.backward [50, 100], then
    step.update [100, 150]; launches at 5 (outside), 20 (grad), 60 (the
    autograd thread, inside backward) and 110 (update), a sync at 140."""
    host = [(P + "step.grad", 10, 100), (P + "step.backward", 50, 100),
            (P + "step.update", 100, 150), ("aten::mm", 18, 30),
            ("cudaLaunchKernel", 5, 6), ("cudaLaunchKernel", 20, 21),
            ("cudaLaunchKernel", 60, 61), (launch_memset, 110, 111),
            ("cudaStreamSynchronize", 140, 150)]
    device = [("k0", 6, 8), ("gemm", 25, 40), ("k2_backward", 65, 90),
              ("Memset (Device)", 115, 116)]
    return Trace(device=device, host=sorted(host, key=lambda h: h[1]),
                 start_us=0, end_us=160)


def test_each_device_event_goes_to_the_spans_open_at_its_launch():
    tr = hand_built()
    assert spans.device_stacks(tr) == [
        (), ("step.grad",), ("step.grad", "step.backward"), ("step.update",)]
    assert spans.device_s_in(tr, "step.grad") == pytest.approx(40e-6)
    assert spans.device_s_in(tr, "step.backward") == pytest.approx(25e-6)
    assert spans.device_s_in(tr, "step.update") == pytest.approx(1e-6)
    assert spans.device_s_in(tr, "step.primal") is None
    assert spans.span_device_s(tr) == pytest.approx({
        spans.OUTSIDE: 2e-6, "step.grad": 15e-6, "step.backward": 25e-6,
        "step.update": 1e-6})


def test_a_trace_whose_launches_do_not_pair_has_no_answer():
    tr = hand_built(launch_memset="cudaLaunchKernel")   # kernel vs memset
    assert spans.device_stacks(tr) is None
    assert spans.device_s_in(tr, "step.grad") is None
    bare = Trace(device=tr.device, host=[h for h in tr.host
                                         if not h[0].startswith(P)],
                 start_us=0, end_us=160)
    assert spans.device_stacks(bare) is None and \
        spans.idle_by_span(bare) is None


def test_idle_gaps_go_to_the_innermost_span_open_at_their_start():
    got = dict(spans.idle_by_span(hand_built()))
    # gaps [0,6] and [8,25] start outside; [40,65] in grad; [90,115] in
    # backward; [116,160] in update
    assert got == pytest.approx({spans.OUTSIDE: 23e-6, "step.grad": 25e-6,
                                 "step.backward": 25e-6,
                                 "step.update": 44e-6})


def load_metric(name):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", METRICS)
def test_each_device_side_metric_reads_its_span_per_step(name):
    want = {"grad_device_ms_per_step": 40e-3 / 2,
            "update_device_ms_per_step": 1e-3 / 2,
            "primal_device_ms_per_step": None}[name]
    got = load_metric(name).read(hand_built(), {"steps_traced": 2})
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("cell", ["minicpm2b_gossip_eps1",
                                  "minicpm2b_allreduce_adamw"])
def test_a_toy_traced_lm_run_holds_the_spans_and_reads_no_device_time(cell):
    from toy_sizes import toy
    box, _, _ = harness.make_cell(cell, 41, True, device="cpu",
                                  overrides=toy(harness, cell))
    box.setup()
    box.measure(0.2)
    tr = box.ctx.tracer.trace
    names = {s[0] for s in spans.program_spans(tr)}
    want = {"step.grad", "step.forward", "step.backward", "step.update"}
    if cell == "minicpm2b_gossip_eps1":
        want |= {"step.primal", "gossip.clip", "gossip.mix",
                 "gossip.sparsity"}
    assert want <= names, want - names
    assert not tr.device
    for name in METRICS:
        assert load_metric(name).read(tr, box.counts) is None


def test_the_span_table_reads_the_rings_host_side_numbers(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "span_table", ROOT / "tools" / "span_table.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = tmp_path / "ring.json"
    assert tool.main(["--workload", "ring_online", "--seed", str(2**40 + 7),
                      "--device", "cpu", "--pairs", "1",
                      "--profiled-pairs", "1", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    host = got["spans_only"]
    for key in ("kernel_host_us_per_launch", "torch_ops_host_us_per_round",
                "run_overhead_ms_per_run"):
        assert host[key] > 0, key
    assert got["profiled"]["correlated"]
    # the run's rounds and the warm-up chunk's one
    assert host["spans"]["round"]["count"] == host["units"] + 1
