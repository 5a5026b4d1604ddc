"""The port's program spans (`repro_torch.obs.span`) and their two sinks.

A dead span is the shared no-op; a live one reaches the ambient tracer, a
recording ``torch.profiler`` session as a prefixed host annotation on the
profiler's clock, or both; nested spans carry their parent's id; and the
ring run, the gossip step (the fused update, and the eager chain at
eps = inf) and the AdamW step record every span of their paths while
their outputs equal the untraced ones bit for bit.
"""
import json
import time

import pytest

torch = pytest.importorskip("torch")

import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
from repro_torch import ExecConfig, RunSpec, run  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

RING_SPANS = {"run", "run.build", "run.compile", "run.chunk", "run.result",
              "round", "round.stats", "round.noise", "round.mix",
              "kernel.round_stats", "kernel.round_update"}
STEP_SPANS = {"step.grad", "step.forward", "step.backward", "step.update"}
# the paper's stages take the fused update (clip factors, then one
# `gossip_update` call a leaf); eps = inf (no noise) the eager chain
GOSSIP_SPANS = STEP_SPANS | {"step.primal", "gossip.clip", "gossip.mix",
                             "gossip.sparsity"}
EAGER_GOSSIP_SPANS = GOSSIP_SPANS | {"gossip.dual_step"}
NODES, B, T = 2, 1, 8


@pytest.fixture(autouse=True)
def _ambient_off():
    obs.disable()
    yield
    obs.disable()


def test_a_dead_span_is_the_shared_null_span():
    assert not autograd_profiler._is_profiler_enabled
    assert obs.span("round") is obs.NULL_SPAN
    assert obs.Tracer(enabled=False).span("x") is obs.NULL_SPAN
    with obs.span("round") as sp:
        assert sp is obs.NULL_SPAN


def test_a_span_stands_in_the_profiler_on_its_clock(tmp_path):
    tel = obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("round"):
            torch.ones(64).mul_(2)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == obs.PREFIX + "round"]
    assert len(events) == 1
    (sp,) = tel.tracer.spans
    exported = [e for e in tel.tracer.chrome_events() if e["ph"] == "X"]
    assert abs(exported[0]["ts"] - events[0].start_ns() / 1e3) < 1e3
    assert abs(tel.tracer.epoch_us(sp.t0) - time.time_ns() / 1e3) < 60e6
    path = tel.export_chrome(str(tmp_path / "trace.json"))
    assert json.load(open(path))["traceEvents"][-1]["args"]["id"] == sp.id


def test_a_span_goes_to_the_profiler_alone_while_telemetry_is_off():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert autograd_profiler._is_profiler_enabled
        with obs.span("round"):
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count(obs.PREFIX + "round") == 1
    assert obs.active().tracer.spans == []


def test_nested_spans_carry_their_parents_ids():
    tel = obs.enable()
    with obs.span("run"):
        with obs.span("round"):
            with obs.span("kernel.round_stats"):
                pass
        with obs.span("round"):
            pass
    by = {}
    for s in tel.tracer.spans:
        by.setdefault(s.name, []).append(s)
    (outer,), (kern,) = by["run"], by["kernel.round_stats"]
    first, second = by["round"]
    assert outer.parent_id is None and outer.parent is None
    assert first.parent_id == second.parent_id == outer.id
    assert kern.parent_id == first.id and kern.parent == "round"
    assert first.id != second.id and kern.depth == 2


# -- every span of each path, and the outputs bit for bit ---------------------

def ring_outputs():
    spec = RunSpec(nodes=8, dim=256, horizon=24, eps=1.0, alpha0=0.5,
                   lam=0.01, stream="drift", stream_options={"period": 3},
                   backend="cuda")
    res = run(spec, exec=ExecConfig(chunk_rounds=8, compute_regret=False),
              device="cpu")
    return [torch.as_tensor(getattr(res, f)) for f in
            ("final_w", "loss", "correct", "w_bar_loss", "sparsity",
             "eps_ledger")]


def lm_outputs(strategy, eps=1.0):
    torch.manual_seed(0)
    cfg = get_config("minicpm-2b").reduced(layers=1, d_model=64, d_ff=128,
                                           vocab=128)
    model = build_model(cfg, device="cpu")
    lead = (NODES, B) if strategy == "gossip" else (NODES * B,)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 128, lead + (T,), generator=g,
                           dtype=torch.int32)
    labels = torch.cat([tokens[..., 1:], torch.full(lead + (1,), -1,
                                                    dtype=torch.int32)], -1)
    batch = {"tokens": tokens, "labels": labels}
    if strategy == "gossip":
        gdp = steps.make_gossip_dp(NODES, steps.TrainRecipe(eps=eps))
        step = steps.make_gossip_train_step(model, gdp)
        state = steps.make_gossip_init(model, gdp, NODES)(0)
    else:
        step, init = steps.make_allreduce_train_step(
            model, steps.TrainRecipe(strategy="allreduce"))
        state = init(0)
    out = []
    for _ in range(2):
        state, metrics = step(state, batch)
        out += [torch.as_tensor(v) for _, v in sorted(metrics.items())]
    return out + tree.leaves(state)


PATHS = {"ring": (ring_outputs, RING_SPANS),
         "gossip": (lambda: lm_outputs("gossip"), GOSSIP_SPANS),
         "gossip_eager": (lambda: lm_outputs("gossip", eps=float("inf")),
                          EAGER_GOSSIP_SPANS),
         "allreduce": (lambda: lm_outputs("allreduce"), STEP_SPANS)}


@pytest.mark.parametrize("sink", ["telemetry", "profiler", "both"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_every_span_is_recorded_and_the_outputs_equal_bit_for_bit(path,
                                                                  sink):
    outputs, want = PATHS[path]
    off = outputs()
    tel = obs.enable() if sink != "profiler" else None
    names = set()
    if sink == "telemetry":
        on = outputs()
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = outputs()
        names = {e.name()[len(obs.PREFIX):]
                 for e in prof.profiler.kineto_results.events()
                 if e.name().startswith(obs.PREFIX)}
        assert want <= names, want - names
    if tel is not None:
        recorded = {s.name for s in tel.tracer.spans}
        assert want <= recorded, want - recorded
        if sink == "both":
            assert recorded == names
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert same(a, b), (a, b)


def same(a, b) -> bool:
    """Bit for bit: tensors (dtype and values), generators (their state),
    anything else by equality."""
    if isinstance(a, torch.Generator):
        return torch.equal(a.get_state(), b.get_state())
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b
