"""The graphed ring round's host side, on the CPU (`api/round_graph.py`).

* the per-run constants table equals ``omd.step_context(t)`` and
  ``mech.scale`` bit for bit over the paper's 1,562 rounds (both Laplace
  calibrations; eps = inf is all zeros and draws nothing);
* which runs replay a captured round: the fused ring, torus and dense
  complete on a CUDA device; hybrid, ``dcn`` faults, delay 1, node shards
  and the CPU run eagerly; so does a chunk outside the run's plan;
* the round counters: a CPU run's rounds are all ``round.eager_rounds``;
  each replay adds the captured launches to the kernels' launch counts;
* the graph path's own work (the chunk copied in, the round counter, the
  constants rows, the generators handed to the graph and back, the output
  rows, the fresh state) equals the eager loop bit for bit, with the
  capture stood in by the round body itself (the card's capture is held
  in ``test_torch_graph_round.py``).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.api import ExecConfig, RunSpec, run, run_batch
from repro_torch.api import round_graph as rg
from repro_torch.api.runner import make_batch_chunk_program, make_chunk_program
from repro_torch.kernels import round_fused as rf
import repro_torch.obs as obs

PAPER_T = 1_562
FIELDS = ("final_w", "loss", "w_bar_loss", "correct", "sparsity",
          "eps_ledger")


def spec(**kw) -> RunSpec:
    base = dict(nodes=8, dim=64, horizon=40, mixer="ring",
                mechanism="laplace", eps=1.0, calibration="coordinate",
                clip_norm=1.0, alpha0=1.0, schedule="sqrt_t", lam=1e-3,
                backend="cuda", stream="social_sparse", seed=3)
    base.update(kw)
    return RunSpec(**base)


@pytest.fixture
def pretend_card(monkeypatch):
    """The CPU taken for a card by the graph path, each capture replaced
    by the round body run eagerly at every replay."""
    monkeypatch.setattr(rg, "_card", lambda device: True)
    monkeypatch.setattr(rg, "_capture",
                        lambda body, gens, device: (body, [0, 0, 0, 0]))


def same(a, b) -> None:
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def counted(fn):
    """(fn()'s result, the ambient telemetry's metrics after it)."""
    tel = obs.enable()
    try:
        return fn(), tel.metrics.snapshot()
    finally:
        obs.disable()


@pytest.mark.parametrize("calibration", ["global", "coordinate"])
@pytest.mark.parametrize("eps", [1.0, 0.5, math.inf])
def test_constants_table_is_the_eager_rounds_values(calibration, eps):
    s = spec(nodes=64, dim=10_000, horizon=PAPER_T, eps=eps,
             calibration=calibration)
    omd, mech = s.omd_config(), s.resolve_mechanism()
    table = rg.round_constants(omd, mech, s.dim, 0, PAPER_T)
    assert table.dtype == np.float32 and table.shape == (PAPER_T, 3)
    want = np.empty((PAPER_T, 3))
    for t in range(1, PAPER_T + 1):
        ctx = omd.step_context(t)
        want[t - 1] = (ctx.alpha_t, ctx.lam_t, mech.scale(ctx.alpha_t, s.dim))
    # the eager round's values are f32 already: the table holds them exactly
    assert np.array_equal(table.astype(np.float64), want)
    assert np.array_equal(rg.round_constants(omd, mech, s.dim, 700, 900),
                          table[700:900])
    graph = rg.RoundGraph(None, None, engine="sim", omd=omd, mech=mech,
                          m=s.nodes, n=s.dim, device=torch.device("cpu"))
    graph.plan(0, PAPER_T, 256)
    if math.isinf(eps):
        assert not table[:, rg.SCALE].any()
        assert graph._draws is False              # no draw at all
    else:
        assert graph._draws is True


@pytest.mark.parametrize("kw", [
    dict(), dict(calibration="global"), dict(eps=0.25),
    dict(mechanism="gaussian"), dict(eps=math.inf),
    dict(mechanism="none")])
def test_a_mechanism_scales_every_round_or_none(kw):
    """The noise draw is decided once a run from the table: each of the
    port's mechanisms scales by 0 in every round or in none."""
    s = spec(**kw)
    omd, mech = s.omd_config(), s.resolve_mechanism()
    assert rg.graphable_mechanism(mech)
    nonzero = rg.round_constants(omd, mech, s.dim, 0, PAPER_T)[:, rg.SCALE]
    assert nonzero.all() or not nonzero.any()


@pytest.mark.parametrize("kw,graphed", [
    (dict(), True),
    (dict(mixer="torus"), True),
    (dict(mixer="dense", mixer_options={"topology": "complete"}), True),
    (dict(mechanism="gaussian"), True),
    (dict(mechanism="none"), True),
    (dict(backend_options={"mode": "hybrid"}), False),
    (dict(faults="dcn"), False),
    (dict(delay=1), False),
    (dict(mixer="complete"), False),
])
def test_which_runs_replay_a_captured_round(kw, graphed, monkeypatch):
    s = spec(**kw)
    cpu = torch.device("cpu")
    for build in (make_chunk_program, make_batch_chunk_program):
        assert build(s, "sim", cpu)[0].graphs == ()
    # a CUDA device as the backend sees it
    monkeypatch.setattr(rg, "_card", lambda device: True)
    for build in (make_chunk_program, make_batch_chunk_program):
        assert bool(build(s, "sim", cpu)[0].graphs) is graphed


def test_node_shards_never_replay(pretend_card):
    s = spec()
    res, snap = counted(lambda: run(s, device="cpu", exec=ExecConfig(
        chunk_rounds=16, node_devices=2)))
    assert snap["round.graph_rounds"] == 0
    assert snap["round.eager_rounds"] == s.horizon == res.rounds


def test_a_cpu_run_counts_every_round_eager():
    s = spec()
    res, snap = counted(lambda: run(s, device="cpu",
                                    exec=ExecConfig(chunk_rounds=16)))
    assert snap["round.eager_rounds"] == res.rounds == s.horizon
    assert snap["round.graph_rounds"] == 0


@pytest.mark.parametrize("kw", [
    dict(),
    dict(calibration="global"),
    dict(eps=math.inf),
    dict(mechanism="gaussian"),
    dict(mixer="torus"),
    dict(mixer="dense", mixer_options={"topology": "complete"}),
    dict(clipper="none"),
], ids=["ring", "global", "eps_inf", "gaussian", "torus", "dense",
        "no_clip"])
@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_graph_path_equals_the_eager_loop(kw, engine, monkeypatch):
    s = spec(**kw)
    cfg = ExecConfig(chunk_rounds=16)
    eager = run(s, engine=engine, device="cpu", exec=cfg)
    monkeypatch.setattr(rg, "_card", lambda device: True)
    monkeypatch.setattr(rg, "_capture",
                        lambda body, gens, device: (body, [0, 0, 0, 0]))
    got, snap = counted(lambda: run(s, engine=engine, device="cpu",
                                    exec=cfg))
    same(eager, got)
    assert snap["round.graph_rounds"] == s.horizon
    assert snap["round.eager_rounds"] == 0
    gen = (lambda r: r.final_state.generator)
    assert torch.equal(gen(eager).get_state(), gen(got).get_state())


def test_graph_path_batch_equals_the_eager_batch(pretend_card):
    s = spec()
    cfg = ExecConfig(chunk_rounds=16)
    got = run_batch(s, [5, 6, 7], device="cpu", exec=cfg)
    rg_card = rg._card
    try:
        rg._card = lambda device: False
        eager = run_batch(s, [5, 6, 7], device="cpu", exec=cfg)
    finally:
        rg._card = rg_card
    for a, b in zip(eager, got):
        same(a, b)


def test_held_chunk_state_survives_later_chunks(pretend_card):
    s = spec(horizon=48)
    held = []
    run(s, device="cpu", exec=ExecConfig(chunk_rounds=16),
        on_chunk=lambda b, state, acc: held.append(
            (state.theta, state.theta.clone())))
    assert len(held) == 3
    for kept, copy in held:
        assert torch.equal(kept, copy)
    assert held[0][0].data_ptr() != held[1][0].data_ptr()


def test_a_chunk_outside_the_plan_runs_eagerly(pretend_card):
    """A chunk program driven without `_drive`'s plan runs the eager loop;
    once planned, the chunks inside the plan replay and the rest do not."""
    s = spec()
    dev = torch.device("cpu")
    graphed, init = make_batch_chunk_program(s, "sim", dev)
    graph, = graphed.graphs
    rg._card, card = (lambda device: False), rg._card
    try:
        eager = make_batch_chunk_program(s, "sim", dev)[0]
    finally:
        rg._card = card
    assert eager.graphs == ()
    stream = s.resolve_stream(device=dev)
    a, b = init([1, 2]), init([1, 2])
    replays = []
    for lo, hi in ((0, 8), (8, 24), (24, 32), (32, 40)):
        if lo == 8:
            graph.plan(8, 32, 16)
        xs, ys = stream.chunk(lo, hi)
        xs = torch.as_tensor(xs).unsqueeze(1).expand(-1, 2, -1, -1)
        ys = torch.as_tensor(ys).unsqueeze(1).expand(-1, 2, -1)
        a, out_a = graphed(a, xs.contiguous(), ys.contiguous())
        b, out_b = eager(b, xs.contiguous(), ys.contiguous())
        replays.append(graph.replayed)
        assert torch.equal(a.theta, b.theta) and a.t == b.t == hi
        for f, g in zip(out_a, out_b):
            assert torch.equal(f, g)
        for g1, g2 in zip(a.generators, b.generators):
            assert torch.equal(g1.get_state(), g2.get_state())
    assert replays == [0, 16, 24, 24]


def test_each_replay_adds_the_captured_launches(monkeypatch):
    """The kernels' launch counts go up at every replay by what the
    capture recorded, and the capture leaves them as they were."""
    monkeypatch.setattr(rg, "_card", lambda device: True)
    monkeypatch.setattr(rg, "_capture",
                        lambda body, gens, device: (lambda: None,
                                                    [1, 2, 3, 5]))
    s = spec()
    rf.reset_launches()
    seen = []
    run(s, device="cpu", exec=ExecConfig(chunk_rounds=16, warmup=False),
        on_chunk=lambda b, state, acc: seen.append(rf.round_stats.launches))
    assert seen == [16, 32, 40]
    assert (rf.round_stats.launches, rf.round_update.launches,
            rf.round_update.sparse_launches, rf.dual_step.launches) == (
        40, 80, 120, 200)


def test_the_kernel_wrappers_take_a_device_scalar():
    g = torch.Generator().manual_seed(0)
    theta = torch.randn((2, 8, 64), generator=g)
    x = torch.randn((2, 8, 64), generator=g)
    lam = torch.tensor([0.25], dtype=torch.float32)
    for a, b in zip(rf.round_stats(theta, x, lam[0], 8),
                    rf.round_stats(theta, x, 0.25, 8)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="one-element float32"):
        rf._scalar("lam_t", torch.zeros(2), torch.device("cpu"))
    assert rf._scalar("alpha_t", 0.5, torch.device("cpu")) == (None, 0.5)
