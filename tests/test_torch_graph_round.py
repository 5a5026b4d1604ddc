"""The graphed ring round on the card, held bit for bit to the eager loop.

A run whose round replays from a CUDA graph (`repro_torch.api.round_graph`)
must equal the eager loop (``program.chunk_loop`` over the round of
``CudaBackend().make_round_program``) on the same spec and seed in every output
— final_w, loss, w_bar_loss, correct, sparsity, the eps ledger — and leave
each seed's generator in the same state. Cases: the paper's shape (64
nodes, n = 10,000, the ring) over 300 rounds in chunks of 256, so the
remainder chunk is covered; the gaussian mechanism and a run without a
clip after the Laplace runs of the same shape; a seed batch of three;
``complete`` on the dense A; a chunk-end state held while later chunks
replay; the round counters and the kernels' launch counts.

Needs an NVIDIA card (marker ``card``; skipped elsewhere). On the card,
without JAX (the repository's conftest imports it):
``python -m pytest -q --noconftest -m card tests/test_torch_graph_round.py``
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.api import ExecConfig, RunSpec, run, run_batch
from repro_torch.api import round_graph as rg
from repro_torch.api.backends import CudaBackend
from repro_torch.api.program import chunk_loop
from repro_torch.api.runner import make_batch_chunk_program, make_chunk_program
from repro_torch.kernels import round_fused as rf
import repro_torch.obs as obs

pytestmark = pytest.mark.card

FIELDS = ("final_w", "loss", "w_bar_loss", "correct", "sparsity",
          "eps_ledger")
T = 300


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the round is captured in a CUDA "
                    "graph only there")
    return torch.device("cuda")


@pytest.fixture
def eager(monkeypatch):
    """A context in which the cuda backend builds no graph: the eager
    loop, `chunk_loop` over its round."""
    def off():
        monkeypatch.setattr(rg, "_card", lambda device: False)
    return off


def paper(**kw) -> RunSpec:
    base = dict(nodes=64, dim=10_000, horizon=T, stream="social_sparse",
                mixer="ring", mechanism="laplace", eps=1.0,
                calibration="coordinate", clip_norm=1.0, alpha0=1.0,
                schedule="sqrt_t", lam=1e-3, seed=7, backend="cuda")
    base.update(kw)
    return RunSpec(**base)


CFG = ExecConfig(chunk_rounds=256, warmup=False)


def same(a, b) -> None:
    for f in FIELDS:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.shape == y.shape and x.dtype == y.dtype, f
        assert np.array_equal(x, y), f"{f}: max gap {np.abs(x - y).max()}"


def gen_state(result) -> torch.Tensor:
    return result.final_state.generator.get_state()


@pytest.mark.parametrize("kw", [dict(), dict(engine="dist")],
                         ids=["sim", "dist"])
def test_paper_ring_graphed_equals_eager(card, eager, kw):
    s = paper()
    rf.reset_launches()
    tel = obs.enable()
    try:
        got = run(s, exec=CFG, device=card, **kw)
        snap = tel.metrics.snapshot()
    finally:
        obs.disable()
    launches = (rf.round_stats.launches, rf.round_update.launches,
                rf.round_update.sparse_launches, rf.dual_step.launches)
    assert snap["round.graph_rounds"] == T and snap["round.eager_rounds"] == 0
    assert launches == (T, T, T, 0)
    eager()
    want = run(s, exec=CFG, device=card, **kw)
    same(want, got)
    assert torch.equal(gen_state(want), gen_state(got))


@pytest.mark.parametrize("kw", [dict(mechanism="gaussian"),
                                dict(clipper="none")],
                         ids=["gaussian", "no_clip"])
def test_another_round_of_the_same_shape_graphed_equals_eager(card, eager,
                                                              kw):
    """Run after the Laplace runs above in one process: the capture runs
    its round once first whatever ran before, so its kernels (``randn``,
    the clip's norms) never launch for the first time inside a capture."""
    s = paper(**kw)
    got = run(s, exec=CFG, device=card)
    eager()
    want = run(s, exec=CFG, device=card)
    same(want, got)
    assert torch.equal(gen_state(want), gen_state(got))


def test_eps_inf_graphed_equals_eager(card, eager):
    s = paper(eps=float("inf"))
    got = run(s, exec=CFG, device=card)
    eager()
    same(run(s, exec=CFG, device=card), got)


def test_batch_of_three_graphed_equals_eager_chunk_loop(card):
    s = paper()
    graphed, init = make_batch_chunk_program(s, "sim", card)
    loop = chunk_loop(CudaBackend().make_round_program(s, "sim", card)[0])
    assert graphed.graphs and not loop.graphs
    stream = s.resolve_stream(device=card)
    a, b = init([1, 2, 3]), init([1, 2, 3])
    graphed.graphs[0].plan(0, T, 256)
    for lo, hi in ((0, 256), (256, T)):
        xs, ys = (torch.as_tensor(v, device=card) for v in stream.chunk(lo,
                                                                        hi))
        xs = xs[:, None].expand(-1, 3, -1, -1).contiguous()
        ys = ys[:, None].expand(-1, 3, -1).contiguous()
        a, out_a = graphed(a, xs, ys)
        b, out_b = loop(b, xs, ys)
        assert torch.equal(a.theta, b.theta)
        for f, g in zip(out_a, out_b):
            assert f.shape == g.shape and torch.equal(f, g)
        for g1, g2 in zip(a.generators, b.generators):
            assert torch.equal(g1.get_state(), g2.get_state())
    assert graphed.graphs[0].replayed == T


def test_run_batch_of_three_graphed_equals_eager(card, eager):
    s = paper()
    got = run_batch(s, [1, 2, 3], exec=CFG, device=card)
    eager()
    for a, b in zip(run_batch(s, [1, 2, 3], exec=CFG, device=card), got):
        same(a, b)


def test_complete_on_the_dense_a_graphed_equals_eager(card, eager):
    s = paper(mixer="dense", mixer_options={"topology": "complete"})
    assert make_chunk_program(s, "sim", card)[0].graphs
    rf.reset_launches()
    got = run(s, exec=CFG, device=card)
    assert rf.round_update.launches == T
    assert rf.round_update.sparse_launches == 0
    eager()
    same(run(s, exec=CFG, device=card), got)


def test_a_held_chunk_end_state_does_not_change(card):
    held = []
    run(paper(horizon=600), exec=CFG, device=card,
        on_chunk=lambda b, state, acc: held.append(
            (state.theta, state.theta.clone())))
    torch.cuda.synchronize()
    assert len(held) == 3
    for kept, copy in held:
        assert torch.equal(kept, copy)
