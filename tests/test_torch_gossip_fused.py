"""`GossipDP.update`'s one-pass kernel path, held bit for bit to its eager
chain.

With the paper's stages exactly (a synchronous `RingRollMixer`, the port's
`LaplaceMechanism` noising every copy at a scale above 0, `OMDLassoRule`
with the l1 prox, `PerNodeL2Clipper`), ``update`` makes one
`kernels.gossip_update` call a leaf: a kernel pass on the card, the
wrapper's plain version on the CPU. The eager chain is the same update
with a subclass of the Laplace mechanism that changes nothing
(`eager_twin`), which the dispatch declines. The tests hold the fused path
to it: theta, the sparsity, the gradient norm and the generator's state
after the update, bit for bit, for m in {1, 2, 3, 4, 64}, leaves whose
node rows are not a multiple of 4, bfloat16 and float32 gradients, with
the clip active and not. Then the dispatch: it engages for the gossip
benchmark cell's stages and declines for every other stage, a subclass of
one and float16 gradients; the counters ``gossip.fused_leaves`` and
``gossip.eager_leaves`` say which. An op count (the dry-run's, on meta
tensors too) sees one kernel row a leaf, the same on the CPU and on meta.

The tests marked ``card`` need an NVIDIA card and skip elsewhere: the
kernel against the eager chain on a small minicpm-shaped tree (m = 4) and on
the dist engine's (64, 10,000) leaf, the generator's next draw after the
update, ``run(engine="dist")`` against ``engine="sim"`` over 300 rounds,
and minicpm-2b's (reduced) gossip step launching the kernel once a leaf.
On the card, without JAX (the repository's conftest imports it):
``python -m pytest -q --noconftest -m card tests/test_torch_gossip_fused.py``
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.obs as obs
from repro_torch.api import ExecConfig, RunSpec, run
from repro_torch.api.clippers import PerNodeL2Clipper
from repro_torch.api.mechanisms import LaplaceMechanism
from repro_torch.api.mixers import RingRollMixer
from repro_torch.core import gossip
from repro_torch.kernels import gossip_update as gu
from repro_torch.launch import steps

SHAPES = ((7,), (3, 5), (2, 2, 3))      # node rows of 7, 15 and 12


def _tree(m, shapes, gdtype, grad_scale, seed=0):
    g = torch.Generator().manual_seed(seed)
    theta = {f"p{i}": 0.3 * torch.randn((m,) + s, generator=g)
             for i, s in enumerate(shapes)}
    grads = {k: (grad_scale * torch.randn(v.shape, generator=g)).to(gdtype)
             for k, v in theta.items()}
    return theta, grads


@dataclasses.dataclass(frozen=True)
class SameLaplace(LaplaceMechanism):
    """The port's Laplace mechanism under another type: the same draws and
    scale, which the dispatch hands to the eager chain."""


def eager_twin(gdp):
    """``gdp`` with its mechanism as a `SameLaplace`: the eager chain."""
    mech = gdp.mechanism
    return dataclasses.replace(gdp, mechanism=SameLaplace(**{
        f.name: getattr(mech, f.name) for f in dataclasses.fields(mech)
        if f.init}))


def _update(gdp, theta, grads, device="cpu"):
    """One update from a fresh state (seed 3): (new state, metrics, the
    telemetry's counters)."""
    state = gdp.init(theta, seed=3, device=device)
    tel = obs.enable()
    try:
        new, metrics = gdp.update(state, grads)
    finally:
        obs.disable()
    return new, metrics, tel.metrics.snapshot()


def _same(a, b):
    (sa, ma, _), (sb, mb, _) = a, b
    assert sa.t == sb.t
    for k in sa.theta:
        assert torch.equal(sa.theta[k], sb.theta[k]), k
    for key in ("theta_sparsity", "grad_norm_mean"):
        assert torch.equal(ma[key], mb[key]), key
    assert ma["alpha_t"] == mb["alpha_t"]
    assert ma["noise_scale"] == mb["noise_scale"]
    assert torch.equal(sa.generator.get_state(), sb.generator.get_state())


def _spec(m=4, **kw):
    base = dict(nodes=m, mixer="ring", eps=1.0, calibration="coordinate",
                clip_norm=1.0, alpha0=0.5, lam=0.4)
    base.update(kw)
    return RunSpec(**base)


# -- the plain version against the eager chain -------------------------------

@pytest.mark.parametrize("grad_scale", [5.0, 1e-3], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("gdtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 64])
def test_fused_path_equals_the_eager_chain(m, gdtype, grad_scale):
    gdp = _spec(m).build_distributed()
    theta, grads = _tree(m, SHAPES, gdtype, grad_scale)
    eager = _update(eager_twin(gdp), theta, grads)
    fused = _update(gdp, theta, grads)
    assert eager[2] == {"gossip.eager_leaves": len(SHAPES)}
    assert fused[2] == {"gossip.fused_leaves": len(SHAPES)}
    norms = PerNodeL2Clipper(1.0).factor(grads)[1]
    assert bool((norms > 1.0).all()) == (grad_scale > 1.0)
    _same(eager, fused)
    assert 0.0 < float(fused[1]["theta_sparsity"]) < 1.0


def test_a_second_update_continues_bit_for_bit():
    """Two updates: the second reads the first's theta and generator."""
    gdp = _spec(4).build_distributed()
    theta, grads = _tree(4, SHAPES, torch.bfloat16, 5.0)
    outs = []
    for g in (eager_twin(gdp), gdp):
        state = g.init(theta, seed=3, device="cpu")
        for _ in range(2):
            state, metrics = g.update(state, grads)
        outs.append((state, metrics, None))
    _same(*outs)


def test_the_plain_version_adds_its_count_and_leaves_theta():
    theta, grads = _tree(3, ((9,),), torch.float32, 5.0)
    th, g = theta["p0"], grads["p0"]
    kept = th.clone()
    u = torch.rand(th.shape, generator=torch.Generator().manual_seed(1))
    factor = torch.tensor([0.5, 1.0, 0.25])
    zeros = torch.full((1,), 5, dtype=torch.int64)
    ring = RingRollMixer(m=3, self_weight=0.5)
    nxt = gu.gossip_update(th, u, g, factor, 0.1, 0.5, 0.3, ring, zeros)
    want, count = gu.gossip_update_plain(th, u, g, factor, 0.1, 0.5, 0.3,
                                         ring)
    assert torch.equal(nxt, want) and torch.equal(th, kept)
    assert int(zeros) == 5 + int(count)


@pytest.mark.parametrize("bad", ["theta_dtype", "u_shape", "grad_dtype",
                                 "factor_shape", "zeros_dtype"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    th = torch.zeros(2, 4)
    args = dict(theta=th, u=torch.zeros(2, 4), grad=torch.zeros(2, 4),
                factor=torch.ones(2), zeros=torch.zeros(1, dtype=torch.int64))
    args.update({
        "theta_dtype": dict(theta=th.double()),
        "u_shape": dict(u=torch.zeros(2, 5)),
        "grad_dtype": dict(grad=torch.zeros(2, 4, dtype=torch.float16)),
        "factor_shape": dict(factor=torch.ones(3)),
        "zeros_dtype": dict(zeros=torch.zeros(1)),
    }[bad])
    with pytest.raises(ValueError):
        gu.gossip_update(args["theta"], args["u"], args["grad"],
                         args["factor"], 0.1, 0.5, 0.3, RingRollMixer(m=2),
                         args["zeros"])


def test_the_work_count_reads_each_byte_once():
    from repro_torch.kernels.work import work
    m, n = 4, 122_753 * 2_304
    nbytes, _ = work("gossip_update", m, n, grad_bytes=2)
    assert nbytes == 14 * m * n + 4 * m + 8
    assert work("gossip_update", 64, 10_000)[0] == 16 * 640_000 + 264


# -- the dispatch ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplayLaplace(LaplaceMechanism):
    """A subclass that draws another way (as the reference-replay tests'
    mechanism does): the update must keep the eager chain."""

    def unit(self, generator, shape):
        return torch.ones(shape)


def _lm_recipe_gdp():
    """The gossip benchmark cell's stages, built as the benchmark builds
    them (`launch.steps.TrainRecipe`, coordinate calibration)."""
    return steps.make_gossip_dp(4, steps.TrainRecipe(
        strategy="gossip", eps=1.0, L=1.0, lam=1e-5, alpha0=0.01,
        topology="ring", clip_style="coordinate"))


DECLINED = {
    "delayed_ring": dict(delay=1),
    "delay_in_the_ring": dict(mixer_options={"delay": 1}),
    "fault_schedule": dict(faults="dcn", horizon=10),
    "replay_laplace": dict(mechanism=ReplayLaplace(
        eps=1.0, L=1.0, calibration="coordinate")),
    "gaussian": dict(mechanism="gaussian"),
    "eps_inf": dict(eps=float("inf")),
    "noise_self_false": dict(noise_self=False),
    "group_prox": dict(prox_kind="group"),
    "truncated_gradient": dict(local_rule="tg"),
    "value_clipper": dict(clipper="value"),
    "no_clipper": dict(clipper="none"),
    "dense_ring": dict(mixer="dense", mixer_options={"topology": "ring"}),
}


@pytest.mark.parametrize("case", sorted(DECLINED))
def test_every_other_stage_keeps_the_eager_chain(case):
    theta, grads = _tree(4, SHAPES, torch.float32, 5.0)
    gdp = _spec(4, **DECLINED[case]).build_distributed()
    _, _, snap = _update(gdp, theta, grads)
    assert snap == {"gossip.eager_leaves": len(SHAPES)}


@pytest.mark.parametrize("case", ["f16_grad"])
def test_leaves_the_kernel_does_not_take_keep_the_eager_chain(case):
    theta, grads = _tree(4, SHAPES, torch.float32, 5.0)
    gdp = _spec(4).build_distributed()
    assert gdp._fusable(grads, 0.5)
    grads = {k: v.half() for k, v in grads.items()}
    assert not gdp._fusable(grads, 0.5)
    _, _, snap = _update(gdp, theta, grads)
    assert snap == {"gossip.eager_leaves": len(SHAPES)}


def _counted_update(device):
    from repro_torch.launch import op_cost
    theta, grads = _tree(4, SHAPES, torch.bfloat16, 5.0)
    gdp = _spec(4).build_distributed()
    state = gdp.init(theta, seed=3, device=device)
    grads = {k: v.to(device) for k, v in grads.items()}
    tel = obs.enable()
    try:
        _, cost = op_cost.count(gdp.update, state, grads)
    finally:
        obs.disable()
    return cost, tel.metrics.snapshot()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_an_op_count_sees_one_kernel_row_a_leaf(device):
    from repro_torch.kernels.work import work
    cost, snap = _counted_update(device)
    assert snap == {"gossip.fused_leaves": len(SHAPES)}
    row = cost.ops["kernel.gossip_update"]
    assert row["calls"] == len(SHAPES)
    assert row["bytes"] == sum(work("gossip_update", 4, n, grad_bytes=2)[0]
                               for n in (7, 15, 12))
    if device == "meta":
        assert cost.ops == _counted_update("cpu")[0].ops


@pytest.mark.parametrize("path", ["eager", "fused"])
def test_a_gradient_tree_of_another_structure_is_refused(path):
    theta, grads = _tree(4, SHAPES, torch.float32, 5.0)
    gdp = _spec(4).build_distributed()
    gdp = eager_twin(gdp) if path == "eager" else gdp
    state = gdp.init(theta, seed=3, device="cpu")
    with pytest.raises(ValueError, match="structure"):
        gdp.update(state, {"extra": grads["p0"], **grads})


def _lm_steps(device, gdp, steps_run=2):
    """minicpm-2b reduced, 4 gossip nodes, eps 1: ``steps_run`` train steps
    from one init with the ambient telemetry on; (state, counters)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config("minicpm-2b").reduced()
    model = build_model(cfg, device=device)
    state = steps.make_gossip_init(model, gdp, 4)(0)
    step = steps.make_gossip_train_step(model, gdp)
    g = torch.Generator().manual_seed(1)
    tel = obs.enable()
    try:
        for _ in range(steps_run):
            toks = torch.randint(0, cfg.vocab_size, (4, 2, 16), generator=g,
                                 dtype=torch.int32)
            batch = {"tokens": toks.to(device),
                     "labels": torch.roll(toks, -1, dims=-1).to(device)}
            state, _ = step(state, batch)
    finally:
        obs.disable()
    return state, tel.metrics.snapshot()


def test_the_gossip_lm_step_fuses_every_leaf_bit_for_bit():
    """Two minicpm-2b (reduced) gossip steps: every leaf of every step
    takes the fused path, bit for bit the eager steps."""
    gdp = _lm_recipe_gdp()
    eager, es = _lm_steps("cpu", eager_twin(gdp))
    fused, fs = _lm_steps("cpu", gdp)
    leaves = len(gossip.tree.leaves(fused.gossip.theta))
    # the tied unembedding, once a node a step: on the CPU its plain path
    assert es == {"gossip.eager_leaves": 2 * leaves,
                  "unembed.plain_calls": 2 * 4}
    assert fs == {"gossip.fused_leaves": 2 * leaves,
                  "unembed.plain_calls": 2 * 4}
    for a, b in zip(gossip.tree.leaves(eager.gossip.theta),
                    gossip.tree.leaves(fused.gossip.theta)):
        assert torch.equal(a, b)


# -- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the gossip update's kernel runs "
                    "only there")
    return torch.device("cuda")


# a minicpm-shaped tree a node: a (vocab, d) table, one layer's square and
# wide matrices and a norm, ragged widths included
MINI = ((1_001, 64), (64, 64), (64, 160), (160, 64), (64,), (37,))


def _card_tree(shapes, m, dev):
    theta, grads = _tree(m, shapes, torch.bfloat16, 5.0, seed=11)
    return ({k: v.to(dev) for k, v in theta.items()},
            {k: v.to(dev) for k, v in grads.items()})


@pytest.mark.card
@pytest.mark.parametrize("case", ["minicpm_m4", "dist_leaf"])
def test_kernel_equals_the_eager_chain_on_the_card(card, case):
    if case == "minicpm_m4":
        theta, grads = _card_tree(MINI, 4, card)
    else:
        g = torch.Generator().manual_seed(2)
        theta = {"w": torch.randn(64, 10_000, generator=g).to(card)}
        grads = {"w": torch.randn(64, 10_000, generator=g).to(card)}
    gdp = _spec(len(next(iter(theta.values()))), lam=0.2).build_distributed()
    before = gu.gossip_update.launches
    fused = _update(gdp, theta, grads, device=card)
    assert gu.gossip_update.launches - before == len(theta)
    eager = _update(eager_twin(gdp), theta, grads, device=card)
    assert fused[2] == {"gossip.fused_leaves": len(theta)}
    assert eager[2] == {"gossip.eager_leaves": len(theta)}
    _same(eager, fused)
    # the generator's next draw after the update
    assert torch.equal(torch.rand(16, generator=eager[0].generator,
                                  device=card),
                       torch.rand(16, generator=fused[0].generator,
                                  device=card))


@pytest.mark.card
def test_dist_engine_equals_sim_on_the_card(card):
    """300 rounds of the paper's ring at its width on the reference
    backend: the dist engine's update takes the kernel every round and its
    RunResult equals the simulator's."""
    spec = RunSpec(nodes=64, dim=10_000, horizon=300, stream="social_sparse",
                   mixer="ring", mechanism="laplace", eps=1.0,
                   calibration="coordinate", clip_norm=1.0, alpha0=1.0,
                   lam=1e-3, seed=7, backend="reference")
    cfg = ExecConfig(chunk_rounds=256, warmup=False)
    sim = run(spec, engine="sim", device=card, exec=cfg)
    before = gu.gossip_update.launches
    dist = run(spec, engine="dist", device=card, exec=cfg)
    assert gu.gossip_update.launches - before == 300
    for f in ("final_w", "loss", "w_bar_loss", "correct", "sparsity",
              "eps_ledger"):
        a, b = np.asarray(getattr(sim, f)), np.asarray(getattr(dist, f))
        assert np.array_equal(a, b), f


@pytest.mark.card
def test_the_gossip_lm_step_fuses_every_leaf_on_the_card(card):
    """The gossip cell's stages on minicpm-2b (reduced), 4 nodes, two steps
    on the card: one kernel launch a leaf a step, none eager."""
    before = gu.gossip_update.launches
    state, snap = _lm_steps(card, _lm_recipe_gdp())
    leaves = len(gossip.tree.leaves(state.gossip.theta))
    # the tied unembedding, once a node a step: the reduced model is f32,
    # so its plain path
    assert snap == {"gossip.fused_leaves": 2 * leaves,
                    "unembed.plain_calls": 2 * 4}
    assert gu.gossip_update.launches - before == 2 * leaves
    assert all(bool(torch.isfinite(t).all())
               for t in gossip.tree.leaves(state.gossip.theta))
