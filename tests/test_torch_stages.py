"""The rest of the stage registries against the JAX package: the Gaussian
mechanism, the truncated-gradient and RDA rules, the value clipper, the
group prox, per-edge delays and the drift, heterogeneous and bursty streams.

Runs use `test_torch_run.py`'s injection harness: the reference's stream
chunks and its per-round unit draws (Laplace, or N(0, 1) for the Gaussian
mechanism) go into the port. The streams are held exactly under the
reference's own `jax.random` draws, fed through the port streams' draw
methods; their own samplers are checked by distribution.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import clippers as jclippers  # noqa: E402
from repro.api import mechanisms as jmech  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.api import streams as jstreams  # noqa: E402
from repro.core import omd as jomd  # noqa: E402
from repro.core import prox as jprox  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run  # noqa: E402
from repro_torch.api import clippers, mechanisms, streams  # noqa: E402
from repro_torch.core import omd, prox  # noqa: E402
from test_torch_run import (ReplayLaplace, ReplayStream,  # noqa: E402
                            _reference_draws, assert_contract)

M, N, T = 6, 120, 12
BASE = dict(nodes=M, dim=N, horizon=T, alpha0=0.5, lam=0.05, eps=1.0,
            calibration="coordinate", clip_norm=1.0, seed=5)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# -- prox, rules, mechanism and clipper, op by op ----------------------------

def test_group_and_elastic_net_prox_match():
    """The elastic net is elementwise, so exact; the group prox takes each
    group's norm, a sum whose order differs from XLA's: 1e-6 relative."""
    rng = np.random.default_rng(3)
    p = rng.standard_normal((7, 33)).astype(np.float32)
    p[0] = 0.0
    for lam in (0.0, 0.5, 3.0):
        for axis in (-1, 0):
            got = prox.group_soft_threshold(_t(p), lam, axis=axis).numpy()
            want = np.asarray(jprox.group_soft_threshold(jnp.asarray(p), lam,
                                                         axis=axis))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_array_equal(
            prox.elastic_net_prox(_t(p), lam, 0.3).numpy(),
            np.asarray(jprox.elastic_net_prox(jnp.asarray(p), lam, 0.3)))


@pytest.mark.parametrize("prox_kind", ["l1", "group", "none"])
def test_omd_primal_matches_on_a_pytree(prox_kind):
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((4, 9)).astype(np.float32),
            "b": rng.standard_normal((4, 3, 2)).astype(np.float32)}
    got = omd.omd_primal({k: _t(v) for k, v in tree.items()}, 0.7, prox_kind)
    want = jomd.omd_primal({k: jnp.asarray(v) for k, v in tree.items()},
                           jnp.float32(0.7), prox_kind)
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError):
        omd.omd_primal(tree, 0.1, "l0")


@pytest.mark.parametrize("rule", ["tg", "rda", "omd-group"])
def test_rules_match_op_by_op(rule):
    from repro.api import LOCAL_RULES as JLOCAL
    from repro_torch.api import LOCAL_RULES
    opts = {"prox_kind": "group"} if rule == "omd-group" else {}
    name = rule.split("-")[0]
    port = LOCAL_RULES.build(name, opts)
    ref = JLOCAL.build(name, opts)
    rng = np.random.default_rng(5)
    theta, grad = (rng.standard_normal((5, 17)).astype(np.float32)
                   for _ in range(2))
    sched = omd.OMDConfig(alpha0=0.5, lam=0.3)
    jsched = jomd.OMDConfig(alpha0=0.5, lam=0.3)
    for t in (1, 2, 7):
        ctx, jctx = sched.step_context(t), jsched.step_context(jnp.int32(t))
        np.testing.assert_array_equal(
            port.primal(_t(theta), ctx).numpy(),
            np.asarray(ref.primal(jnp.asarray(theta), jctx)))
        np.testing.assert_array_equal(
            port.dual_step(_t(theta), _t(grad), ctx).numpy(),
            np.asarray(ref.dual_step(jnp.asarray(theta), jnp.asarray(grad),
                                     jctx)))
    np.testing.assert_array_equal(port.init_state(_t(theta)).numpy(),
                                  np.asarray(ref.init_state(
                                      jnp.asarray(theta))))
    assert LOCAL_RULES.build("truncated_gradient") == LOCAL_RULES.build("tg")
    with pytest.raises(ValueError, match="prox_kind"):
        LOCAL_RULES.build("omd", {"prox_kind": "l0"})


@pytest.mark.parametrize("eps,delta", [(1.0, 1e-5), (0.3, 1e-3),
                                       (float("inf"), 1e-5)])
def test_gaussian_scale_matches_exactly(eps, delta):
    mech = mechanisms.GaussianMechanism(eps=eps, delta=delta, L=0.7)
    ref = jmech.GaussianMechanism(eps=eps, delta=delta, L=0.7)
    assert mech.is_private == ref.is_private
    for alpha in (1.0, 0.5, np.float32(1.0) / np.sqrt(np.float32(7))):
        want = np.float32(ref.scale(jnp.float32(alpha), 100))
        assert np.float32(mech.scale(alpha, 100)) == want
    g = torch.Generator().manual_seed(0)
    if not mech.is_private:
        assert not mech.sample(g, (3, 4), 0.0).any()


def test_gaussian_sampler_by_distribution():
    mech = mechanisms.GaussianMechanism()
    g = torch.Generator().manual_seed(1)
    draws = mech.sample(g, (400, 500), 2.0)
    assert abs(float(draws.mean())) < 0.02
    assert abs(float(draws.std()) - 2.0) < 0.02


def test_value_clipper_matches_exactly():
    rng = np.random.default_rng(6)
    g = {"w": 3 * rng.standard_normal((4, 11)).astype(np.float32),
         "b": rng.standard_normal((4, 2)).astype(np.float32)}
    for bound in (1.0, 0.25):
        got, norms = clippers.ValueClipper(max_value=bound).clip(
            {k: _t(v) for k, v in g.items()})
        want, jnorms = jclippers.ValueClipper(max_value=bound).clip(
            {k: jnp.asarray(v) for k, v in g.items()})
        for k in g:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        np.testing.assert_allclose(norms.numpy(), np.asarray(jnorms),
                                   rtol=1e-6)


# -- runs against repro.api.run ----------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ReplayGaussian(mechanisms.GaussianMechanism):
    """The port's Gaussian mechanism with the reference's N(0, 1) draws."""

    draws: object = None

    def unit(self, generator, shape):
        u = next(self.draws)
        assert u.shape == tuple(shape)
        return torch.tensor(u)


def _reference_normals(seed, rounds, shape):
    """The reference round's N(0, 1) draws: ``key, sub = split(key)``, then
    ``normal(sub, shape)``, round by round."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape)))
    return out


@pytest.fixture(scope="module")
def injected():
    stream = JRunSpec(**BASE).resolve_stream()
    xs, ys = (np.asarray(a) for a in stream.chunk(0, T))
    return (xs, ys, _reference_draws(BASE["seed"], T, (M, N)),
            _reference_normals(BASE["seed"], T, (M, N)))


STAGES = {
    "gaussian": dict(mechanism="gaussian"),
    "tg": dict(local_rule="tg"),
    "rda": dict(local_rule="rda", local_rule_options={"gamma": 2.0}),
    "value": dict(clipper="value"),
    "group": dict(prox_kind="group"),
}
# (stage, port backend, reference backend): the fused backends carry the
# paper's rule and the per-node L2 clipper only, so tg, rda, value and
# group run on the torch-op engines
RUNS = [(s, "reference", "reference") for s in STAGES] + [
    ("gaussian", "cuda", "pallas")]


@pytest.mark.parametrize("stage,backend,ref_backend", RUNS)
def test_stage_run_matches_the_reference(injected, stage, backend,
                                         ref_backend):
    xs, ys, laplace, normals = injected
    fields = STAGES[stage]
    ref = jrun(JRunSpec(**BASE, **fields, backend=ref_backend),
               exec=JExecConfig(chunk_rounds=5, warmup=False))
    if stage == "gaussian":
        mech = ReplayGaussian(eps=BASE["eps"], L=BASE["clip_norm"],
                              draws=iter(normals))
    else:
        mech = ReplayLaplace(eps=BASE["eps"], L=BASE["clip_norm"],
                             calibration=BASE["calibration"],
                             draws=iter(laplace))
    port_fields = {k: v for k, v in fields.items() if k != "mechanism"}
    spec = RunSpec(**BASE, **port_fields, mechanism=mech, backend=backend,
                   stream=ReplayStream(xs, ys))
    port = run(spec, exec=ExecConfig(chunk_rounds=5, warmup=False),
               device="cpu")
    what = f"{stage} on {backend}"
    assert_contract(ref, port, what)
    d = np.abs(port.regret - ref.regret).max()
    assert d <= 1e-4 * T * M, f"{what}: regret off by {d}"


@pytest.mark.parametrize("stage", ["tg", "rda", "value", "group"])
def test_fused_backend_refuses_what_it_does_not_fuse(stage):
    spec = RunSpec(**BASE, **STAGES[stage], backend="cuda")
    with pytest.raises(ValueError, match="backend='reference'"):
        run(spec, exec=ExecConfig(compute_regret=False), device="cpu")
    with pytest.raises(ValueError, match="backend='reference'"):
        jrun(JRunSpec(**BASE, **STAGES[stage], backend="pallas"),
             exec=JExecConfig(compute_regret=False))


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_sim_and_dist_are_bit_identical(stage):
    spec = RunSpec(**BASE, **STAGES[stage], delay=1)
    cfg = ExecConfig(chunk_rounds=5, warmup=False)
    sim = run(spec, engine="sim", exec=cfg, device="cpu")
    dist = run(spec, engine="dist", exec=cfg, device="cpu")
    for f in ("final_w", "loss", "w_bar_loss", "correct", "sparsity",
              "regret"):
        np.testing.assert_array_equal(getattr(dist, f), getattr(sim, f),
                                      err_msg=f)


def test_delay_dist_resolves_and_refuses_as_the_reference():
    spec = RunSpec(nodes=8, dim=4, mixer="hypercube", delay=3,
                   delay_dist="geometric", seed=2)
    jspec = JRunSpec(nodes=8, dim=4, mixer="hypercube", delay=3,
                     delay_dist="geometric", seed=2)
    got, want = spec.resolve_mixer(), jspec.resolve_mixer()
    np.testing.assert_array_equal(got.delays, want.delays)
    assert got.delay == want.delay
    for bad, match in ((dict(delay=0), "delay >= 1"),
                       (dict(mixer="ring_alternating"), "ring_alternating"),
                       (dict(mixer=got), "topology NAME")):
        with pytest.raises(ValueError, match=match):
            spec.replace(**bad).resolve_mixer()
        with pytest.raises(ValueError, match=match):
            jspec.replace(**{**bad, "mixer": want} if "mixer" in bad
                          and not isinstance(bad["mixer"], str)
                          else bad).resolve_mixer()


# -- streams -----------------------------------------------------------------

SN, SM = 96, 5


def _round_draws(seed):
    """The reference's per-round draws of social_sparse/drift/heterogeneous:
    features from the first half of the split round key, flips from the
    second."""
    def draws(t):
        k = jax.random.fold_in(jax.random.PRNGKey(seed + 1), t)
        kx, kn = jax.random.split(k)
        return (_t(jax.random.normal(kx, (SM, SN))),
                _t(jax.random.uniform(kn, (SM,))))
    return draws


def _inject(stream, **hooks):
    """``stream`` with its draw methods replaced by ``hooks``."""
    for name, fn in hooks.items():
        object.__setattr__(stream, name, fn)
    return stream


def _base_w(seed, sparsity):
    from repro.data.social import _w_true
    return lambda: _t(_w_true(SN, sparsity, seed))


def _held(stream, ref, t0, t1):
    xs, ys = stream.chunk(t0, t1)
    jxs, jys = ref.chunk(t0, t1)
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(ys.numpy(), np.asarray(jys))
    return xs, ys


@pytest.mark.parametrize("mode", ["reshuffle", "rotate"])
@pytest.mark.parametrize("seed", [0, 3])
def test_drift_stream_is_the_reference_under_its_draws(mode, seed):
    kw = dict(n=SN, nodes=SM, rounds=40, period=4, mode=mode,
              sparsity_true=0.1, label_noise=0.2, seed=seed)
    ref = jstreams.DriftStream(**kw)
    stream = _inject(
        streams.DriftStream(**kw, device="cpu"),
        round_draws=_round_draws(seed), base_w_true=_base_w(seed, 0.1),
        phase_w_true=lambda p: _t(ref.w_true_at(p * kw["period"])))
    for t in (0, 3, 4, 13, 39):
        np.testing.assert_array_equal(stream.w_true_at(t).numpy(),
                                      np.asarray(ref.w_true_at(t)))
    _held(stream, ref, 3, 17)


@pytest.mark.parametrize("seed", [0, 3])
def test_heterogeneous_stream_is_the_reference_under_its_draws(seed):
    kw = dict(n=SN, nodes=SM, rounds=20, scale_spread=0.7, noise_max=0.3,
              sparsity_true=0.1, seed=seed)
    ref = jstreams.HeterogeneousStream(**kw)
    stream = _inject(
        streams.HeterogeneousStream(**kw, device="cpu"),
        round_draws=_round_draws(seed), base_w_true=_base_w(seed, 0.1),
        node_scales=lambda: _t(ref.node_scales()),
        node_noise_rates=lambda: _t(ref.node_noise_rates()))
    _held(stream, ref, 2, 11)


@pytest.mark.parametrize("seed,tail", [(0, 1.5), (4, 0.8)])
def test_bursty_stream_is_the_reference_under_its_draws(seed, tail):
    kw = dict(n=SN, nodes=SM, rounds=30, burst_max=6, tail=tail,
              sparsity_true=0.1, seed=seed)
    ref = jstreams.BurstyStream(**kw)

    def uniforms(t):
        k = jax.random.fold_in(jax.random.PRNGKey(seed + 2), t)
        return _t(jax.random.uniform(k, (SM,), minval=1e-7, maxval=1.0))

    def normals(t, k):
        kk = jax.random.fold_in(jax.random.PRNGKey(seed + 1), t)
        return _t(jax.random.normal(jax.random.fold_in(kk, k), (SM, SN)))

    stream = _inject(streams.BurstyStream(**kw, device="cpu"),
                     burst_uniforms=uniforms, burst_normals=normals,
                     base_w_true=_base_w(seed, 0.1))
    np.testing.assert_array_equal(stream.counts(1, 30).numpy(),
                                  np.asarray(ref.counts(1, 30)))
    _held(stream, ref, 5, 19)


def test_drift_stream_samples_by_distribution():
    s = streams.DriftStream(n=4000, nodes=3, rounds=64, period=8,
                            sparsity_true=0.05, seed=1, device="cpu")
    ws = [s.w_true_at(8 * p) for p in range(4)]
    for w in ws:
        assert abs(float(torch.linalg.norm(w)) - 1.0) < 1e-5
        assert 0.04 < float((w != 0).float().mean()) < 0.06
    assert not torch.equal(ws[0], ws[1])
    assert torch.equal(s.w_true_at(9), ws[1])
    rot = dataclasses.replace(s, mode="rotate")
    assert torch.equal(rot.w_true_at(0), rot.base_w_true())
    assert torch.equal(rot.w_true_at(8),
                       torch.roll(rot.base_w_true(), 4000 // 4 + 1))
    xs, ys = s.chunk(0, 16)
    a, b = s.chunk(0, 5), s.chunk(5, 16)
    assert torch.equal(xs, torch.cat([a[0], b[0]]))
    assert torch.equal(ys, torch.cat([a[1], b[1]]))
    assert set(ys.unique().tolist()) <= {-1.0, 1.0}
    # its features are social_sparse's for the same seed
    social = streams.SocialStream(n=4000, nodes=3, rounds=64, seed=1,
                                  device="cpu")
    assert torch.equal(xs, social.chunk(0, 16)[0])


def test_heterogeneous_stream_samples_by_distribution():
    s = streams.HeterogeneousStream(n=64, nodes=4000, rounds=4,
                                    scale_spread=0.5, noise_max=0.2, seed=2,
                                    device="cpu")
    z = torch.log(s.node_scales()) / 0.5            # lognormal -> N(0, 1)
    assert abs(float(z.mean())) < 0.06 and abs(float(z.std()) - 1) < 0.06
    rates = s.node_noise_rates()
    assert 0 <= float(rates.min()) and float(rates.max()) < 0.2
    assert abs(float(rates.mean()) - 0.1) < 0.005
    xs, ys = s.chunk(0, 4)
    norms = xs.norm(dim=-1).mean(dim=0)              # ~ each node's scale
    ratio = norms / s.node_scales()
    assert float((ratio - 1).abs().mean()) < 0.1
    assert set(ys.unique().tolist()) <= {-1.0, 1.0}


def test_bursty_stream_samples_by_distribution():
    s = streams.BurstyStream(n=32, nodes=400, rounds=50, burst_max=8,
                             tail=1.5, seed=3, device="cpu")
    c = s.counts(0, 50).float()
    assert float(c.min()) == 1 and float(c.max()) == 8
    for k in (2, 4):                                 # P(c >= k) = k^-tail
        assert abs(float((c >= k).float().mean()) - k ** -1.5) < 0.015
    assert abs(float((c == 8).float().mean()) - 8 ** -1.5) < 0.01
    xs, ys = s.chunk(0, 6)
    # a burst of c unit-variance samples has mean-square 1/c per feature
    ms = (xs * xs).mean(dim=-1) * 32
    ratio = (ms * s.counts(0, 6)).mean()
    assert abs(float(ratio) - 1.0) < 0.05
    assert set(ys.unique().tolist()) <= {-1.0, 1.0}
    with pytest.raises(ValueError, match="burst_max"):
        streams.BurstyStream(n=4, nodes=2, rounds=2, burst_max=0)
    with pytest.raises(ValueError, match="period"):
        streams.DriftStream(n=4, nodes=2, rounds=2, period=0)
