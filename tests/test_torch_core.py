"""The port's round math against the JAX package, module by module.

Inputs come from numpy with fixed seeds and go through both the reference
function and its `repro_torch` counterpart. Elementwise maps and host-side
scalar math (prox, schedules, noise scales, the accountant, the ring
history, the graph) must match exactly; reductions (norms, the ring mix,
the regret comparator) within float32 tolerances stated where they are
used. The port's Laplace sampler draws different numbers from JAX's, so it
is checked by distribution.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api import clippers as jclippers  # noqa: E402
from repro.api import mechanisms as jmech  # noqa: E402
from repro.api import mixers as jmixers  # noqa: E402
from repro.core import algorithm1 as jalg  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import omd as jomd  # noqa: E402
from repro.core import privacy as jpriv  # noqa: E402
from repro.core import prox as jprox  # noqa: E402
from repro.core import regret as jregret  # noqa: E402
from repro.data import social as jsocial  # noqa: E402

from repro_torch.api import clippers, mechanisms, mixers  # noqa: E402
from repro_torch.core import (algorithm1, graph, omd, privacy, prox,  # noqa: E402
                              regret)
from repro_torch.data import social  # noqa: E402


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _np(a):
    return np.asarray(a)


# -- prox --------------------------------------------------------------------

def test_soft_threshold_and_sparsity_match_exactly():
    rng = np.random.default_rng(0)
    p = rng.standard_normal((7, 301)).astype(np.float32)
    p[0, :5] = [0.3, -0.3, 0.0, -0.0, 0.2999999]
    for lam in (0.0, 0.3, 1.7):
        got = prox.soft_threshold(_t(p), lam).numpy()
        np.testing.assert_array_equal(got, _np(jprox.soft_threshold(
            jnp.asarray(p), lam)))
        assert float(prox.sparsity(_t(got))) == float(
            jprox.sparsity(jnp.asarray(got)))


# -- schedules ---------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sqrt_t", "theorem2", "constant"])
def test_alpha_schedules_and_step_context_match_exactly(kind):
    for alpha0 in (1.0, 0.1, 0.37):
        cfg = omd.OMDConfig(alpha0=alpha0, schedule=kind, lam=1e-3, T=1562)
        jcfg = jomd.OMDConfig(alpha0=alpha0, schedule=kind, lam=1e-3, T=1562)
        for t in (0, 1, 2, 3, 17, 1562):
            ctx, jctx = cfg.step_context(t), jcfg.step_context(jnp.int32(t))
            assert ctx.alpha_t == float(jctx.alpha_t), (kind, alpha0, t)
            assert ctx.lam_t == float(jctx.lam_t), (kind, alpha0, t)
    with pytest.raises(ValueError):
        omd.alpha_schedule("theorem2", 1.0)


# -- privacy -----------------------------------------------------------------

@pytest.mark.parametrize("calibration", ["global", "coordinate"])
def test_noise_scales_match_exactly(calibration):
    for eps in (0.1, 1.0, 3.0, math.inf):
        for n in (1, 200, 10_000):
            for alpha in (1.0, 0.35355338, 0.025):
                mech = mechanisms.LaplaceMechanism(eps=eps, L=0.7,
                                                   calibration=calibration)
                jm = jmech.LaplaceMechanism(eps=eps, L=0.7,
                                            calibration=calibration)
                a32 = np.float32(alpha)
                assert mech.scale(a32, n) == float(jm.scale(
                    jnp.float32(alpha), n)), (eps, n, alpha)
    assert float(privacy.laplace_scale(0.5, 100, 1.0, 2.0)) == float(
        jpriv.laplace_scale(jnp.float32(0.5), 100, 1.0, 2.0))
    assert float(privacy.sensitivity(0.5, 100, 1.0)) == float(
        jpriv.sensitivity(jnp.float32(0.5), 100, 1.0))


def test_sample_laplace_by_distribution():
    """Laplace(0, b): mean 0 and E|X| = b. With N = 400,000 draws the
    standard error of the mean is b*sqrt(2/N) ~ 0.0022*b and of mean|X| is
    b/sqrt(N) ~ 0.0016*b, so 0.02*b bounds are ~9 and ~12 standard errors
    wide at this fixed generator seed."""
    g = torch.Generator().manual_seed(1234)
    b = 2.5
    draws = privacy.sample_laplace(g, (400, 1000), b)
    assert draws.dtype == torch.float32 and bool(torch.isfinite(draws).all())
    assert abs(float(draws.mean())) < 0.02 * b
    assert abs(float(draws.abs().mean()) - b) < 0.02 * b
    # P(|X| > b ln 10) = 0.1 for Laplace(0, b)
    tail = float((draws.abs() > b * math.log(10)).float().mean())
    assert abs(tail - 0.1) < 0.005
    zeros = privacy.sample_laplace(g, (3, 4), 0.0)
    assert torch.equal(zeros, torch.zeros(3, 4))


def test_mechanism_sample_scales_its_unit_draws():
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    mech = mechanisms.LaplaceMechanism(eps=1.0)
    unit = mech.unit(g1, (4, 6))
    assert torch.equal(mech.sample(g2, (4, 6), 0.75), 0.75 * unit)
    assert torch.equal(mechanisms.NoNoise().sample(g1, (2, 2), 1.0),
                       torch.zeros(2, 2))


def test_privacy_accountant_matches_reference():
    for disjoint in (True, False):
        acc = privacy.PrivacyAccountant(1.5, disjoint_streams=disjoint)
        jacc = jpriv.PrivacyAccountant(1.5, disjoint_streams=disjoint)
        for k, part in ((3, None), (4, [4, 2, 0]), (2, None), (0, [0, 0, 0])):
            acc.step(k, participation=part)
            jacc.step(k, participation=part)
        assert acc.ledger() == jacc.ledger()
        assert acc.ledger(4) == jacc.ledger(4)
        assert acc.summary() == jacc.summary()
        np.testing.assert_array_equal(acc.per_node_guarantee(),
                                      jacc.per_node_guarantee())
    with pytest.raises(ValueError):
        privacy.PrivacyAccountant(1.0).step(2, participation=[3])


# -- clip --------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [1.0, 0.3])
def test_per_node_l2_clip_matches_reference(max_norm):
    rng = np.random.default_rng(3)
    g = rng.standard_normal((6, 257)).astype(np.float32)
    g[2] *= 1e-3                       # under the bound: untouched
    g[4] = 0.0                         # zero row: no division by zero
    got, norms = clippers.PerNodeL2Clipper(max_norm).clip(_t(g))
    want, jnorms = jclippers.PerNodeL2Clipper(max_norm).clip(jnp.asarray(g))
    np.testing.assert_allclose(norms.numpy(), _np(jnorms), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.numpy()[[2, 4]], g[[2, 4]])
    same, _ = clippers.NoClipper().clip(_t(g))
    np.testing.assert_array_equal(same.numpy(), g)


# -- graph -------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 3, 7])
def test_ring_graph_matches_reference(m):
    np.testing.assert_array_equal(graph.ring_matrix(m, 0.4),
                                  jgraph.ring_matrix(m, 0.4))
    g, jg = graph.ring_edges(m, 0.4), jgraph.ring_edges(m, 0.4)
    np.testing.assert_array_equal(g.to_dense(), jg.to_dense())
    np.testing.assert_array_equal(g.to_dense(), graph.ring_matrix(m, 0.4))
    np.testing.assert_array_equal(g.diag(), jg.diag())
    assert g.edges == jg.edges
    assert g.validate() is g
    with pytest.raises(ValueError):
        graph.SparseGraph(dst=[0], src=[0], weight=[0.5], m=1).validate()


# -- mixers and the history ring ---------------------------------------------

@pytest.mark.parametrize("noise_self", [True, False])
def test_ring_roll_mixer_matches_dense_matrix_and_reference(noise_self):
    m, n = 7, 130
    rng = np.random.default_rng(11)
    clean, tilde, recv = (rng.standard_normal((m, n)).astype(np.float32)
                          for _ in range(3))
    mixer = mixers.RingRollMixer(m=m, self_weight=0.5)
    jmixer = jmixers.RingRollMixer(m=m, self_weight=0.5)
    A = graph.ring_matrix(m, 0.5)
    np.testing.assert_allclose(mixer.apply(_t(tilde), 0).numpy(), A @ tilde,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(mixer.apply(_t(tilde), 0).numpy(),
                                  _np(jmixer.apply(jnp.asarray(tilde), 0)))
    np.testing.assert_array_equal(
        mixer.mix(_t(clean), _t(tilde), noise_self, 0).numpy(),
        _np(jmixer.mix(jnp.asarray(clean), jnp.asarray(tilde), noise_self,
                       0)))
    np.testing.assert_array_equal(
        mixer.mix_delayed(_t(clean), _t(tilde), _t(recv), noise_self,
                          0).numpy(),
        _np(jmixer.mix_delayed(jnp.asarray(clean), jnp.asarray(tilde),
                               jnp.asarray(recv), noise_self, 0)))


def test_history_ring_read_write_matches_reference():
    depth, m, n, d = 3, 2, 5, 2
    hist = torch.zeros((depth, m, n))
    jhist = jnp.zeros((depth, m, n))
    for t in range(7):
        value = np.full((m, n), t + 1.0, np.float32)
        hist = mixers.ring_write(hist, t, _t(value))
        jhist = jmixers.ring_write(jhist, jnp.int32(t), jnp.asarray(value))
        np.testing.assert_array_equal(hist.numpy(), _np(jhist))
        for lag in (0, 1, d):
            got = mixers.ring_read(hist, t, lag, _t(-value)).numpy()
            want = jmixers.ring_read(jhist, jnp.int32(t), lag,
                                     jnp.asarray(-value))
            np.testing.assert_array_equal(got, _np(want))
    delayed = mixers.DelayedMixer(mixers.RingRollMixer(m=4), delay=2)
    x = _t(np.arange(8.0).reshape(4, 2))
    with pytest.raises(ValueError):
        delayed.mix_history(x, x, None, True, 3)
    with pytest.raises(ValueError):
        mixers.DelayedMixer(mixers.RingRollMixer(m=4), delay=0)


# -- loss, labels, regret ----------------------------------------------------

def test_hinge_loss_and_grad_match_reference():
    rng = np.random.default_rng(4)
    w, x = (rng.standard_normal((5, 150)).astype(np.float32) for _ in range(2))
    y = np.sign(rng.standard_normal(5)).astype(np.float32)
    loss, grad = algorithm1.hinge_loss_and_grad(_t(w), _t(x), _t(y))
    jloss, jgrad = jalg.hinge_loss_and_grad(jnp.asarray(w), jnp.asarray(x),
                                            jnp.asarray(y))
    np.testing.assert_allclose(loss.numpy(), _np(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(grad.numpy(), _np(jgrad))


def test_labels_map_a_zero_logit_to_plus_one():
    logits = np.array([[-1.0, 0.0, -0.0, 2.0]], np.float32)
    got = social.labels_from_logits(_t(logits)).numpy()
    np.testing.assert_array_equal(got, _np(jsocial.labels_from_logits(
        jnp.asarray(logits))))
    np.testing.assert_array_equal(got, [[-1.0, 1.0, 1.0, 1.0]])


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_best_fixed_hinge_splits_the_margin_tie_like_jax_grad(steps):
    """X = I, Y = 1: one step lands every margin on exactly 1. jax.grad of
    maximum(1 - margin, 0) then takes half of -y x; torch autograd's tie
    rule would take none of it and stop moving."""
    X = np.eye(2, dtype=np.float32)[None]
    Y = np.ones((1, 2), np.float32)
    got = regret.best_fixed_hinge(_t(X), _t(Y), steps=steps).numpy()
    want = _np(jregret.best_fixed_hinge(jnp.asarray(X), jnp.asarray(Y),
                                        steps=steps))
    np.testing.assert_array_equal(got, want)
    if steps == 2:
        np.testing.assert_allclose(got, 1.0 + 2.0 / math.sqrt(2) * 0.25,
                                   rtol=1e-6)


def test_best_fixed_hinge_and_regret_match_reference():
    """1500 subgradient steps on a small stream. The two sides reduce X @ w
    and X^T @ g in different orders, and a margin within float error of 1
    switches the active set, so the comparators drift apart: by up to
    8e-4 per coordinate over five seeds at this size. The comparator is
    held to 2e-3. With the same comparator the regret curves agree to
    float32 rounding; with each side's own comparator the regret's
    comparator term — a sum of T*m hinge terms, each moving by ~1e-4 when w
    moves that much — is held to 1e-4 * T * m (measured: at most 1.5e-3
    here, on regrets of ~50)."""
    rng = np.random.default_rng(8)
    T, m, n = 12, 5, 60
    xs = (rng.standard_normal((T, m, n)) / np.sqrt(n)).astype(np.float32)
    ys = np.sign(rng.standard_normal((T, m))).astype(np.float32)
    wb = rng.uniform(0.5, 1.5, T).astype(np.float32)
    w = regret.best_fixed_hinge(_t(xs), _t(ys)).numpy()
    jw = _np(jregret.best_fixed_hinge(jnp.asarray(xs), jnp.asarray(ys)))
    np.testing.assert_allclose(w, jw, atol=2e-3)
    got = regret.cumulative_regret(wb, _t(xs), _t(ys), m, w_star=_t(jw))
    want = jregret.cumulative_regret(jnp.asarray(wb), jnp.asarray(xs),
                                     jnp.asarray(ys), m, w_star=jw)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    full = regret.cumulative_regret(wb, _t(xs), _t(ys), m)
    np.testing.assert_allclose(full, want, atol=1e-4 * T * m)


def test_social_stream_is_chunk_invariant_and_well_formed():
    s = social.SocialStream(n=37, nodes=3, rounds=10, seed=4,
                            label_noise=0.2, device="cpu")
    xs, ys = s.chunk(0, 10)
    xa, ya = s.chunk(0, 4)
    xb, yb = s.chunk(4, 10)
    assert torch.equal(xs, torch.cat([xa, xb]))
    assert torch.equal(ys, torch.cat([ya, yb]))
    assert set(ys.unique().tolist()) <= {-1.0, 1.0}
    w = s.w_true
    assert abs(float(torch.linalg.norm(w)) - 1.0) < 1e-5
    other = social.SocialStream(n=37, nodes=3, rounds=10, seed=5,
                                device="cpu")
    assert not torch.equal(other.chunk(0, 2)[0], xs[:2])
