"""The paper path's names of `repro.core`, `repro.data`, `repro.configs`,
`repro.kernels` and `repro.api.runner`, in the port, held to the reference
on the same numpy-seeded inputs.

Host math (`theorem2_bound`, `PrivacyConfig.scale_for`, the
`SocialLinearConfig` fields) equals the reference's exactly; tensor math
(`clip_by_l2`, `OnlineMirrorDescent`) within f32 rounding of it (the
reference's whole-array sums add in XLA's order); `sample_laplace_tree`
draws from a torch generator, so it is checked by distribution, as the
reference's own test checks its draws.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import social_linear as jsocial_linear  # noqa: E402
from repro.core import omd as jomd  # noqa: E402
from repro.core import privacy as jprivacy  # noqa: E402
from repro.core.regret import theorem2_bound as jtheorem2_bound  # noqa: E402

from repro_torch.configs import social_linear  # noqa: E402
from repro_torch.core import omd, privacy  # noqa: E402
from repro_torch.core.regret import theorem2_bound  # noqa: E402
from repro_torch.data import make_social_stream  # noqa: E402


# -- core/privacy.py ------------------------------------------------------------

def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((64, 12)).astype(np.float32),
            "b": rng.standard_normal((8,)).astype(np.float32) * 3,
            "h": [rng.standard_normal((5, 3)).astype(np.float32)]}


@pytest.mark.parametrize("max_norm", [0.01, 1.0, 5.0, 27.0, 1e3])
@pytest.mark.parametrize("seed", [0, 1])
def test_clip_by_l2_equals_the_reference(seed, max_norm):
    t = _tree(seed)
    want, want_norm = jprivacy.clip_by_l2(jax.tree.map(jnp.asarray, t),
                                          max_norm)
    got, norm = privacy.clip_by_l2(
        {"w": torch.from_numpy(t["w"]), "b": torch.from_numpy(t["b"]),
         "h": [torch.from_numpy(t["h"][0])]}, max_norm)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=2e-7)
    for a, b in ((got["w"], want["w"]), (got["b"], want["b"]),
                 (got["h"][0], want["h"][0])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=4e-7,
                                   atol=1e-9)
    post = math.sqrt(sum(float(torch.sum(torch.square(leaf)))
                         for leaf in (got["w"], got["b"], got["h"][0])))
    assert post <= max_norm * (1 + 1e-5)
    if float(norm) <= max_norm:                 # inside the ball: a no-op
        assert torch.equal(got["w"], torch.from_numpy(t["w"]))


@pytest.mark.parametrize("clip_style", ["global", "coordinate"])
@pytest.mark.parametrize("eps", [0.1, 1.0, 10.0, math.inf])
def test_privacy_config_scale_equals_the_reference_bit_for_bit(eps,
                                                               clip_style):
    for alpha_t in (1.0, 0.1, 1.0 / math.sqrt(7.0), 0.0253):
        for n in (1, 96, 10_000):
            kw = dict(eps=eps, L=1.3, clip_style=clip_style)
            got = privacy.PrivacyConfig(**kw).scale_for(alpha_t, n)
            want = np.asarray(jprivacy.PrivacyConfig(**kw).scale_for(
                alpha_t, n))
            assert isinstance(got, np.float32)
            assert got.tobytes() == want.astype(np.float32).tobytes()
    cfg = privacy.PrivacyConfig(eps=eps)
    assert cfg.is_private == (not math.isinf(eps))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jprivacy.PrivacyConfig(eps=eps))


@pytest.mark.parametrize("scale", [0.5, 2.0])
def test_sample_laplace_tree_by_distribution(scale):
    """One draw per leaf in the tree's leaf order, each Laplace(0, scale):
    mean 0, variance 2 b^2, E|x| = b; independent leaves; the dtype asked
    for; a zero scale gives zeros."""
    g = torch.Generator().manual_seed(0)
    t = {"b": torch.zeros(40_000), "a": [torch.zeros(200, 200),
                                         torch.zeros(3, dtype=torch.float64)]}
    noise = privacy.sample_laplace_tree(g, t, scale)
    assert noise["a"][1].dtype == torch.float64
    for x in (noise["b"], noise["a"][0].flatten()):
        x = x.double()
        assert abs(float(x.mean())) < 0.03 * scale
        assert float(x.var()) == pytest.approx(2 * scale ** 2, rel=0.05)
        assert float(x.abs().mean()) == pytest.approx(scale, rel=0.03)
    corr = np.corrcoef(noise["b"].numpy(),
                       noise["a"][0].flatten().numpy())[0, 1]
    assert abs(corr) < 0.05
    # the leaves draw in JAX's leaf order ("a" before "b"): the same
    # generator state gives "a"'s first leaf the first draw
    first = privacy.sample_laplace(torch.Generator().manual_seed(0),
                                   (200, 200), scale)
    assert torch.equal(noise["a"][0], first)
    half = privacy.sample_laplace_tree(g, t, scale, dtype=torch.float16)
    assert half["b"].dtype == torch.float16
    zero = privacy.sample_laplace_tree(g, t, 0.0)
    assert all(float(leaf.abs().max()) == 0.0
               for leaf in (zero["b"], zero["a"][0]))


# -- core/regret.py -------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.1, 1.0, 10.0, math.inf])
def test_theorem2_bound_equals_the_reference(eps):
    for args in ((1000, 64, 10_000, 1.0, 0.01, 2.0),
                 (1562, 64, 10_000, 1.0, 1e-3, 1.0),
                 (120, 8, 64, 1.0, 0.0, 0.5)):
        assert theorem2_bound(*args, eps=eps) == jtheorem2_bound(*args,
                                                                  eps=eps)
    lo, hi, inf = (theorem2_bound(1000, 64, 10_000, 1.0, 0.01, 2.0, eps=e)
                   for e in (0.1, 10.0, math.inf))
    assert lo > hi > inf > 0


# -- core/omd.py ----------------------------------------------------------------

@pytest.mark.parametrize("prox_kind", ["l1", "none", "group"])
@pytest.mark.parametrize("schedule", ["sqrt_t", "constant", "theorem2"])
def test_online_mirror_descent_follows_the_reference(schedule, prox_kind):
    """Six steps of init / primal / dual_step on the same gradients: the
    round counter, alpha_t bit for bit, theta and the primal within f32
    rounding."""
    cfg = dict(alpha0=0.7, schedule=schedule, lam=0.05, T=50,
               prox_kind=prox_kind)
    mine = omd.OnlineMirrorDescent(omd.OMDConfig(**cfg))
    ref = jomd.OnlineMirrorDescent(jomd.OMDConfig(**cfg))
    rng = np.random.default_rng(7)
    params = {"w": rng.standard_normal((4, 16)).astype(np.float32),
              "b": rng.standard_normal((4,)).astype(np.float32)}
    st = mine.init({k: torch.from_numpy(v) for k, v in params.items()})
    jst = ref.init({k: jnp.asarray(v) for k, v in params.items()})
    assert isinstance(st, omd.OMDState) and st.t == 0
    for step in range(6):
        assert np.float32(mine.alpha_t(st)).tobytes() == \
            np.asarray(ref.alpha_t(jst), np.float32).tobytes()
        w, jw = mine.primal(st), ref.primal(jst)
        for k in params:
            np.testing.assert_allclose(w[k].numpy(), np.asarray(jw[k]),
                                       rtol=1e-6, atol=1e-6)
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in params.items()}
        mixed = {k: 0.5 * (st.theta[k] + st.theta[k].roll(1, 0))
                 for k in params}
        jmixed = {k: 0.5 * (jst.theta[k] + jnp.roll(jst.theta[k], 1, 0))
                  for k in params}
        st = mine.dual_step(st, mixed, {k: torch.from_numpy(v)
                                        for k, v in grads.items()})
        jst = ref.dual_step(jst, jmixed, {k: jnp.asarray(v)
                                          for k, v in grads.items()})
        assert st.t == int(jst.t) == step + 1
        for k in params:
            np.testing.assert_allclose(st.theta[k].numpy(),
                                       np.asarray(jst.theta[k]),
                                       rtol=1e-6, atol=1e-6)


def test_omd_dual_step_equals_the_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    th, g = (rng.standard_normal((8, 33)).astype(np.float32) for _ in "tg")
    alpha = np.float32(0.37)
    got = omd.omd_dual_step({"w": torch.from_numpy(th)},
                            {"w": torch.from_numpy(g)}, alpha)
    want = jomd.omd_dual_step({"w": jnp.asarray(th)}, {"w": jnp.asarray(g)},
                              jnp.asarray(alpha))
    assert got["w"].numpy().tobytes() == np.asarray(want["w"]).tobytes()


def test_omd_equals_sgd_when_no_prox():
    """tests/test_optim.py's case: lam = 0, no prox — OMD is plain SGD."""
    cfg = omd.OMDConfig(alpha0=0.1, schedule="constant", lam=0.0,
                        prox_kind="none")
    opt = omd.OnlineMirrorDescent(cfg)
    state = opt.init({"w": torch.tensor([1.0, 2.0])})
    state = opt.dual_step(state, state.theta,
                          {"w": torch.tensor([0.5, -0.5])})
    np.testing.assert_allclose(opt.primal(state)["w"].numpy(), [0.95, 2.05],
                               rtol=1e-6)


# -- configs/social_linear.py and data/social.py -----------------------------

def test_social_linear_config_equals_the_reference_field_for_field():
    for mine, ref in ((social_linear.CONFIG, jsocial_linear.CONFIG),
                      (social_linear.smoke(), jsocial_linear.smoke())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        assert mine.rounds == ref.rounds
    assert [(f.name, f.type, f.default) for f in dataclasses.fields(
        social_linear.SocialLinearConfig)] == \
        [(f.name, f.type, f.default) for f in dataclasses.fields(
            jsocial_linear.SocialLinearConfig)]
    assert (social_linear.CONFIG.n, social_linear.CONFIG.nodes,
            social_linear.CONFIG.rounds) == (10_000, 64, 1_562)


def test_make_social_stream_of_the_smoke_config():
    cfg = social_linear.smoke()
    stream = make_social_stream(cfg, device="cpu")
    assert (stream.n, stream.nodes, stream.rounds, stream.sparsity_true,
            stream.seed) == (cfg.n, cfg.nodes, cfg.rounds, cfg.sparsity_true,
                             cfg.seed)
    xs, ys = stream.chunk(0, cfg.rounds)
    assert tuple(xs.shape) == (250, 8, 256) and tuple(ys.shape) == (250, 8)
    assert xs.dtype == ys.dtype == torch.float32
    assert set(torch.unique(ys).tolist()) == {-1.0, 1.0}
    assert 0.4 < float((ys > 0).float().mean()) < 0.6       # balanced labels
    # labels are the ground truth's signs (no label noise in the config)
    torch.testing.assert_close(
        ys, torch.where(xs @ stream.w_true >= 0, 1.0, -1.0))
    assert stream.disjoint
    # the reference's stream of the same config: the same shapes, balanced
    from repro.data import make_social_stream as jmake
    jstream = jmake(jsocial_linear.smoke())
    jx, jy = jstream.chunk(0, cfg.rounds)
    assert tuple(np.shape(jx)) == tuple(xs.shape)
    assert 0.4 < float(np.mean(np.asarray(jy) > 0)) < 0.6


def test_make_social_stream_runs_on_the_card_by_default():
    stream = make_social_stream(social_linear.smoke())
    assert stream.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            stream.chunk(0, 1)
