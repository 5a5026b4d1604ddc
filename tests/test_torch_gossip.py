"""The port's distributed engine (`repro_torch.core.gossip.GossipDP`, and
``run(engine="dist")``) against the JAX package's, on the same data and
noise.

As in tests/test_torch_run.py, the reference's `jax.random` draws are
injected, never pinned: its stream chunks go into the port through a
Stream instance, and its unit Laplace draws through a Mechanism that
replays them while the port applies its own scale. For a multi-leaf tree
the reference splits the round's key into one key per leaf, in leaf order
(dict keys sorted); the replay hands the port those draws in that order.

The contract (ROADMAP, North star): ``correct``, ``sparsity`` and
``eps_ledger`` exact; ``final_w``, ``loss``, ``w_bar_loss`` — and here the
engine state and the update's metrics — within 5e-6. Inside the port,
``run(engine="sim")`` and ``run(engine="dist")`` are bit-identical, as the
reference's tests/test_runner.py demands of the reference.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.core.privacy import sample_laplace as jsample_laplace  # noqa: E402

from repro_torch import ExecConfig, RunResult, RunSpec, run  # noqa: E402
from repro_torch.api.mechanisms import LaplaceMechanism  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.core.gossip import GossipState  # noqa: E402

ATOL = 5e-6
EXACT = ("correct", "sparsity", "eps_ledger")
CLOSE = ("final_w", "loss", "w_bar_loss")
FIELDS = EXACT + CLOSE + ("regret",)
M, N, T = 6, 200, 12
BASE = dict(nodes=M, dim=N, horizon=T, alpha0=0.5, lam=0.05,
            calibration="coordinate", clip_norm=1.0, seed=3)


@dataclasses.dataclass(frozen=True)
class ReplayStream:
    """The reference stream's chunks, handed to the port."""

    xs: np.ndarray
    ys: np.ndarray
    disjoint: bool = True

    @property
    def n(self):
        return self.xs.shape[2]

    @property
    def nodes(self):
        return self.xs.shape[1]

    @property
    def rounds(self):
        return self.xs.shape[0]

    def chunk(self, t0, t1):
        return torch.tensor(self.xs[t0:t1]), torch.tensor(self.ys[t0:t1])


@dataclasses.dataclass(frozen=True, eq=False)
class ReplayLaplace(LaplaceMechanism):
    """The port's Laplace mechanism with the reference's unit draws."""

    draws: object = None      # iterator over float32 arrays

    def unit(self, generator, shape):
        u = next(self.draws)
        assert u.shape == tuple(shape)
        return torch.tensor(u)


def _reference_draws(seed, rounds, shape):
    """The unit Laplace draws of the reference round, round by round (a
    single-leaf tree consumes the round's key as the simulator does)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jsample_laplace(sub, shape, 1.0)))
    return out


@pytest.fixture(scope="module")
def injected():
    stream = JRunSpec(**BASE).resolve_stream()
    xs, ys = (np.asarray(a) for a in stream.chunk(0, T))
    return xs, ys, _reference_draws(BASE["seed"], T, (M, N))


def _port_spec(injected, start=0, **kw):
    xs, ys, draws = injected
    base = {**BASE, **kw}
    mech = ReplayLaplace(eps=base.get("eps", 1.0), L=base["clip_norm"],
                         calibration=base["calibration"],
                         draws=iter(draws[start:]))
    return RunSpec(**base, stream=ReplayStream(xs, ys), mechanism=mech)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


# -- one GossipDP.update on a multi-leaf tree ---------------------------------

@pytest.mark.parametrize("delay", [0, 1])
@pytest.mark.parametrize("noise_self", [True, False])
def test_update_on_a_two_leaf_tree_matches_the_reference(noise_self, delay):
    """Two updates of a {"w": (m, n), "b": (m, 3, 5)} tree with the global
    (Lemma-1) calibration, whose noise scale counts every leaf's
    coordinates: theta, history and every metric within 5e-6."""
    m, n = 5, 24
    kw = dict(nodes=m, eps=2.0, alpha0=0.5, lam=0.05, clip_norm=1.0,
              calibration="global", noise_self=noise_self, delay=delay)
    jgdp = JRunSpec(**kw).build_distributed()
    rng = np.random.default_rng(11)
    params = {"w": rng.standard_normal((m, n)).astype(np.float32),
              "b": rng.standard_normal((m, 3, 5)).astype(np.float32)}
    grads = [{"w": (s * rng.standard_normal((m, n))).astype(np.float32),
              "b": (s * rng.standard_normal((m, 3, 5))).astype(np.float32)}
             for s in (3.0, 0.05)]         # clipped, then mostly not

    jstate = jgdp.init(jax.tree_util.tree_map(jnp.asarray, params),
                       jax.random.PRNGKey(4))
    draws, key = [], jstate.key
    for _ in grads:
        key, sub = jax.random.split(key)
        for k, shape in zip(jax.random.split(sub, 2), [(m, 3, 5), (m, n)]):
            draws.append(np.asarray(jsample_laplace(k, shape, 1.0)))
    mech = ReplayLaplace(eps=2.0, L=1.0, calibration="global",
                         noise_self=noise_self, draws=iter(draws))
    gdp = RunSpec(**kw, mechanism=mech).build_distributed()
    state = gdp.init({k: _t(v) for k, v in params.items()}, 4, device="cpu")

    for g in grads:
        jstate, jmetrics = jgdp.update(
            jstate, jax.tree_util.tree_map(jnp.asarray, g))
        state, metrics = gdp.update(state, {k: _t(v) for k, v in g.items()})
        assert sorted(metrics) == sorted(jmetrics)
        for k, v in metrics.items():
            assert abs(float(v) - float(jmetrics[k])) <= ATOL, k
        for leaf in ("w", "b"):
            d = np.abs(state.theta[leaf].numpy()
                       - np.asarray(jstate.theta[leaf])).max()
            assert d <= ATOL, f"theta[{leaf}] off by {d}"
            if delay:
                d = np.abs(state.history[leaf].numpy()
                           - np.asarray(jstate.history[leaf])).max()
                assert d <= ATOL, f"history[{leaf}] off by {d}"
    assert state.t == int(jstate.t) == 2
    assert next(mech.draws, None) is None       # every draw consumed


def test_gossip_mix_tree_and_per_node_clip_match_the_reference():
    from repro.api import MIXERS as JMIXERS
    from repro.core.gossip import gossip_mix_tree as jmix
    from repro.core.gossip import per_node_clip as jclip
    from repro_torch.api import MIXERS
    from repro_torch.core.gossip import gossip_mix_tree, per_node_clip
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((8, 32)).astype(np.float32),
            "b": rng.standard_normal((8, 4)).astype(np.float32)}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = {k: _t(v) for k, v in tree.items()}
    want = jmix(jtree, jax.random.PRNGKey(1), jnp.zeros(()),
                JMIXERS.build("ring", m=8), True, jnp.zeros((), jnp.int32))
    got = gossip_mix_tree(ttree, torch.Generator(), 0.0,
                          MIXERS.build("ring", m=8), True, 0)
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    jc, jn = jclip(jtree, 1.0)
    tc, tn = per_node_clip(ttree, 1.0)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=1e-7)


# -- run(engine="dist") against the reference's ---------------------------------

_JAX_RUNS = {}


def _jax_dist_run(backend, mode, eps, delay):
    key = (backend, mode, eps, delay)
    if key not in _JAX_RUNS:
        spec = JRunSpec(**BASE, eps=eps, delay=delay, backend=backend,
                        backend_options={"mode": mode} if mode else {})
        _JAX_RUNS[key] = jrun(spec, engine="dist",
                              exec=JExecConfig(chunk_rounds=6, warmup=False))
    return _JAX_RUNS[key]


# (port backend, mode) -> the reference backend it is held against
PAIRS = {
    ("reference", None): ("reference", None),
    ("cuda", "auto"): ("pallas", "auto"),
    ("cuda", "hybrid"): ("pallas", "hybrid"),
}


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("eps", [1.0, math.inf])
@pytest.mark.parametrize("backend,mode", list(PAIRS))
def test_dist_run_matches_the_reference_dist_run(injected, backend, mode,
                                                 eps, delay):
    ref = _jax_dist_run(*PAIRS[(backend, mode)], eps, delay)
    spec = _port_spec(injected, eps=eps, delay=delay, backend=backend,
                      backend_options={"mode": mode} if mode else {})
    port = run(spec, engine="dist",
               exec=ExecConfig(chunk_rounds=6, warmup=False), device="cpu")
    what = f"dist {backend}/{mode} eps={eps} delay={delay}"
    assert port.engine == "dist" and isinstance(port.final_state,
                                                GossipState)
    for f in EXACT:
        np.testing.assert_array_equal(
            np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
            err_msg=f"{what}: {f} must match exactly")
    for f in CLOSE:
        d = np.abs(np.asarray(getattr(port, f))
                   - np.asarray(getattr(ref, f))).max()
        assert d <= ATOL, f"{what}: {f} off by {d} (> {ATOL})"
    d = np.abs(port.final_state.theta["w"].numpy()
               - np.asarray(ref.final_state.theta["w"])).max()
    assert d <= ATOL, f"{what}: theta off by {d}"
    assert np.abs(port.regret - ref.regret).max() <= 1e-4 * T * M
    assert 0 < port.sparsity.max() and port.sparsity.min() < 1


# -- inside the port -------------------------------------------------------------

@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("backend,mode", list(PAIRS))
def test_sim_and_dist_are_bit_identical(backend, mode, delay):
    spec = RunSpec(**BASE, eps=1.0, delay=delay, backend=backend,
                   backend_options={"mode": mode} if mode else {})
    cfg = ExecConfig(chunk_rounds=5)
    sim = run(spec, engine="sim", exec=cfg, device="cpu")
    dist = run(spec, engine="dist", exec=cfg, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(dist, f), getattr(sim, f),
                                      err_msg=f)
    assert torch.equal(dist.final_state.theta["w"], sim.final_state.theta)
    assert torch.equal(dist.final_state.generator.get_state(),
                       sim.final_state.generator.get_state())


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_dist_checkpoint_resume_is_bit_stable(tmp_path, backend):
    spec = RunSpec(**{**BASE, "horizon": 10}, eps=1.0, delay=2,
                   backend=backend)
    cfg = ExecConfig(chunk_rounds=4, warmup=False, compute_regret=False)
    full = run(spec, engine="dist", exec=cfg, device="cpu")
    d = str(tmp_path / "ckpt")
    run(spec, engine="dist", horizon=6,
        exec=cfg.replace(checkpoint_every=6, checkpoint_dir=d), device="cpu")
    with np.load(tmp_path / "ckpt" / "ckpt_00000006.npz") as data:
        assert {"theta/w", "t", "history/w", "generator"} <= set(data.files)
    res = run(spec, engine="dist",
              exec=cfg.replace(checkpoint_dir=d, resume=True), device="cpu")
    assert res.start_round == 6
    np.testing.assert_array_equal(res.final_w, full.final_w)
    for f in ("loss", "correct", "sparsity", "w_bar_loss"):
        np.testing.assert_array_equal(getattr(res, f),
                                      getattr(full, f)[6:], err_msg=f)


@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_record_round_trip_is_exact(tmp_path, engine):
    """to_record -> JSON -> from_record gives back every field bit for bit,
    and the decoded engine state resumes the run bit-identically."""
    spec = RunSpec(**{**BASE, "horizon": 10}, eps=1.0, delay=2,
                   backend="cuda")
    cfg = ExecConfig(chunk_rounds=4, warmup=False)
    full = run(spec, engine=engine, exec=cfg.replace(compute_regret=False),
               device="cpu")
    part = run(spec, engine=engine, horizon=6, exec=cfg, device="cpu")
    rec = json.loads(json.dumps(part.to_record(include_state=True)))
    back = RunResult.from_record(rec)
    for f in FIELDS + ("accuracy", "rounds", "engine", "device", "privacy"):
        want, got = getattr(part, f), getattr(back, f)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            assert got == want, f
    st, want_st = back.final_state, part.final_state
    assert type(st) is type(want_st) and st.t == want_st.t == 6
    for a, b in ((st.theta, want_st.theta), (st.history, want_st.history)):
        a = a["w"] if engine == "dist" else a
        b = b["w"] if engine == "dist" else b
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(st.generator.get_state(),
                       want_st.generator.get_state())
    assert part.to_record()["final_state"] is None

    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 6, st)
    res = run(spec, engine=engine, exec=cfg.replace(
        checkpoint_dir=d, resume=True, compute_regret=False), device="cpu")
    np.testing.assert_array_equal(res.final_w, full.final_w)


def test_state_from_jax_carries_a_reference_gossip_state(tmp_path, injected):
    """The reference dist engine runs k rounds; its GossipState checkpoint
    (keys theta/w, t, history/w) carries into the port, and both run k more
    rounds on the same injected data and noise."""
    k = T // 2
    spec = JRunSpec(**BASE, eps=1.0, delay=2)
    cfg = JExecConfig(chunk_rounds=k, warmup=False, compute_regret=False)
    full = jrun(spec, engine="dist", exec=cfg)
    jdir = tmp_path / "jax"
    jrun(spec, engine="dist", horizon=k,
         exec=cfg.replace(checkpoint_every=k, checkpoint_dir=str(jdir)))
    state = state_from_jax(jdir / f"ckpt_{k:08d}.npz", "cpu", seed=3)
    assert isinstance(state, GossipState) and state.t == k
    assert tuple(state.theta["w"].shape) == (M, N)
    assert tuple(state.history["w"].shape) == (3, M, N)

    pdir = tmp_path / "port"
    save_checkpoint(str(pdir), k, state)
    port = run(_port_spec(injected, start=k, eps=1.0, delay=2),
               engine="dist",
               exec=ExecConfig(chunk_rounds=k, warmup=False,
                               compute_regret=False, resume=True,
                               checkpoint_dir=str(pdir)), device="cpu")
    assert port.start_round == k and port.rounds == T
    for f in ("correct", "sparsity"):
        np.testing.assert_array_equal(getattr(port, f),
                                      np.asarray(getattr(full, f))[k:])
    for f in ("loss", "w_bar_loss"):
        d = np.abs(getattr(port, f) - np.asarray(getattr(full, f))[k:]).max()
        assert d <= ATOL, f"{f} off by {d}"
    assert np.abs(port.final_w - full.final_w).max() <= ATOL
