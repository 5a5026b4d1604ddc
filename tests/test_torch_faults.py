"""The port's fault injection (`repro_torch.faults`) against the JAX
package's (`repro.faults`), on the same seeded inputs.

Everything in a compiled schedule but the link drops is numpy in both
packages, and is held bit for bit: link numbering, crash windows,
stragglers, liveness and participation. The link drops the reference
draws with `jax.random`, which the port cannot reproduce; so, as the
stream and the Laplace draws of tests/test_torch_run.py, the reference's
keep masks are injected into the port (`ref_keeps` replaces
`FaultSchedule.link_keep`), and the port's own draw is checked by
distribution.

The contract: ``correct``, ``sparsity``, ``eps_ledger``, ``connectivity``,
``participated_rounds`` and ``metrics["faults"]`` exact; ``final_w``,
``loss`` and ``w_bar_loss`` within 5e-6; a mixer's outputs within 1e-6.
Inside the port, a zero-rate scenario is bit-identical to the clean run.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import MIXERS as JMIXERS  # noqa: E402
from repro.api import RunResult as JRunResult  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.core.privacy import sample_laplace as jsample_laplace  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch import ExecConfig, RunResult, RunSpec, run  # noqa: E402
from repro_torch.api import MIXERS  # noqa: E402
from repro_torch.api.backends import _dense_mix_form  # noqa: E402
from repro_torch.api.mechanisms import LaplaceMechanism  # noqa: E402
from repro_torch.core.graph import SparseGraph  # noqa: E402
from repro_torch.faults import (FAULTS, FaultSchedule, FaultSpec,  # noqa: E402
                                FaultyDenseMixer, FaultySparseMixer,
                                degradation, edge_link_idx, link_table,
                                rounds_to_recover, wrap_mixer)
from repro_torch.kernels import round_fused as rf  # noqa: E402

ATOL = 5e-6
MIX_ATOL = 1e-6
EXACT = ("correct", "sparsity", "eps_ledger", "connectivity")
CLOSE = ("final_w", "loss", "w_bar_loss")
M, N, T = 8, 64, 32
BASE = dict(nodes=M, dim=N, horizon=T, alpha0=0.5, lam=0.05,
            calibration="coordinate", clip_norm=1.0, seed=3)


def _jax_fault_spec(spec: FaultSpec):
    """The reference's FaultSpec with the same fields."""
    return jfaults.FaultSpec(**{f.name: getattr(spec, f.name)
                                for f in dataclasses.fields(spec)})


@functools.lru_cache(maxsize=None)
def _jax_keep(spec: FaultSpec, t: int, num_links: int) -> np.ndarray:
    # the keeps depend on the rate and the seed only
    sched = jfaults.FaultSpec(link_rate=spec.link_rate,
                              seed=spec.seed).compile(m=1)
    return np.asarray(sched.link_keep(t, num_links))


@pytest.fixture
def ref_keeps(monkeypatch):
    """Every port schedule draws the reference's per-round link keeps."""
    monkeypatch.setattr(
        FaultSchedule, "link_keep",
        lambda self, t, num_links: _jax_keep(self.spec, int(t),
                                             int(num_links)))


# -- schedules: numpy draws bit for bit ---------------------------------------

@pytest.mark.parametrize("topology,m", [("ring", 8), ("torus", 16),
                                        ("hypercube", 16), ("complete", 8)])
def test_link_numbering_matches_reference(topology, m):
    g = SparseGraph.make(topology, m)
    uniq, num = link_table(g.dst, g.src, m)
    juniq, jnum = jfaults.link_table(g.dst, g.src, m)
    np.testing.assert_array_equal(uniq, juniq)
    assert num == jnum
    for dst, src in ((g.dst, g.src), (g.src, g.dst)):
        idx, found = edge_link_idx(uniq, dst, src, m)
        jidx, jfound = jfaults.edge_link_idx(juniq, dst, src, m)
        np.testing.assert_array_equal(idx, jidx)
        np.testing.assert_array_equal(found, jfound)


PRESETS = [
    ("none", {}),
    ("links", {"link_rate": 0.3, "seed": 3}),
    ("partition", {"start": 3, "end": 9, "cut": 4}),
    ("crash", {"crash_rate": 0.5, "crash_rounds": 4, "seed": 1}),
    ("crash", {"crashes": ((2, 3, 7), (5, 0, 2))}),
    ("dcn", {}),
    ("dcn", {"crash_rate": 0.4, "straggler_rate": 0.4, "seed": 5}),
]


@pytest.mark.parametrize("name,options", PRESETS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(PRESETS)])
def test_schedule_matches_reference(name, options):
    sched = FAULTS.build(name, options).compile(m=M, horizon=T)
    ref = jfaults.FAULTS.build(name, options).compile(m=M, horizon=T)
    assert sched.crash_windows == ref.crash_windows
    assert sched.partitions == ref.partitions
    np.testing.assert_array_equal(sched.extra, ref.extra)
    assert sched.max_extra == ref.max_extra
    assert sched.has_crashes == ref.has_crashes
    np.testing.assert_array_equal(sched.alive_table(0, T),
                                  ref.alive_table(0, T))
    np.testing.assert_array_equal(sched.participation(3, T - 5),
                                  ref.participation(3, T - 5))
    for t in range(T + 3):
        np.testing.assert_array_equal(sched.alive_mask(t).numpy(),
                                      np.asarray(ref.alive_mask(t)))
        np.testing.assert_array_equal(sched.alive_f32(t).numpy(),
                                      np.asarray(ref.alive_f32(t)))


def test_dcn_at_the_papers_scale_draws_the_reference_windows():
    """m = 64, horizon 1,562 (the paper's run), fault seed 0."""
    sched = FAULTS.build("dcn").compile(m=64, horizon=1562)
    ref = jfaults.FAULTS.build("dcn").compile(m=64, horizon=1562)
    assert sched.crash_windows == ref.crash_windows == (
        (7, 1157, 1165), (10, 366, 374), (18, 172, 180), (35, 1153, 1161),
        (41, 1177, 1185))
    np.testing.assert_array_equal(sched.extra, ref.extra)
    assert np.flatnonzero(sched.extra).tolist() == [0, 14, 23, 24, 27, 35,
                                                    46, 63]
    part = sched.participation(0, 1562)
    np.testing.assert_array_equal(part, ref.participation(0, 1562))
    assert sorted(np.flatnonzero(part < 1562).tolist()) == [7, 10, 18, 35,
                                                            41]
    assert set(part.tolist()) == {1554, 1562}


def test_schedule_validation_matches_reference():
    assert FAULTS.names() == tuple(sorted(jfaults.FAULTS.names()))
    assert FAULTS.build("none").is_zero
    assert FAULTS.build("links", {"link_rate": 0.0}).is_zero
    with pytest.raises(ValueError, match="link_rate"):
        FaultSpec(link_rate=1.5)
    with pytest.raises(ValueError, match="horizon"):
        FaultSpec(crash_rate=0.5).compile(m=4)
    with pytest.raises(ValueError, match="cut"):
        FaultSpec(partitions=((0, 2, 4),)).compile(m=4)
    with pytest.raises(ValueError, match="out of range"):
        FaultSpec(crashes=((4, 0, 2),)).compile(m=4)
    with pytest.raises(ValueError, match="delay_dist"):
        RunSpec(**BASE, faults="links", delay=2,
                delay_dist="uniform").resolve_mixer()


# -- the port's own link draw, by distribution --------------------------------

def test_port_link_keep_is_a_pure_function_of_seed_and_round():
    spec = FaultSpec(link_rate=0.3, seed=7)
    a = spec.compile(m=8, horizon=10)
    b = spec.compile(m=8, horizon=5000)       # the horizon does not matter
    for t in (0, 5, 9):
        np.testing.assert_array_equal(a.link_keep(t, 16), b.link_keep(t, 16))
        np.testing.assert_array_equal(a.keep(t, 16).numpy(),
                                      b.keep(t, 16).numpy())
        np.testing.assert_array_equal(a.keep(t, 16).numpy(),
                                      a.link_keep(t, 16))
    assert not np.array_equal(a.link_keep(1, 64), a.link_keep(2, 64))
    assert not np.array_equal(a.link_keep(1, 64),
                              FaultSpec(link_rate=0.3, seed=8).compile(
                                  m=8).link_keep(1, 64))
    np.testing.assert_array_equal(
        FaultSpec(link_rate=0.0, seed=7).compile(m=8).link_keep(3, 40),
        np.ones(40, np.float32))


@pytest.mark.parametrize("rate", [0.05, 0.3, 0.9])
def test_port_link_keep_rate_within_binomial_bounds(rate):
    sched = FaultSpec(link_rate=rate, seed=2).compile(m=8)
    keeps = sched.link_keep_table(0, 2000, 32)
    assert keeps.dtype == np.float32 and set(np.unique(keeps)) <= {0.0, 1.0}
    n = keeps.size
    sigma = np.sqrt(n * rate * (1 - rate))
    assert abs(keeps.sum() - n * (1 - rate)) <= 5 * sigma


@pytest.mark.parametrize("mixer,options", [("sparse", {"topology": "ring"}),
                                           ("dense", {"topology": "ring"}),
                                           ("complete", {})])
def test_port_draw_keeps_both_directions_of_a_link(mixer, options):
    spec = RunSpec(**BASE, mixer=mixer, mixer_options=options,
                   faults="links", faults_options={"link_rate": 0.5})
    fm = spec.resolve_mixer()
    dropped = 0
    for t in range(6):
        A = fm.apply(torch.eye(M), t).numpy()
        np.testing.assert_allclose(A.sum(axis=1), 1.0, atol=MIX_ATOL)
        np.testing.assert_array_equal(A, A.T)
        dropped += int((A == 0).sum())
    assert dropped > 0


# -- mixers against the reference's, with its keeps injected -----------------

MIXER_FORMS = {"sparse-ring": ("sparse", {"topology": "ring"}, 8),
               "sparse-torus": ("sparse", {"topology": "torus"}, 8),
               "dense-ring": ("dense", {"topology": "ring"}, 8),
               "complete": ("complete", {}, 8)}


@pytest.mark.parametrize("fseed", [0, 3])
@pytest.mark.parametrize("rate", [0.3, 0.9])
@pytest.mark.parametrize("form", list(MIXER_FORMS))
def test_faulty_mixer_matches_reference(ref_keeps, form, rate, fseed):
    name, options, m = MIXER_FORMS[form]
    fspec = FaultSpec(link_rate=rate, seed=fseed, crashes=((2, 2, 6),),
                      partitions=((3, 7, m // 2),),
                      stragglers=((1, 1), (5, 2)))
    sched = fspec.compile(m=m, horizon=T)
    fm = wrap_mixer(MIXERS.build(name, options, m=m), sched)
    ref = jfaults.wrap_mixer(JMIXERS.build(name, options, m=m),
                             _jax_fault_spec(fspec).compile(m=m, horizon=T))
    assert type(fm).__name__ == type(ref).__name__
    assert (fm.delay, fm.base_delay, fm.num_links) == (ref.delay,
                                                       ref.base_delay,
                                                       ref.num_links)
    rng = np.random.default_rng(fseed)
    x = rng.standard_normal((m, 5)).astype(np.float32)
    clean = rng.standard_normal((m, 5)).astype(np.float32)
    hist = rng.standard_normal((fm.delay + 1, m, 5)).astype(np.float32)
    tx, tc, th = (torch.from_numpy(a) for a in (x, clean, hist))
    for t in range(9):
        pairs = [(fm.apply(tx, t), ref.apply(x, t)),
                 (fm.diag(t), ref.diag(t)),
                 (fm.mix(tc, tx, False, t), ref.mix(clean, x, False, t))]
        for noise_self in (True, False):
            pairs.append((fm.mix_history(tc, tx, th, noise_self, t),
                          ref.mix_history(clean, x, hist, noise_self, t)))
        for got, want in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=MIX_ATOL, rtol=0)
    conn, want = fm.connectivity(T), np.asarray(ref.connectivity(T))
    assert conn.dtype == want.dtype == np.float32
    if form == "sparse-torus":
        # weights of 1/3 and 1/6: the sums of surviving and of all
        # off-diagonal weight round by their summation order, which XLA
        # picks; elsewhere every weight is a power of two and they are exact
        np.testing.assert_allclose(conn, want, atol=MIX_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(conn, want)


def test_faulty_mixer_refusals_match_reference():
    sched = FaultSpec(link_rate=0.1).compile(m=6)
    assert isinstance(wrap_mixer(MIXERS.build("ring", m=6), sched),
                      FaultySparseMixer)
    assert isinstance(wrap_mixer(MIXERS.build("ring_alternating", m=6),
                                 sched), FaultyDenseMixer)
    with pytest.raises(ValueError, match="[Dd]isconnected"):
        wrap_mixer(MIXERS.build("disconnected", m=6), sched)
    het = RunSpec(nodes=6, dim=8, mixer="ring", delay=2,
                  delay_dist="uniform").resolve_mixer()
    with pytest.raises(ValueError, match="straggler"):
        wrap_mixer(het, sched)
    with pytest.raises(ValueError, match="m=4"):
        wrap_mixer(MIXERS.build("ring", m=6),
                   FaultSpec().compile(m=4))


def test_stragglers_widen_the_history_ring():
    spec = RunSpec(**BASE, delay=1, faults=FaultSpec(stragglers=((0, 2),)))
    mixer = spec.resolve_mixer()
    assert (mixer.delay, mixer.base_delay) == (3, 1)
    alg = spec.build_simulator()
    assert alg.delay == 3
    assert tuple(alg.init(0, "cpu").history.shape) == (4, M, N)
    st = spec.build_distributed().init({"w": torch.zeros(M, N)}, 0, "cpu")
    assert tuple(st.history["w"].shape) == (4, M, N)


# -- whole runs against repro.api.run -----------------------------------------

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

    draws: object = None      # iterator over (m, n) float32 arrays

    def unit(self, generator, shape):
        u = next(self.draws)
        assert u.shape == tuple(shape)
        return torch.tensor(u)


@pytest.fixture(scope="module")
def injected():
    """Reference stream chunks and unit Laplace draws for BASE."""
    stream = JRunSpec(**BASE).resolve_stream()
    xs, ys = (np.asarray(a) for a in stream.chunk(0, T))
    key = jax.random.PRNGKey(BASE["seed"])
    draws = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jsample_laplace(sub, (M, N), 1.0)))
    return xs, ys, draws


SCENARIOS = {
    # link drops, a crash, a partition and two stragglers on a sparse ring
    "composite": dict(mixer="sparse", mixer_options={"topology": "ring"},
                      faults=FaultSpec(link_rate=0.3, crashes=((2, 5, 12),),
                                       partitions=((8, 14, 4),),
                                       stragglers=((1, 1), (6, 2)),
                                       seed=3)),
    # the dcn preset, with crashes drawn inside the horizon, on the ring
    # (lowered to its sparse form) over a uniform delay
    "dcn": dict(mixer="ring", delay=1, faults="dcn",
                faults_options={"crash_rate": 0.4, "straggler_rate": 0.3,
                                "link_rate": 0.1, "seed": 5}),
    # the crash preset on a dense ring
    "crash-dense": dict(mixer="dense", mixer_options={"topology": "ring"},
                        faults="crash",
                        faults_options={"crash_rate": 0.5,
                                        "crash_rounds": 6, "seed": 1}),
}
# port backend -> the reference backend it is held against (a faulty
# mixer has no fixed form, so both cuda and pallas run hybrid)
BACKEND_PAIRS = {"reference": "reference", "cuda": "pallas"}


@functools.lru_cache(maxsize=None)
def _jax_run(scenario, backend, engine):
    fields = dict(SCENARIOS[scenario])
    if isinstance(fields["faults"], FaultSpec):
        fields["faults"] = _jax_fault_spec(fields["faults"])
    spec = JRunSpec(**BASE, **fields, backend=backend)
    return jrun(spec, engine=engine,
                exec=JExecConfig(chunk_rounds=10, warmup=False,
                                 compute_regret=False))


@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", list(BACKEND_PAIRS))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_faulty_run_matches_reference(ref_keeps, injected, scenario,
                                      backend, engine):
    xs, ys, draws = injected
    ref = _jax_run(scenario, BACKEND_PAIRS[backend], engine)
    mech = ReplayLaplace(eps=1.0, L=BASE["clip_norm"],
                         calibration=BASE["calibration"], draws=iter(draws))
    spec = RunSpec(**BASE, **SCENARIOS[scenario], backend=backend,
                   stream=ReplayStream(xs, ys), mechanism=mech)
    port = run(spec, engine=engine,
               exec=ExecConfig(chunk_rounds=10, warmup=False,
                               compute_regret=False), device="cpu")
    what = f"{scenario} {backend}/{engine}"
    for f in EXACT:
        np.testing.assert_array_equal(
            np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
            err_msg=f"{what}: {f} must match exactly")
    for f in CLOSE:
        d = np.abs(np.asarray(getattr(port, f))
                   - np.asarray(getattr(ref, f))).max()
        assert d <= ATOL, f"{what}: {f} off by {d} (> {ATOL})"
    assert port.privacy == ref.privacy
    assert port.metrics["faults"] == ref.metrics["faults"]
    # the scenario is not degenerate: something failed, and a node was
    # down for some rounds where the scenario crashes nodes
    assert port.connectivity.min() < 1.0
    if port.metrics["faults"]["crash_windows"]:
        assert min(port.privacy["participated_rounds"]) < T


def test_faulty_cuda_backend_runs_hybrid(monkeypatch):
    """A faulty mixer never reaches round_update: auto mode takes the
    hybrid path (dual_step every round), and mode='fused' raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("a faulty mixer reached round_update")

    calls = []
    dual = rf.dual_step
    monkeypatch.setattr(rf, "round_update", refuse)
    monkeypatch.setattr(rf, "dual_step",
                        lambda *a: calls.append(1) or dual(*a))
    cfg = ExecConfig(chunk_rounds=4, warmup=False, compute_regret=False)
    for engine in ("sim", "dist"):
        calls.clear()
        run(RunSpec(**{**BASE, "horizon": 8}, mixer="sparse",
                    faults="dcn", faults_options={"crash_rate": 0.5},
                    backend="cuda"), engine=engine, exec=cfg, device="cpu")
        assert len(calls) == 8
    with pytest.raises(ValueError, match="hybrid"):
        run(RunSpec(**{**BASE, "horizon": 8}, faults="links",
                    backend="cuda", backend_options={"mode": "fused"}),
            exec=cfg, device="cpu")


@pytest.mark.parametrize("mixer,options", [
    ("ring", {}), ("sparse", {"topology": "ring"}),
    ("sparse", {"topology": "torus"}), ("dense", {"topology": "ring"}),
    ("hypercube", {}), ("complete", {}), ("ring_alternating", {}),
    ("delayed", {"inner": "ring", "delay": 2})])
def test_no_faulty_mixer_has_a_fixed_form(mixer, options):
    """`_dense_mix_form` refuses every faulty mixer, even where the clean
    mixer has a fixed form — or the fused path would mix the clean graph
    and every fault would vanish."""
    spec = RunSpec(**BASE, mixer=mixer, mixer_options=options)
    faulty = spec.replace(faults="links").resolve_mixer()
    assert faulty.schedule is not None
    assert _dense_mix_form(faulty, torch.device("cpu")) is None

    class Subclassed(FaultySparseMixer, type(spec.resolve_mixer())):
        """A faulty mixer that also claims a fixed-form mixer's type."""

    if isinstance(faulty, FaultySparseMixer):
        faulty.__class__ = Subclassed
        assert _dense_mix_form(faulty, torch.device("cpu")) is None


# -- zero rates: bit-identical to the clean run --------------------------------

ZERO = dict(nodes=6, dim=8, horizon=10, eps=1.0, alpha0=0.5, lam=0.01,
            stream="drift", stream_options={"period": 3})


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("form", ["sparse", "dense"])
def test_zero_rate_is_bit_identical(form, engine, delay, backend):
    spec = RunSpec(**ZERO, mixer=form, mixer_options={"topology": "ring"},
                   delay=delay, backend=backend,
                   backend_options={"mode": "hybrid"}
                   if backend == "cuda" else {})
    zero = (dict(faults="links", faults_options={"link_rate": 0.0})
            if form == "sparse" else dict(faults="none"))
    cfg = ExecConfig(chunk_rounds=4, warmup=False, compute_regret=False)
    clean = run(spec, engine=engine, exec=cfg, device="cpu")
    faulty = run(spec.replace(**zero), engine=engine, exec=cfg, device="cpu")
    for f in ("final_w", "loss", "correct", "w_bar_loss", "sparsity",
              "eps_ledger"):
        np.testing.assert_array_equal(getattr(faulty, f), getattr(clean, f),
                                      err_msg=f)
    np.testing.assert_array_equal(faulty.connectivity,
                                  np.ones(10, np.float32))
    assert clean.connectivity is None and "faults" not in clean.metrics


# -- the crash freeze, the accountant and the metrics -------------------------

def test_crashed_node_freezes_and_rejoins():
    """Driving Algorithm1.round directly: node 2 is down for rounds 3-6."""
    spec = RunSpec(**ZERO, faults=FaultSpec(crashes=((2, 3, 7),)))
    alg = spec.build_simulator()
    stream = spec.resolve_stream(device="cpu")
    xs, ys = stream.chunk(0, 10)
    state = alg.init(0, "cpu")
    thetas = {0: state.theta.clone()}
    for t in range(10):
        state, _ = alg.round(state, (xs[t], ys[t]))
        thetas[t + 1] = state.theta.clone()
    for t in range(3, 7):            # frozen through the window ...
        assert torch.equal(thetas[t + 1][2], thetas[3][2])
        assert not torch.equal(thetas[t + 1][1], thetas[t][1])
    assert not torch.equal(thetas[8][2], thetas[7][2])   # ... then rejoins
    w, outs = alg.final_params(0, xs, ys, device="cpu")
    torch.testing.assert_close(w, alg.local_rule.primal(
        thetas[10], alg._ctx(10)), rtol=0, atol=0)
    assert outs.correct.shape == (10, 6)
    assert torch.equal(alg.run(0, xs, ys, device="cpu").loss, outs.loss)


def test_crashed_rounds_spend_no_eps():
    res = run(RunSpec(**ZERO, faults=FaultSpec(crashes=((2, 3, 7),))),
              exec=ExecConfig(chunk_rounds=4, warmup=False,
                              compute_regret=False), device="cpu")
    assert res.privacy["participated_rounds"] == [10, 10, 6, 10, 10, 10]
    assert res.privacy["eps_per_node_max"] == res.privacy["eps_per_round"]


def test_degradation_and_recovery_match_reference():
    cfg = ExecConfig(chunk_rounds=4, warmup=False)
    spec = RunSpec(**ZERO, mixer="sparse")
    clean = run(spec, exec=cfg, device="cpu")
    faulty = run(spec.replace(faults=FaultSpec(partitions=((3, 6, 3),))),
                 exec=cfg, device="cpu")
    conn = faulty.connectivity
    assert conn[:3].min() == 1.0 and conn[6:].min() == 1.0
    assert conn[3:6].max() < 1.0
    assert degradation(clean, faulty) == jfaults.degradation(clean, faulty)
    assert degradation(clean, faulty)["min_connectivity"] < 1.0
    rng = np.random.default_rng(0)
    for heal, tol, window in ((2, 0.5, 2), (0, 0.1, 4), (5, 1e-3, 3)):
        a = rng.random(12)
        b = a + rng.random(12) * np.linspace(1, 0, 12)
        assert rounds_to_recover(a, b, heal, tol, window) == \
            jfaults.rounds_to_recover(a, b, heal, tol, window)
    with pytest.raises(ValueError):
        rounds_to_recover(np.zeros(8), np.ones(5), heal_round=2)


# -- the RunResult surface ------------------------------------------------------

def test_run_result_surface_matches_reference():
    cfg = ExecConfig(chunk_rounds=4, warmup=False)
    res = run(RunSpec(**ZERO, faults="links"), exec=cfg, device="cpu")
    jres = JRunResult(engine="sim", rounds=res.rounds,
                      wall_clock=res.wall_clock,
                      rounds_per_sec=res.rounds_per_sec, stream=res.stream,
                      privacy=res.privacy, correct=res.correct,
                      regret=res.regret, accuracy=res.accuracy)
    assert res.summary() == jres.summary()
    assert list(res.summary()) == list(jres.summary())
    assert res.metrics == {**res.summary(), "faults": res.metrics["faults"]}
    for window in (1, 3, 5):
        np.testing.assert_array_equal(res.accuracy_curve(window),
                                      jres.accuracy_curve(window))


@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_record_round_trips_connectivity_and_metrics(engine):
    import json
    res = run(RunSpec(**ZERO, faults="dcn",
                      faults_options={"crash_rate": 0.5}),
              engine=engine, exec=ExecConfig(chunk_rounds=4, warmup=False),
              device="cpu")
    back = RunResult.from_record(json.loads(json.dumps(res.to_record())))
    assert back.connectivity.dtype == res.connectivity.dtype == np.float32
    np.testing.assert_array_equal(back.connectivity, res.connectivity)
    assert back.metrics == res.metrics and "faults" in back.metrics
    assert back.privacy == res.privacy


def test_package_exports_the_faults():
    from repro_torch import faults
    for name in ("FAULTS", "FaultSpec", "wrap_mixer", "degradation",
                 "rounds_to_recover"):
        assert getattr(repro_torch, name) is getattr(faults, name)
        assert getattr(repro_torch.api, name) is getattr(faults, name)
    assert sorted(faults.__all__) == sorted(jfaults.__all__)
