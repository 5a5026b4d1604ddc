"""The port's topologies against the JAX package: every graph builder of the
paper's Fig. 3 and every mixer, on the same inputs.

The graph builders are numpy on both sides and draw from numpy's
``default_rng(seed)``, so their matrices, edge arrays, per-edge delays and
time-varying schedules must be equal bit for bit. The mixers run torch ops
against jnp ops and are held within 1e-6. Inside the port, each new mixer
must give bit-identical runs on the simulator and the distributed engine,
on both backends.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api import MIXERS as JMIXERS  # noqa: E402
from repro.api import mixers as jmixers  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run  # noqa: E402
from repro_torch.api import MIXERS  # noqa: E402
from repro_torch.api import mixers  # noqa: E402
from repro_torch.api.shard_node import sparse_graph_and_delay  # noqa: E402
from repro_torch.core import graph  # noqa: E402

SEEDS = [0, 1, 2]
MIX_TOL = 1e-6
# (topology, m) of GossipGraph.make: hypercube needs a power of two, torus a
# factorable m (int(sqrt(m)) rows)
TOPOLOGIES = [("ring", 7), ("torus", 12), ("complete", 5), ("hypercube", 16),
              ("random", 9), ("random", 16), ("disconnected", 4),
              ("time_varying", 7)]


def _ids(cases):
    return [f"{t}-m{m}" for t, m in cases]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("topology,m", TOPOLOGIES, ids=_ids(TOPOLOGIES))
def test_gossip_graph_matrices_match_bit_for_bit(topology, m, seed):
    got = graph.GossipGraph.make(topology, m, seed=seed)
    want = jgraph.GossipGraph.make(topology, m, seed=seed)
    assert got.name == want.name and got.m == want.m
    assert len(got.matrices) == len(want.matrices)
    for A, B in zip(got.matrices, want.matrices):
        assert A.dtype == B.dtype == np.float32
        np.testing.assert_array_equal(A, B)
        graph.assert_doubly_stochastic(A)
        assert graph.spectral_gap(A) == jgraph.spectral_gap(B)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("degree", [3, 4, 6])
def test_random_regular_and_metropolis_match_bit_for_bit(seed, degree):
    np.testing.assert_array_equal(
        graph.random_regular_matrix(11, degree=degree, seed=seed),
        jgraph.random_regular_matrix(11, degree=degree, seed=seed))
    adj = np.random.default_rng(seed).random((6, 6)) < 0.4
    adj = adj | adj.T
    np.fill_diagonal(adj, False)
    np.testing.assert_array_equal(graph.metropolis_hastings(adj),
                                  jgraph.metropolis_hastings(adj))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["ring_alternating", "random_matching"])
@pytest.mark.parametrize("m", [5, 8])
def test_time_varying_schedule_matches_bit_for_bit(kind, m, seed):
    got = graph.time_varying_schedule(m, kind=kind, seed=seed)
    want = jgraph.time_varying_schedule(m, kind=kind, seed=seed)
    assert len(got) == len(want)
    for A, B in zip(got, want):
        np.testing.assert_array_equal(A, B)
    with pytest.raises(ValueError, match="unknown time-varying"):
        graph.time_varying_schedule(m, kind="nope")


SPARSE = [("ring", 7), ("torus", 12), ("torus", 8), ("hypercube", 16),
          ("random", 9), ("random", 64), ("complete", 5)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("topology,m", SPARSE, ids=_ids(SPARSE))
def test_sparse_graph_edge_arrays_match_bit_for_bit(topology, m, seed):
    got = graph.SparseGraph.make(topology, m, seed=seed)
    want = jgraph.SparseGraph.make(topology, m, seed=seed)
    for f in ("dst", "src", "weight", "indptr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.degree(), want.degree())
    np.testing.assert_array_equal(got.diag(), want.diag())
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    assert got.is_symmetric() == want.is_symmetric() is True
    again = graph.SparseGraph.from_dense(got.to_dense(), name=topology)
    np.testing.assert_array_equal(again.to_dense(), got.to_dense())
    assert again.validate() is again


def test_edge_builders_and_neighbor_weights_match():
    for rows, cols in ((3, 4), (1, 5), (2, 2), (1, 1)):
        g, jg = graph.torus_edges(rows, cols), jgraph.torus_edges(rows, cols)
        np.testing.assert_array_equal(g.to_dense(), jg.to_dense())
        np.testing.assert_array_equal(g.to_dense(),
                                      graph.torus_matrix(rows, cols))
    assert graph.ring_neighbor_weights(0.4) == \
        jgraph.ring_neighbor_weights(0.4)
    assert graph.torus_neighbor_weights() == jgraph.torus_neighbor_weights()
    for bad in (np.ones((2, 3)), np.full((2, 2), 0.7),
                np.array([[1.5, -0.5], [-0.5, 1.5]])):
        with pytest.raises(ValueError):
            graph.assert_doubly_stochastic(bad)
        with pytest.raises(ValueError):
            jgraph.assert_doubly_stochastic(bad)
    with pytest.raises(ValueError, match="time_varying"):
        graph.SparseGraph.make("time_varying", 6)
    with pytest.raises(ValueError, match="power-of-two"):
        graph.GossipGraph.make("hypercube", 6)
    with pytest.raises(ValueError, match="unknown topology"):
        graph.GossipGraph.make("star", 6)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dist", ["constant", "uniform", "geometric"])
def test_sample_edge_delays_match_bit_for_bit(dist, seed):
    support = graph.hypercube_matrix(8) > 0
    for sup in (None, support):
        got = mixers.sample_edge_delays(8, 3, dist, seed, support=sup)
        want = jmixers.sample_edge_delays(8, 3, dist, seed, support=sup)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="delay_dist"):
        mixers.sample_edge_delays(4, 2, "pareto")


# every registered mixer, built the same way in both packages
MIXER_CASES = [
    ("ring", {}), ("complete", {}), ("disconnected", {}),
    ("ring_alternating", {}), ("hypercube", {}), ("random", {}),
    ("torus", {}), ("time_varying", {}),
    ("time_varying", {"kind": "random_matching"}),
    ("dense", {"topology": "complete"}),
    ("dense", {"topology": "ring", "delay": 2}),
    ("sparse", {"topology": "torus"}), ("sparse", {"topology": "hypercube"}),
    ("delayed", {"inner": "hypercube", "delay": 2}),
    ("het_delayed", {"inner": "hypercube", "delay": 2}),
    ("het_delayed", {"inner": "random", "delay": 3,
                     "delay_dist": "geometric"}),
]
M_MIX, N_MIX = 8, 37


def _mix_id(case):
    name, opts = case
    return name + "".join(f"-{k}={v}" for k, v in opts.items())


def _close(got, want, what):
    d = np.abs(got.numpy() - np.asarray(want)).max()
    assert d <= MIX_TOL, f"{what}: off by {d}"


@pytest.mark.parametrize("noise_self", [True, False])
@pytest.mark.parametrize("case", MIXER_CASES, ids=[_mix_id(c)
                                                   for c in MIXER_CASES])
def test_mixers_match_the_reference(case, noise_self):
    name, opts = case
    mixer = MIXERS.build(name, opts, m=M_MIX, seed=1)
    jmixer = JMIXERS.build(name, opts, m=M_MIX, seed=1)
    assert mixer.m == jmixer.m and mixer.delay == jmixer.delay
    assert type(mixer).__name__ == type(jmixer).__name__
    rng = np.random.default_rng(7)
    clean, tilde = (rng.standard_normal((M_MIX, N_MIX)).astype(np.float32)
                    for _ in range(2))
    depth = mixer.delay + 1
    hist = rng.standard_normal((depth, M_MIX, N_MIX)).astype(np.float32)
    leaf = rng.standard_normal((M_MIX, 3, 4)).astype(np.float32)
    T = lambda a: torch.tensor(a)  # noqa: E731
    J = jnp.asarray
    for t in (0, 1, 2, 5):
        _close(mixer.apply(T(tilde), t), jmixer.apply(J(tilde), t),
               f"apply t={t}")
        _close(mixer.apply(T(leaf), t), jmixer.apply(J(leaf), t),
               f"apply of a (m, 3, 4) leaf t={t}")
        np.testing.assert_array_equal(mixer.diag(t).numpy(),
                                      np.asarray(jmixer.diag(t)))
        if name != "het_delayed":
            _close(mixer.mix(T(clean), T(tilde), noise_self, t),
                   jmixer.mix(J(clean), J(tilde), noise_self, t),
                   f"mix t={t}")
        ring = None if not mixer.delay else T(hist)
        jring = None if not mixer.delay else J(hist)
        _close(mixer.mix_history(T(clean), T(tilde), ring, noise_self, t),
               jmixer.mix_history(J(clean), J(tilde), jring, noise_self, t),
               f"mix_history t={t}")


@pytest.mark.parametrize("topology", ["torus", "hypercube", "random", "ring",
                                      "complete"])
def test_sparse_mixer_sums_rows_as_the_dense_product_does(topology):
    """The edge-list mixer sums each row from 0 in ascending source order,
    one multiply-add per edge — the order of a dense product and of
    round_update's sparse path — so it equals the dense mixer on the same
    A bit for bit. A segment sum of separately rounded products did not,
    and on the card it put the reference backend's sparse torus run one
    zero off the fused one's `sparsity` within 64 rounds at the paper's
    scale (chip_smoke.py phase 9)."""
    sparse = MIXERS.build("sparse", {"topology": topology}, m=64, seed=0)
    dense = MIXERS.build("dense", {"topology": topology}, m=64, seed=0)
    x = torch.tensor(np.random.default_rng(8).standard_normal(
        (64, 300)).astype(np.float32))
    assert torch.equal(sparse.apply(x, 0), dense.apply(x, 0))


def test_het_delayed_mixer_refuses_what_the_reference_refuses():
    mixer = MIXERS.build("het_delayed", {"inner": "ring", "delay": 2}, m=6)
    x = torch.zeros(6, 3)
    with pytest.raises(NotImplementedError, match="mix_history"):
        mixer.mix_delayed(x, x, x, True, 0)
    with pytest.raises(ValueError, match="history ring"):
        mixer.mix_history(x, x, None, True, 0)
    with pytest.raises(ValueError, match="delays must be"):
        mixers.HeterogeneousDelayMixer(inner=mixer.inner,
                                       delays=np.zeros((5, 5)))
    with pytest.raises(TypeError, match="SparseGraph"):
        mixers.SparseMixer(graph=object())


@pytest.mark.parametrize("name,opts,fixed", [
    ("ring", {}, True), ("hypercube", {}, True), ("random", {}, True),
    ("torus", {}, True), ("dense", {"topology": "complete"}, True),
    ("sparse", {"topology": "torus"}, True),
    ("delayed", {"inner": "hypercube", "delay": 1}, True),
    ("complete", {}, False), ("disconnected", {}, False),
    ("ring_alternating", {}, False), ("time_varying", {}, False),
    ("het_delayed", {"inner": "ring", "delay": 1}, False),
])
def test_fixed_sparse_form_matches_the_reference(name, opts, fixed):
    """`sparse_graph_and_delay` lowers exactly the mixers the reference's
    does, to the same graph — the fused backend's auto mode follows it."""
    from repro.api.shard_node import sparse_graph_and_delay as jlower
    mixer = MIXERS.build(name, opts, m=16, seed=2)
    jmixer = JMIXERS.build(name, opts, m=16, seed=2)
    if not fixed:
        with pytest.raises(ValueError):
            sparse_graph_and_delay(mixer)
        with pytest.raises(ValueError):
            jlower(jmixer)
        return
    (g, d), (jg, jd) = sparse_graph_and_delay(mixer), jlower(jmixer)
    assert d == jd
    for f in ("dst", "src", "weight"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))


SIM_DIST = ["hypercube", "random", "torus", "complete", "disconnected",
            "ring_alternating", "time_varying", "dense-complete",
            "sparse-torus", "het_delayed"]
RUN_MIXERS = {
    "dense-complete": ("dense", {"topology": "complete"}),
    "sparse-torus": ("sparse", {"topology": "torus"}),
    "het_delayed": ("het_delayed", {"inner": "hypercube", "delay": 2,
                                    "delay_dist": "constant"}),
}


def mixer_spec(key):
    """(mixer, mixer_options) of a run-level topology case."""
    return RUN_MIXERS.get(key, (key, {}))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("key", SIM_DIST)
def test_sim_and_dist_are_bit_identical_for_each_mixer(key, backend):
    name, opts = mixer_spec(key)
    spec = RunSpec(nodes=8, dim=48, horizon=6, eps=1.0, alpha0=0.5,
                   lam=0.01, calibration="coordinate", seed=4, mixer=name,
                   mixer_options=opts, backend=backend)
    cfg = ExecConfig(chunk_rounds=4, warmup=False)
    sim = run(spec, engine="sim", exec=cfg, device="cpu")
    dist = run(spec, engine="dist", exec=cfg, device="cpu")
    for f in ("final_w", "loss", "w_bar_loss", "correct", "sparsity",
              "regret", "eps_ledger"):
        np.testing.assert_array_equal(getattr(dist, f), getattr(sim, f),
                                      err_msg=f)
    assert torch.equal(dist.final_state.theta["w"], sim.final_state.theta)
    if sim.final_state.history is not None:
        assert torch.equal(dist.final_state.history["w"],
                           sim.final_state.history)
