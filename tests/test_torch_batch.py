"""Seed batches in the port: `repro_torch.api.run_batch` and the seed axis of
the round kernels, against per-seed runs and against `repro.api.run_batch`.

`run_batch` steps S seeds of one configuration together: theta and the delay
ring carry a leading seed axis, each seed keeps its own generator, and on
``backend="cuda"`` one ``round_stats`` and one ``round_update`` (or
``dual_step``) launch serve all S seeds. The contract held here:

* the batched plain kernels equal S stacked one-seed calls bit for bit and
  match the Pallas kernels under ``jax.vmap`` (interpret mode) within the
  5e-6 float contract, ``nnz`` exact;
* every seed's RunResult equals its own ``run()`` bit for bit (timing
  aside), on both engines, both backends, with and without delay and
  faults, and through a checkpoint and resume;
* on the reference's per-seed stream chunks and Laplace draws (injected,
  the draws served in the port's order: round by round, seed by seed) the
  port's batch matches the reference's: ``correct``, ``sparsity`` and
  ``eps_ledger`` exact, ``final_w``, ``loss`` and ``w_bar_loss`` within
  5e-6.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import run_batch as jrun_batch  # noqa: E402
from repro.core.privacy import sample_laplace as jsample_laplace  # noqa: E402
from repro.kernels import round_fused as jrf  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run, run_batch  # noqa: E402
from repro_torch.api import seed_vectorizable  # noqa: E402
from repro_torch.api.mechanisms import LaplaceMechanism  # noqa: E402
from repro_torch.core.graph import SparseGraph, ring_edges  # noqa: E402
from repro_torch.kernels import round_fused as rf  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

SEEDS = (0, 1, 2)
ATOL = 5e-6
EXACT = ("correct", "sparsity", "eps_ledger")
CLOSE = ("final_w", "loss", "w_bar_loss")
# RunResult fields a batch may report otherwise than its seeds' runs
TIMING = {"wall_clock", "rounds_per_sec"}
TIMING_METRICS = {"wall_clock_s", "rounds_per_sec", "batch"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _stacked(fn, *batched):
    """``fn`` called once per seed on the seeds' slices, stacked."""
    outs = [fn(*row) for row in zip(*batched)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def _pad(a: np.ndarray, m_pad: int, n_pad: int | None = None):
    """Zero-pad the last one or two axes of a seed batch for Pallas."""
    width = [(0, 0)] * (a.ndim - 2 if n_pad is not None else a.ndim - 1)
    width += [(0, m_pad - a.shape[-2 if n_pad is not None else -1])]
    if n_pad is not None:
        width += [(0, n_pad - a.shape[-1])]
    return jnp.asarray(np.pad(a, width))


# -- (a) the kernels' seed axis (plain versions) -------------------------------

@pytest.mark.parametrize("prox_l1", [True, False])
@pytest.mark.parametrize("S,m,n", [(3, 6, 40), (2, 10, 130), (5, 3, 64)])
def test_batched_round_stats(S, m, n, prox_l1):
    rng = np.random.default_rng(S * m * n)
    theta = rng.standard_normal((S, m, n)).astype(np.float32)
    x = (rng.standard_normal((S, m, n)) / np.sqrt(n)).astype(np.float32)
    lam = 0.37
    got = rf.round_stats(_t(theta), _t(x), lam, m, prox_l1=prox_l1)
    assert [tuple(g.shape) for g in got] == [(S, m)] * 4 + [(S, n)]
    # a batch is S one-seed calls, bit for bit
    one = _stacked(lambda t, xx: rf.round_stats(t, xx, lam, m,
                                                prox_l1=prox_l1),
                   _t(theta), _t(x))
    for g, o in zip(got, one):
        assert torch.equal(g, o)
    # and the Pallas kernel under the seed vmap within the contract
    m_pad, n_pad = jrf._pad_rows(m), jrf._pad_cols(n)
    want = jax.vmap(lambda t, xx: jrf.round_stats(
        t, xx, jnp.float32(lam), m, prox_l1=prox_l1, interpret=True))(
        _pad(theta, m_pad, n_pad), _pad(x, m_pad, n_pad))
    np.testing.assert_array_equal(
        got[2].numpy(), np.asarray(want[2])[:, :m].astype(np.int32))
    for k in (0, 1, 3):
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(want[k])[:, :m],
                                   rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4])[:, :n],
                               rtol=ATOL, atol=ATOL)


def _mix(name: str, m: int, rng):
    """(A, csr) of a mix: the ring and the hypercube through their CSR
    forms (the sparse path on a card), a softmax A (the dense path)."""
    if name == "softmax":
        logits = rng.standard_normal((m, m))
        return (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                ).astype(np.float32), None
    graph = ring_edges(m) if name == "ring" else SparseGraph.make(name, m)
    return graph.to_dense().astype(np.float32), rf.sparse_mix(graph, "cpu")


@pytest.mark.parametrize("mix", ["softmax", "ring", "hypercube"])
@pytest.mark.parametrize("noise_self", [True, False])
@pytest.mark.parametrize("use_recv", [0, 1])
def test_batched_round_update(mix, use_recv, noise_self):
    S, m, n = 3, 8, 72
    rng = np.random.default_rng(
        [["softmax", "ring", "hypercube"].index(mix), use_recv, noise_self])
    theta, recv = (rng.standard_normal((S, m, n)).astype(np.float32)
                   for _ in range(2))
    delta = (0.1 * rng.standard_normal((S, m, n))).astype(np.float32)
    x = (rng.standard_normal((S, m, n)) / np.sqrt(n)).astype(np.float32)
    coeff = rng.standard_normal((S, m)).astype(np.float32)
    alive = np.ones((S, m), np.float32)
    alive[1, 2] = 0.0            # a crash-frozen row in one seed only
    A, csr = _mix(mix, m, rng)
    diag = np.ascontiguousarray(np.diagonal(A))
    batched = (_t(theta), _t(delta), _t(x), _t(recv), _t(coeff))
    got = rf.round_update(_t(A), *batched, _t(diag), _t(alive), 0.25,
                          use_recv, noise_self, csr=csr)
    assert [tuple(g.shape) for g in got] == [(S, m, n)] * 2
    one = _stacked(lambda th, d, xx, rv, cf, al: rf.round_update(
        _t(A), th, d, xx, rv, cf, _t(diag), al, 0.25, use_recv, noise_self,
        csr=csr), *batched, _t(alive))
    for g, o in zip(got, one):
        assert torch.equal(g, o)
    np.testing.assert_array_equal(got[0].numpy()[1, 2], theta[1, 2])
    m_pad, n_pad = jrf._pad_rows(m), jrf._pad_cols(n)
    want = jax.vmap(lambda th, d, xx, rv, cf, al: jrf.round_update(
        _pad(A, m_pad, m_pad), th, d, xx, rv, cf, _pad(diag, m_pad), al,
        jnp.float32(0.25), jnp.float32(use_recv), noise_self,
        interpret=True))(*(_pad(a, m_pad, n_pad)
                           for a in (theta, delta, x, recv)),
                         _pad(coeff, m_pad), _pad(alive, m_pad))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :m, :n],
                                   rtol=ATOL, atol=ATOL)


def test_batched_wrappers_check_the_seed_axis():
    S, m, n = 2, 4, 16
    theta = torch.zeros((S, m, n))
    with pytest.raises(ValueError, match="x must have shape"):
        rf.round_stats(theta, torch.zeros((m, n)), 0.1, m)
    A, diag = torch.eye(m), torch.ones(m)
    with pytest.raises(ValueError, match="coeff must have shape"):
        rf.round_update(A, theta, theta, theta, theta, torch.zeros(m), diag,
                        torch.ones((S, m)), 0.1, 0, True)
    with pytest.raises(ValueError, match="diag must have shape"):
        rf.round_update(A, theta, theta, theta, theta, torch.zeros((S, m)),
                        torch.ones((S, m)), torch.ones((S, m)), 0.1, 0, True)
    with pytest.raises(ValueError, match="or \\(S, m, n\\)"):
        rf.round_stats(torch.zeros((1, S, m, n)), torch.zeros((1, S, m, n)),
                       0.1, m)


# -- (b) run_batch == per-seed run(), bit for bit -----------------------------

def _spec(**kw):
    base = dict(nodes=4, dim=24, horizon=20, eps=1.0, alpha0=0.5, lam=0.01,
                calibration="coordinate", stream="drift",
                stream_options={"period": 7})
    base.update(kw)
    return RunSpec(**base)


def assert_same_run(batch, seq, what):
    """Every RunResult field of a batch's seed equals the seed's own run,
    exactly (timing aside), and so does its final engine state."""
    for f in dataclasses.fields(seq):
        if f.name in TIMING | {"final_state"}:
            continue
        a, b = getattr(batch, f.name), getattr(seq, f.name)
        if f.name == "metrics":
            a, b = ({k: v for k, v in d.items() if k not in TIMING_METRICS}
                    for d in (a, b))
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b)
        assert same, f"{what}: {f.name} differs"
    st, sst = batch.final_state, seq.final_state
    assert type(st) is type(sst) and st.t == sst.t, what
    for a, b in zip(*(jax.tree_util.tree_leaves(
            {"theta": s.theta, "history": s.history}) for s in (st, sst))):
        assert torch.equal(a, b), f"{what}: final state differs"
    assert torch.equal(st.generator.get_state(), sst.generator.get_state())


BACKENDS = {"reference": {}, "cuda-fused": {"mode": "fused"},
            "cuda-hybrid": {"mode": "hybrid"}}
# a dcn-style scenario at this size: link drops, crashes and stragglers
# inside the horizon, on the ring (a faulty mixer runs hybrid on cuda)
DCN = dict(faults="dcn", faults_options={"crash_rate": 0.5,
                                         "straggler_rate": 0.5,
                                         "link_rate": 0.2, "seed": 5})


def _backend(name: str) -> dict:
    return dict(backend=name.split("-")[0], backend_options=BACKENDS[name])


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_run_batch_equals_per_seed_runs(engine, delay, backend):
    spec = _spec(delay=delay, **_backend(backend))
    cfg = ExecConfig(chunk_rounds=7, warmup=False)
    batch = run_batch(spec, SEEDS, engine, exec=cfg, device="cpu")
    assert len(batch) == len(SEEDS)
    for s, res in zip(SEEDS, batch):
        seq = run(spec.replace(seed=s), engine, exec=cfg, device="cpu")
        assert_same_run(res, seq, f"{engine} delay={delay} {backend} "
                        f"seed {s}")
    # the batch's totals, as the reference reports them
    info = batch[0].metrics["batch"]
    assert info["seeds"] == list(SEEDS) and info["devices"] == 1
    assert info["pad_seeds"] == 0
    assert batch[0].wall_clock == pytest.approx(info["wall_clock_s"] / 3)
    assert info["seed_rounds_per_sec"] == batch[0].rounds_per_sec


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_run_batch_under_faults_equals_per_seed_runs(engine, backend):
    """Every seed runs the scenario's one fault pattern (FaultSpec.seed is
    the scenario's), on the cuda backend (auto mode) through the hybrid
    path with one dual_step over the S*m rows."""
    spec = _spec(delay=1, backend=backend, **DCN)
    cfg = ExecConfig(chunk_rounds=6, warmup=False)
    batch = run_batch(spec, SEEDS, engine, exec=cfg, device="cpu")
    for s, res in zip(SEEDS, batch):
        seq = run(spec.replace(seed=s), engine, exec=cfg, device="cpu")
        assert_same_run(res, seq, f"faults {engine} {backend} seed {s}")
    assert batch[0].connectivity.min() < 1.0
    assert min(batch[0].privacy["participated_rounds"]) < spec.horizon
    assert batch[0].metrics["faults"] == batch[2].metrics["faults"]


def test_cuda_batch_launches_each_round_kernel_once_a_round(monkeypatch):
    """On the cuda backend a batch round is one round_stats and one
    round_update call for all seeds (fused), or one round_stats and one
    dual_step over the S*m rows (hybrid)."""
    calls = []
    for name in ("round_stats", "round_update", "dual_step"):
        fn = getattr(rf, name)
        monkeypatch.setattr(rf, name, functools.partial(
            lambda fn, name, *a, **k: calls.append(
                (name, tuple(a[1 if name == "round_update" else 0].shape)))
            or fn(*a, **k), fn, name))
    cfg = ExecConfig(chunk_rounds=5, warmup=False, compute_regret=False)
    for mode, second in (("fused", "round_update"), ("hybrid", "dual_step")):
        calls.clear()
        run_batch(_spec(horizon=5, backend="cuda",
                        backend_options={"mode": mode}), SEEDS, exec=cfg,
                  device="cpu")
        rows = (3, 4, 24) if second == "round_update" else (12, 24)
        assert calls == [("round_stats", (3, 4, 24)), (second, rows)] * 5


# -- (c) against repro.api.run_batch on injected draws -------------------------

M, N, T = 6, 200, 12
JBASE = dict(nodes=M, dim=N, horizon=T, alpha0=0.5, lam=0.05, eps=1.0,
             calibration="coordinate", clip_norm=1.0)


@dataclasses.dataclass(frozen=True)
class ReplayStream:
    """One seed's reference stream chunks, handed to the port."""

    xs: np.ndarray
    ys: np.ndarray
    disjoint: bool = True
    nodes: int = M
    n: int = N
    rounds: int = T

    def chunk(self, t0, t1):
        return torch.tensor(self.xs[t0:t1]), torch.tensor(self.ys[t0:t1])


@dataclasses.dataclass(frozen=True, eq=False)
class ReplayLaplace(LaplaceMechanism):
    """The port's Laplace mechanism serving the reference's unit draws in
    the order the port's batch draws them: round by round, seed by seed."""

    draws: object = None      # iterator over (m, n) float32 arrays

    def unit(self, generator, shape):
        u = next(self.draws)
        assert u.shape == tuple(shape)
        return torch.tensor(u)


@functools.lru_cache(maxsize=None)
def _reference_inputs():
    """Per seed: the reference stream's chunks and its round's unit Laplace
    draws (``key, sub = split(key)``, then ``sample_laplace(sub)``)."""
    out = {}
    for s in SEEDS:
        xs, ys = (np.asarray(a) for a in
                  JRunSpec(**JBASE, seed=s).resolve_stream().chunk(0, T))
        key, draws = jax.random.PRNGKey(s), []
        for _ in range(T):
            key, sub = jax.random.split(key)
            draws.append(np.asarray(jsample_laplace(sub, (M, N), 1.0)))
        out[s] = (xs, ys, draws)
    return out


# (port backend, mode) -> the reference backend it is held against
PAIRS = {("reference", None): ("reference", None),
         ("cuda", "fused"): ("pallas", "fused"),
         ("cuda", "hybrid"): ("pallas", "hybrid")}


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("backend,mode", list(PAIRS))
def test_run_batch_matches_reference_run_batch(monkeypatch, backend, mode,
                                               delay):
    jbackend, jmode = PAIRS[(backend, mode)]
    ref = jrun_batch(JRunSpec(**JBASE, delay=delay, backend=jbackend,
                              backend_options={"mode": jmode} if jmode
                              else {}),
                     SEEDS, exec=JExecConfig(chunk_rounds=5, warmup=False))
    inputs = _reference_inputs()
    streams = {s: ReplayStream(xs, ys) for s, (xs, ys, _) in inputs.items()}
    # each seed's spec resolves to that seed's replayed stream
    monkeypatch.setattr(RunSpec, "resolve_stream",
                        lambda self, device="cuda": streams[self.seed])
    mech = ReplayLaplace(eps=1.0, L=1.0, calibration="coordinate",
                         draws=iter([inputs[s][2][t] for t in range(T)
                                     for s in SEEDS]))
    spec = RunSpec(**JBASE, delay=delay, stream="social_sparse",
                   mechanism=mech, backend=backend,
                   backend_options={"mode": mode} if mode else {})
    port = run_batch(spec, SEEDS, exec=ExecConfig(chunk_rounds=5,
                                                  warmup=False),
                     device="cpu")
    for s, p, r in zip(SEEDS, port, ref):
        what = f"{backend}/{mode} delay={delay} seed {s}"
        for f in EXACT:
            np.testing.assert_array_equal(
                np.asarray(getattr(p, f)), np.asarray(getattr(r, f)),
                err_msg=f"{what}: {f} must match exactly")
        for f in CLOSE:
            d = np.abs(np.asarray(getattr(p, f))
                       - np.asarray(getattr(r, f))).max()
            assert d <= ATOL, f"{what}: {f} off by {d} (> {ATOL})"
        d = np.abs(p.regret - np.asarray(r.regret)).max()
        assert d <= 1e-4 * T * M, f"{what}: regret off by {d}"
        assert 0 < p.sparsity.max() and p.sparsity.min() < 1
    # the seeds really differ
    assert not np.array_equal(port[0].final_w, port[1].final_w)


# -- (d) checkpoints -------------------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "cuda-fused"])
def test_run_batch_checkpoint_resume_bit_identical(tmp_path, backend):
    """A batch that checkpoints and resumes mid-horizon continues exactly
    where the uninterrupted batch (and the sequential runs) would be: the
    checkpoint holds every seed's theta, delay ring and generator."""
    spec = _spec(delay=1, horizon=24, **_backend(backend))
    cfg = ExecConfig(chunk_rounds=6, warmup=False)
    full = run_batch(spec, SEEDS, exec=cfg, device="cpu")
    ck = str(tmp_path / "ck")
    first = run_batch(spec, SEEDS, horizon=12, exec=cfg.replace(
        checkpoint_every=12, checkpoint_dir=ck), device="cpu")
    assert first[0].rounds == 12
    resumed = run_batch(spec, SEEDS, exec=cfg.replace(
        checkpoint_dir=ck, resume=True, compute_regret=False), device="cpu")
    assert resumed[0].start_round == 12
    for f, r in zip(full, resumed):
        np.testing.assert_array_equal(f.final_w, r.final_w)
        np.testing.assert_array_equal(f.correct[12:], r.correct)
        np.testing.assert_array_equal(f.loss[12:], r.loss)
        np.testing.assert_array_equal(f.eps_ledger[12:], r.eps_ledger)
    seq = run(spec.replace(seed=SEEDS[1]), exec=cfg.replace(chunk_rounds=24),
              device="cpu")
    np.testing.assert_array_equal(seq.final_w, resumed[1].final_w)
    assert torch.equal(seq.final_state.generator.get_state(),
                       resumed[1].final_state.generator.get_state())


def test_run_batch_resume_when_already_complete(tmp_path):
    """Resuming a batch whose checkpoint is at the horizon returns empty
    trajectories, as run() does, for every seed."""
    spec = _spec(horizon=12)
    ck = str(tmp_path / "ck")
    cfg = ExecConfig(chunk_rounds=6, warmup=False, compute_regret=False)
    run_batch(spec, SEEDS, exec=cfg.replace(checkpoint_every=12,
                                            checkpoint_dir=ck), device="cpu")
    done = run_batch(spec, SEEDS, exec=cfg.replace(checkpoint_dir=ck,
                                                   resume=True),
                     device="cpu")
    assert len(done) == len(SEEDS)
    assert done[0].start_round == 12 and done[0].rounds == 12
    assert done[0].loss is None and done[0].accuracy is None
    assert done[0].eps_ledger.size == 0


def test_one_seed_checkpoint_does_not_resume_a_batch(tmp_path):
    spec = _spec(horizon=6)
    ck = str(tmp_path / "ck")
    cfg = ExecConfig(chunk_rounds=6, warmup=False, compute_regret=False)
    run(spec, exec=cfg.replace(checkpoint_every=6, checkpoint_dir=ck),
        device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        run_batch(spec.replace(horizon=12), SEEDS,
                  exec=cfg.replace(checkpoint_dir=ck, resume=True),
                  device="cpu")


# -- (e) seed_vectorizable ------------------------------------------------------

@pytest.mark.parametrize("fields,want", [
    (dict(mixer="ring"), True),
    (dict(mixer="complete"), True),
    (dict(mixer="hypercube"), True),
    (dict(mixer="ring", **DCN), True),
    (dict(delay=2, delay_dist="uniform"), False),
])
def test_seed_vectorizable(fields, want):
    assert seed_vectorizable(_spec(**fields), SEEDS) is want
    assert seed_vectorizable(_spec(**fields), (4,))


def test_run_batch_refuses_a_seed_dependent_mixer():
    spec = _spec(delay=2, delay_dist="uniform", horizon=8)
    cfg = ExecConfig(chunk_rounds=8, warmup=False, compute_regret=False)
    with pytest.raises(ValueError, match="depends on RunSpec.seed"):
        run_batch(spec, (0, 1), exec=cfg, device="cpu")
    with pytest.raises(ValueError, match="at least one seed"):
        run_batch(_spec(), (), exec=cfg, device="cpu")
    # check_vectorizable=False skips the check (for a caller that made it)
    out = run_batch(_spec(horizon=8), (0, 1), device="cpu",
                    exec=cfg.replace(check_vectorizable=False))
    assert len(out) == 2


# -- (f) the seed axis over a mesh ------------------------------------------------

@pytest.mark.parametrize("field,value", [("devices", 2), ("devices", "auto"),
                                         ("mesh", make_mesh((2,), ("seed",),
                                                            device="cpu"))])
def test_seed_sharding_is_refused_naming_the_queue(field, value):
    """The config's seed-sharding field shards the batch (no longer
    refused): every seed bit for bit the one-device batch, and the batch
    reports its seed shards and pad seeds ("auto" on the CPU is one
    device)."""
    cfg = ExecConfig(chunk_rounds=2, warmup=False, compute_regret=False)
    spec = _spec(horizon=4)
    sharded = run_batch(spec, SEEDS, exec=cfg.replace(**{field: value}),
                        device="cpu")
    plain = run_batch(spec, SEEDS, exec=cfg, device="cpu")
    D = 1 if value == "auto" else 2
    info = sharded[0].metrics["batch"]
    assert (info["devices"], info["pad_seeds"]) == (D, (-len(SEEDS)) % D)
    for a, b in zip(sharded, plain):
        for f in ("final_w", "loss", "correct", "w_bar_loss", "sparsity"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_run_batch_defaults_to_cuda_and_refuses_without_it():
    assert not torch.cuda.is_available()      # this suite runs on the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_batch(_spec(horizon=4), SEEDS)
