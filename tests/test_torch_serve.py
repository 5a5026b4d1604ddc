"""repro_torch.serve against repro.serve: snapshots, admission, background
training, replay, async checkpoints.

Every case of tests/test_serve.py runs on the port (``device="cpu"``: the
kernels' plain versions). Beside them, the port's trainer is held to
`repro.serve`'s on the reference's injected stream chunks and Laplace draws
(`ReplayStream`, `ReplayLaplace`, as in tests/test_torch_run.py): every
published ``w`` and ``w_bar`` within 5e-6; the port's predict step serves a
JAX snapshot carried across by `snapshot_from_jax` as
`repro.serve.make_predict_fn` does (margins within 1e-5 of their largest
magnitude, labels exact); a crashed trainer resumes bit for bit; and two
threads that reach a kernel at first use build it once and share one
counter array.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.serve import BackgroundTrainer as JBackgroundTrainer  # noqa: E402
from repro.serve import ServeState as JServeState  # noqa: E402
from repro.serve import make_predict_fn as jmake_predict_fn  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    restore_checkpoint)
from repro_torch.convert import snapshot_from_jax  # noqa: E402
from repro_torch.serve import (BackgroundTrainer, BurstyReplay,  # noqa: E402
                               ServeConfig, ServeService, ServeState,
                               snapshot_from_state, verify_snapshot)
from test_torch_run import (ReplayLaplace, ReplayStream,  # noqa: E402
                            _reference_draws)

ATOL = 5e-6
CPU = "cpu"


def _spec(**kw):
    base = dict(nodes=4, dim=16, horizon=32, eps=1.0, alpha0=0.5, lam=0.01,
                stream="bursty")
    base.update(kw)
    return RunSpec(**base)


def _cfg(**kw):
    return ExecConfig(**{"chunk_rounds": 8, "warmup": False,
                         "compute_regret": False, **kw})


def _state(spec, **kw):
    return ServeState(spec, device=CPU, **kw)


def _trainer(spec, state, **kw):
    return BackgroundTrainer(spec, state, warmup=False, **kw)


def _service(spec, **kw):
    return ServeService(ServeConfig(spec=spec, device=CPU,
                                    **{"warmup": False, **kw}))


def _wait(cond, timeout=120.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


# -- runner on_chunk hook -----------------------------------------------------

@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_on_chunk_fires_at_every_boundary_with_live_state(backend):
    seen = []
    run(_spec(backend=backend), exec=_cfg(), device=CPU,
        on_chunk=lambda b, st, acc: seen.append((b, int(st.t))) and False)
    assert [b for b, _ in seen] == [8, 16, 24, 32]
    assert all(b == t for b, t in seen)     # state is synchronized to b


@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_on_chunk_truthy_stops_early_and_result_reflects_it(engine):
    res = run(_spec(), engine, exec=_cfg(), device=CPU,
              on_chunk=lambda b, st, acc: b >= 16)
    assert res.rounds == 16
    assert res.correct.shape == (16, 4) and res.eps_ledger.shape == (16,)
    # the early-stopped state equals a fresh run to the same horizon
    ref = run(_spec(horizon=16), engine, exec=_cfg(), device=CPU)
    np.testing.assert_array_equal(res.final_w, ref.final_w)
    np.testing.assert_array_equal(res.loss, ref.loss)


# -- snapshots ----------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_published_snapshot_bit_identical_to_reference_run(engine, backend):
    spec = _spec(backend=backend)
    state = _state(spec, engine=engine)
    state.publish_initial()
    tr = _trainer(spec, state, engine=engine, chunk_rounds=8)
    tr.run_blocking()
    snap = state.current
    # 1 initial (round 0) + 4 chunk-boundary publications
    assert snap.round == 32 and state.published == 5
    assert verify_snapshot(spec, engine, snap, chunk_rounds=8)
    np.testing.assert_array_equal(snap.w.numpy(), tr.result.final_w)
    # a corrupted snapshot must NOT verify
    bad = snap.__class__(version=snap.version, round=snap.round,
                         theta=snap.theta, w=snap.w + 1e-3,
                         w_bar=snap.w_bar, eps_spent=snap.eps_spent)
    assert not verify_snapshot(spec, engine, bad, chunk_rounds=8)


def test_history_ring_prunes_to_keep():
    spec = _spec()
    state = _state(spec, keep=2)
    state.publish_initial()
    _trainer(spec, state, chunk_rounds=8).run_blocking()
    assert state.snapshot(4) is not None and state.snapshot(3) is not None
    assert state.snapshot(1) is None        # pruned
    with pytest.raises(ValueError, match="keep"):
        _state(spec, keep=0)


@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_sparse_topology_trainer_snapshot_verifies_and_serves(engine):
    """A sparse-graph trainer (the fused backend's CSR path on the card):
    published snapshots verify bit for bit, and the batched predict path
    serves the trained per-node rows."""
    spec = _spec(nodes=10, mixer="sparse",
                 mixer_options={"topology": "ring"}, backend="cuda")
    state = _state(spec, engine=engine)
    state.publish_initial()
    _trainer(spec, state, engine=engine, chunk_rounds=8).run_blocking()
    snap = state.current
    assert snap.round == 32
    assert verify_snapshot(spec, engine, snap, chunk_rounds=8)
    feats = np.linspace(-1, 1, spec.dim * 6).reshape(6, spec.dim)
    nodes = np.asarray([0, 3, 9, 9, 1, 5])
    margins, labels, used = state.predict(feats, nodes)
    assert used.version == snap.version
    ref = (snap.w.numpy()[nodes] * feats).sum(axis=1)
    np.testing.assert_allclose(margins.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(labels.numpy(),
                                  np.where(margins.numpy() >= 0, 1, -1))


def test_verify_snapshot_atol_bounds_cross_layout_drift():
    """Exact comparison rejects perturbed models, while a bound of the
    size of a reduction-order difference accepts them."""
    spec = _spec(nodes=10, mixer="sparse",
                 mixer_options={"topology": "ring"})
    res = run(spec, exec=_cfg(), device=CPU)
    snap = snapshot_from_state(spec, "sim", res.final_state, version=1,
                               eps_spent=1.0)
    assert verify_snapshot(spec, "sim", snap, chunk_rounds=8)
    nudged = snap.__class__(version=1, round=snap.round, theta=snap.theta,
                            w=snap.w + 1e-7, w_bar=snap.w_bar + 1e-7,
                            eps_spent=snap.eps_spent)
    assert not verify_snapshot(spec, "sim", nudged, chunk_rounds=8)
    assert verify_snapshot(spec, "sim", nudged, chunk_rounds=8, atol=2e-6)
    bad = snap.__class__(version=1, round=snap.round, theta=snap.theta,
                         w=snap.w + 1e-3, w_bar=snap.w_bar,
                         eps_spent=snap.eps_spent)
    assert not verify_snapshot(spec, "sim", bad, chunk_rounds=8, atol=2e-6)


def test_verify_snapshot_node_devices_is_not_ported():
    """verify_snapshot(node_devices=) is ported: a snapshot of a
    2-shard run replays bit for bit under 2 shards, within the float
    contract under none, and the round-0 snapshot is all zeros."""
    from repro_torch.serve.state import snapshot_from_state
    spec = _spec(horizon=8)
    snap0 = _state(spec).publish_initial()
    assert verify_snapshot(spec, "sim", snap0, node_devices=2)
    res = run(spec, exec=ExecConfig(chunk_rounds=4, warmup=False,
                                    compute_regret=False, node_devices=2),
              device=CPU)
    snap = snapshot_from_state(spec, "sim", res.final_state, version=1,
                               eps_spent=1.0)
    assert verify_snapshot(spec, "sim", snap, chunk_rounds=3,
                           node_devices=2)
    assert verify_snapshot(spec, "sim", snap, atol=5e-6)


def test_serving_entry_points_default_to_cuda_and_refuse_without_it():
    spec = _spec()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeState(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeService(ServeConfig(spec=spec))
    assert ServeConfig(spec=spec).device == "cuda"


# -- admission / batching -----------------------------------------------------

@pytest.mark.parametrize("mode", ["node", "average"])
def test_service_predict_matches_direct_predict_despite_padding(mode):
    spec = _spec()
    svc = _service(spec, train=False, max_batch=8, max_wait_ms=0.2,
                   mode=mode).start()
    try:
        feats = np.linspace(-1, 1, spec.dim).astype(np.float32)
        req = svc.predict(feats, node=2, timeout=30.0)
        assert req.status == "ok" and req.snapshot_round == 0
        snap = svc.state.current
        direct_feats = np.zeros((8, spec.dim), np.float32)
        direct_feats[0] = feats
        nodes = np.zeros((8,), np.int64)
        nodes[0] = 2
        margins, labels = svc.state.predict_fn(
            snap.w, snap.w_bar, torch.as_tensor(direct_feats),
            torch.as_tensor(nodes))
        assert float(margins[0]) == req.margin
        assert float(labels[0]) == req.label
        assert svc.verify(req)
    finally:
        svc.stop()


def test_snapshot_age_grows_while_the_trainer_publishes_nothing():
    """Staleness counts rounds of publication lag, so it reads 0 while no
    snapshot is published; the served snapshot's age is the time since
    its publication, and grows."""
    spec = _spec()
    svc = _service(spec, train=False, max_batch=2, max_wait_ms=0.2).start()
    try:
        feats = [1.0] * spec.dim
        first = svc.predict(feats, node=0, timeout=30.0)
        time.sleep(0.05)
        later = svc.predict(feats, node=1, timeout=30.0)
    finally:
        svc.stop()
    assert first.staleness_rounds == later.staleness_rounds == 0
    assert later.snapshot_age_s >= first.snapshot_age_s + 0.05
    assert svc.stats()["admission"]["staleness_max_rounds"] == 0
    assert svc.stats_.snapshot_age_ms()["max"] == round(
        later.snapshot_age_s * 1e3, 3)


def test_batcher_packs_a_padded_batch_in_one_buffer():
    """The batch's features and node ids share one host buffer (one copy
    to the card); rows past the batch are zero, also after a fuller
    batch."""
    from repro_torch.serve.admission import Request
    svc = _service(_spec(), train=False, max_batch=4)
    rows = np.arange(3 * 16, dtype=np.float32).reshape(3, 16)
    feats, nodes = svc.batcher.pack(
        [Request(features=r, node=i + 1) for i, r in enumerate(rows)])
    np.testing.assert_array_equal(feats.numpy()[:3], rows)
    assert feats.shape == (4, 16) and nodes.tolist() == [1, 2, 3, 0]
    assert not feats.numpy()[3].any()
    feats, nodes = svc.batcher.pack([Request(features=rows[2], node=3)])
    assert not feats.numpy()[1:].any() and nodes.tolist() == [3, 0, 0, 0]


def test_full_queue_sheds_instead_of_blocking():
    spec = _spec()
    svc = _service(spec, train=False, queue_capacity=4, max_batch=2,
                   max_wait_ms=0.1)
    # batcher NOT started: the queue can only fill
    svc.state.publish_initial()
    feats = [1.0] * spec.dim
    reqs = [svc.submit(feats, node=0) for _ in range(10)]
    shed = [r for r in reqs if r.status == "shed"]
    assert len(shed) == 6 and all(r.done() for r in shed)
    assert all(r.shed_reason == "full" for r in shed)
    assert svc.stats()["admission"]["shed"] == 6


def test_expired_requests_shed_with_reason_timeout():
    spec = _spec()
    svc = _service(spec, train=False, max_age_s=0.0)
    svc.state.publish_initial()
    reqs = [svc.submit([1.0] * spec.dim, node=0) for _ in range(3)]
    time.sleep(0.01)
    svc.batcher.start()
    assert all(r.wait(30.0).status == "shed" for r in reqs)
    svc.stop()
    assert svc.stats()["admission"]["shed_reasons"] == {"timeout": 3}


def test_sequential_budget_exhausts_and_refuses():
    spec = _spec(horizon=32)
    svc = _service(spec, chunk_rounds=4, composition="sequential",
                   eps_budget=10.0, max_batch=2, max_wait_ms=0.2).start()
    try:
        assert _wait(svc.exhausted)
        # budget 10.0 at eps=1.0/round: rounds 4 and 8 publish, 12 would
        # overspend — training stops at 8 and the snapshot stays there
        assert svc.state.current.round == 8
        assert svc.eps_spent() <= 10.0
        req = svc.submit([1.0] * spec.dim, node=0).wait(30.0)
        assert req.status == "refused"
        assert svc.stats()["admission"]["refused"] >= 1
    finally:
        svc.stop()


def test_parallel_composition_never_exhausts_on_disjoint_stream():
    spec = _spec(horizon=32)
    svc = _service(spec, chunk_rounds=8, composition="parallel",
                   eps_budget=10.0).start()
    try:
        assert _wait(lambda: svc.state.current.round >= 32)
        assert not svc.exhausted()
        assert svc.eps_spent() == pytest.approx(spec.eps)   # Theorem 1: flat
    finally:
        svc.stop()


# -- end to end ---------------------------------------------------------------

def test_replay_end_to_end_serves_while_training(tmp_path):
    spec = _spec(horizon=48, backend="cuda")
    svc = _service(spec, chunk_rounds=8, max_batch=8, max_wait_ms=0.5,
                   queue_capacity=64, checkpoint_dir=str(tmp_path),
                   keep_snapshots=16).start()
    replay = BurstyReplay(spec.resolve_stream(device=CPU))
    # the trainer's first chunk lands before the burst: every response
    # then names a snapshot the service checkpointed (round 0 is not)
    assert _wait(lambda: svc.state.published >= 2)
    out = replay.drive(svc, 0, 32, timeout_s=120.0)
    svc.stop()
    assert out["submitted"] == replay.total_requests(0, 32)
    assert out["served"] > 0 and out["qps"] > 0
    assert out["served"] + out["shed"] + out["refused"] == out["submitted"]
    served = [r for r in out["requests"] if r.status == "ok"]
    sample = max(served, key=lambda r: r.snapshot_version)
    assert sample.staleness_rounds is not None
    assert sample.staleness_rounds >= 0
    assert svc.verify(sample)
    # async checkpoints of published snapshots landed on disk
    rounds = sorted(int(f.split("_")[-1].split(".")[0])
                    for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert rounds and set(rounds) <= {8, 16, 24, 32, 40, 48}
    snap = svc.state.snapshot(sample.snapshot_version)
    restored = restore_checkpoint(str(tmp_path),
                                  {"theta": torch.zeros_like(snap.w)},
                                  step=snap.round)
    assert torch.equal(restored["theta"], snap.theta)


def test_replay_derives_load_from_stream_counts():
    spec = _spec(horizon=16)
    stream = spec.resolve_stream(device=CPU)
    replay = BurstyReplay(stream)
    counts = stream.counts(0, 16).numpy()
    ticks = list(replay.ticks(0, 16))
    assert [len(t) for t in ticks] == counts.sum(axis=1).tolist()
    xs = stream.chunk(0, 16)[0].numpy()
    feats, node = ticks[5][-1]
    np.testing.assert_array_equal(feats, xs[5, node])
    with pytest.raises(ValueError):
        BurstyReplay(object())


# -- crashes --------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_crashed_trainer_resumes_bit_for_bit(engine, tmp_path):
    """A trainer killed at round 20 restarts from its last checkpoint
    (round 16: theta, the delay ring and the noise generator's state) and
    ends bit for bit on the uncrashed trainer's snapshot."""
    spec = _spec(horizon=40, delay=1, backend="cuda")
    clean = _service(spec, chunk_rounds=8, engine=engine).start()
    crashed = _service(spec, chunk_rounds=8, engine=engine,
                       crash_at_round=20,
                       checkpoint_dir=str(tmp_path)).start()
    for svc in (clean, crashed):
        svc.trainer.join(timeout=120)
        svc.stop()
    assert crashed.trainer.restarts == 1 and clean.trainer.restarts == 0
    a, b = clean.state.current, crashed.state.current
    assert a.round == b.round == 40
    assert torch.equal(a.w, b.w) and torch.equal(a.w_bar, b.w_bar)
    assert torch.equal(a.theta, b.theta)
    assert sorted(os.listdir(tmp_path / "trainer")) == [
        f"ckpt_{r:08d}.npz" for r in (8, 16, 24, 32, 40)]
    with pytest.raises(ValueError, match="checkpoint_dir"):
        _service(spec, crash_at_round=20)


# -- against repro.serve --------------------------------------------------------

M, N, T = 6, 48, 16
BASE = dict(nodes=M, dim=N, horizon=T, alpha0=0.5, lam=0.05,
            calibration="coordinate", clip_norm=1.0, seed=3, eps=1.0)


@pytest.fixture(scope="module")
def jax_serving():
    """The reference trainer's publications over its bursty stream, with
    the stream's chunks and the round's unit Laplace draws."""
    jspec = JRunSpec(**BASE, stream="bursty")
    xs, ys = (np.asarray(a) for a in jspec.resolve_stream().chunk(0, T))
    snaps = []
    state = JServeState(jspec)
    state.publish_initial()
    JBackgroundTrainer(jspec, state, chunk_rounds=4, warmup=False,
                       on_publish=snaps.append).run_blocking()
    return xs, ys, _reference_draws(BASE["seed"], T, (M, N)), snaps


def _injected_spec(xs, ys, draws, **kw):
    mech = ReplayLaplace(eps=BASE["eps"], L=BASE["clip_norm"],
                         calibration=BASE["calibration"], draws=iter(draws))
    return RunSpec(**BASE, stream=ReplayStream(xs, ys), mechanism=mech, **kw)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_trainer_publications_match_repro_serve(jax_serving, backend):
    xs, ys, draws, jsnaps = jax_serving
    spec = _injected_spec(xs, ys, draws, backend=backend)
    snaps = []
    state = _state(spec)
    state.publish_initial()
    _trainer(spec, state, chunk_rounds=4,
             on_publish=snaps.append).run_blocking()
    assert [s.round for s in snaps] == [s.round for s in jsnaps] \
        == [4, 8, 12, 16]
    for port, ref in zip(snaps, jsnaps):
        assert (port.version, port.eps_spent) == (ref.version, ref.eps_spent)
        for f in ("w", "w_bar"):
            d = np.abs(getattr(port, f).numpy()
                       - np.asarray(getattr(ref, f))).max()
            assert d <= ATOL, f"round {port.round}: {f} off by {d}"
    assert 0 < (snaps[-1].w == 0).float().mean() < 1   # sparse, not empty


@pytest.mark.parametrize("mode", ["node", "average"])
def test_predict_serves_a_jax_snapshot_as_repro_serve_does(jax_serving,
                                                           mode):
    *_, jsnaps = jax_serving
    jsnap = jsnaps[-1]
    snap = snapshot_from_jax(jsnap, CPU)
    assert (snap.version, snap.round) == (jsnap.version, jsnap.round)
    state = ServeState(_spec(nodes=M, dim=N), mode=mode, device=CPU)
    state.publish(snap)
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((32, N)).astype(np.float32)
    nodes = rng.integers(0, M, 32).astype(np.int32)
    margins, labels, used = state.predict(feats, nodes)
    assert used is snap
    jm, jl = jmake_predict_fn(mode)(jsnap.w, jsnap.w_bar, feats, nodes)
    jm, jl = np.asarray(jm), np.asarray(jl)
    d = np.abs(margins.numpy() - jm).max()
    assert d <= 1e-5 * np.abs(jm).max(), f"margins off by {d}"
    np.testing.assert_array_equal(labels.numpy(), jl)
    with pytest.raises(ValueError, match="w_bar"):
        snapshot_from_jax({"version": 0, "round": 0, "theta": jsnap.theta,
                           "w": jsnap.w, "w_bar": jsnap.theta,
                           "eps_spent": 0.0}, CPU)


# -- async checkpointing ------------------------------------------------------

def test_async_checkpointer_roundtrip_and_error_surfacing(tmp_path):
    good = tmp_path / "good"
    with AsyncCheckpointer(str(good)) as ck:
        for step in (1, 2, 3):
            ck.save(step, {"w": torch.full((3,), float(step))})
        ck.wait()
    out = restore_checkpoint(str(good), {"w": torch.zeros((3,))}, step=2)
    assert out["w"].tolist() == [2.0, 2.0, 2.0]
    # a failing write surfaces on the NEXT call, not silently
    bad_parent = tmp_path / "not_a_dir"
    bad_parent.write_text("file, not dir")
    ck = AsyncCheckpointer(str(bad_parent / "sub"))
    ck.save(1, {"w": torch.zeros((2,))})
    with pytest.raises(RuntimeError, match="async checkpoint"):
        ck.wait()
    with pytest.raises(RuntimeError, match="closed"):
        ck.close() or ck.save(2, {"w": torch.zeros((2,))})


def test_async_checkpointer_copies_the_state_at_save(tmp_path):
    """``save`` copies the engine state when it is called — the tensors and
    the generator's state — so the trainer may go on advancing and drawing;
    the checkpoint resumes as a synchronous one does."""
    from repro_torch.checkpoint import save_checkpoint
    spec = _spec(delay=1)
    state = run(spec, exec=_cfg(), horizon=8, device=CPU).final_state
    save_checkpoint(str(tmp_path / "sync"), 8, state)
    with AsyncCheckpointer(str(tmp_path / "async")) as ck:
        ck.save(8, state)
        state.theta.add_(1.0)                # later work on the live state
        state.history.add_(1.0)
        torch.rand(5, generator=state.generator)
    for name in ("theta", "history", "generator", "t"):
        a = np.load(tmp_path / "sync" / "ckpt_00000008.npz")[name]
        b = np.load(tmp_path / "async" / "ckpt_00000008.npz")[name]
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- thread safety of the kernel wrappers' shared state -------------------------

def test_kernel_build_and_counters_are_thread_safe(tmp_path, monkeypatch):
    """Two threads reach a kernel at first use at once: one nvcc runs (the
    compile step stubbed: it writes the temporary output), both get the
    library's path, and the stream counter table hands both one array."""
    from repro_torch.kernels import build, launch
    calls = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            time.sleep(0.05)                 # a slow compile widens the race
            out = cmd[cmd.index("-o") + 1]
            with open(out, "wb") as fh:
                fh.write(b"\x7fELF")
            self.returncode = 0

        def communicate(self):
            return "ptxas info: stubbed", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc_path", lambda: "/stub/nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(launch, "_COUNTERS", {})

    class Stream:
        cuda_stream = 7

    gate = threading.Barrier(2)
    paths, counters = [], []

    def first_use():
        gate.wait(timeout=10)
        paths.append(build.build("round_fused.cu")[0])
        counters.append(launch.stream_counter("round_stats",
                                              torch.device("cpu"), Stream(),
                                              4))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=first_use) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1
    assert paths[0] == paths[1] == build.library_path("round_fused.cu")
    assert paths[0].read_bytes() == b"\x7fELF"
    assert not list(paths[0].parent.glob("*.tmp"))
    assert counters[0] is counters[1] and len(launch._COUNTERS) == 1
