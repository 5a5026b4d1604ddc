"""Node-axis sharding of the port (`repro_torch.api.shard_node`) against
the JAX package's (`repro.api.shard_node`), on the same data and noise.

The reference's sharded runs need several devices, so they run once, in
one subprocess for the module, with 8 fake host devices
(``--xla_force_host_platform_device_count``, as tests/test_shard_node.py
runs them) and come back as an npz. The port runs here on a mesh of CPU
shards, with the reference stream's chunks and its unit Laplace draws
injected as tests/test_torch_run.py injects them: both sides draw the full
(m, n) sample each round and slice their blocks from it.

The contract: ``correct``, ``sparsity`` and ``eps_ledger`` exact;
``final_w``, ``loss`` and ``w_bar_loss`` within 5e-6 — m = 10 on 4 shards
(padding live: the last shard has one real row and two pad rows), delay 0
and 2, both engines, the port's reference backend against the JAX
reference backend and the port's cuda backend (the kernels' plain versions
here) against the JAX pallas backend in interpret mode. Inside the port:
sim == dist and a rerun, bit for bit; the sharded run within the contract
of the unsharded one at every shard count; checkpoints crossing shard
counts; a JAX sharded state carried across by `convert.state_from_jax`;
`verify_snapshot(node_devices=)`. Then the in-process cases of
tests/test_shard_node.py: the mesh rules and refusals, the mixer lowering
and the partitioner.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import shard_node as jshard  # noqa: E402
from repro.core.graph import SparseGraph as JSparseGraph  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run, run_batch  # noqa: E402
from repro_torch.api.mixers import (MIXERS, DelayedMixer,  # noqa: E402
                                    RingRollMixer, SparseMixer)
from repro_torch.api.shard_node import (Blocks, ShardedSparseMixer,  # noqa: E402
                                        make_node_chunk_fn, mix_order,
                                        partition_graph, resolve_node_mesh,
                                        sparse_graph_and_delay)
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402
from repro_torch.core.graph import SparseGraph, ring_edges  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_mesh, mesh_device,  # noqa: E402
                                     node_mesh, seed_node_mesh)

from test_torch_run import (ReplayLaplace, ReplayStream,  # noqa: E402
                            _reference_draws)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 5e-6
EXACT = ("correct", "sparsity", "eps_ledger")
CLOSE = ("final_w", "loss", "w_bar_loss")
FIELDS = EXACT + CLOSE
M, N, T, D, K = 10, 8, 14, 4, 7
BASE = dict(nodes=M, dim=N, horizon=T, eps=1.0, alpha0=0.5, lam=0.01,
            stream="drift", stream_options={"period": 7}, mixer="sparse",
            mixer_options={"topology": "ring"})
CFG = ExecConfig(chunk_rounds=7, warmup=False, compute_regret=False)
# (port backend) -> the reference backend it is held against
PAIRS = {"reference": "reference", "cuda": "pallas"}

_SCRIPT = r"""
import sys
import numpy as np
import jax
from repro.api import ExecConfig, RunSpec, run
assert jax.local_device_count() == 8
out_path, ckpt_dir, base, fields = sys.argv[1], sys.argv[2], eval(sys.argv[3]), eval(sys.argv[4])
cfg = ExecConfig(chunk_rounds=7, warmup=False, compute_regret=False,
                 node_devices=4)
out = {}
for backend in ("reference", "pallas"):
    for delay in (0, 2):
        res = run(RunSpec(**base, delay=delay, backend=backend), exec=cfg)
        for f in fields:
            out[f"{backend}/{delay}/{f}"] = np.asarray(getattr(res, f))
# a sharded state at round 7, as its checkpoint writes it
run(RunSpec(**base, delay=2), horizon=7,
    exec=cfg.replace(checkpoint_every=7, checkpoint_dir=ckpt_dir))
np.savez(out_path, **out)
"""


def jax_subprocess(script: str, *args: str, timeout: int = 600) -> None:
    """Run ``script`` in a JAX process with 8 fake host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", script, *args],
                         capture_output=True, text=True, timeout=timeout,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The reference's 4-device sharded runs (and a sharded checkpoint at
    round K), from one subprocess."""
    tmp = tmp_path_factory.mktemp("jax_shard_node")
    path, ckpt = tmp / "runs.npz", tmp / "ckpt"
    jax_subprocess(_SCRIPT, str(path), str(ckpt), repr(BASE), repr(FIELDS))
    with np.load(path) as data:
        runs = {k: data[k] for k in data.files}
    return runs, ckpt / f"ckpt_{K:08d}.npz"


@pytest.fixture(scope="module")
def injected():
    """The reference stream's chunks and unit noise for BASE."""
    stream = JRunSpec(**BASE).resolve_stream()
    xs, ys = (np.asarray(a) for a in stream.chunk(0, T))
    return xs, ys, _reference_draws(0, T, (M, N))


def _port_spec(injected, start=0, **kw):
    xs, ys, draws = injected
    spec = RunSpec(**BASE, **kw)
    mech = spec.resolve_mechanism()
    return spec.replace(stream=ReplayStream(xs, ys), mechanism=ReplayLaplace(
        eps=mech.eps, L=mech.L, calibration=mech.calibration,
        noise_self=mech.noise_self, draws=iter(draws[start:])))


def assert_contract(ref: dict, port, what: str, start: int = 0) -> None:
    for f in EXACT:
        np.testing.assert_array_equal(
            np.asarray(getattr(port, f)), np.asarray(ref[f])[start:],
            err_msg=f"{what}: {f} must match exactly")
    for f in CLOSE:
        want = np.asarray(ref[f]) if f == "final_w" else \
            np.asarray(ref[f])[start:]
        d = np.abs(np.asarray(getattr(port, f)) - want).max()
        assert d <= ATOL, f"{what}: {f} off by {d} (> {ATOL})"


def assert_identical(a, b, what: str) -> None:
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{what}: {f} diverged")


def _ref(runs: dict, backend: str, delay: int) -> dict:
    return {f: runs[f"{PAIRS[backend]}/{delay}/{f}"] for f in FIELDS}


# -- against the reference's sharded runs ----------------------------------------

@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("backend", list(PAIRS))
def test_sharded_run_matches_the_reference_sharded_run(jax_runs, injected,
                                                       backend, delay,
                                                       engine):
    runs, _ = jax_runs
    port = run(_port_spec(injected, delay=delay, backend=backend),
               engine=engine, exec=CFG.replace(node_devices=D), device="cpu")
    assert port.final_w.shape == (M, N) and port.loss.shape == (T, M)
    assert_contract(_ref(runs, backend, delay), port,
                    f"{backend}/{engine}/delay={delay} on {D} shards")
    # the workload is not degenerate: some but not all weights are zero
    assert 0 < port.sparsity.max() and port.sparsity.min() < 1


def test_jax_sharded_state_resumes_in_the_port(jax_runs, injected, tmp_path):
    """The reference's 4-device run checkpointed at round K carries into
    the port (`state_from_jax`) and resumes there on 4 shards, within the
    contract of the reference's uninterrupted sharded run."""
    runs, ckpt = jax_runs
    state = state_from_jax(ckpt, "cpu", seed=0)
    assert state.t == K and state.history.shape == (3, M, N)
    save_checkpoint(str(tmp_path), K, state)
    port = run(_port_spec(injected, start=K, delay=2), device="cpu",
               exec=CFG.replace(node_devices=D, resume=True,
                                checkpoint_dir=str(tmp_path)))
    assert port.start_round == K and port.rounds == T
    assert_contract(_ref(runs, "reference", 2), port, "carried across", K)


# -- inside the port ---------------------------------------------------------------

@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("backend", list(PAIRS))
def test_sharded_sim_equals_dist_and_reruns_bit_for_bit(backend, delay):
    spec = RunSpec(**BASE, delay=delay, backend=backend)
    cfg = CFG.replace(node_devices=D)
    sim = run(spec, exec=cfg, device="cpu")
    dist = run(spec, engine="dist", exec=cfg, device="cpu")
    again = run(spec, exec=cfg, device="cpu")
    assert_identical(sim, dist, f"{backend}/delay={delay} sim vs dist")
    assert_identical(sim, again, f"{backend}/delay={delay} rerun")


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("backend", list(PAIRS))
def test_sharded_run_within_the_contract_of_the_unsharded_run(backend,
                                                              shards):
    """Every shard count — one shard (a prebuilt mesh), padding from 0 to 6
    rows, shards with no real row at all (8 shards of 2 rows) — within the
    contract of the unsharded run on the same data and noise."""
    spec = RunSpec(**BASE, delay=1, backend=backend)
    plain = run(spec, exec=CFG, device="cpu")
    mesh = make_mesh((shards,), ("node",), device="cpu")
    sharded = run(spec, exec=CFG.replace(node_mesh=mesh), device="cpu")
    ref = {f: getattr(plain, f) for f in FIELDS}
    assert_contract(ref, sharded, f"{backend} on {shards} shards")


@pytest.mark.parametrize("direction", ["4->1", "1->4", "4->4"])
def test_checkpoints_cross_node_device_counts(tmp_path, direction):
    """State crossing a chunk boundary is global and unpadded: a checkpoint
    saved under one shard count resumes under another; under the same
    count the resumed run is bit for bit the uninterrupted one."""
    save, resume = (int(c) for c in direction.split("->"))
    spec = RunSpec(**{**BASE, "horizon": 12}, delay=1)
    cfg = CFG.replace(chunk_rounds=6)
    full = run(spec, exec=cfg.replace(node_devices=resume), device="cpu")
    run(spec, horizon=6, device="cpu",
        exec=cfg.replace(node_devices=save, checkpoint_every=6,
                         checkpoint_dir=str(tmp_path)))
    res = run(spec, device="cpu",
              exec=cfg.replace(node_devices=resume, resume=True,
                               checkpoint_dir=str(tmp_path)))
    assert res.start_round == 6
    if save == resume:
        np.testing.assert_array_equal(res.final_w, full.final_w)
        np.testing.assert_array_equal(res.loss, full.loss[6:])
    else:
        assert np.abs(res.final_w - full.final_w).max() <= ATOL
        np.testing.assert_array_equal(res.correct, full.correct[6:])


def test_verify_snapshot_replays_the_sharded_layout():
    """A snapshot of a 4-shard trainer replays bit for bit under 4 shards
    and within the contract unsharded; the batched predict serves the
    sharded model's rows. (The reference also pins that the unsharded
    replay's bits differ; that pins its own reduction order, not a
    contract, so it is not carried.)"""
    from repro_torch.serve.state import (make_predict_fn, snapshot_from_state,
                                         verify_snapshot)
    spec = RunSpec(**BASE)
    res = run(spec, exec=CFG.replace(node_devices=D), device="cpu")
    snap = snapshot_from_state(spec, "sim", res.final_state, version=1,
                               eps_spent=1.0)
    assert snap.round == T
    np.testing.assert_array_equal(snap.w.numpy(), res.final_w)
    assert verify_snapshot(spec, "sim", snap, node_devices=D)
    assert verify_snapshot(spec, "sim", snap, atol=ATOL)
    predict = make_predict_fn("node")
    feats = torch.ones((5, N))
    nodes = torch.tensor([0, 3, 9, 9, 1])
    margins, labels = predict(snap.w, snap.w_bar, feats, nodes)
    want = res.final_w.sum(axis=1)[nodes.numpy()]
    np.testing.assert_allclose(margins.numpy(), want, atol=1e-6)
    assert set(labels.tolist()) <= {-1.0, 1.0}


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5])
def test_sharded_mixer_adds_as_the_sparse_mixer(shards):
    """The sharded mix of each shard's rows equals the unsharded
    `SparseMixer`'s bit for bit (ascending source, slot by slot); each
    used offset but 0 is one halo copy a shard."""
    g = SparseGraph.make("torus", 12, rows=3)
    part = partition_graph(g, shards)
    mixer = ShardedSparseMixer(part, devices=("cpu",) * shards)
    x = torch.from_numpy(np.random.default_rng(shards).standard_normal(
        (12, 5)).astype(np.float32))
    xp = torch.cat([x, torch.zeros(part.m_pad - 12, 5)])
    blocks = Blocks(xp[d * part.block:(d + 1) * part.block]
                    for d in range(shards))
    ShardedSparseMixer.reset_halo_copies()
    got = torch.cat(mixer.apply(blocks, 0).parts)
    want = SparseMixer(graph=g).apply(x, 0)
    assert torch.equal(got[:12], want)
    assert torch.equal(got[12:], torch.zeros_like(got[12:]))
    used = sum(1 for o, *_ in part.offsets if o)
    assert ShardedSparseMixer.halo_copies == used * shards


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5])
def test_sharded_ring_adds_as_the_ring_roll_mixer(shards):
    """A ring sharded in `mix_order`'s ring order adds each row as
    `RingRollMixer` does (self, then i-1, then i+1), bit for bit on every
    row — the wrap-around rows 0 and m-1 and the rows at shard boundaries
    too — where ascending source order parts on the wrap-around rows."""
    m = 64
    ring = RingRollMixer(m=m)
    assert mix_order(ring) == "ring"
    assert mix_order(DelayedMixer(inner=ring, delay=2)) == "ring"
    assert mix_order(SparseMixer(graph=ring_edges(m))) == "ascending"
    assert mix_order(RingRollMixer(m=2)) == "ascending"
    graph = sparse_graph_and_delay(ring)[0]
    part = partition_graph(graph, shards, order=mix_order(ring))
    x = torch.from_numpy(np.random.default_rng(shards).standard_normal(
        (m, 96)).astype(np.float32))
    xp = torch.cat([x, torch.zeros(part.m_pad - m, 96)])
    blocks = Blocks(xp[d * part.block:(d + 1) * part.block]
                    for d in range(shards))
    want = ring.apply(x, 0)
    got = torch.cat(ShardedSparseMixer(part, devices=("cpu",) * shards)
                    .apply(blocks, 0).parts)
    assert torch.equal(got[:m], want)
    asc = torch.cat(ShardedSparseMixer(partition_graph(graph, shards),
                                       devices=("cpu",) * shards)
                    .apply(blocks, 0).parts)
    assert torch.equal(asc[1:m - 1], want[1:m - 1])
    assert not torch.equal(asc[:m], want)
    with pytest.raises(ValueError, match="mix order"):
        partition_graph(graph, shards, order="random")


# The paper's run (chip_smoke.paper_spec) at n = 96, over its whole horizon.
LONG = dict(nodes=64, dim=96, horizon=1562, stream="social_sparse",
            mixer="ring", mechanism="laplace", eps=1.0,
            calibration="coordinate", clip_norm=1.0, alpha0=1.0,
            schedule="sqrt_t", lam=1e-3)
LONG_SEEDS = (0, 1, 2)
LONG_CFG = ExecConfig(chunk_rounds=256, warmup=False, compute_regret=False)


@pytest.fixture(scope="module")
def one_thread():
    """One intra-op thread for the long runs: their tensors are small, and
    idle pool threads spinning between ops starve parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def long_unsharded(one_thread):
    """backend -> the unsharded runs of LONG at LONG_SEEDS (made once)."""
    runs = {}

    def get(backend):
        if backend not in runs:
            runs[backend] = [run(RunSpec(**LONG, seed=s, backend=backend),
                                 exec=LONG_CFG, device="cpu")
                             for s in LONG_SEEDS]
        return runs[backend]

    return get


@pytest.mark.parametrize("shards", [4, 3])
@pytest.mark.parametrize("backend", list(PAIRS))
def test_sharded_ring_equals_the_unsharded_ring_over_the_paper_horizon(
        long_unsharded, backend, shards):
    """m = 64 on 4 shards (block 16) and 3 (block 22, two pad rows), 1,562
    rounds, seeds 0-2 as one sharded batch: ``final_w``, ``correct``,
    ``sparsity`` and ``eps_ledger`` bit for bit the unsharded run's in
    every round — the sharded ring adds each row in the unsharded ring's
    roll order — and ``loss`` and ``w_bar_loss`` within 5e-6 (the metric
    sums add in shard order)."""
    sharded = run_batch(RunSpec(**LONG, backend=backend), LONG_SEEDS,
                        exec=LONG_CFG.replace(node_devices=shards),
                        device="cpu")
    for seed, plain, sh in zip(LONG_SEEDS, long_unsharded(backend), sharded):
        what = f"{backend} seed {seed} on {shards} shards"
        for f in ("final_w",) + EXACT:
            np.testing.assert_array_equal(
                np.asarray(getattr(sh, f)), np.asarray(getattr(plain, f)),
                err_msg=f"{what}: {f} must be bit for bit")
        for f in ("loss", "w_bar_loss"):
            d = np.abs(np.asarray(getattr(sh, f))
                       - np.asarray(getattr(plain, f))).max()
            assert d <= ATOL, f"{what}: {f} off by {d} (> {ATOL})"


def test_a_halo_is_a_copy_never_a_view():
    """On a repeated device the halo buffer is a copy: writing the source
    block afterwards does not move the mix."""
    part = partition_graph(ring_edges(6), 2)
    mixer = ShardedSparseMixer(part, devices=("cpu", "cpu"))
    x = Blocks(torch.ones(3, 2) * (d + 1) for d in range(2))
    bufs = mixer._exchange(x)
    assert all(b.data_ptr() != p.data_ptr() for b in bufs for p in x.parts)
    before = [b.clone() for b in bufs]
    for p in x.parts:
        p.fill_(7.0)
    assert all(torch.equal(a, b) for a, b in zip(before, bufs))


def test_chunk_fn_takes_and_returns_global_unpadded_state():
    spec = RunSpec(**{**BASE, "horizon": 4})
    chunk_fn, init_fn = make_node_chunk_fn(
        spec, "dist", make_mesh((3,), ("node",), device="cpu"))
    state = init_fn(0)
    xs, ys = spec.resolve_stream(device="cpu").chunk(0, 4)
    state, outs = chunk_fn(state, xs, ys)
    assert state.theta["w"].shape == (M, N) and state.t == 4
    assert outs.loss.shape == (4, M) and outs.correct.shape == (4, M)
    assert outs.sparsity.shape == (4,) and outs.w_bar_loss.shape == (4,)
    with pytest.raises(ValueError, match="'sim' or 'dist'"):
        make_node_chunk_fn(spec, "sharded",
                           make_mesh((2,), ("node",), device="cpu"))
    with pytest.raises(ValueError, match="'node' axis"):
        make_node_chunk_fn(spec, "sim",
                           make_mesh((2,), ("seed",), device="cpu"))
    with pytest.raises(ValueError, match="seed"):
        make_node_chunk_fn(spec, "sim", make_mesh((2,), ("node",),
                                                  device="cpu"),
                           batched=True)


# -- the mesh rules (in-process) ----------------------------------------------------

def _spec(**kw):
    return RunSpec(**{**BASE, "horizon": 10, **kw})


def test_node_mesh_single_device_fallback():
    """None, 0 and 1 (and "auto" on the CPU, which torch counts as one
    device) are the unsharded path; an int D on the CPU is D cpu shards."""
    for v in (None, 0, 1, "auto"):
        assert node_mesh(v, device="cpu") is None
    assert seed_node_mesh(1, "auto", device="cpu") is None
    assert seed_node_mesh(1, 1, device="cpu") is None
    mesh = node_mesh(3, device="cpu")
    assert mesh.shape == {"node": 3}
    assert [str(d) for d in mesh.devices.flat] == ["cpu"] * 3
    assert seed_node_mesh(2, 3, device="cpu").shape == {"seed": 2, "node": 3}


def test_node_mesh_too_many_devices_errors(monkeypatch):
    """On CUDA an int asks for that many distinct cards, and the error
    names a prebuilt Mesh over a repeated device as the way to test."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="prebuilt Mesh"):
        node_mesh(2)
    with pytest.raises(ValueError, match="prebuilt Mesh"):
        seed_node_mesh(1, 2)
    assert node_mesh("auto") is None
    mesh = make_mesh((4,), ("node",), devices=["cuda:0"] * 4)
    assert mesh.device_type == "cuda" and mesh.size == 4


def test_the_mesh_decides_where_the_shards_live(monkeypatch):
    cpu_mesh = make_mesh((2,), ("node",), device="cpu")
    assert mesh_device(cpu_mesh, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="device="):
        mesh_device(cpu_mesh, "cuda")
    cuda_mesh = Mesh(np.array([torch.device("cuda:0")] * 2, dtype=object),
                     ("node",))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_device(cuda_mesh, "cuda")            # no CUDA on this host
    with pytest.raises(ValueError, match="device="):
        run(_spec(), exec=CFG.replace(node_mesh=cuda_mesh), device="cpu")
    with pytest.raises(ValueError, match="one device type"):
        Mesh(np.array([torch.device("cpu"), torch.device("cuda:0")],
                      dtype=object), ("node",))
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((2,), ("node", "seed"), device="cpu")


def test_run_node_devices_one_is_the_plain_path():
    plain = run(_spec(), exec=CFG, device="cpu")
    one = run(_spec(), exec=CFG.replace(node_devices=1), device="cpu")
    assert_identical(plain, one, "node_devices=1")


def test_one_device_node_mesh_runs_the_sharded_program():
    """An explicit one-shard mesh runs the sharded program (halo-free)
    and stays within the contract of the unsharded run."""
    ShardedSparseMixer.reset_halo_copies()
    sharded = run(_spec(), device="cpu", exec=CFG.replace(
        node_mesh=make_mesh((1,), ("node",), device="cpu")))
    plain = run(_spec(), exec=CFG, device="cpu")
    assert ShardedSparseMixer.halo_copies == 0
    assert np.abs(sharded.final_w - plain.final_w).max() <= ATOL
    assert np.abs(sharded.w_bar_loss - plain.w_bar_loss).max() <= ATOL


def test_resolve_node_mesh_error_surfaces():
    with pytest.raises(ValueError, match="'node' axis"):
        resolve_node_mesh(None, make_mesh((1,), ("seed",), device="cpu"))
    assert resolve_node_mesh(None, None) is None
    assert resolve_node_mesh(1, None, device="cpu") is None
    with pytest.raises(ValueError, match="'node' axis"):
        run(_spec(), device="cpu", exec=CFG.replace(
            node_mesh=make_mesh((2,), ("seed",), device="cpu")))


def test_run_batch_rejects_node_mesh_without_seed_axis():
    with pytest.raises(ValueError, match="seed"):
        run_batch(_spec(), (0, 1), device="cpu", exec=CFG.replace(
            mesh=make_mesh((1,), ("node",), device="cpu")))


# -- mixer lowering and the partitioner --------------------------------------------

def test_sparse_graph_and_delay_unwraps_mixers():
    g, d = sparse_graph_and_delay(SparseMixer(graph=ring_edges(6)))
    assert d == 0 and g.m == 6
    g, d = sparse_graph_and_delay(
        DelayedMixer(inner=SparseMixer(graph=ring_edges(6)), delay=3))
    assert d == 3 and g.m == 6
    # RingRollMixer lowers to its exact edge-list form
    g, d = sparse_graph_and_delay(RingRollMixer(m=8, self_weight=0.3))
    from repro_torch.core.graph import ring_matrix
    np.testing.assert_array_equal(g.to_dense(), ring_matrix(8, 0.3))
    # fixed dense single-matrix stacks convert; schedules refuse
    g, _ = sparse_graph_and_delay(MIXERS.build("hypercube", m=8))
    assert g.edges > 0
    with pytest.raises(ValueError, match="time-varying"):
        sparse_graph_and_delay(MIXERS.build("time_varying", m=8))
    with pytest.raises(ValueError, match="node-sharded"):
        sparse_graph_and_delay(MIXERS.build("het_delayed", m=8, delay=2))
    with pytest.raises(ValueError, match="node-sharded"):
        sparse_graph_and_delay(MIXERS.build("disconnected", m=8))
    with pytest.raises(ValueError, match="node-sharded"):
        run(_spec(mixer="complete", mixer_options={}), device="cpu",
            exec=CFG.replace(node_devices=2))


@pytest.mark.parametrize("devices", [1, 2, 3, 4, 5])
def test_partition_reassembles_to_the_dense_matrix(devices):
    g = SparseGraph.make("ring", 10)
    part = partition_graph(g, devices)
    assert part.block * devices == part.m_pad >= 10
    A = np.zeros((part.m_pad, part.m_pad), np.float32)
    for o, dl, sl, ww in part.offsets:
        for d in range(devices):
            s = (d + o) % devices
            np.add.at(A, (dl[d] + d * part.block, sl[d] + s * part.block),
                      ww[d])
    np.testing.assert_array_equal(A[:10, :10], g.to_dense())
    assert np.all(A[10:] == 0) and np.all(A[:, 10:] == 0)
    np.testing.assert_array_equal(part.diag_blocks.ravel()[:10], g.diag())


@pytest.mark.parametrize("topology,devices", [("ring", 4), ("torus", 3),
                                              ("hypercube", 5)])
def test_partition_equals_the_reference_partition(topology, devices):
    kw = {"rows": 4} if topology == "torus" else {}
    g = SparseGraph.make(topology, 16, **kw)
    part = partition_graph(g, devices)
    ref = jshard.partition_graph(JSparseGraph.make(topology, 16, **kw),
                                 devices)
    assert (part.m, part.devices, part.block, part.m_pad) == \
        (ref.m, ref.devices, ref.block, ref.m_pad)
    assert len(part.offsets) == len(ref.offsets)
    for mine, theirs in zip(part.offsets, ref.offsets):
        assert mine[0] == theirs[0]
        for a, b in zip(mine[1:], theirs[1:]):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(part.diag_blocks,
                                  np.asarray(ref.diag_blocks))


def test_partition_rejects_zero_devices():
    with pytest.raises(ValueError, match="devices"):
        partition_graph(ring_edges(4), 0)
