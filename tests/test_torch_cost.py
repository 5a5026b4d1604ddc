"""The port's predict-then-measure cost loop against repro's.

`repro_torch.launch.op_cost.count` is the counterpart of
`repro.launch.hlo_cost.analyze`: the cases of tests/test_hlo_cost.py that
carry over to an eager count (a matmul's flops exact, an elementwise
chain's bytes as operands plus results, views free), the kernel wrappers'
own reports (each of the five counts exactly its `kernels.work` numbers on
the CPU, none of its plain version's ops), and `obs.cost`
(`analyze_chunk`, `calibrate`, `CostModel`) as tests/test_obs.py holds the
reference's. Then the runner: `run` and `run_batch` with
``Telemetry(cost=True)`` equal the runs without it bit for bit on both
backends and engines, and carry the reference's ``metrics["obs"]["cost"]``
keys and event sequence for the same spec and chunking.
"""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.api import run_batch as jrun_batch  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
from repro_torch import ExecConfig, RunSpec, run, run_batch  # noqa: E402
from repro_torch.api.runner import (_copy_state, _stream_chunk,  # noqa: E402
                                    make_chunk_program)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import round_fused as rf  # noqa: E402
from repro_torch.kernels.hinge_grad import hinge_grad  # noqa: E402
from repro_torch.kernels.pdomd_update import pdomd_update  # noqa: E402
from repro_torch.kernels.work import work  # noqa: E402
from repro_torch.launch.op_cost import count  # noqa: E402
from repro_torch.obs import (ChunkCost, CostModel, Telemetry,  # noqa: E402
                             analyze_chunk, calibrate, read_events)

FIELDS = ("final_w", "loss", "correct", "w_bar_loss", "sparsity",
          "eps_ledger", "regret")
SPEC = dict(nodes=4, dim=16, eps=1.0, alpha0=0.5, lam=0.01, stream="drift",
            stream_options={"period": 3})


@pytest.fixture(autouse=True)
def _ambient_off():
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


def _f32(*shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


# -- op_cost.count: hlo_cost's rules on an eager call -----------------------------

def test_matmul_flops_exact():
    a, b = _f32(512, 512), _f32(512, 512, seed=1)
    out, c = count(lambda x, y: x @ y, a, b)
    assert c.flops == 2 * 512 ** 3
    assert c.hbm_bytes == 3 * 512 * 512 * 4
    assert c.collective_bytes == 0
    np.testing.assert_array_equal(out.numpy(), (a @ b).numpy())


def test_elementwise_chain_counts_every_operand_and_result():
    """No fusion discount in eager mode: each op reads its operands and
    writes its result; tanh is weighted as hlo_cost weighs it."""
    a, b = _f32(256, 256), _f32(256, 256, seed=1)
    _, c = count(lambda x, y: torch.tanh(x @ y) * 2 + 1, a, b)
    e = 256 * 256
    assert c.hbm_bytes == 4 * (3 * e + 2 * e + 2 * e + 2 * e)
    assert c.flops == 2 * 256 ** 3 + 6 * e + e + e
    assert {k: r["calls"] for k, r in c.ops.items()} == {
        "aten.mm": 1, "aten.tanh": 1, "aten.mul": 1, "aten.add": 1}


def test_reductions_count_their_input_elements():
    x = _f32(64, 100)
    _, c = count(lambda t: t.sum(dim=1), x)
    assert c.flops == 64 * 100
    assert c.hbm_bytes == 4 * (64 * 100 + 64)


@pytest.mark.parametrize("view", [
    lambda t: t.t(), lambda t: t.view(-1), lambda t: t[1:], lambda t: t[0],
    lambda t: t.expand(3, 8, 16)[0], lambda t: t.unsqueeze(0),
    lambda t: t.reshape(16, 8), lambda t: list(t.unbind(0))])
def test_views_count_nothing(view):
    _, c = count(view, _f32(8, 16))
    assert c.flops == 0 and c.hbm_bytes == 0 and c.ops == {}


def test_count_sees_only_its_own_thread():
    """The dispatch mode is entered around the counted call on its thread:
    a busy second thread (the serving client's, say) is not counted."""
    stop = threading.Event()

    def busy():
        t = torch.ones(32)
        while not stop.is_set():
            t = t + 1.0

    th = threading.Thread(target=busy)
    th.start()
    try:
        _, c = count(lambda x: [x * 2.0 for _ in range(50)], _f32(16))
    finally:
        stop.set()
        th.join()
    assert c.ops == {"aten.mul": {"calls": 50, "flops": 50 * 16.0,
                                  "bytes": 50 * 2 * 64.0}}


# -- each kernel wrapper reports its own work ----------------------------------

def _kernel_calls():
    m, n = 6, 40
    theta, x = _f32(m, n), _f32(m, n, seed=1)
    delta, recv = _f32(m, n, seed=2), _f32(m, n, seed=3)
    coeff, alive = _f32(m, seed=4), torch.ones(m)
    A = torch.softmax(_f32(m, m, seed=5), dim=1)
    diag = torch.diagonal(A).contiguous()
    csr = rf.MixCSR.ring_roll(m, 0.5, "cpu")
    ring = torch.as_tensor(np.asarray(
        [[0.5 if i == j else 0.25 if (i - j) % m in (1, m - 1) else 0.0
          for j in range(m)] for i in range(m)], np.float32))
    tiles = [_f32(16, 128, seed=s) for s in range(4)]
    xb, yb, wb = _f32(5, 256), torch.sign(_f32(5, seed=1)), _f32(256, seed=2)
    theta2, x2 = torch.stack([theta, x]), torch.stack([x, theta])
    half = torch.full((m,), 0.5)
    return {
        "round_stats": (lambda: rf.round_stats(theta, x, 0.01, m),
                        work("round_stats", m, n)),
        "round_stats_batch": (
            lambda: rf.round_stats(theta2, x2, 0.01, m),
            work("round_stats", m, n, seeds=2)),
        "round_update_dense": (
            lambda: rf.round_update(A, theta, delta, x, recv, coeff, diag,
                                    alive, 0.1, 0, True),
            work("round_update", m, n)),
        "round_update_sparse": (
            lambda: rf.round_update(ring, theta, delta, x, recv, coeff,
                                    half, alive, 0.1, 1, True, csr=csr),
            work("round_update", m, n, nnz=3 * m)),
        "dual_step": (lambda: rf.dual_step(theta, x, delta, coeff, alive,
                                           0.1),
                      work("dual_step", m, n)),
        "pdomd_update": (lambda: pdomd_update(*tiles, 0.1, 0.01),
                         work("pdomd_update", 16, 128)),
        "hinge_grad": (lambda: hinge_grad(xb, yb, wb),
                       work("hinge_grad", 5, 256)),
    }


@pytest.mark.parametrize("case", list(_kernel_calls()))
def test_a_kernel_wrapper_counts_exactly_its_work(case):
    call, (nbytes, flops) = _kernel_calls()[case]
    out, c = count(call)
    name = case.replace("_batch", "").replace("_dense", "").replace(
        "_sparse", "")
    assert c.ops == {f"kernel.{name}": {"calls": 1, "flops": float(flops),
                                        "bytes": float(nbytes)}}
    assert (c.flops, c.hbm_bytes) == (flops, nbytes)
    # the wrapper's outputs are those of an uncounted call
    again = call()
    for got, want in zip(out if isinstance(out, tuple) else (out,),
                         again if isinstance(again, tuple) else (again,)):
        assert torch.equal(got, want)


def test_pytree_ops_count_their_kernel_and_their_tile_plumbing():
    tree = {"w": _f32(3, 50)}
    tiles = ops.tree_to_tiles(tree)
    _, c = count(lambda: ops.pdomd_update(tiles, tiles, tiles, tiles,
                                          0.1, 0.01))
    rows = tiles.shape[0]
    assert c.ops["kernel.pdomd_update"]["bytes"] == work(
        "pdomd_update", rows, 128)[0]
    assert [k for k in c.ops if k.startswith("kernel.")] == \
        ["kernel.pdomd_update"]


def test_no_kernel_row_without_an_active_count():
    from repro_torch.kernels import work as kernel_work
    assert kernel_work.active() is None
    assert kernel_work.scope("round_stats", 4, 4) is kernel_work._NULL


# -- obs.cost ------------------------------------------------------------------

def test_analyze_chunk_predicts_from_the_count():
    x = _f32(32, 32)
    model = CostModel(peak_flops=1e12, peak_bandwidth=1e11)
    cc = analyze_chunk(lambda t: t @ t, x, model=model)
    assert isinstance(cc, ChunkCost)
    assert cc.cost.flops >= 2 * 32 ** 3
    assert cc.predicted_s == model.predict_seconds(cc.cost) > 0
    cc.record(cc.predicted_s)               # measured == predicted
    assert abs(cc.summary()["error_ratio"] - 1.0) < 1e-9
    assert cc.summary()["measured_chunks"] == 1


def test_analyze_chunk_scales_one_round_by_the_rounds():
    x = _f32(16, 16)
    model = CostModel(peak_flops=1e9, peak_bandwidth=1e9)
    one = analyze_chunk(lambda t: torch.exp(t @ t), x, model=model)
    k = analyze_chunk(lambda t: torch.exp(t @ t), x, model=model, rounds=7)
    assert (k.cost.flops, k.cost.hbm_bytes) == (7 * one.cost.flops,
                                                7 * one.cost.hbm_bytes)
    assert k.cost.ops["aten.exp"]["calls"] == 7
    assert k.predicted_s == pytest.approx(7 * one.predicted_s)


def test_summary_keys_are_the_references():
    jcc = jobs.ChunkCost(cost=type("C", (), {"flops": 1.0, "hbm_bytes": 2.0,
                                             "collective_bytes": 0.0})(),
                         model=jobs.CostModel(1.0, 1.0), predicted_s=2.0)
    cc = analyze_chunk(lambda t: t + 1.0, _f32(4),
                       model=CostModel(1.0, 1.0))
    for c in (cc, jcc):
        c.record(4.0)
    assert cc.summary().keys() == jcc.summary().keys()
    assert cc.model.summary().keys() == jcc.model.summary().keys()


def test_calibrate_is_positive_and_cached():
    model = calibrate(device="cpu")
    assert model.peak_flops > 0 and model.peak_bandwidth > 0
    assert calibrate(device="cpu") is model


def test_calibrate_defaults_to_cuda_and_refuses_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate()


# -- the runner's cost loop --------------------------------------------------------

def _spec(horizon=8, **kw):
    return RunSpec(**{**SPEC, "horizon": horizon, **kw})


def _cfg(**kw):
    return ExecConfig(**{"chunk_rounds": 4, "warmup": False, **kw})


def _assert_identical(a, b):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert a.final_state.t == b.final_state.t


def _kinds(path):
    return [e["event"] for e in read_events(path)]


def _ref_cost_run(tmp_path, batch=False):
    path = str(tmp_path / "r.jsonl")
    jtel = jobs.Telemetry(events=path, cost=True)
    cfg = JExecConfig(chunk_rounds=4, warmup=False, obs=jtel)
    if batch:
        out = jrun_batch(JRunSpec(**SPEC, horizon=8), [0, 1], exec=cfg)[0]
    else:
        out = jrun(JRunSpec(**SPEC, horizon=8), exec=cfg)
    jtel.close()
    return out, path


@pytest.mark.parametrize("warmup", [False, True])
@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_run_with_the_cost_loop_is_bit_identical(engine, backend, warmup,
                                                 tmp_path):
    spec = _spec(backend=backend)
    off = run(spec, engine, exec=_cfg(warmup=warmup), device="cpu")
    path = str(tmp_path / "e.jsonl")
    tel = Telemetry(events=path, cost=True)
    on = run(spec, engine, exec=_cfg(obs=tel, warmup=warmup), device="cpu")
    tel.close()
    _assert_identical(off, on)
    # the generators moved exactly as far (the count drew on a copy)
    assert torch.equal(off.final_state.generator.get_state(),
                       on.final_state.generator.get_state())
    cost = on.metrics["obs"]["cost"]
    ref, ref_path = _ref_cost_run(tmp_path)
    assert cost.keys() == ref.metrics["obs"]["cost"].keys()
    assert cost["measured_chunks"] == 2 and cost["predicted_s"] > 0
    assert cost["error_ratio"] is not None and cost["collective_bytes"] == 0
    assert _kinds(path) == _kinds(ref_path) == [
        "run_start", "chunk", "chunk", "chunk_cost", "run_end"]
    ev = [e for e in read_events(path) if e["event"] == "chunk_cost"][0]
    jev = [e for e in read_events(ref_path) if e["event"] == "chunk_cost"][0]
    assert ev.keys() == jev.keys()
    assert tel.tracer.summary()["run.chunk"]["count"] == 2


@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_run_batch_with_the_cost_loop_is_bit_identical(engine, backend,
                                                       tmp_path):
    spec = _spec(backend=backend)
    off = run_batch(spec, [0, 1], engine, exec=_cfg(), device="cpu")
    path = str(tmp_path / "e.jsonl")
    tel = Telemetry(events=path, cost=True)
    on = run_batch(spec, [0, 1], engine, exec=_cfg(obs=tel), device="cpu")
    tel.close()
    for o, n in zip(off, on):
        _assert_identical(o, n)
    ref, ref_path = _ref_cost_run(tmp_path, batch=True)
    costs = [r.metrics["obs"]["cost"] for r in on]
    assert costs[0] == costs[1]                      # one batch, one cost
    assert costs[0].keys() == ref.metrics["obs"]["cost"].keys()
    assert _kinds(path) == _kinds(ref_path)
    assert "chunk_cost" in _kinds(path)


def test_the_batch_counts_the_whole_seed_batch(tmp_path):
    """run_batch's chunk cost is the S-seed chunk program's: the kernel
    rows of S seeds in one launch (times the chunk's 4 rounds), the torch
    ops of every seed."""
    model = CostModel(peak_flops=1e12, peak_bandwidth=1e12)
    spec = _spec(backend="cuda")
    one = run(spec, exec=_cfg(obs=Telemetry(cost=True, cost_model=model)),
              device="cpu").metrics["obs"]["cost"]
    tel = Telemetry(cost=True, cost_model=model)
    two = run_batch(spec, [0, 1], exec=_cfg(obs=tel),
                    device="cpu")[0].metrics["obs"]["cost"]
    assert two["hbm_bytes"] > 1.9 * one["hbm_bytes"]
    assert two["model"] == model.summary()
    m, n = SPEC["nodes"], SPEC["dim"]
    kernel_bytes = 4 * (work("round_stats", m, n, seeds=2)[0]
                        + work("round_update", m, n, nnz=3 * m,
                               seeds=2)[0])
    rows = tel.tracer.summary()          # the count ran outside the loop
    assert rows["run_batch.chunk"]["count"] == 2
    assert two["hbm_bytes"] > kernel_bytes


def test_one_chunk_boundary_gets_no_cost(tmp_path):
    """A run resumed at its horizon runs no chunk: nothing is counted (as
    in the reference, the loop needs two boundaries)."""
    tel = Telemetry(cost=True)
    d = str(tmp_path / "ckpt")
    run(_spec(), exec=_cfg(checkpoint_every=4, checkpoint_dir=d),
        device="cpu")
    res = run(_spec(), exec=_cfg(obs=tel, checkpoint_every=4,
                                 checkpoint_dir=d, resume=True),
              device="cpu")
    assert "cost" not in res.metrics["obs"]


def test_fused_round_counts_at_least_its_kernels_bytes():
    """One round of the paper's spec (ring, Laplace, L2 clip) on the fused
    backend at a small width: its bytes are the two round kernels' plus
    the torch ops around them (noise draw, clip, loss, sparsity)."""
    m, n = 16, 96
    spec = RunSpec(nodes=m, dim=n, horizon=4, stream="social_sparse",
                   mixer="ring", mechanism="laplace", eps=1.0,
                   calibration="coordinate", clip_norm=1.0, alpha0=1.0,
                   lam=1e-3, backend="cuda")
    fn, init = make_chunk_program(spec, "sim", "cpu")
    state = init(0)
    xs, ys = _stream_chunk(spec.resolve_stream(device="cpu"), 0, 1,
                           torch.device("cpu"))
    _, c = count(fn, _copy_state(state), xs, ys)
    kernels = work("round_stats", m, n)[0] + work(
        "round_update", m, n, nnz=3 * m)[0]
    assert c.share("kernel.")[1] == kernels
    assert c.hbm_bytes >= kernels and c.share("aten.")[1] > 0
    assert {"kernel.round_stats", "kernel.round_update", "aten.rand"} <= \
        set(c.ops)
    # the count does not depend on the data: a second round counts alike
    _, again = count(fn, _copy_state(state), xs, ys)
    assert again.ops == c.ops
