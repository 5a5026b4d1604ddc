"""repro_torch.run's custom mode and per-round CSV log against repro's.

Custom mode (``step_fn=``) is the reference's `_run_custom` loop: the
three cases of tests/test_runner.py on the port, then the same Python
``step_fn``, ``state`` and ``batches`` through both packages' `run`, which
must give equal history, final state, metrics, eps ledger and privacy, a
byte-equal step CSV and equal ``print_every`` lines (the seconds a step
masked). The stream mode's CSV log (``ExecConfig.log_path``) is held to
the reference's on the injected draws of tests/test_torch_run.py: the
header identical, ``accuracy``, ``eps`` and ``sparsity`` exact, ``loss``
and ``w_bar_loss`` within the 5e-6 float contract — and to the port's own
RunResult, every cell as ``str(float)`` writes it.
"""
import contextlib
import io
import os
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import run as jrun  # noqa: E402

from repro_torch import ExecConfig, RunResult, RunSpec, run  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint  # noqa: E402
from test_torch_run import (ATOL, BASE, T, _port_spec,  # noqa: E402,F401
                            injected)

SPEC = dict(nodes=4, dim=16, horizon=8, eps=1.0, alpha0=0.5, lam=0.01,
            stream="drift", stream_options={"period": 3})


def _counting():
    i = 0
    while True:
        yield i
        i += 1


# -- tests/test_runner.py's custom-mode cases ----------------------------------

def test_run_custom_step_fn_loop(tmp_path):
    calls = []

    def step_fn(state, batch):
        calls.append(batch)
        return state + batch, {"loss": float(state)}

    with warnings.catch_warnings():        # the reference's legacy spelling
        warnings.simplefilter("ignore", DeprecationWarning)
        res = run(None, engine="custom", step_fn=step_fn, state=0,
                  batches=_counting(), horizon=5, print_every=None,
                  log_path=str(tmp_path / "steps.csv"))
    assert res.final_state == 0 + 1 + 2 + 3 + 4
    assert len(res.history) == 5 and calls == [0, 1, 2, 3, 4]
    assert res.history[-1] == {"loss": 6.0}
    assert os.path.exists(tmp_path / "steps.csv")


def test_run_custom_mode_requires_horizon():
    with pytest.raises(ValueError):
        run(None, step_fn=lambda s, b: (s, {}), batches=iter([]), state=0)


def test_run_without_spec_or_step_fn_raises():
    with pytest.raises(ValueError, match="step_fn"):
        run(None)


# -- the same loop through both packages ----------------------------------------

def _step(state, batch):
    """A plain-Python step: numpy state, metrics of every kind the
    reference's print line reads."""
    nxt = state * np.float32(0.5) + np.float32(batch)
    return nxt, {"loss": np.float32(nxt.mean()), "ce": batch / 7.0,
                 "theta_sparsity": float((nxt == 0).mean())}


def _custom(run_fn, exec_cls, spec, tmp_path, name):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run_fn(spec, step_fn=_step,
                     state=np.zeros(3, np.float32), batches=_counting(),
                     horizon=7, exec=exec_cls(
                         log_path=str(tmp_path / f"{name}.csv"),
                         print_every=3))
    lines = [re.sub(r"\([0-9.]+s/step\)", "(s/step)", ln)
             for ln in out.getvalue().splitlines()]
    return res, lines


@pytest.mark.parametrize("with_spec", [False, True])
def test_custom_mode_matches_the_reference(tmp_path, with_spec):
    spec = RunSpec(**SPEC) if with_spec else None
    jspec = JRunSpec(**SPEC) if with_spec else None
    port, plines = _custom(run, ExecConfig, spec, tmp_path, "port")
    ref, rlines = _custom(jrun, JExecConfig, jspec, tmp_path, "ref")
    assert port.history == ref.history
    np.testing.assert_array_equal(port.final_state, ref.final_state)
    assert port.metrics == ref.metrics
    assert port.privacy == ref.privacy
    if with_spec:
        np.testing.assert_array_equal(port.eps_ledger, ref.eps_ledger)
    else:
        assert port.eps_ledger is None and ref.eps_ledger is None
    assert (port.rounds, port.engine) == (ref.rounds, ref.engine)
    assert plines == rlines and len(plines) == 3      # steps 0, 3, 6
    with open(tmp_path / "port.csv", "rb") as a, \
            open(tmp_path / "ref.csv", "rb") as b:
        assert a.read() == b.read()


def test_custom_mode_checkpoints_its_state(tmp_path):
    d = str(tmp_path / "ckpt")
    res = run(None, step_fn=_step, state=np.zeros(3, np.float32),
              batches=_counting(), horizon=6,
              exec=ExecConfig(checkpoint_every=2, checkpoint_dir=d))
    assert latest_step(d) == 6
    back = restore_checkpoint(d, np.zeros(3, np.float32), step=6)
    np.testing.assert_array_equal(back, res.final_state)


def test_custom_mode_drives_an_engine_round(tmp_path):
    """The loop phase 16 of chip_smoke.py runs at paper width: one round
    of the fused chunk program a step, equal to the stream-mode run."""
    from repro_torch.api.runner import _stream_chunk, make_chunk_program
    spec = RunSpec(**SPEC, backend="cuda")
    fn, init = make_chunk_program(spec, "sim", "cpu")
    stream = spec.resolve_stream(device="cpu")

    def step_fn(state, batch):
        state, out = fn(state, *batch)
        return state, {"loss": out.loss.mean(), "accuracy":
                       out.correct.mean()}

    def rounds():
        for t in range(spec.horizon):
            yield _stream_chunk(stream, t, t + 1, torch.device("cpu"))

    res = run(spec, step_fn=step_fn, state=init(spec.seed),
              batches=rounds(), horizon=spec.horizon)
    ref = run(spec, exec=ExecConfig(chunk_rounds=3, warmup=False,
                                    compute_regret=False), device="cpu")
    final_w = spec.resolve_local_rule().primal(
        res.final_state.theta,
        spec.omd_config().step_context(res.final_state.t))
    np.testing.assert_array_equal(final_w.numpy(), ref.final_w)
    assert [h["loss"] for h in res.history] == \
        [float(v) for v in ref.loss.mean(axis=1)]
    np.testing.assert_array_equal(res.eps_ledger, ref.eps_ledger)


def test_history_round_trips_through_the_record():
    res = run(None, step_fn=_step, state=np.zeros(3, np.float32),
              batches=_counting(), horizon=4)
    back = RunResult.from_record(res.to_record())
    assert back.history == res.history and back.metrics == res.metrics
    stream = run(RunSpec(**SPEC), device="cpu",
                 exec=ExecConfig(chunk_rounds=4, warmup=False))
    assert RunResult.from_record(stream.to_record()).history is None


# -- the stream mode's CSV log ---------------------------------------------------

def _rows(path):
    lines = open(path).read().strip().splitlines()
    return lines[0], [ln.split(",") for ln in lines[1:]]


def test_run_csv_log(tmp_path):
    path = str(tmp_path / "run.csv")
    with warnings.catch_warnings():        # the reference's legacy spelling
        warnings.simplefilter("ignore", DeprecationWarning)
        run(RunSpec(**SPEC), engine="sim", warmup=False,
            compute_regret=False, log_path=path, device="cpu")
    lines = open(path).read().strip().splitlines()
    assert len(lines) == 9  # header + one row per round
    assert "eps" in lines[0] and "accuracy" in lines[0]


@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_csv_rows_are_the_results_trajectories(tmp_path, engine, backend):
    path = str(tmp_path / "run.csv")
    spec = RunSpec(**SPEC, backend=backend)
    cfg = ExecConfig(chunk_rounds=3, warmup=False, compute_regret=False)
    res = run(spec, engine, exec=cfg.replace(log_path=path), device="cpu")
    plain = run(spec, engine, exec=cfg, device="cpu")
    np.testing.assert_array_equal(res.final_w, plain.final_w)
    header, rows = _rows(path)
    assert header == "step,accuracy,eps,loss,sparsity,w_bar_loss"
    want = [[str(t), str(float(res.correct[t].mean())),
             str(float(res.eps_ledger[t])), str(float(res.loss[t].mean())),
             str(float(res.sparsity[t])), str(float(res.w_bar_loss[t]))]
            for t in range(res.rounds)]
    assert rows == want


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_csv_log_matches_the_reference(tmp_path, injected, backend):
    jpath, ppath = str(tmp_path / "ref.csv"), str(tmp_path / "port.csv")
    jrun(JRunSpec(**BASE, eps=1.0),
         exec=JExecConfig(chunk_rounds=5, warmup=False, log_path=jpath))
    run(_port_spec(injected, eps=1.0, backend=backend), device="cpu",
        exec=ExecConfig(chunk_rounds=5, warmup=False, log_path=ppath))
    jheader, jrows = _rows(jpath)
    pheader, prows = _rows(ppath)
    assert pheader == jheader and len(prows) == len(jrows) == T
    cols = jheader.split(",")
    for p, j in zip(prows, jrows):
        row = dict(zip(cols, zip(p, j)))
        for f in ("step", "accuracy", "eps", "sparsity"):
            assert row[f][0] == row[f][1], (f, row[f])
        for f in ("loss", "w_bar_loss"):
            assert abs(float(row[f][0]) - float(row[f][1])) <= ATOL, \
                (f, row[f])


def test_csv_log_resumes_under_its_header(tmp_path):
    """A run resumed from a checkpoint appends its rounds to the first
    pass's file: together they are the uninterrupted run's file."""
    spec = RunSpec(**SPEC)
    cfg = ExecConfig(chunk_rounds=4, warmup=False, compute_regret=False)
    whole = str(tmp_path / "whole.csv")
    run(spec, exec=cfg.replace(log_path=whole), device="cpu")
    parts, d = str(tmp_path / "parts.csv"), str(tmp_path / "ckpt")
    run(spec, horizon=4, device="cpu",
        exec=cfg.replace(log_path=parts, checkpoint_every=4,
                         checkpoint_dir=d))
    run(spec, device="cpu", exec=cfg.replace(log_path=parts,
                                             checkpoint_every=4,
                                             checkpoint_dir=d, resume=True))
    assert open(parts).read() == open(whole).read()
