"""`repro_torch.run` on every topology against `repro.api.run`, on the same
data and noise.

The reference's stream chunks and per-round unit Laplace draws are injected
into the port (`test_torch_run.py`'s harness). Each topology runs on both
backends: the port's torch-op engine against the reference's, and the
port's fused backend (its kernels' plain versions on the CPU) against the
reference's ``backend="pallas"`` in interpret mode, both in auto mode — so
the hypercube, random, torus, sparse and complete ``dense`` graphs take the
fused path on both sides, and the complete, time-varying, alternating-ring,
disconnected and per-edge-delay mixers the hybrid one. The contract is the
port's: ``correct``, ``sparsity`` and ``eps_ledger`` exact; ``final_w``,
``loss`` and ``w_bar_loss`` within 5e-6; regret within 1e-4 * T * m.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import run as jrun  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run  # noqa: E402
from test_torch_run import (ReplayLaplace, ReplayStream,  # noqa: E402
                            _reference_draws, assert_contract)

M, N, T = 8, 160, 12
BASE = dict(nodes=M, dim=N, horizon=T, alpha0=0.5, lam=0.05, eps=1.0,
            calibration="coordinate", clip_norm=1.0, seed=3)
# topology case -> RunSpec fields (the same in both packages)
CASES = {
    "complete": dict(mixer="complete"),
    "hypercube": dict(mixer="hypercube"),
    "random": dict(mixer="random"),
    "time_varying": dict(mixer="time_varying"),
    "torus": dict(mixer="torus"),
    "ring_alternating": dict(mixer="ring_alternating"),
    "disconnected": dict(mixer="disconnected"),
    "dense-complete": dict(mixer="dense",
                           mixer_options={"topology": "complete"}),
    "sparse-torus": dict(mixer="sparse", mixer_options={"topology": "torus"}),
    "het_delayed": dict(mixer="hypercube", delay=2, delay_dist="uniform"),
    "delayed-random": dict(mixer="random", delay=2),
}
# the kernel path the port's fused backend takes in auto mode
FUSED_SPARSE = {"hypercube", "random", "torus", "sparse-torus",
                "delayed-random"}
FUSED_DENSE = {"dense-complete"}
PAIRS = {"reference": "reference", "cuda": "pallas"}


@pytest.fixture(scope="module")
def injected():
    stream = JRunSpec(**BASE).resolve_stream()
    xs, ys = (np.asarray(a) for a in stream.chunk(0, T))
    return xs, ys, _reference_draws(BASE["seed"], T, (M, N))


def _port_spec(injected, **kw):
    xs, ys, draws = injected
    mech = ReplayLaplace(eps=BASE["eps"], L=BASE["clip_norm"],
                         calibration=BASE["calibration"], draws=iter(draws))
    return RunSpec(**BASE, **kw, stream=ReplayStream(xs, ys), mechanism=mech)


@pytest.mark.parametrize("backend", list(PAIRS))
@pytest.mark.parametrize("case", list(CASES))
def test_topology_run_matches_the_reference(injected, case, backend):
    ref = jrun(JRunSpec(**BASE, **CASES[case], backend=PAIRS[backend]),
               exec=JExecConfig(chunk_rounds=5, warmup=False))
    port = run(_port_spec(injected, **CASES[case], backend=backend),
               exec=ExecConfig(chunk_rounds=5, warmup=False), device="cpu")
    what = f"{case} on {backend}"
    assert_contract(ref, port, what)
    d = np.abs(port.regret - ref.regret).max()
    assert d <= 1e-4 * T * M, f"{what}: regret off by {d}"
    assert port.accuracy == pytest.approx(ref.accuracy)
    assert 0 < port.sparsity.max() and port.sparsity.min() < 1


@pytest.mark.parametrize("case", list(CASES))
def test_auto_mode_takes_the_fused_path_on_fixed_graphs(case):
    """Which path the fused backend's auto mode takes at the paper's m = 64:
    the fused one on a fixed graph — its CSR form when no row holds more
    than 16 non-zeros (hypercube 7, random 5-7, torus 5), else the dense A
    (complete: 64) — and the hybrid one otherwise; forcing mode='fused' on
    the latter raises, as in the reference."""
    from repro_torch.api.backends import _dense_mix_form
    spec = RunSpec(**{**BASE, "nodes": 64, "dim": 8}, **CASES[case],
                   backend="cuda")
    form = _dense_mix_form(spec.resolve_mixer(), torch.device("cpu"))
    if case in FUSED_SPARSE | FUSED_DENSE:
        A, diag, delay, csr = form
        assert (csr is not None) == (case in FUSED_SPARSE)
        assert delay == spec.resolve_mixer().delay
        np.testing.assert_array_equal(diag.numpy(), np.diagonal(A.numpy()))
    else:
        assert form is None
        with pytest.raises(ValueError, match="hybrid"):
            run(spec.replace(backend_options={"mode": "fused"}),
                exec=ExecConfig(chunk_rounds=4, compute_regret=False),
                device="cpu")
