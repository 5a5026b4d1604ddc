"""The port end to end against `repro.api.run`, on the same data and noise.

The reference draws its stream and its Laplace noise with `jax.random`,
which the port cannot reproduce (and which moves between JAX versions). So
the draws are injected, never pinned: the reference stream's chunks go into
the port through a Stream instance (`ReplayStream`), and the reference
round's unit Laplace draws — ``key, sub = jax.random.split(state.key)`` then
``sample_laplace(sub, (m, n), 1)`` each round — through a Mechanism that
replays them (`ReplayLaplace`) while the port applies its own scale, so the
scale is checked too.

The contract (ROADMAP, North star): ``correct``, ``sparsity`` and
``eps_ledger`` exact; ``final_w``, ``loss`` and ``w_bar_loss`` within 5e-6.
``regret`` is held to 1e-4 * T * m absolute: its comparator comes from 1500
full-batch subgradient steps whose active set (margins < 1) is sensitive to
reduction order, so the two sides' comparators drift by ~1e-3 per
coordinate (tests/test_torch_core.py measures it), and the comparator term
sums T * m hinge terms.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.core.privacy import sample_laplace as jsample_laplace  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run  # noqa: E402
from repro_torch.api.mechanisms import LaplaceMechanism  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.convert import state_from_jax  # noqa: E402

ATOL = 5e-6
EXACT = ("correct", "sparsity", "eps_ledger")
CLOSE = ("final_w", "loss", "w_bar_loss")
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

    draws: object = None      # iterator over (m, n) float32 arrays

    def unit(self, generator, shape):
        u = next(self.draws)
        assert u.shape == tuple(shape)
        return torch.tensor(u)


def _reference_draws(seed, rounds, shape):
    """The unit Laplace draws of the reference round, round by round."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jsample_laplace(sub, shape, 1.0)))
    return out


@pytest.fixture(scope="module")
def injected():
    """Reference stream chunks and unit noise for the shared spec."""
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


_JAX_RUNS = {}


def _jax_run(backend, mode, eps, delay):
    key = (backend, mode, eps, delay)
    if key not in _JAX_RUNS:
        spec = JRunSpec(**BASE, eps=eps, delay=delay, backend=backend,
                        backend_options={"mode": mode} if mode else {})
        _JAX_RUNS[key] = jrun(spec, exec=JExecConfig(chunk_rounds=5,
                                                     warmup=False))
    return _JAX_RUNS[key]


def assert_contract(ref, port, what):
    for f in EXACT:
        np.testing.assert_array_equal(
            np.asarray(getattr(port, f)), np.asarray(getattr(ref, f)),
            err_msg=f"{what}: {f} must match exactly")
    for f in CLOSE:
        d = np.abs(np.asarray(getattr(port, f))
                   - np.asarray(getattr(ref, f))).max()
        assert d <= ATOL, f"{what}: {f} off by {d} (> {ATOL})"


# (port backend, port mode) -> the reference run it is held against
PAIRS = {
    ("reference", None): ("reference", None),
    ("cuda", "fused"): ("pallas", "fused"),
    ("cuda", "hybrid"): ("pallas", "hybrid"),
}


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("eps", [1.0, math.inf])
@pytest.mark.parametrize("backend,mode", list(PAIRS))
def test_port_matches_reference_run(injected, backend, mode, eps, delay):
    ref = _jax_run(*PAIRS[(backend, mode)], eps, delay)
    spec = _port_spec(injected, eps=eps, delay=delay, backend=backend,
                      backend_options={"mode": mode} if mode else {})
    port = run(spec, exec=ExecConfig(chunk_rounds=5, warmup=False),
               device="cpu")
    what = f"{backend}/{mode} eps={eps} delay={delay}"
    assert_contract(ref, port, what)
    d = np.abs(port.regret - ref.regret).max()
    assert d <= 1e-4 * T * M, f"{what}: regret off by {d}"
    assert port.rounds == T and port.accuracy == pytest.approx(ref.accuracy)
    # the workload is not degenerate: some but not all weights are zero
    assert 0 < port.sparsity.max() and port.sparsity.min() < 1


def test_state_carries_across_from_jax(tmp_path, injected):
    """The reference engine runs k rounds; its state (as the npz its
    checkpoint writes) carries into the port, and both run k more rounds
    on the same injected data and noise."""
    k = T // 2
    spec = JRunSpec(**BASE, eps=1.0, delay=2)
    cfg = JExecConfig(chunk_rounds=k, warmup=False, compute_regret=False)
    full = jrun(spec, exec=cfg)
    jdir = tmp_path / "jax"
    jrun(spec, horizon=k, exec=cfg.replace(checkpoint_every=k,
                                           checkpoint_dir=str(jdir)))
    state = state_from_jax(jdir / f"ckpt_{k:08d}.npz", "cpu", seed=3)
    assert state.t == k and state.history.shape == (3, M, N)

    pdir = tmp_path / "port"
    save_checkpoint(str(pdir), k, state)
    port = run(_port_spec(injected, start=k, eps=1.0, delay=2),
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
    np.testing.assert_array_equal(port.eps_ledger, full.eps_ledger[k:])


def test_port_checkpoint_resume_is_bit_stable(tmp_path):
    """Within the port: a run checkpointed mid-horizon and resumed equals
    its uninterrupted run bit for bit, on both backends (the state layout
    is backend-independent, so one resumes from the other's checkpoint)."""
    spec = RunSpec(**{**BASE, "horizon": 10}, eps=1.0, delay=2,
                   backend="cuda")
    cfg = ExecConfig(chunk_rounds=4, warmup=False, compute_regret=False)
    full = run(spec, exec=cfg, device="cpu")
    d = str(tmp_path / "ckpt")
    run(spec, horizon=6, exec=cfg.replace(checkpoint_every=6,
                                          checkpoint_dir=d), device="cpu")
    res = run(spec, exec=cfg.replace(checkpoint_dir=d, resume=True),
              device="cpu")
    assert res.start_round == 6
    np.testing.assert_array_equal(res.final_w, full.final_w)
    np.testing.assert_array_equal(res.loss, full.loss[6:])
    cross = run(spec.replace(backend="reference"),
                exec=cfg.replace(checkpoint_dir=d, resume=True), device="cpu")
    assert np.abs(cross.final_w - full.final_w).max() <= ATOL


def test_warmup_leaves_the_run_unchanged():
    spec = RunSpec(**BASE, eps=1.0, backend="cuda")
    cold = run(spec, exec=ExecConfig(chunk_rounds=5, warmup=False),
               device="cpu")
    warm = run(spec, exec=ExecConfig(chunk_rounds=5, warmup=True),
               device="cpu")
    for f in ("final_w", "loss", "correct", "sparsity", "regret"):
        np.testing.assert_array_equal(getattr(warm, f), getattr(cold, f))
