"""Fault injection under node sharding — the port of
tests/test_faults_shard.py, held to the JAX package's faulty sharded runs.

The reference's faulty 4-device runs come from one subprocess with 8 fake
host devices (tests/test_torch_shard_node.py's harness). The port runs on
4 CPU shards with the reference's stream chunks, unit Laplace draws and
per-round link keeps injected (`FaultSchedule.link_keep` replaced, as
tests/test_torch_faults.py does). The contract: ``correct``,
``sparsity``, ``eps_ledger``, ``connectivity`` and the participated
rounds exact; ``final_w``, ``loss`` and ``w_bar_loss`` within 5e-6.
Inside the port: a zero-rate scenario is bit for bit the clean sharded
run; the faulty sharded run is within the contract of the faulty
unsharded run (its mix adds each row as `FaultySparseMixer` does) and
reruns bit for bit; stragglers and dense faulty mixers are refused.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.api import RunSpec as JRunSpec  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run  # noqa: E402
from repro_torch.api.shard_node import Blocks, partition_graph  # noqa: E402
from repro_torch.core.graph import ring_edges  # noqa: E402
from repro_torch.faults import (FaultSchedule, FaultSpec,  # noqa: E402
                                FaultyShardedSparseMixer)
from repro_torch.launch.mesh import make_mesh  # noqa: E402

from test_torch_faults import _jax_keep  # noqa: E402
from test_torch_run import (ReplayLaplace, ReplayStream,  # noqa: E402
                            _reference_draws)
from test_torch_shard_node import jax_subprocess  # noqa: E402

ATOL = 5e-6
EXACT = ("correct", "sparsity", "eps_ledger", "connectivity")
CLOSE = ("final_w", "loss", "w_bar_loss")
FIELDS = EXACT + CLOSE
M, N, T, D = 10, 8, 14, 4
BASE = dict(nodes=M, dim=N, horizon=T, eps=1.0, alpha0=0.5, lam=0.01,
            stream="drift", stream_options={"period": 7}, mixer="sparse",
            mixer_options={"topology": "ring"})
FAULTS = FaultSpec(link_rate=0.15, crashes=((3, 4, 9),),
                   partitions=((5, 8, 5),), seed=7)
CFG = ExecConfig(chunk_rounds=7, warmup=False, compute_regret=False)
PAIRS = {"reference": "reference", "cuda": "pallas"}

_SCRIPT = r"""
import sys
import numpy as np
import jax
from repro.api import ExecConfig, RunSpec, run
from repro.faults import FaultSpec
assert jax.local_device_count() == 8
out_path, base, fields, faults = (sys.argv[1], eval(sys.argv[2]),
                                  eval(sys.argv[3]), eval(sys.argv[4]))
cfg = ExecConfig(chunk_rounds=7, warmup=False, compute_regret=False,
                 node_devices=4)
out = {}
for backend in ("reference", "pallas"):
    for delay in (0, 2):
        res = run(RunSpec(**base, delay=delay, backend=backend,
                          faults=FaultSpec(**faults)), exec=cfg)
        for f in fields:
            out[f"{backend}/{delay}/{f}"] = np.asarray(getattr(res, f))
        out[f"{backend}/{delay}/participated"] = np.asarray(
            res.privacy["participated_rounds"])
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_faults_shard") / "runs.npz"
    jax_subprocess(_SCRIPT, str(path), repr(BASE), repr(FIELDS),
                   repr(dataclasses.asdict(FAULTS)))
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture
def ref_keeps(monkeypatch):
    """Every port schedule draws the reference's per-round link keeps."""
    monkeypatch.setattr(
        FaultSchedule, "link_keep",
        lambda self, t, num_links: _jax_keep(self.spec, int(t),
                                             int(num_links)))


def _port_spec(**kw):
    stream = JRunSpec(**BASE).resolve_stream()
    xs, ys = (np.asarray(a) for a in stream.chunk(0, T))
    spec = RunSpec(**BASE, **kw)
    mech = spec.resolve_mechanism()
    return spec.replace(stream=ReplayStream(xs, ys), mechanism=ReplayLaplace(
        eps=mech.eps, L=mech.L, calibration=mech.calibration,
        noise_self=mech.noise_self,
        draws=iter(_reference_draws(0, T, (M, N)))))


def assert_close(a, b, what):
    for f in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{what}: {f} must match")
    for f in CLOSE:
        d = np.abs(np.asarray(getattr(a, f))
                   - np.asarray(getattr(b, f))).max()
        assert d <= ATOL, f"{what}: {f} off by {d} (> {ATOL})"


def assert_identical(a, b, what):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{what}: {f} diverged")


@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("backend", list(PAIRS))
def test_faulty_sharded_run_matches_the_reference(jax_runs, ref_keeps,
                                                  backend, delay, engine):
    """Link drops + a crash window + a transient partition on 4 shards,
    against the reference's faulty 4-device run on the same draws."""
    port = run(_port_spec(delay=delay, backend=backend, faults=FAULTS),
               engine=engine, exec=CFG.replace(node_devices=D), device="cpu")
    key = f"{PAIRS[backend]}/{delay}"
    ref = type("Ref", (), {f: jax_runs[f"{key}/{f}"] for f in FIELDS})
    assert_close(port, ref, f"{backend}/{engine}/delay={delay}")
    np.testing.assert_array_equal(port.privacy["participated_rounds"],
                                  jax_runs[f"{key}/participated"])
    assert port.privacy["participated_rounds"][3] == T - 5
    assert port.connectivity.min() < 1.0


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", list(PAIRS))
def test_zero_fault_bit_identical_under_node_sharding(backend, engine,
                                                      delay):
    """A link_rate=0 scenario on 4 shards is bit for bit the clean sharded
    run: the keeps, the healed-mass fold and the faulty weights run but
    change nothing."""
    kw = dict(engine=engine, exec=CFG.replace(node_devices=D), device="cpu")
    clean = run(RunSpec(**BASE, delay=delay, backend=backend), **kw)
    zero = run(RunSpec(**BASE, delay=delay, backend=backend, faults="links",
                       faults_options={"link_rate": 0.0}), **kw)
    for f in ("final_w", "loss", "correct", "w_bar_loss", "sparsity"):
        np.testing.assert_array_equal(getattr(clean, f), getattr(zero, f),
                                      err_msg=f)


@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", list(PAIRS))
def test_faulty_sharded_matches_faulty_unsharded(backend, engine):
    """The port's own keeps: the faulty sharded run within the contract of
    the faulty unsharded run, layout-independent crash accounting, and a
    rerun bit for bit."""
    spec = RunSpec(**BASE, faults=FAULTS, backend=backend)
    flat = run(spec, engine=engine, exec=CFG, device="cpu")
    sh = run(spec, engine=engine, exec=CFG.replace(node_devices=D),
             device="cpu")
    assert_close(sh, flat, f"{backend}/{engine} sharded vs unsharded")
    assert (sh.privacy["participated_rounds"]
            == flat.privacy["participated_rounds"])
    again = run(spec, engine=engine, exec=CFG.replace(node_devices=D),
                device="cpu")
    assert_identical(sh, again, f"{backend}/{engine} rerun")


def test_faulty_sharded_mixer_is_row_stochastic_with_padding():
    """m = 10 on 4 shards: every real row of the effective matrix sums to
    1 under drops, crashes and a cut, and the pad rows stay empty."""
    sched = FaultSpec(link_rate=0.4, crashes=((2, 0, 5),),
                      partitions=((0, 5, 4),), seed=1).compile(m=M)
    part = partition_graph(ring_edges(M), D)
    mixer = FaultyShardedSparseMixer(part, ring_edges(M), sched,
                                     devices=("cpu",) * D)
    eye = torch.eye(part.m_pad)
    blocks = Blocks(eye[d * part.block:(d + 1) * part.block]
                    for d in range(D))
    for t in range(5):
        A = torch.cat(mixer.apply(blocks, t).parts)
        torch.testing.assert_close(A[:M].sum(dim=1), torch.ones(M))
        assert torch.equal(A[M:], torch.zeros_like(A[M:]))


# -- error surfaces (in-process) ---------------------------------------------------

def _spec(**kw):
    return RunSpec(**{**BASE, "nodes": 8, "horizon": 8, **kw})


def test_stragglers_rejected_under_node_sharding():
    s = _spec(faults=FaultSpec(stragglers=((0, 2),)))
    with pytest.raises(ValueError, match="straggler"):
        run(s, device="cpu", exec=CFG.replace(
            node_mesh=make_mesh((1,), ("node",), device="cpu")))
    with pytest.raises(ValueError, match="straggler"):
        FaultyShardedSparseMixer(partition_graph(ring_edges(8), 2),
                                 ring_edges(8), FaultSpec(
                                     stragglers=((0, 2),)).compile(m=8))


def test_dense_faulty_mixer_rejected_under_node_sharding():
    s = _spec(mixer="dense", mixer_options={}, faults="links",
              faults_options={"link_rate": 0.1})
    with pytest.raises(ValueError, match="sparse edge-list"):
        run(s, device="cpu", exec=CFG.replace(
            node_mesh=make_mesh((1,), ("node",), device="cpu")))


def test_one_device_node_mesh_runs_faults_in_process():
    """A one-shard mesh runs the faulty sharded mixer: zero-rate bit for
    bit the clean one-shard run, a faulty run within the contract of the
    faulty unsharded run."""
    mesh = make_mesh((1,), ("node",), device="cpu")
    kw = dict(exec=CFG.replace(node_mesh=mesh), device="cpu")
    clean = run(_spec(), **kw)
    zero = run(_spec(faults="links", faults_options={"link_rate": 0.0}),
               **kw)
    np.testing.assert_array_equal(clean.final_w, zero.final_w)
    faulty = run(_spec(faults="links", faults_options={"link_rate": 0.5}),
                 **kw)
    flat = run(_spec(faults="links", faults_options={"link_rate": 0.5}),
               exec=CFG, device="cpu")
    assert np.abs(faulty.final_w - flat.final_w).max() <= ATOL
