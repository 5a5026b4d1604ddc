"""repro_torch's ExecConfig and legacy-kwarg shim against repro's.

Every case of tests/test_exec_config.py on the port, each refusal's
message held to the message the reference gives for the same call (the
package name aside). Then: the legacy spelling equals the ``exec=``
spelling bit for bit on both entry points, the two ExecConfigs have the
same fields and defaults, and the multi-device fields shard the call
that uses them (on the CPU, D shards of ``cpu``), by ``exec=`` and by
legacy kwarg alike.
"""
import dataclasses
import warnings

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import exec_config as jec  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.api.runner import run_batch as jrun_batch  # noqa: E402

from repro_torch.api import ExecConfig, RunSpec, run  # noqa: E402
from repro_torch.api import exec_config as ec  # noqa: E402
from repro_torch.api.runner import run_batch  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402

SPEC = dict(nodes=4, dim=16, horizon=6, eps=1.0, alpha0=0.5, lam=0.01,
            stream="drift", stream_options={"period": 3})


def _spec(**kw):
    return RunSpec(**{**SPEC, **kw})


def _jspec(**kw):
    return JRunSpec(**{**SPEC, **kw})


def _message(call, exc):
    with pytest.raises(exc) as info:
        call()
    return str(info.value).replace("repro_torch", "repro")


def _same_refusal(port_call, ref_call, exc):
    """Both calls raise ``exc`` with one message; returns it."""
    ours, theirs = _message(port_call, exc), _message(ref_call, exc)
    assert ours == theirs
    return ours


@pytest.fixture(autouse=True)
def _quiet_shim():
    """Each test sees the shim's once-per-process warning state fresh."""
    ec._warned_legacy = jec._warned_legacy = True
    yield
    ec._warned_legacy = jec._warned_legacy = True


def test_exec_config_is_frozen_with_replace():
    cfg = ExecConfig(chunk_rounds=7)
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.chunk_rounds = 8
    assert cfg.replace(warmup=False).warmup is False
    assert cfg.replace(warmup=False).chunk_rounds == 7
    assert cfg.chunk_rounds == 7


def test_fields_and_defaults_are_the_references():
    ours = [(f.name, f.default) for f in dataclasses.fields(ExecConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JExecConfig)]
    assert ours == theirs


def test_legacy_kwargs_round_trip_bit_identical():
    spec = _spec()
    via_exec = run(spec, exec=ExecConfig(chunk_rounds=3, warmup=False,
                                         compute_regret=False), device="cpu")
    via_legacy = run(spec, chunk_rounds=3, warmup=False,
                     compute_regret=False, device="cpu")
    np.testing.assert_array_equal(via_exec.final_w, via_legacy.final_w)
    np.testing.assert_array_equal(via_exec.loss, via_legacy.loss)


def test_legacy_kwargs_warn_once():
    ec._warned_legacy = False
    spec = _spec()
    with pytest.warns(DeprecationWarning, match="ExecConfig") as record:
        run(spec, chunk_rounds=3, warmup=False, compute_regret=False,
            device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        run(spec, chunk_rounds=3, warmup=False, compute_regret=False,
            device="cpu")
    jec._warned_legacy = False
    with pytest.warns(DeprecationWarning) as jrecord:
        jrun(_jspec(), chunk_rounds=3, warmup=False, compute_regret=False)
    ours = [str(w.message).replace("repro_torch", "repro") for w in record
            if w.category is DeprecationWarning]
    theirs = [str(w.message) for w in jrecord
              if w.category is DeprecationWarning]
    assert ours == theirs and len(ours) == 1


def test_unknown_kwarg_names_fields():
    msg = _same_refusal(lambda: run(_spec(), chunk=3, device="cpu"),
                        lambda: jrun(_jspec(), chunk=3), TypeError)
    assert "chunk_rounds" in msg


def test_exec_and_legacy_together_raise():
    msg = _same_refusal(
        lambda: run(_spec(), exec=ExecConfig(), chunk_rounds=3,
                    device="cpu"),
        lambda: jrun(_jspec(), exec=JExecConfig(), chunk_rounds=3),
        TypeError)
    assert "both exec=" in msg


def test_exec_must_be_exec_config():
    msg = _same_refusal(
        lambda: run(_spec(), exec={"chunk_rounds": 3}, device="cpu"),
        lambda: jrun(_jspec(), exec={"chunk_rounds": 3}), TypeError)
    assert "ExecConfig" in msg


def test_run_rejects_batch_only_fields():
    msg = _same_refusal(
        lambda: run(_spec(), exec=ExecConfig(devices=2, warmup=False),
                    device="cpu"),
        lambda: jrun(_jspec(), exec=JExecConfig(devices=2, warmup=False)),
        ValueError)
    assert "run_batch" in msg


def test_run_batch_rejects_run_only_fields():
    msg = _same_refusal(
        lambda: run_batch(_spec(), [0, 1], device="cpu",
                          exec=ExecConfig(print_every=5, warmup=False)),
        lambda: jrun_batch(_jspec(), [0, 1],
                           exec=JExecConfig(print_every=5, warmup=False)),
        ValueError)
    assert "run()" in msg


@pytest.mark.parametrize("field", ["log_path", "node_mesh"])
def test_run_batch_rejects_the_other_run_only_fields(field):
    value = "x.csv" if field == "log_path" else object()
    _same_refusal(
        lambda: run_batch(_spec(), [0, 1], device="cpu",
                          exec=ExecConfig(**{field: value})),
        lambda: jrun_batch(_jspec(), [0, 1],
                           exec=JExecConfig(**{field: value})),
        ValueError)


@pytest.mark.parametrize("field", ["devices", "mesh"])
def test_run_rejects_each_batch_only_field_by_legacy_kwarg(field):
    value = 2 if field == "devices" else object()
    ec._warned_legacy = jec._warned_legacy = True
    _same_refusal(lambda: run(_spec(), device="cpu", **{field: value}),
                  lambda: jrun(_jspec(), **{field: value}), ValueError)


def test_run_batch_legacy_shim():
    spec = _spec()
    via_exec = run_batch(spec, [0, 1], device="cpu",
                         exec=ExecConfig(chunk_rounds=3, warmup=False,
                                         compute_regret=False))
    via_legacy = run_batch(spec, [0, 1], chunk_rounds=3, warmup=False,
                           compute_regret=False, device="cpu")
    for a, b in zip(via_exec, via_legacy):
        np.testing.assert_array_equal(a.final_w, b.final_w)
        np.testing.assert_array_equal(a.loss, b.loss)


def test_defaults_match_old_signature_defaults():
    cfg = ExecConfig()
    assert cfg.chunk_rounds == 512
    assert cfg.compute_regret is True
    assert cfg.warmup is True
    assert cfg.resume is False
    assert cfg.checkpoint_every is None and cfg.checkpoint_dir is None


# -- the multi-device fields ---------------------------------------------------

@pytest.mark.parametrize("legacy", [{"devices": 2}, {"devices": "auto"},
                                    {"mesh": make_mesh((2,), ("seed",),
                                                       device="cpu")},
                                    {"node_devices": 2}])
def test_run_batch_sharding_is_refused_naming_the_queue(legacy):
    """Each sharding field, passed as a legacy kwarg, shards the batch (no
    longer refused): the seed axis bit for bit the one-device batch, the
    ("seed", "node") grid within the float contract of it."""
    ec._warned_legacy = jec._warned_legacy = True
    kw = dict(chunk_rounds=3, warmup=False, compute_regret=False)
    sharded = run_batch(_spec(), [0, 1], device="cpu", **legacy, **kw)
    plain = run_batch(_spec(), [0, 1], device="cpu", **kw)
    seed_axis = "node_devices" not in legacy
    for a, b in zip(sharded, plain):
        np.testing.assert_array_equal(a.correct, b.correct)
        np.testing.assert_array_equal(a.sparsity, b.sparsity)
        d = np.abs(a.final_w - b.final_w).max()
        assert d == 0.0 if seed_axis else d <= 5e-6


@pytest.mark.parametrize("field,value", [("node_devices", 2),
                                         ("node_devices", "auto"),
                                         ("node_mesh",
                                          make_mesh((2,), ("node",),
                                                    device="cpu"))])
def test_run_node_sharding_is_refused_naming_the_queue(field, value):
    """node_devices / node_mesh shard the node axis (no longer refused),
    by legacy kwarg and by ``exec=`` alike, within the float contract of
    the plain run ("auto" on the CPU, one device, is the plain run)."""
    ec._warned_legacy = jec._warned_legacy = True
    kw = dict(chunk_rounds=3, warmup=False, compute_regret=False)
    plain = run(_spec(), exec=ExecConfig(**kw), device="cpu")
    legacy = run(_spec(), device="cpu", **{field: value}, **kw)
    via_exec = run(_spec(), exec=ExecConfig(**{field: value}, **kw),
                   device="cpu")
    np.testing.assert_array_equal(legacy.final_w, via_exec.final_w)
    np.testing.assert_array_equal(legacy.correct, plain.correct)
    np.testing.assert_array_equal(legacy.sparsity, plain.sparsity)
    assert np.abs(legacy.final_w - plain.final_w).max() <= 5e-6


def test_config_carries_the_multi_device_fields():
    """Building the config never raises: a config moves between the
    packages unchanged."""
    cfg = ExecConfig(devices=4, mesh="m", node_devices=2, node_mesh="n")
    assert (cfg.devices, cfg.node_devices) == (4, 2)
    assert ExecConfig(**dataclasses.asdict(JExecConfig(devices=4))) \
        .devices == 4
