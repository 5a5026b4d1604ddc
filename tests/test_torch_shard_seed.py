"""The seed axis of `repro_torch.run_batch` over a device mesh — the port
of tests/test_shard_seed.py.

Seeds are independent runs, so a batch sharded over a ("seed",) mesh must
equal the one-device batch (and each seed's own `run()`) bit for bit:
S = 5 on 4 seed shards pads 3 duplicate seeds and drops them again, on
both engines, delay 0 and 2, both backends; checkpoints cross seed-shard
counts. The one-device batch is held to `repro.api.run_batch` on injected
draws in tests/test_torch_batch.py, so these equalities carry that hold to
the sharded batch. The ("seed", "node") grid equals the per-seed
node-sharded runs (held to the reference's in
tests/test_torch_shard_node.py) bit for bit. Then the sweep's ``devices``:
`SweepSpec` validation (the reference's messages), the engine and the
CLI. On the CPU the shards all sit on ``cpu``, as the reference's tests
put them on fake host devices.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sweep import SweepSpec as JSweepSpec  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402

from repro_torch import ExecConfig, RunSpec, run, run_batch  # noqa: E402
from repro_torch.launch.mesh import make_mesh, seed_mesh  # noqa: E402
from repro_torch.sweep import SweepSpec, sweep  # noqa: E402

FIELDS = ("final_w", "loss", "correct", "w_bar_loss", "sparsity",
          "eps_ledger")
BASE = dict(nodes=3, dim=16, horizon=14, eps=1.0, alpha0=0.5, lam=0.01,
            stream="drift", stream_options={"period": 7})
CFG = ExecConfig(chunk_rounds=7, warmup=False, compute_regret=False)
SEEDS = (0, 1, 2, 3, 4)


def _spec(**kw):
    return RunSpec(**{**BASE, **kw})


def assert_identical(a, b, what):
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
            err_msg=f"{what}: field {f} diverged")
    assert a.accuracy == b.accuracy, what


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_sharded_batch_bit_identical_to_the_batch_and_sequential(
        backend, engine, delay):
    """S = 5 on 4 seed shards (pad 3): every seed equals the one-device
    batch and its own run() bit for bit; the pad seeds leak nowhere."""
    sp = _spec(delay=delay, backend=backend)
    sharded = run_batch(sp, SEEDS, engine=engine, device="cpu",
                        exec=CFG.replace(devices=4))
    info = sharded[0].metrics["batch"]
    assert (info["devices"], info["pad_seeds"]) == (4, 3)
    assert len(sharded) == 5 and info["seeds"] == list(SEEDS)
    batch = run_batch(sp, SEEDS, engine=engine, exec=CFG, device="cpu")
    for s, sh, b in zip(SEEDS, sharded, batch):
        what = f"{backend}/{engine}/delay={delay}/seed={s}"
        assert_identical(sh, b, what + " sharded vs batch")
        seq = run(sp.replace(seed=s), engine=engine, exec=CFG, device="cpu")
        assert_identical(sh, seq, what + " sharded vs sequential")
        assert sh.final_state.theta is not None
    assert not np.array_equal(sharded[3].final_w, sharded[4].final_w)


def test_a_prebuilt_seed_mesh_shards_as_devices_does():
    mesh = make_mesh((2,), ("seed",), device="cpu")
    a = run_batch(_spec(), SEEDS[:3], exec=CFG.replace(mesh=mesh),
                  device="cpu")
    b = run_batch(_spec(), SEEDS[:3], exec=CFG.replace(devices=2),
                  device="cpu")
    assert a[0].metrics["batch"]["pad_seeds"] == 1
    for x, y in zip(a, b):
        assert_identical(x, y, "mesh= vs devices=")


@pytest.mark.parametrize("save,resume", [(4, 1), (1, 4), (2, 4)])
def test_checkpoint_crosses_device_counts(tmp_path, save, resume):
    """A batch checkpoint saved under one seed-shard count resumes bit for
    bit under another: the saved state is global, without pad seeds."""
    sp = _spec(delay=1, horizon=24)
    cfg = CFG.replace(chunk_rounds=6)
    full = run_batch(sp, SEEDS, exec=cfg, device="cpu")
    run_batch(sp, SEEDS, horizon=12, device="cpu",
              exec=cfg.replace(devices=save, checkpoint_every=12,
                               checkpoint_dir=str(tmp_path)))
    resumed = run_batch(sp, SEEDS, device="cpu",
                        exec=cfg.replace(devices=resume, resume=True,
                                         checkpoint_dir=str(tmp_path)))
    assert resumed[0].start_round == 12
    for f, r in zip(full, resumed):
        np.testing.assert_array_equal(f.final_w, r.final_w)
        np.testing.assert_array_equal(f.correct[12:], r.correct)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_seed_node_grid_matches_per_seed_sharded_runs(backend):
    """run_batch over a ("seed", "node") grid of 2 x 4 shards: every seed
    equals its own 4-shard run() bit for bit, and the 1 x 4 grid the 2 x 4
    one (the node reduction order depends on the node shards alone)."""
    nb = dict(nodes=10, dim=8, mixer="sparse",
              mixer_options={"topology": "ring"}, backend=backend)
    seeds = (0, 1, 2)
    for engine, delay in (("sim", 0), ("dist", 2)):
        sp = _spec(**nb, delay=delay)
        grid = run_batch(sp, seeds, engine=engine, device="cpu",
                         exec=CFG.replace(devices=2, node_devices=4))
        assert grid[0].metrics["batch"]["devices"] == 2
        assert grid[0].metrics["batch"]["pad_seeds"] == 1
        narrow = run_batch(sp, seeds, engine=engine, device="cpu",
                           exec=CFG.replace(node_devices=4))
        prebuilt = run_batch(sp, seeds, engine=engine, device="cpu",
                             exec=CFG.replace(mesh=make_mesh(
                                 (2, 4), ("seed", "node"), device="cpu")))
        for s, g, nv, pb in zip(seeds, grid, narrow, prebuilt):
            seq = run(sp.replace(seed=s), engine=engine, device="cpu",
                      exec=CFG.replace(node_devices=4))
            assert_identical(g, seq, f"{engine} grid seed={s} vs its run")
            assert_identical(g, nv, f"{engine} seed={s}: 2x4 vs 1x4 grid")
            assert_identical(g, pb, f"{engine} seed={s}: prebuilt grid")


# -- one device and the error surfaces (in-process) ---------------------------------

def test_seed_mesh_single_device_fallback():
    """'auto', 1, 0 and None all mean the one-device batch on the CPU."""
    for v in (None, 0, 1, "auto"):
        assert seed_mesh(v, device="cpu") is None
    assert seed_mesh(3, device="cpu").shape == {"seed": 3}


def test_seed_mesh_too_many_devices_errors(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="prebuilt Mesh"):
        seed_mesh(3)
    assert seed_mesh("auto").shape == {"seed": 2}
    assert [str(d) for d in seed_mesh(2).devices] == ["cuda:0", "cuda:1"]


def test_run_batch_devices_auto_graceful_on_one_device():
    auto = run_batch(_spec(), (0, 1), exec=CFG.replace(devices="auto"),
                     device="cpu")
    plain = run_batch(_spec(), (0, 1), exec=CFG, device="cpu")
    for a, b in zip(auto, plain):
        assert_identical(a, b, "devices='auto' on one device")
    assert auto[0].metrics["batch"]["devices"] == 1
    assert auto[0].metrics["batch"]["pad_seeds"] == 0


def test_run_batch_rejects_mesh_without_seed_axis():
    with pytest.raises(ValueError, match="'seed' axis"):
        run_batch(_spec(), (0, 1), device="cpu", exec=CFG.replace(
            mesh=make_mesh((1,), ("data",), device="cpu")))


@pytest.mark.parametrize("devices", [None, "auto", 4, 0, "many", -2])
def test_sweepspec_devices_validation(devices):
    """The port's SweepSpec accepts and refuses what the reference's does,
    with the same message."""
    def outcome(cls, base):
        try:
            cls(base=base, devices=devices)
        except ValueError as e:
            return str(e)
        return None
    assert outcome(SweepSpec, _spec()) == outcome(JSweepSpec,
                                                  JRunSpec(**BASE))
    if devices in (0, "many", -2):
        assert "devices" in outcome(SweepSpec, _spec())


def test_sweep_engine_sharded_matches_one_device():
    """SweepSpec(devices=) shards each point's batch and agrees with the
    one-device sweep per (point, seed); a seed-dependent stage still falls
    back to sequential runs, devices or not."""
    sw = dict(base=_spec(), axes={"eps": (0.5, 1.0)}, seeds=(0, 1, 2),
              chunk_rounds=7, compute_regret=False)
    sharded = sweep(SweepSpec(**sw, devices=4), store=None, warmup=False,
                    device="cpu")
    plain = sweep(SweepSpec(**sw), store=None, warmup=False, device="cpu")
    for prs, vrs in zip(sharded.results, plain.results):
        for a, b in zip(prs, vrs):
            assert_identical(a, b, "sweep sharded vs one device")
            assert a.metrics["batch"]["devices"] == 4
    dd = _spec(delay=2, delay_dist="uniform", horizon=7)
    fb = sweep(SweepSpec(base=dd, seeds=(0, 1), chunk_rounds=7,
                         compute_regret=False, devices=4),
               store=None, warmup=False, device="cpu")
    for s, res in zip((0, 1), fb.results[0]):
        seq = run(dd.replace(seed=s), exec=CFG, device="cpu")
        assert_identical(res, seq, f"fallback seed={s}")


def test_sweep_devices_auto_on_one_device():
    sw = SweepSpec(base=_spec(), seeds=(0, 1), chunk_rounds=6,
                   compute_regret=False, devices="auto")
    out = sweep(sw, store=None, warmup=False, device="cpu")
    for s, res in zip((0, 1), out.results[0]):
        seq = run(_spec().replace(seed=s), device="cpu",
                  exec=CFG.replace(chunk_rounds=6))
        np.testing.assert_array_equal(res.final_w, seq.final_w)


@pytest.mark.parametrize("devices", ["auto", "2"])
def test_cli_devices_parsing(tmp_path, devices):
    from repro_torch.launch.sweep import main
    out = main(["--nodes", "3", "--dim", "16", "--horizon", "6",
                "--axis", "eps=0.5", "--seeds", "0,1,2",
                "--chunk-rounds", "6", "--no-regret", "--devices", devices,
                "--store", str(tmp_path), "--name", "t_dev",
                "--device", "cpu"])
    assert out["summary"]["ran_points"] == 1
