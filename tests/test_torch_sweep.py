"""repro_torch.sweep — SweepSpec grids, the batched seed axis, the store, the
plot and the CLI, as tests/test_sweep.py holds `repro.sweep`.

The load-bearing guarantees, as the reference's:
  * a sweep point's seeds go through `run_batch` (or, for a seed-dependent
    stage, sequential `run()` calls) and every seed's result equals its own
    run;
  * RunResult survives the JSON record round trip exactly;
  * the store regenerates sweep results without re-running (reuse), and
    never silently reuses records from a changed spec.
The grid, the record identities and the CLI's axis parsing are
framework-free, so they are held to the reference's own functions too.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import sweep as jsweep  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402

from repro_torch.api import ExecConfig, RunResult, RunSpec, run  # noqa: E402
from repro_torch.sweep import (SweepSpec, SweepStore, SweepStoreMiss,  # noqa: E402
                               aggregate_records, record_key,
                               spec_from_record, spec_record, sweep)

SEEDS = (0, 1, 2)
SPEC = dict(nodes=3, dim=16, horizon=30, eps=1.0, alpha0=0.5, lam=0.01,
            stream="drift", stream_options={"period": 7})


def _spec(**kw):
    return RunSpec(**{**SPEC, **kw})


def _run(spec, chunk_rounds, **kw):
    return run(spec, exec=ExecConfig(chunk_rounds=chunk_rounds, warmup=False,
                                     **kw), device="cpu")


def _sweep(sw, **kw):
    return sweep(sw, warmup=False, device="cpu", **kw)


def _assert_results_equal(a: RunResult, b: RunResult, regret: bool = True):
    fields = ["final_w", "loss", "w_bar_loss", "correct", "sparsity",
              "eps_ledger"] + (["regret"] if regret else [])
    for f in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
            err_msg=f"field {f} diverged")
    assert a.accuracy == b.accuracy


# -- SweepSpec grid resolution ----------------------------------------------

GRIDS = {
    "grid": {"eps": (0.1, 1.0), "lam": (0.0, 0.5)},
    "zipped": {"nodes,horizon": ((2, 10), (4, 5)), "eps": (0.5, 1.0)},
}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_points_match_the_reference_grid(grid):
    """The same axes resolve to the reference's points, in its order, and
    each point's spec carries its coordinates."""
    axes = GRIDS[grid]
    sw = SweepSpec(base=_spec(), axes=axes)
    ref = jsweep.SweepSpec(base=JRunSpec(**SPEC), axes=axes)
    assert [p.coords for p in sw.points()] == [p.coords for p in ref.points()]
    assert sw.store_name == ref.store_name
    for p in sw.points():
        assert all(getattr(p.spec, k) == v for k, v in p.coords.items())


def test_points_grid_order():
    sw = SweepSpec(base=_spec(), axes=GRIDS["grid"])
    assert [p.coords for p in sw.points()] == [
        {"eps": 0.1, "lam": 0.0}, {"eps": 0.1, "lam": 0.5},
        {"eps": 1.0, "lam": 0.0}, {"eps": 1.0, "lam": 0.5}]
    assert sw.points()[1].spec.eps == 0.1 and sw.points()[1].spec.lam == 0.5
    assert sw.store_name == "sweep_eps-lam"


def test_points_zipped_axis_crosses_with_grid():
    sw = SweepSpec(base=_spec(), axes=GRIDS["zipped"])
    coords = [p.coords for p in sw.points()]
    assert coords[0] == {"nodes": 2, "horizon": 10, "eps": 0.5}
    assert coords[3] == {"nodes": 4, "horizon": 5, "eps": 1.0}
    assert sw.points()[3].spec.nodes == 4 and sw.points()[3].spec.horizon == 5


@pytest.mark.parametrize("kw,match", [
    (dict(axes={"nope": (1,)}), "unknown RunSpec field"),
    (dict(axes={"seed": (0, 1)}), "SweepSpec.seeds"),
    (dict(seeds=(0, 0)), "duplicate seeds"),
    (dict(axes={"nodes,horizon": (4,)}), "2-tuples"),
    (dict(axes={"eps": ()}), "no values"),
    (dict(seeds=()), "at least one seed"),
])
def test_spec_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        SweepSpec(base=_spec(), **kw)


@pytest.mark.parametrize("devices", [2, "auto"])
def test_spec_devices_refused_naming_the_queue(devices):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 4"):
        SweepSpec(base=_spec(), devices=devices)


# -- RunResult JSON round-trip ----------------------------------------------

@pytest.mark.parametrize("engine,delay", [("sim", 0), ("sim", 2), ("dist", 2)])
def test_runresult_record_round_trip_exact(engine, delay):
    res = run(_spec(delay=delay), engine=engine, device="cpu",
              exec=ExecConfig(chunk_rounds=15, warmup=False))
    back = RunResult.from_record(json.loads(json.dumps(
        res.to_record(include_state=True))))
    _assert_results_equal(res, back)
    assert back.rounds == res.rounds and back.engine == engine
    assert back.privacy == res.privacy
    orig, rest = res.final_state, back.final_state
    assert type(rest) is type(orig) and rest.t == orig.t
    assert torch.equal(orig.generator.get_state(), rest.generator.get_state())
    theta = (lambda s: s.theta) if engine == "sim" else \
        (lambda s: s.theta["w"])
    assert torch.equal(theta(orig), theta(rest))
    if delay:
        hist = (lambda s: s.history) if engine == "sim" else \
            (lambda s: s.history["w"])
        assert torch.equal(hist(orig), hist(rest))


def test_record_handles_inf_eps():
    res = _run(_spec(eps=math.inf), 30, compute_regret=False)
    back = RunResult.from_record(json.loads(json.dumps(res.to_record())))
    assert math.isinf(back.privacy["eps_per_round"])
    np.testing.assert_array_equal(back.eps_ledger, res.eps_ledger)


# -- the engine: batched points, the fallback, aggregates ----------------------

def test_sweep_aggregate_equals_the_mean_of_per_seed_runs():
    """A batched point (the ring) and a seed-dependent one (per-edge
    delays, which takes the sequential fallback): every seed's result is
    its own run()'s, and the aggregate is the mean over them."""
    sw = SweepSpec(base=_spec(horizon=16, delay=2),
                   axes={"delay_dist": (None, "uniform")}, seeds=SEEDS,
                   chunk_rounds=8, compute_regret=False)
    out = _sweep(sw, store=None)
    assert out.ran_points == 2
    for point, results in zip(out.points, out.results):
        seq = [_run(point.spec.replace(seed=s), 8, compute_regret=False)
               for s in SEEDS]
        for a, b in zip(results, seq):
            _assert_results_equal(a, b, regret=False)
        batched = "batch" in results[0].metrics
        assert batched == (point.coords["delay_dist"] is None)
    for row, results in zip(out.aggregate("accuracy"), out.results):
        accs = [r.accuracy for r in results]
        assert row["mean"] == float(np.mean(accs))
        assert row["std"] == float(np.std(accs)) and row["n"] == 3


def test_sweep_vectorize_seeds_true_refuses_a_seed_dependent_point():
    sw = SweepSpec(base=_spec(horizon=8, delay=2, delay_dist="uniform"),
                   seeds=(0, 1), chunk_rounds=8, compute_regret=False,
                   vectorize_seeds=True)
    with pytest.raises(ValueError, match="depends on RunSpec.seed"):
        _sweep(sw, store=None)


def test_sweep_end_to_end_with_store(tmp_path):
    sw = SweepSpec(base=_spec(horizon=12), axes={"eps": (0.5, 1.0)},
                   seeds=(0, 1), name="t_e2e", chunk_rounds=12,
                   compute_regret=False)
    out = _sweep(sw, store=str(tmp_path))
    assert out.ran_points == 2 and out.loaded_points == 0
    assert len(out.records) == 4
    store = SweepStore(str(tmp_path))
    assert store.names() == ["t_e2e"]
    assert len(store.load("t_e2e")) == 4
    assert {r["seed"] for r in store.query("t_e2e", eps=0.5)} == {0, 1}

    rows = out.aggregate("accuracy")
    assert [r["eps"] for r in rows] == [0.5, 1.0]
    assert all(r["n"] == 2 and r["std"] is not None for r in rows)

    again = _sweep(sw, store=str(tmp_path), reuse=True)
    assert again.ran_points == 0 and again.loaded_points == 2
    for a, b in zip(out.results, again.results):
        for ra, rb in zip(a, b):
            _assert_results_equal(ra, rb, regret=False)
    assert again.aggregate("accuracy") == rows

    _sweep(sw, store=str(tmp_path))
    assert len(store.load("t_e2e")) == 4
    with open(store.path("t_e2e")) as f:
        assert sum(1 for line in f if line.strip()) == 4


# -- the store ------------------------------------------------------------------

REC = {"coords": {"eps": 1.0}, "seed": 0, "engine": "sim", "spec": {},
       "result": {"accuracy": 0.5}}


def test_store_append_first_crash_durability(tmp_path):
    """Refreshed records persist the moment their point finishes (append),
    and a 'crash' before the end-of-sweep compaction still reads back
    deduped with the LAST write winning."""
    store = SweepStore(str(tmp_path))
    old = dict(REC, spec={"lam": 0.0}, result={"accuracy": 0.1})
    new = dict(old, result={"accuracy": 0.9})
    store.append("t_crash", [old])
    store.append("t_crash", [new])
    rows = store.load("t_crash")
    assert len(rows) == 1 and rows[0]["result"]["accuracy"] == 0.9
    store.compact("t_crash")
    with open(store.path("t_crash")) as f:
        assert sum(1 for line in f if line.strip()) == 1
    assert store.load("t_crash")[0]["result"]["accuracy"] == 0.9


def test_store_tolerates_torn_trailing_line(tmp_path):
    store = SweepStore(str(tmp_path))
    store.append("t_torn", [REC])
    with open(store.path("t_torn"), "a") as f:
        f.write('{"coords": {"eps": 2.0}, "seed": 1, "eng')   # torn write
    rows = store.load("t_torn")
    assert len(rows) == 1 and rows[0]["seed"] == 0
    with open(store.path("t_torn"), "a") as f:
        f.write("\n" + json.dumps(dict(REC, seed=2)) + "\n")
    with pytest.raises(json.JSONDecodeError):      # torn line now mid-file
        store.load("t_torn")


def test_store_append_heals_torn_tail(tmp_path):
    store = SweepStore(str(tmp_path))
    store.append("t_heal", [REC])
    with open(store.path("t_heal"), "a") as f:
        f.write('{"coords": {"eps": 2.0}, "seed": 1')       # torn, no \n
    store.append("t_heal", [dict(REC, seed=2)])
    assert sorted(r["seed"] for r in store.load("t_heal")) == [0, 2]
    store.compact("t_heal")
    with open(store.path("t_heal")) as f:
        assert sum(1 for line in f if line.strip()) == 2


def test_store_reuse_requires_regret_when_requested(tmp_path):
    sw = SweepSpec(base=_spec(horizon=12), axes={"eps": (0.5,)}, seeds=(0,),
                   name="t_regret", chunk_rounds=12, compute_regret=False)
    _sweep(sw, store=str(tmp_path))
    again = _sweep(sw.replace(compute_regret=True), store=str(tmp_path),
                   reuse=True)
    assert again.ran_points == 1 and again.results[0][0].regret is not None
    third = _sweep(sw.replace(compute_regret=True), store=str(tmp_path),
                   reuse=True)
    assert third.loaded_points == 1
    np.testing.assert_array_equal(third.results[0][0].regret,
                                  again.results[0][0].regret)


def test_store_never_reuses_changed_spec(tmp_path):
    sw = SweepSpec(base=_spec(horizon=12), axes={"eps": (0.5,)}, seeds=(0,),
                   name="t_stale", chunk_rounds=12, compute_regret=False)
    _sweep(sw, store=str(tmp_path))
    out = _sweep(sw.replace(base=_spec(horizon=12, lam=0.5)),
                 store=str(tmp_path), reuse=True)
    assert out.ran_points == 1 and out.loaded_points == 0


def test_spec_record_round_trip():
    spec = _spec(eps=math.inf, delay=3)
    rec = json.loads(json.dumps(spec_record(spec)))
    assert spec_from_record(rec) == spec
    assert record_key({"coords": {"a": 1}, "seed": 0, "engine": "sim",
                       "spec": rec}) == record_key(
        {"spec": rec, "engine": "sim", "seed": 0, "coords": {"a": 1}})


@pytest.mark.parametrize("a,b", [
    ({"coords": {"eps": 1}, "spec": {"lam": 0}},
     {"coords": {"eps": 1.0}, "spec": {"lam": 0.0}}),
    ({"coords": {"nodes": 4, "eps": math.inf}, "spec": {"delay": 2}},
     {"coords": {"eps": math.inf, "nodes": 4.0}, "spec": {"delay": 2.0}}),
])
def test_record_key_int_float_coords_identical(tmp_path, a, b):
    """The CLI parses eps=1 as int, the Python API passes 1.0 — one record
    identity (the reference's own), so upsert dedups instead of
    duplicating."""
    a, b = (dict(r, seed=0, engine="sim") for r in (a, b))
    assert record_key(a) == record_key(b) == jsweep.record_key(a)
    store = SweepStore(str(tmp_path))
    store.upsert("t_kk", [dict(a, result={"accuracy": 0.1})])
    store.upsert("t_kk", [dict(b, result={"accuracy": 0.2})])
    rows = store.load("t_kk")
    assert len(rows) == 1 and rows[0]["result"]["accuracy"] == 0.2


def test_spec_record_marks_instances():
    from repro_torch.api import SocialStream
    stream = SocialStream(n=16, nodes=3, rounds=8, device="cpu")
    rec = spec_record(_spec(stream=stream))
    assert rec["stream"] == {"__instance__": "SocialStream"}
    with pytest.raises(ValueError, match="audit-only"):
        spec_from_record(rec)


def test_aggregate_records():
    recs = [{"coords": {"eps": e}, "seed": s,
             "result": {"accuracy": 0.5 + 0.1 * s}}
            for e in (0.5, 1.0) for s in (0, 1)]
    rows = aggregate_records(recs, by=("eps",), value="accuracy")
    assert len(rows) == 2 and rows[0]["n"] == 2
    assert rows[0]["mean"] == pytest.approx(0.55)
    assert rows == jsweep.aggregate_records(recs, by=("eps",),
                                            value="accuracy")


def test_plot_regenerates_figure_rows_from_the_store(tmp_path):
    from repro_torch.sweep import plot
    sw = SweepSpec(base=_spec(horizon=12), axes={"eps": (0.5, 1.0)},
                   seeds=(0, 1), name="t_plot", chunk_rounds=12)
    out = _sweep(sw, store=str(tmp_path / "store"))
    summary = plot.plot_sweep("t_plot", store=SweepStore(
        str(tmp_path / "store")), out_dir=str(tmp_path / "fig"))
    assert summary["records"] == 4 and summary["axes"] == ["eps"]
    regret = summary["metrics"]["regret_final"]
    want = out.aggregate("regret_final")
    assert [r["mean"] for r in regret] == [r["mean"] for r in want]
    with open(summary["json_path"]) as f:
        assert json.load(f)["sweep"] == "t_plot"
    assert plot.main(["--store", str(tmp_path / "store"), "--out-dir",
                      str(tmp_path / "fig"), "t_plot"]) == 0
    assert plot.main(["--store", str(tmp_path / "store"), "nope"]) == 1


# -- CLI -------------------------------------------------------------------------

@pytest.mark.parametrize("arg,want", [
    ("eps=0.1,1,inf", ("eps", (0.1, 1, math.inf))),
    ("nodes,horizon=4:8,8:4", ("nodes,horizon", ((4, 8), (8, 4)))),
    ("mixer=ring,complete", ("mixer", ("ring", "complete"))),
])
def test_cli_axis_parsing(arg, want):
    from repro.launch.sweep import parse_axis as jparse_axis
    from repro_torch.launch.sweep import parse_axis
    assert parse_axis(arg) == want == jparse_axis(arg)


CLI = ["--nodes", "3", "--dim", "16", "--horizon", "12", "--chunk-rounds",
       "12", "--no-regret", "--device", "cpu"]


def test_store_lookup_int_float_identity(tmp_path):
    from repro_torch.launch.sweep import main
    argv = CLI + ["--seeds", "0", "--store", str(tmp_path), "--name", "t_if"]
    main(argv + ["--axis", "eps=1"])                 # int axis value
    out = main(argv + ["--axis", "eps=1.0", "--from-store"])  # float
    assert out["summary"]["loaded_points"] == 1
    assert out["summary"]["ran_points"] == 0
    store = SweepStore(str(tmp_path))
    assert len(store.query("t_if", eps=1)) == 1
    assert len(store.query("t_if", eps=1.0)) == 1


def test_require_store_raises_on_missing_records(tmp_path):
    sw = SweepSpec(base=_spec(horizon=12), axes={"eps": (0.5, 1.0)},
                   seeds=(0, 1), name="t_req", chunk_rounds=12,
                   compute_regret=False)
    with pytest.raises(SweepStoreMiss, match="no record"):
        _sweep(sw, store=str(tmp_path), reuse=True, require_store=True)
    assert not SweepStore(str(tmp_path)).load("t_req")   # nothing ran
    _sweep(sw, store=str(tmp_path))
    out = _sweep(sw, store=str(tmp_path), reuse=True, require_store=True)
    assert out.ran_points == 0 and out.loaded_points == 2
    with pytest.raises(SweepStoreMiss, match="eps=0.5"):
        _sweep(sw.replace(base=_spec(horizon=12, lam=0.5)),
               store=str(tmp_path), reuse=True, require_store=True)


def test_require_store_without_reuse_rejected(tmp_path):
    sw = SweepSpec(base=_spec(horizon=12), seeds=(0,), chunk_rounds=12)
    with pytest.raises(ValueError, match="reuse=True"):
        _sweep(sw, store=str(tmp_path), require_store=True)


def test_cli_from_store_empty_store_errors(tmp_path):
    from repro_torch.launch.sweep import main
    argv = CLI + ["--axis", "eps=0.5", "--seeds", "0,1", "--store",
                  str(tmp_path), "--name", "t_fs"]
    with pytest.raises(SystemExit, match="no record"):
        main(argv + ["--from-store"])
    main(argv)
    out = main(argv + ["--from-store"])
    assert out["summary"]["loaded_points"] == 1
    assert out["summary"]["ran_points"] == 0


def test_cli_main_smoke(tmp_path):
    """Both backends; the seed axis batched (one run_batch per point)."""
    from repro_torch.launch.sweep import main
    outs = [main(CLI + ["--axis", "eps=0.5,1.0", "--seeds", "0,1",
                        "--store", str(tmp_path), "--name", f"t_cli_{b}",
                        "--backend", b]) for b in ("cuda", "reference")]
    for out in outs:
        assert out["summary"]["ran_points"] == 2
        assert len(out["rows"]) == 2 and out["rows"][0]["eps"] == 0.5
    recs = SweepStore(str(tmp_path)).load("t_cli_cuda")
    assert len(recs) == 4 and recs[0]["spec"]["backend"] == "cuda"
    assert all(r["result"]["metrics"]["batch"]["seeds"] == [0, 1]
               for r in recs)
    # the fused round and the torch-op oracle agree on these runs
    assert [r["mean"] for r in outs[0]["rows"]] == \
        [r["mean"] for r in outs[1]["rows"]]


def test_cli_refuses_devices_naming_the_queue(tmp_path, capsys):
    from repro_torch.launch.sweep import main
    with pytest.raises(SystemExit):
        main(CLI + ["--axis", "eps=0.5", "--devices", "2", "--no-store"])
    assert "ROADMAP queue 1 item 4" in capsys.readouterr().err
