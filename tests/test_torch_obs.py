"""repro_torch.obs against repro.obs: spans, metrics registry, event
streams, the report CLI, the profiler capture, and the telemetry-off
bit-identity contract across the port's runner / sweep / serve stack.

Every case of tests/test_obs.py is here but the HLO cost loop's, which
tests/test_torch_cost.py ports onto the port's op count. The event streams
of the two packages are held to the same event names and field keys, and
each package's report CLI renders the other's stream exactly as its own
(the cost loop's ``chunk_cost`` event included).
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.api import run_batch as jrun_batch  # noqa: E402
from repro.launch.obs import main as jobs_main  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
from repro_torch import ExecConfig, RunSpec, run, run_batch  # noqa: E402
from repro_torch.launch.obs import main as obs_main  # noqa: E402
from repro_torch.launch.obs import summarize_events  # noqa: E402
from repro_torch.obs import (EventLog, MetricsRegistry, Telemetry,  # noqa: E402
                             Tracer, group_runs, read_events)

FIELDS = ("final_w", "loss", "correct", "w_bar_loss", "sparsity",
          "eps_ledger", "regret")
SPEC = dict(nodes=2, dim=8, eps=1.0, alpha0=0.5, lam=0.01, stream="drift",
            stream_options={"period": 3})


def _spec(horizon=8, **kw):
    return RunSpec(**{**SPEC, "horizon": horizon, **kw})


def _cfg(**kw):
    return ExecConfig(**{"chunk_rounds": 4, "warmup": False, **kw})


@pytest.fixture(autouse=True)
def _ambient_off():
    """Every test starts and ends with the ambient default (disabled)."""
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()


# -- tracer ------------------------------------------------------------------

def test_span_nesting_records_parent_and_depth():
    tr = Tracer()
    with tr.span("outer"):
        with tr.span("inner", k=1):
            pass
    inner, outer = tr.spans
    assert (inner.name, inner.parent, inner.depth) == ("inner", "outer", 1)
    assert (outer.name, outer.parent, outer.depth) == ("outer", None, 0)
    assert inner.args == {"k": 1}
    assert outer.duration_s >= inner.duration_s >= 0.0


def test_disabled_tracer_records_nothing():
    tr = Tracer(enabled=False)
    with tr.span("never") as sp:
        pass
    assert tr.spans == [] and sp.duration_s == 0.0


def test_tracer_thread_stacks_are_independent():
    tr = Tracer()
    # barrier keeps all workers alive at once — thread idents are reused
    # after exit, and the distinct-thread assertion needs real overlap
    gate = threading.Barrier(4)

    def worker(name):
        with tr.span(name):
            gate.wait(timeout=10)

    threads = [threading.Thread(target=worker, args=(f"t{i}",))
               for i in range(4)]
    with tr.span("main"):
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in tr.spans}
    assert all(by_name[f"t{i}"].parent is None for i in range(4))
    assert len({s.thread for s in tr.spans}) == 5


def test_tracer_max_spans_drops_not_grows():
    tr = Tracer(max_spans=2)
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert len(tr.spans) == 2 and tr.dropped == 3


def test_chrome_export_shape(tmp_path):
    tr = Tracer()
    with tr.span("phase", engine="sim"):
        pass
    path = tr.export_chrome(str(tmp_path / "trace.json"))
    payload = json.load(open(path))
    events = payload["traceEvents"]
    metas = [e for e in events if e["ph"] == "M"]
    xs = [e for e in events if e["ph"] == "X"]
    assert len(metas) == 1 and len(xs) == 1
    assert xs[0]["name"] == "phase" and xs[0]["args"]["engine"] == "sim"
    assert xs[0]["dur"] >= 0


# -- metrics registry --------------------------------------------------------

def test_registry_get_or_create_and_snapshot():
    reg = MetricsRegistry()
    reg.counter("a").inc(2)
    reg.counter("a").inc(3)
    reg.gauge("g").set(1.5)
    for v in (0.1, 0.2):
        reg.histogram("h").observe(v)
    snap = reg.snapshot()
    assert snap["a"] == 5 and snap["g"] == 1.5
    assert snap["h"]["count"] == 2 and abs(snap["h"]["mean"] - 0.15) < 1e-12
    assert reg.names() == ["a", "g", "h"]


def test_registry_type_conflict_raises():
    reg = MetricsRegistry()
    reg.counter("x")
    with pytest.raises(TypeError, match="already a Counter"):
        reg.gauge("x")


def test_counter_rejects_negative():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)


def test_counter_concurrent_increments_lose_nothing():
    import sys
    reg = MetricsRegistry()
    c = reg.counter("n")

    def worker():
        for _ in range(1000):
            c.inc()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert c.value == 8000


def test_histogram_reservoir_caps_samples():
    reg = MetricsRegistry()
    h = reg.histogram("h", max_samples=10)
    for i in range(100):
        h.observe(float(i))
    assert h.count == 100           # exact count survives the cap
    assert len(h._samples) == 10
    assert h.summary()["max"] == 99.0


# -- event streams -----------------------------------------------------------

def test_event_log_roundtrip_and_grouping(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = EventLog(path)
    log.emit("run_start", run_id="r1", engine="sim")
    log.emit("chunk", run_id="r1", round_end=4)
    log.emit("publish", round=4)            # no run_id
    log.close()
    events = read_events(path)
    assert [e["event"] for e in events] == ["run_start", "chunk", "publish"]
    runs = group_runs(events)
    assert len(runs["r1"]) == 2 and len(runs[""]) == 1


def test_read_events_tolerates_torn_tail(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        f.write('{"ts": 1, "event": "a"}\n{"ts": 2, "ev')
    assert [e["event"] for e in read_events(path)] == ["a"]


def test_read_events_raises_on_mid_file_corruption(tmp_path):
    path = str(tmp_path / "events.jsonl")
    with open(path, "w") as f:
        f.write('{"ts": 1, "ev\n{"ts": 2, "event": "b"}\n')
    with pytest.raises(json.JSONDecodeError):
        read_events(path)


# -- Telemetry / ambient -----------------------------------------------------

def test_ambient_default_disabled_and_enable_disable():
    assert obs.active().enabled is False
    tel = obs.enable()
    assert obs.active() is tel and tel.enabled
    obs.disable()
    assert obs.active().enabled is False


def test_disabled_telemetry_is_inert(tmp_path):
    tel = Telemetry(enabled=False, events=str(tmp_path / "e.jsonl"),
                    cost=True, profile_dir=str(tmp_path / "prof"))
    with tel.span("x"):
        tel.emit("never")
    with tel.profile():
        pass
    assert tel.events is None and tel.cost_enabled is False
    assert tel.tracer.spans == []
    assert not os.path.exists(tmp_path / "e.jsonl")
    assert not os.path.exists(tmp_path / "prof")


# -- runner integration ------------------------------------------------------

def _assert_identical(a, b):
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f


@pytest.mark.parametrize("engine", ["sim", "dist"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_run_bit_identical_with_telemetry(engine, backend, tmp_path):
    spec = _spec(backend=backend)
    off = run(spec, engine=engine, exec=_cfg(), device="cpu")
    tel = Telemetry(events=str(tmp_path / "e.jsonl"))
    on = run(spec, engine=engine, exec=_cfg(obs=tel, warmup=True),
             device="cpu")
    tel.close()
    _assert_identical(off, on)
    assert len(on.metrics["obs"]["run_id"]) == 8
    kinds = [e["event"] for e in read_events(str(tmp_path / "e.jsonl"))]
    assert kinds == ["run_start", "chunk", "chunk", "run_end"]
    summary = tel.tracer.summary()
    assert summary["run.chunk"]["count"] == 2
    assert summary["run.compile"]["count"] == 1
    assert summary["run.regret"]["count"] == 1
    snap = tel.metrics.snapshot()
    assert snap["run.rounds"] == 8 and snap["run.eps_total"] == 1.0
    assert snap["run.chunk_seconds"]["count"] == 2
    assert "obs" not in off.metrics         # telemetry off leaves no trace


@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_run_batch_bit_identical_with_telemetry(engine, tmp_path):
    spec = _spec(backend="cuda")
    off = run_batch(spec, [0, 1], engine, exec=_cfg(), device="cpu")
    tel = Telemetry(events=str(tmp_path / "e.jsonl"))
    on = run_batch(spec, [0, 1], engine, exec=_cfg(obs=tel), device="cpu")
    tel.close()
    for o, n in zip(off, on):
        _assert_identical(o, n)
    ids = {r.metrics["obs"]["run_id"] for r in on}
    assert len(ids) == 1                    # one run_id for the batch
    events = read_events(str(tmp_path / "e.jsonl"))
    starts = [e for e in events if e["event"] == "run_start"]
    assert starts[0]["kind"] == "run_batch" and starts[0]["seeds"] == [0, 1]
    assert tel.metrics.snapshot()["run_batch.rounds"] == 8
    assert tel.tracer.summary()["run_batch.regret"]["count"] == 2


def test_faulty_run_publishes_connectivity_bit_identically(tmp_path):
    spec = _spec(faults="links", backend="cuda")
    off = run(spec, exec=_cfg(), device="cpu")
    tel = Telemetry()
    on = run(spec, exec=_cfg(obs=tel), device="cpu")
    _assert_identical(off, on)
    np.testing.assert_array_equal(on.connectivity, off.connectivity)
    assert (tel.metrics.snapshot()["faults.mean_connectivity"]
            == on.metrics["faults"]["mean_connectivity"])


def test_run_checkpoint_events_and_span(tmp_path):
    tel = Telemetry(events=str(tmp_path / "e.jsonl"))
    run(_spec(), exec=_cfg(checkpoint_every=4,
                           checkpoint_dir=str(tmp_path / "ckpt"), obs=tel),
        device="cpu")
    tel.close()
    kinds = [e["event"] for e in read_events(str(tmp_path / "e.jsonl"))]
    assert kinds.count("checkpoint") == 2
    assert tel.tracer.summary()["run.checkpoint"]["count"] == 2


def test_ambient_telemetry_reaches_run():
    tel = obs.enable()
    res = run(_spec(), exec=_cfg(), device="cpu")
    assert res.metrics["obs"]["run_id"]
    assert tel.metrics.snapshot()["run.rounds"] == 8


def test_profile_dir_writes_a_chrome_trace_of_the_chunk_loop(tmp_path):
    """The profiler wraps the chunk loop: its Chrome trace holds the
    round's ops (on the card, the round kernels' device events too —
    chip_smoke.py phase 15 checks those)."""
    prof = tmp_path / "prof"
    tel = Telemetry(profile_dir=str(prof))
    on = run(_spec(), exec=_cfg(obs=tel), device="cpu")
    _assert_identical(run(_spec(), exec=_cfg(), device="cpu"), on)
    traces = sorted(prof.glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert any(str(n).startswith("aten::") for n in names)


# -- the two packages' event streams -------------------------------------------

def _shape(path, skip=("ts", "run_id")):
    """[(event, sorted field keys)] of a stream, ids and times left out."""
    return [(e["event"], sorted(k for k in e if k not in skip))
            for e in read_events(path)]


def _same_fields(path_port, path_ref, keys):
    """The values that must agree between the packages' streams."""
    for p, r in zip(read_events(path_port), read_events(path_ref)):
        for k in keys:
            if k in r:
                assert p[k] == r[k], (p["event"], k, p[k], r[k])


@pytest.mark.parametrize("case", ["run-sim", "run-dist", "run_batch",
                                  "checkpoint"])
def test_event_streams_match_the_reference(case, tmp_path):
    kw = dict(chunk_rounds=4, warmup=False)
    port_path, ref_path = str(tmp_path / "p.jsonl"), str(tmp_path / "r.jsonl")
    tel, jtel = Telemetry(events=port_path), jobs.Telemetry(events=ref_path)
    if case == "checkpoint":
        kw.update(checkpoint_every=4)
        pkw = dict(checkpoint_dir=str(tmp_path / "pc"))
        jkw = dict(checkpoint_dir=str(tmp_path / "jc"))
    else:
        pkw = jkw = {}
    if case == "run_batch":
        run_batch(_spec(), [0, 1], exec=ExecConfig(**kw, obs=tel),
                  device="cpu")
        jrun_batch(JRunSpec(**SPEC, horizon=8), [0, 1],
                   exec=JExecConfig(**kw, obs=jtel))
    else:
        engine = "dist" if case == "run-dist" else "sim"
        run(_spec(), engine, exec=ExecConfig(**kw, **pkw, obs=tel),
            device="cpu")
        jrun(JRunSpec(**SPEC, horizon=8), engine,
             exec=JExecConfig(**kw, **jkw, obs=jtel))
    tel.close()
    jtel.close()
    assert _shape(port_path) == _shape(ref_path)
    _same_fields(port_path, ref_path,
                 ("kind", "engine", "stream", "nodes", "dim", "horizon",
                  "start_round", "seeds", "devices", "round_start",
                  "round_end", "eps", "step", "rounds", "eps_total"))


def test_sweep_and_serve_streams_match_the_reference(tmp_path):
    """A sweep's and a serving run's events: the same names and keys in
    both packages (the serve summary's nested keys too)."""
    from repro.serve import ServeConfig as JServeConfig
    from repro.serve import ServeService as JServeService
    from repro.sweep import SweepSpec as JSweepSpec
    from repro.sweep import sweep as jsweep
    from repro_torch.serve import ServeConfig, ServeService
    from repro_torch.sweep import SweepSpec, sweep

    def drive(o, SS, sweep_fn, Cfg, Svc, make_spec, **dev):
        sw = SS(base=make_spec(horizon=6), axes={"eps": (0.5, 1.0)},
                seeds=(0,), name="obs_demo", chunk_rounds=6,
                compute_regret=False)
        sweep_fn(sw, store=str(tmp_path / f"store{len(dev)}"),
                 warmup=False, **dev)
        spec = make_spec(horizon=8, stream="bursty", stream_options={})
        svc = Svc(Cfg(spec=spec, chunk_rounds=4, max_batch=4,
                      max_wait_ms=0.5, warmup=False, **dev)).start()
        assert svc.predict([1.0] * 8, node=0, timeout=30.0).status == "ok"
        svc.trainer.join(timeout=60)
        svc.stop()
        o.disable()

    port_path, ref_path = str(tmp_path / "p.jsonl"), str(tmp_path / "r.jsonl")
    obs.enable(events=port_path)
    drive(obs, SweepSpec, sweep, ServeConfig, ServeService, _spec,
          device="cpu")
    jobs.enable(events=ref_path)
    drive(jobs, JSweepSpec, jsweep, JServeConfig, JServeService,
          lambda **kw: JRunSpec(**{**SPEC, **kw}))
    assert _shape(port_path) == _shape(ref_path)
    port, ref = read_events(port_path)[-1], read_events(ref_path)[-1]
    assert port["event"] == ref["event"] == "serve_summary"
    for key in ("admission", "serving", "trainer"):
        assert sorted(port[key]) == sorted(ref[key]), key
    _same_fields(port_path, ref_path, ("sweep", "label", "seeds", "source",
                                       "round", "version", "eps"))


# -- sweep integration -------------------------------------------------------

def test_sweep_emits_point_spans_and_events(tmp_path):
    from repro_torch.sweep import SweepSpec, sweep
    tel = obs.enable(events=str(tmp_path / "e.jsonl"))
    sw = SweepSpec(base=_spec(horizon=6), axes={"eps": (0.5, 1.0)},
                   seeds=(0,), name="obs_demo", chunk_rounds=6,
                   compute_regret=False)
    sweep(sw, store=str(tmp_path / "store"), warmup=False, device="cpu")
    assert tel.tracer.summary()["sweep.point"]["count"] == 2
    assert tel.metrics.snapshot()["sweep.points_ran"] == 2
    points = [e for e in read_events(str(tmp_path / "e.jsonl"))
              if e["event"] == "sweep_point"]
    assert len(points) == 2 and all(p["source"] == "ran" for p in points)
    sweep(sw, store=str(tmp_path / "store"), reuse=True, warmup=False,
          device="cpu")
    assert tel.metrics.snapshot()["sweep.points_loaded"] == 2


# -- serve integration -------------------------------------------------------

def test_serve_counters_spans_and_summary_event(tmp_path):
    from repro_torch.serve import ServeConfig, ServeService
    tel = obs.enable(events=str(tmp_path / "e.jsonl"))
    spec = RunSpec(nodes=2, dim=8, horizon=8, eps=1.0, alpha0=0.5, lam=0.01,
                   stream="bursty")
    svc = ServeService(ServeConfig(spec=spec, chunk_rounds=4, max_batch=4,
                                   max_wait_ms=0.5, warmup=False,
                                   device="cpu")).start()
    r = svc.predict([1.0] * 8, node=0, timeout=30.0)
    assert r.status == "ok"
    svc.stop()
    snap = tel.metrics.snapshot()
    assert snap["serve.served"] >= 1 and snap["serve.batches"] >= 1
    assert snap["serve.latency_s"]["count"] >= 1
    assert snap["serve.published"] >= 1
    assert tel.tracer.summary()["serve.batch"]["count"] >= 1
    assert tel.tracer.summary()["serve.publish"]["count"] >= 1
    events = read_events(str(tmp_path / "e.jsonl"))
    summaries = [e for e in events if e["event"] == "serve_summary"]
    assert len(summaries) == 1
    adm = summaries[0]["admission"]
    assert adm["served"] >= 1 and "shed_reasons" in adm
    assert any(e["event"] == "publish" for e in events)


def test_serve_stats_summary_pins_shed_reasons():
    from repro_torch.serve.admission import ServeStats
    stats = ServeStats()
    stats.record_shed(reason="full")
    stats.record_shed(2, reason="timeout")
    out = stats.summary()
    assert out["shed_reasons"] == {"full": 1, "timeout": 2}
    assert out["shed"] == 3


def test_shed_reasons_mirror_into_registry():
    from repro_torch.serve.admission import ServeStats
    tel = obs.enable()
    stats = ServeStats()
    stats.record_shed(reason="timeout")
    stats.record_refused(2)
    snap = tel.metrics.snapshot()
    assert snap["serve.shed.timeout"] == 1 and snap["serve.refused"] == 2


# -- report CLI --------------------------------------------------------------

def test_report_cli_text_and_json(tmp_path, capsys):
    path = str(tmp_path / "e.jsonl")
    tel = Telemetry(events=path)
    run(_spec(), exec=_cfg(obs=tel), device="cpu")
    tel.close()
    rid = next(iter(summarize_events(path)["runs"]))

    assert obs_main(["report", "--events", path]) == 0
    text = capsys.readouterr().out
    assert f"run {rid}" in text and "chunks: 2" in text

    assert obs_main(["report", "--events", path, "--json"]) == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["runs"][rid]["chunks"] == 2
    assert payload["runs"][rid]["rounds"] == 8

    assert obs_main(["report", "--events", path, "--run", rid]) == 0
    capsys.readouterr()
    assert obs_main(["report", "--events", path, "--run", "nope"]) == 1


def test_report_cli_missing_stream(tmp_path, capsys):
    assert obs_main(["report", "--events",
                     str(tmp_path / "absent.jsonl")]) == 1
    assert "no events" in capsys.readouterr().out


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_report_cli_renders_either_packages_stream_identically(
        writer, tmp_path, capsys):
    """A stream written by one package renders the same through both
    report CLIs, text and JSON (each carries its chunk_cost)."""
    path = str(tmp_path / "e.jsonl")
    if writer == "repro":
        tel = jobs.Telemetry(events=path, cost=True)
        jrun(JRunSpec(**SPEC, horizon=8),
             exec=JExecConfig(chunk_rounds=4, warmup=False, obs=tel))
    else:
        tel = Telemetry(events=path, cost=True)
        run(_spec(), exec=_cfg(obs=tel), device="cpu")
    tel.close()
    outs = {}
    for name, cli in (("port", obs_main), ("ref", jobs_main)):
        for flag in ([], ["--json"]):
            assert cli(["report", "--events", path, *flag]) == 0
            outs[name, bool(flag)] = capsys.readouterr().out
    assert outs["port", False] == outs["ref", False]
    assert outs["port", True] == outs["ref", True]
    assert "cost: predicted" in outs["port", False]
