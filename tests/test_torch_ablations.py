"""The port's ablations (`repro_torch.figures.ablation_sparse_methods`,
`ablation_delay`) against the reference's (``benchmarks/ablation_*.py``),
at ``Scale.smoke()``, held as tests/test_torch_figures.py holds the
figures.

* Each ablation's sweeps, captured before they run: the same names,
  seeds, engines, regret switches and points, and at every point the
  reference's `RunSpec` field for field but ``backend``: the port runs
  ``omd`` (and every delay) on ``"cuda"`` — the kernels' plain versions
  here — and truncated gradient and RDA on ``"reference"``, since the
  fused round hard-codes the paper's rule.
* Each sparse method's point and the delay-2 point, run on the port with
  the reference stream's chunks and unit Laplace draws injected, hold to
  `repro.api.run` of the same point: ``correct``, ``sparsity``,
  ``eps_ledger`` exact, ``final_w``, ``loss``, ``w_bar_loss`` within 5e-6
  or 16 ulps of the field's largest |value| (tests/test_torch_figures.py's
  bound, for the drift ROADMAP queue 3 records); the delay point's dist
  run equals its sim run bit for bit.
* Both packages' ablations run once: the JSON file names, row keys and
  point order are the reference's (the bench file's too); ``from_store``
  rewrites each JSON unchanged without a run; the reference's store serves
  the port nothing; the bench file goes under ``out_dir`` (or
  ``bench_path``), never to the working directory or the repository's
  ``BENCH_delay.json``.
"""
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))         # the reference's benchmarks/

from benchmarks import ablation_delay as jdelay  # noqa: E402
from benchmarks import ablation_sparse_methods as jsparse  # noqa: E402
from benchmarks import common as jcommon  # noqa: E402
from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.sweep import spec_record as jspec_record  # noqa: E402

from repro_torch import ExecConfig, run  # noqa: E402
from repro_torch.figures import ablation_delay, ablation_sparse_methods  # noqa: E402
from repro_torch.figures import common  # noqa: E402
from repro_torch.sweep import SweepStoreMiss, spec_record  # noqa: E402
from repro_torch.sweep import engine as sweep_engine  # noqa: E402

from test_torch_run import (ReplayLaplace, ReplayStream,  # noqa: E402
                            _reference_draws)

ATOL = 5e-6
ULPS = 16
EXACT = ("correct", "sparsity", "eps_ledger")
CLOSE = ("final_w", "loss", "w_bar_loss")
SCALE = common.Scale.smoke()
DELAYS = jdelay.SMOKE_DELAYS
# sweep name -> (port module, reference module, the run's keyword arguments)
SWEEPS = {
    "ablation_sparse_methods": (ablation_sparse_methods, jsparse, {}),
    "ablation_delay_sim": (ablation_delay, jdelay, {"delays": DELAYS}),
    "ablation_delay_dist": (ablation_delay, jdelay, {"delays": DELAYS}),
}
FILES = ["BENCH_delay.json", "ablation_delay.json",
         "ablation_sparse_methods.json"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are small, and idle pool
    threads spinning between ops starve parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Captured(Exception):
    pass


class _Stub:
    points, results = (), ()


def _capture(monkeypatch, common_module, module, kw, index, tmp):
    """The ``index``-th SweepSpec ``module.run`` hands its package's
    sweep (earlier sweeps return an empty stub)."""
    seen = []

    def fake_sweep(spec, **_):
        seen.append(spec)
        if len(seen) > index:
            raise _Captured
        return _Stub()

    monkeypatch.setattr(common_module, "sweep", fake_sweep)
    scale = jcommon.Scale(**vars(SCALE)) if common_module is jcommon \
        else SCALE
    with pytest.raises(_Captured):
        module.run(scale, out_dir=str(tmp), **kw)
    monkeypatch.undo()
    return seen[index]


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """sweep name -> (the port's SweepSpec, the reference's)."""
    tmp = tmp_path_factory.mktemp("capture")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, (port, ref, kw) in SWEEPS.items():
            index = 1 if name.endswith("dist") else 0
            out[name] = (_capture(mp, common, port, kw, index, tmp),
                         _capture(mp, jcommon, ref, kw, index, tmp))
    return out


def _no_backend(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "backend"}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_the_spec_at_every_point_is_the_reference_s(sweeps, name):
    mine, ref = sweeps[name]
    assert (mine.name, mine.seeds, mine.engine, mine.chunk_rounds,
            mine.compute_regret) == (ref.name, ref.seeds, ref.engine,
                                     ref.chunk_rounds, ref.compute_regret)
    points, ref_points = mine.points(), ref.points()
    assert [{k: v for k, v in p.coords.items() if k != "backend"}
            for p in points] == [p.coords for p in ref_points]
    for p, q in zip(points, ref_points):
        want = ablation_sparse_methods.BACKENDS.get(
            p.spec.local_rule, "cuda")
        assert p.spec.backend == want and q.spec.backend == "reference"
        assert _no_backend(spec_record(p.spec)) == \
            _no_backend(jspec_record(q.spec)), p.label()


POINTS = [("ablation_sparse_methods", 0), ("ablation_sparse_methods", 1),
          ("ablation_sparse_methods", 2), ("ablation_delay_sim", 1)]


@pytest.mark.parametrize("name,k", POINTS,
                         ids=["omd", "tg", "rda", "delay2"])
def test_one_point_holds_to_the_reference(sweeps, name, k):
    mine, ref = sweeps[name]
    ref_spec = ref.points()[k].spec
    want = jrun(ref_spec, exec=JExecConfig(chunk_rounds=SCALE.T,
                                           warmup=False,
                                           compute_regret=False))
    m, n, T = ref_spec.nodes, ref_spec.dim, ref_spec.horizon
    xs, ys = (np.asarray(a) for a in ref_spec.resolve_stream().chunk(0, T))

    def port_spec():
        spec = mine.points()[k].spec
        mech = spec.resolve_mechanism()
        return spec.replace(stream=ReplayStream(xs, ys),
                            mechanism=ReplayLaplace(
                                eps=mech.eps, L=mech.L,
                                calibration=mech.calibration,
                                noise_self=mech.noise_self,
                                draws=iter(_reference_draws(spec.seed, T,
                                                            (m, n)))))

    cfg = ExecConfig(chunk_rounds=SCALE.T, warmup=False,
                     compute_regret=False)
    got = run(port_spec(), exec=cfg, device="cpu")
    what = f"{name} {mine.points()[k].label()}"
    for f in EXACT:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            err_msg=f"{what}: {f} must match exactly")
    for f in CLOSE:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        tol = max(ATOL, ULPS * float(np.spacing(np.abs(b).max())))
        d = np.abs(a - b).max()
        assert d <= tol, f"{what}: {f} off by {d} (> {tol})"
    if name == "ablation_delay_sim":
        dist = run(port_spec(), engine="dist", exec=cfg, device="cpu")
        for f in EXACT + CLOSE:
            np.testing.assert_array_equal(
                np.asarray(getattr(dist, f)), np.asarray(getattr(got, f)),
                err_msg=f"{what}: dist vs sim {f}")


def _digest(path) -> str:
    return hashlib.sha256(pathlib.Path(path).read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def ablation_runs(tmp_path_factory):
    """Both packages' ablations run once at the smoke scale from a working
    directory of their own: the port's through its delay CLI and
    `ablation_sparse_methods.run`, the reference's with its defaults
    (its store is ``experiments/store`` there)."""
    tmp = tmp_path_factory.mktemp("ablations")
    root_bench = ROOT / "BENCH_delay.json"
    before = _digest(root_bench)
    port_out, port_store = tmp / "port_out", tmp / "port_store"
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        results = {
            "ablation_sparse_methods": ablation_sparse_methods.run(
                SCALE, out_dir=str(port_out), device="cpu",
                store=str(port_store)),
            "ablation_delay": ablation_delay.main(
                ["--smoke", "--device", "cpu", "--out", str(port_out),
                 "--store", str(port_store)])}
        cwd_files = sorted(p.name for p in tmp.iterdir())
        jsparse.run(jcommon.Scale.smoke(), out_dir=str(tmp / "ref_out"))
        jdelay.run(jcommon.Scale.smoke(), out_dir=str(tmp / "ref_out"),
                   bench_path=str(tmp / "ref_out" / "BENCH_delay.json"),
                   delays=DELAYS)
    assert _digest(root_bench) == before
    return dict(tmp=tmp, port_out=port_out, port_store=port_store,
                ref_out=tmp / "ref_out", ref_store=tmp / "experiments/store",
                results=results, cwd_files=cwd_files)


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_the_ablations_write_the_reference_files_under_out_dir(
        ablation_runs):
    """The bench file lands under --out: nothing in the working directory
    but what the test made, and the repository's BENCH_delay.json is
    unchanged (the fixture compares its digest)."""
    assert sorted(p.name for p in ablation_runs["port_out"].iterdir()) == \
        sorted(p.name for p in ablation_runs["ref_out"].iterdir()) == FILES
    assert ablation_runs["cwd_files"] == ["port_out", "port_store"]


@pytest.mark.parametrize("name", FILES)
def test_rows_keys_and_point_order_are_the_reference(ablation_runs, name):
    mine, ref = _load(ablation_runs["port_out"] / name), \
        _load(ablation_runs["ref_out"] / name)
    if name == "BENCH_delay.json":
        assert list(mine) == list(ref)
        assert {k: mine[k] for k in ("bench", "scale", "eps", "seeds")} == \
            {k: ref[k] for k in ("bench", "scale", "eps", "seeds")}
        mine, ref = mine["rows"], ref["rows"]
    assert type(mine) is type(ref) and len(mine) == len(ref)
    if isinstance(ref, dict):
        assert list(mine) == list(ref)
        pairs = [(mine[k], ref[k]) for k in ref]
    else:
        pairs = list(zip(mine, ref))
        assert [r["delay"] for r in mine] == [r["delay"] for r in ref]
    for a, b in pairs:
        assert list(a) == list(b)
        assert all(np.all(np.isfinite(v)) for v in a.values()
                   if isinstance(v, (int, float)) and v is not None)
    delay = ablation_runs["results"]["ablation_delay"]
    assert isinstance(delay["graceful"], bool)
    for res in (delay["sim"], delay["dist"],
                ablation_runs["results"]["ablation_sparse_methods"]["sweep"]):
        assert res.ran_points == len(res.points)


def _from_store(module, out, store):
    kw = {"delays": DELAYS} if module is ablation_delay else {}
    return module.run(SCALE, out_dir=str(out), from_store=True,
                      device="cpu", store=str(store), **kw)


@pytest.mark.parametrize("module", [ablation_sparse_methods, ablation_delay],
                         ids=["sparse_methods", "delay"])
def test_from_store_rewrites_each_json_without_a_run(ablation_runs, module,
                                                     monkeypatch, tmp_path):
    def no_run(*a, **kw):
        raise AssertionError("from_store ran a point")

    monkeypatch.setattr(sweep_engine, "_run_point", no_run)
    res = _from_store(module, tmp_path, ablation_runs["port_store"])
    sweeps = [res["sweep"]] if module is ablation_sparse_methods \
        else [res["sim"], res["dist"]]
    assert all(s.ran_points == 0 for s in sweeps)
    for path in tmp_path.iterdir():
        assert _load(path) == _load(ablation_runs["port_out"] / path.name)
    assert len(list(tmp_path.iterdir())) == \
        (1 if module is ablation_sparse_methods else 2)


@pytest.mark.parametrize("module", [ablation_sparse_methods, ablation_delay],
                         ids=["sparse_methods", "delay"])
def test_the_reference_records_are_never_served(ablation_runs, module,
                                                tmp_path):
    """The reference's store holds every point under the same sweep
    names; the port's from-store run finds none of its own."""
    assert any(ablation_runs["ref_store"].iterdir())
    with pytest.raises(SweepStoreMiss):
        _from_store(module, tmp_path, ablation_runs["ref_store"])
    assert not any(tmp_path.iterdir())


def test_the_bench_path_can_be_given(ablation_runs, tmp_path):
    res = ablation_delay.run(SCALE, out_dir=str(tmp_path / "out"),
                             bench_path=str(tmp_path / "bench.json"),
                             delays=DELAYS, from_store=True, device="cpu",
                             store=str(ablation_runs["port_store"]))
    assert _load(tmp_path / "bench.json") == res["bench"]
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == \
        ["ablation_delay.json"]
