"""The port's figure modules (`repro_torch.figures`) against the reference's
(``benchmarks/common.py``, ``benchmarks/fig2..fig5``), at ``Scale.smoke()``.

* Each figure's sweep, captured before it runs: the same name, seeds,
  regret switch and points, and at every point `make_spec` gives the
  reference's `RunSpec` field for field but ``backend`` (the port's figures
  run on ``"cuda"``, the reference's on ``"reference"``).
* One point of each figure, run on the port (the cuda backend's plain
  versions here) with the reference stream's chunks and unit Laplace draws
  injected, holds to `repro.api.run` of the same point: ``correct``,
  ``sparsity``, ``eps_ledger`` exact; ``final_w``, ``loss``,
  ``w_bar_loss`` within 5e-6, or 16 ulps of the field's largest |value|
  where that is more. The floats drift from the first round by the two
  reductions tests/test_torch_long_horizon.py records (the clip's norm,
  the margin's dot), and here |w| reaches ~8: measured, in ulps of the
  largest |value| (final_w / loss / w_bar_loss), Fig. 2 eps=1 4 / 2 / 1.5,
  Fig. 4 lam=0.1 2 / 1.5 / 1, Fig. 5 m=4 2 / 5 / 2, and Fig. 3 complete
  12 ulps of final_w at |w| 7.67 — 5.72e-6, past the absolute 5e-6: the
  consensus mix hands every node's drift to every node (the reference's
  own two backends agree there bit for bit).
* Both packages' figure modules run once (the port's CLI runs the two
  ablations after them): the JSON file names, row keys and point
  order are the reference's; ``from_store=True`` rewrites each JSON
  unchanged without a run; a store holding the reference's records of the
  same figure serves the port nothing (`SweepStoreMiss`).
"""
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))         # the reference's benchmarks/

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import (fig2_privacy as jfig2, fig3_topology as jfig3,  # noqa: E402
                        fig4_sparsity as jfig4, fig5_nodes as jfig5)
from repro.api import ExecConfig as JExecConfig  # noqa: E402
from repro.api import run as jrun  # noqa: E402
from repro.sweep import spec_record as jspec_record  # noqa: E402

from repro_torch import ExecConfig, run  # noqa: E402
from repro_torch.figures import (common, fig2_privacy, fig3_topology,  # noqa: E402
                                 fig4_sparsity, fig5_nodes)
from repro_torch.figures.__main__ import main  # noqa: E402
from repro_torch.sweep import SweepStoreMiss, spec_record  # noqa: E402
from repro_torch.sweep import engine as sweep_engine  # noqa: E402

from test_torch_run import (ReplayLaplace, ReplayStream,  # noqa: E402
                            _reference_draws)

ATOL = 5e-6
ULPS = 16       # the float hold at |values| past ~2.6, where 5e-6 is < 16 ulps
EXACT = ("correct", "sparsity", "eps_ledger")
CLOSE = ("final_w", "loss", "w_bar_loss")
SCALE = common.Scale.smoke()
# figure -> (port module, reference module, its JSON file, the point held)
FIGS = {
    "fig2": (fig2_privacy, jfig2, "fig2_privacy_coordinate.json", 1),
    "fig3": (fig3_topology, jfig3, "fig3_topology.json", 1),   # complete
    "fig4": (fig4_sparsity, jfig4, "fig4_sparsity.json", 2),
    "fig5": (fig5_nodes, jfig5, "fig5_nodes.json", 0),         # m=4, T=240
}


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


def _capture(monkeypatch, common_module, fig_module, scale):
    """The SweepSpec ``fig_module.run(scale)`` hands its package's sweep."""
    seen = []

    def fake_sweep(spec, **kw):
        seen.append(spec)
        raise _Captured

    monkeypatch.setattr(common_module, "sweep", fake_sweep)
    with pytest.raises(_Captured):
        fig_module.run(jcommon.Scale(**vars(scale))
                       if common_module is jcommon else scale)
    monkeypatch.undo()
    return seen[0]


@pytest.fixture(scope="module")
def sweeps():
    """fig -> (the port's SweepSpec, the reference's SweepSpec)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for fig, (port, ref, _, _) in FIGS.items():
            out[fig] = (_capture(mp, common, port, SCALE),
                        _capture(mp, jcommon, ref, SCALE))
    return out


def _no_backend(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "backend"}


@pytest.mark.parametrize("fig", list(FIGS))
def test_make_spec_gives_the_reference_spec_at_every_point(sweeps, fig):
    mine, ref = sweeps[fig]
    assert (mine.name, mine.seeds, mine.engine, mine.chunk_rounds,
            mine.compute_regret) == (ref.name, ref.seeds, ref.engine,
                                     ref.chunk_rounds, ref.compute_regret)
    assert mine.axes == ref.axes
    points, ref_points = mine.points(), ref.points()
    assert [p.coords for p in points] == [p.coords for p in ref_points]
    for p, q in zip(points, ref_points):
        assert p.spec.backend == "cuda" and q.spec.backend == "reference"
        assert _no_backend(spec_record(p.spec)) == \
            _no_backend(jspec_record(q.spec)), p.label()


@pytest.mark.parametrize("fig", list(FIGS))
def test_one_point_of_each_figure_holds_to_the_reference(sweeps, fig):
    mine, ref = sweeps[fig]
    k = FIGS[fig][3]
    ref_spec = ref.points()[k].spec
    want = jrun(ref_spec, exec=JExecConfig(chunk_rounds=SCALE.T,
                                           warmup=False,
                                           compute_regret=False))
    m, n, T = ref_spec.nodes, ref_spec.dim, ref_spec.horizon
    xs, ys = (np.asarray(a) for a in ref_spec.resolve_stream().chunk(0, T))
    spec = mine.points()[k].spec
    mech = spec.resolve_mechanism()
    spec = spec.replace(stream=ReplayStream(xs, ys), mechanism=ReplayLaplace(
        eps=mech.eps, L=mech.L, calibration=mech.calibration,
        noise_self=mech.noise_self,
        draws=iter(_reference_draws(spec.seed, T, (m, n)))))
    got = run(spec, exec=ExecConfig(chunk_rounds=SCALE.T, warmup=False,
                                    compute_regret=False), device="cpu")
    what = f"{fig} {mine.points()[k].label()}"
    for f in EXACT:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f)), np.asarray(getattr(want, f)),
            err_msg=f"{what}: {f} must match exactly")
    for f in CLOSE:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        tol = max(ATOL, ULPS * float(np.spacing(np.abs(b).max())))
        d = np.abs(a - b).max()
        assert d <= tol, f"{what}: {f} off by {d} (> {tol})"


@pytest.fixture(scope="module")
def figure_runs(tmp_path_factory):
    """Both packages' four figures run once at the smoke scale: the port's
    through its CLI on the CPU, the reference's from a working directory of
    its own (its store is ``experiments/store`` there)."""
    tmp = tmp_path_factory.mktemp("figures")
    port_out, port_store = tmp / "port_out", tmp / "port_store"
    results = main(["--smoke", "--device", "cpu", "--out", str(port_out),
                    "--store", str(port_store)])
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        for _, ref, _, _ in FIGS.values():
            ref.run(jcommon.Scale.smoke(), out_dir=str(tmp / "ref_out"))
    return dict(tmp=tmp, port_out=port_out, port_store=port_store,
                ref_out=tmp / "ref_out", ref_store=tmp / "experiments/store",
                results=results)


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_the_figures_write_the_reference_files(figure_runs):
    """The CLI writes each figure's file as the reference's figures do,
    and then the two ablations' (tests/test_torch_ablations.py holds
    those to the reference)."""
    ablations = ["BENCH_delay.json", "ablation_delay.json",
                 "ablation_sparse_methods.json"]
    assert sorted(p.name for p in figure_runs["ref_out"].iterdir()) == \
        sorted(f for _, _, f, _ in FIGS.values())
    assert sorted(p.name for p in figure_runs["port_out"].iterdir()) == \
        sorted([f for _, _, f, _ in FIGS.values()] + ablations)
    assert {"ablation_sparse_methods", "ablation_delay"} <= \
        set(figure_runs["results"])


@pytest.mark.parametrize("fig", list(FIGS))
def test_rows_keys_and_point_order_are_the_reference(figure_runs, fig):
    name = FIGS[fig][2]
    mine, ref = _load(figure_runs["port_out"] / name), \
        _load(figure_runs["ref_out"] / name)
    assert type(mine) is type(ref) and len(mine) == len(ref)
    if isinstance(ref, dict):
        assert list(mine) == list(ref)
        pairs = [(mine[k], ref[k]) for k in ref]
    else:
        pairs = list(zip(mine, ref))
        for key in ("lambda", "nodes", "horizon"):
            assert [r.get(key) for r in mine] == [r.get(key) for r in ref]
    for a, b in pairs:
        assert list(a) == list(b)
        assert all(np.all(np.isfinite(v)) for v in a.values()
                   if isinstance(v, (int, float)) and v is not None)
    result = figure_runs["results"][fig]
    check = {"fig2": "ordering_holds", "fig3": "spread",
             "fig4": "interior_best", "fig5": "declines"}[fig]
    assert check in result and result["sweep"].ran_points == \
        len(result["sweep"].points)


@pytest.mark.parametrize("fig", list(FIGS))
def test_from_store_rewrites_each_json_without_a_run(figure_runs, fig,
                                                     monkeypatch, tmp_path):
    def no_run(*a, **kw):
        raise AssertionError("from_store ran a point")

    monkeypatch.setattr(sweep_engine, "_run_point", no_run)
    port, _, name, _ = FIGS[fig]
    res = port.run(SCALE, out_dir=str(tmp_path), from_store=True,
                   device="cpu", store=str(figure_runs["port_store"]))
    assert res["sweep"].ran_points == 0
    assert _load(tmp_path / name) == _load(figure_runs["port_out"] / name)


@pytest.mark.parametrize("fig", list(FIGS))
def test_the_reference_records_are_never_served(figure_runs, fig, tmp_path):
    """The reference's store holds every point of the figure, under the
    same sweep name; the port's from-store run finds none of its own."""
    port, _, _, _ = FIGS[fig]
    ref_file = figure_runs["ref_store"] / f"{FIGS[fig][2][:-5]}.jsonl"
    assert ref_file.exists()
    with pytest.raises(SweepStoreMiss):
        port.run(SCALE, out_dir=str(tmp_path), from_store=True,
                 device="cpu", store=str(figure_runs["ref_store"]))
    assert not any(tmp_path.iterdir())


def test_the_paper_scale_is_the_social_linear_config():
    from repro_torch.configs.social_linear import CONFIG
    paper = common.Scale.paper()
    assert (paper.n, paper.m, paper.T) == (10_000, 64, 1_562) == \
        (CONFIG.n, CONFIG.nodes, CONFIG.rounds)
    assert vars(paper) == vars(jcommon.Scale.paper())
    assert vars(common.Scale.smoke()) == vars(jcommon.Scale.smoke())
    assert vars(common.Scale()) == vars(jcommon.Scale())


def test_the_cli_refuses_two_scales():
    with pytest.raises(SystemExit):
        main(["--smoke", "--paper", "--device", "cpu"])
