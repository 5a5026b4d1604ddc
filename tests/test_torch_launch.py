"""The port's stream CLIs against repro's: `launch.train --stream`,
`launch.dryrun --stream` and the `TrainRecipe` of `launch.steps`.

`parse_stream_options` parses as the reference's does; `train(stream=...)`
prints the reference's line and returns the run of its recipe's spec bit
for bit; `TrainRecipe.to_runspec` builds the reference's spec field for
field; `dryrun_stream` records the reference's keys (read from its source:
importing `repro.launch.dryrun` would set XLA's host-device count for the
whole test process). The LM dry-run (``--arch --shape``, ``--all``) is
held to the reference in tests/test_torch_dryrun_lm.py; here its CLI
writes a record and refuses ``--arch`` alone as the reference does.
"""
import ast
import contextlib
import dataclasses
import io
import json
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api import RunSpec as JRunSpec  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.launch.steps import TrainRecipe as JTrainRecipe  # noqa: E402

from repro_torch import ExecConfig, run  # noqa: E402
from repro_torch.api import RunSpec  # noqa: E402
from repro_torch.launch import dryrun, train  # noqa: E402
from repro_torch.launch.steps import TrainRecipe  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("final_w", "loss", "correct", "w_bar_loss", "sparsity",
          "eps_ledger", "regret")


@pytest.mark.parametrize("pairs", [
    None, [], ["period=16"], ["mode=rotate"], ["period=16", "mode=rotate"],
    ["scale=0.5", "flag=True", "name='x'"], ["ks=[1, 2]", "expr=a=b"],
    ["empty="], ["neg=-3", "inf=inf"]])
def test_parse_stream_options_is_the_references(pairs):
    assert train.parse_stream_options(pairs) == \
        jtrain.parse_stream_options(pairs)


def test_parse_stream_options_refuses_as_the_reference():
    with pytest.raises(ValueError) as ours:
        train.parse_stream_options(["period"])
    with pytest.raises(ValueError) as theirs:
        jtrain.parse_stream_options(["period"])
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("recipe", [
    {}, {"eps": 0.5, "topology": "torus", "lam": 1e-3},
    {"clip_style": "global", "mechanism": "gaussian", "local_rule": "tg"},
    {"delay": 2, "delay_dist": "uniform", "L": 2.0, "noise_self": False}])
def test_recipe_builds_the_references_spec(recipe):
    ours = TrainRecipe(**recipe)
    theirs = JTrainRecipe(**recipe)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    spec, jspec = ours.to_runspec(8), theirs.to_runspec(8)
    for f in dataclasses.fields(JRunSpec):
        if f.name in ("backend", "backend_options"):
            continue
        assert getattr(spec, f.name) == getattr(jspec, f.name), f.name
    assert isinstance(spec, RunSpec) and spec.backend == "reference"


def _mask(line: str) -> str:
    """The line with its numbers (and the run's rate) masked."""
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


KW = dict(stream="drift", stream_options={"period": 4}, nodes=4, dim=32,
          steps=16, engine="sim", seed=1)


def test_train_stream_prints_the_references_line_and_runs_its_spec(
        tmp_path):
    out, ref_out = io.StringIO(), io.StringIO()
    log = str(tmp_path / "train.csv")
    with contextlib.redirect_stdout(out):
        got = train.train(**KW, log_path=log, device="cpu")
    with contextlib.redirect_stdout(ref_out):
        jtrain.train(**KW)
    line, ref_line = out.getvalue().strip(), ref_out.getvalue().strip()
    assert _mask(line) == _mask(ref_line)
    assert line.startswith("stream=drift engine=sim nodes=4 dim=32 "
                           "rounds=16: acc=")
    spec = TrainRecipe().to_runspec(4).replace(
        dim=32, horizon=16, seed=1, stream="drift",
        stream_options={"period": 4}, backend="cuda")
    want = run(spec, "sim", exec=ExecConfig(), device="cpu")
    res = got["result"]
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(res, f), getattr(want, f),
                                      err_msg=f)
    assert got["final"] == res.summary() and got["history"] is None
    assert got["state"] is res.final_state
    assert len(open(log).read().strip().splitlines()) == 17


def test_train_cli_stream_mode(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    out = train.main(["--stream", "bursty", "--nodes", "4", "--dim", "32",
                      "--steps", "12", "--engine", "dist", "--device", "cpu",
                      "--checkpoint-every", "6", "--checkpoint-dir", ckpt,
                      "--stream-opt", "tail=2.0"])
    assert "stream=bursty engine=dist" in capsys.readouterr().out
    assert out["result"].rounds == 12
    assert sorted(p.name for p in pathlib.Path(ckpt).iterdir()) == [
        "ckpt_00000006.npz", "ckpt_00000012.npz"]


def test_train_cli_defaults_to_cuda_and_refuses_without_it():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--stream", "drift", "--steps", "2"])


def test_train_cli_needs_a_mode(capsys):
    with pytest.raises(SystemExit):
        train.main([])
    assert "one of --arch or --stream" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--arch", "minicpm-2b", "--shape", "decode_32k"],
    ["--arch", "minicpm-2b"]])
def test_the_lm_modes_raise_naming_the_queue(argv, tmp_path, monkeypatch,
                                             capsys):
    """The LM dry-run is ported (tests/test_torch_dryrun_lm.py holds it to
    the reference): ``--arch --shape`` counts the step on shapes and
    writes its record; ``--arch`` alone raises the reference's usage
    error, naming what is missing."""
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    if "--shape" in argv:
        assert dryrun.main(argv) == 0
        rec = json.loads((tmp_path / "minicpm-2b__decode_32k__16x16__"
                          "gossip.json").read_text())
        assert rec["status"] == "ok" and rec["hlo_flops"] > 0
        assert "[ok] minicpm-2b x decode_32k" in capsys.readouterr().out
        return
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 2
    assert "--arch and --shape required unless --all" in \
        capsys.readouterr().err
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("strategy", ["gossip", "allreduce"])
def test_train_arch_cli_runs_on_the_cpu(strategy, capsys):
    """`launch.train --arch` on the CPU: run()'s custom mode prints the
    reference's step lines and returns the strategy's state."""
    from repro_torch.launch.steps import (AllreduceTrainState,
                                          GossipTrainState)
    res = train.main(["--arch", "minicpm-2b", "--steps", "2", "--nodes",
                      "2", "--seq-len", "16", "--strategy", strategy,
                      "--device", "cpu"])
    assert "step    1 loss=" in capsys.readouterr().out
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    want = GossipTrainState if strategy == "gossip" else AllreduceTrainState
    assert isinstance(res["state"], want)


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium"])
def test_train_arch_adds_the_frontend(arch):
    """`train(arch=)` feeds the vision arch zeros for its frontend tokens
    with those labels masked, and the enc-dec arch zero frames, as the
    reference's driver does; one gossip step on each."""
    res = train.train(arch, nodes=2, steps=1, seq_len=16, device="cpu")
    assert np.isfinite(res["history"][0]["loss"])
    assert res["state"].gossip.t == 1


def _reference_record_keys() -> list:
    """The keys of the record the reference's dryrun_stream builds, read
    from its source."""
    tree = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_stream")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", None) == "rec")
    return [k.value for k in rec.keys]


@pytest.mark.parametrize("stream", ["bursty", "social_sparse"])
@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_dryrun_stream_records_the_references_keys(engine, stream, capsys):
    rec = dryrun.dryrun_stream(stream, engine=engine, nodes=4, dim=32,
                               chunk_rounds=16, save=False, device="cpu")
    keys = _reference_record_keys()
    assert len(keys) == 14 and set(keys) <= set(rec)
    assert rec["arch"] == f"stream-{stream}" and rec["shape"] == "chunk16"
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert rec["memory_peak_bytes"] is None          # no card here
    assert f"[ok] stream={stream}" in capsys.readouterr().out


def test_dryrun_counts_one_round_times_the_chunk():
    """A chunk of 16 rounds counts 16 times what a chunk of 1 does (the
    horizon never runs), and the kernels' rows are their work."""
    one = dryrun.dryrun_stream("drift", nodes=4, dim=32, chunk_rounds=1,
                               save=False, verbose=False, device="cpu")
    many = dryrun.dryrun_stream("drift", nodes=4, dim=32, chunk_rounds=16,
                                save=False, verbose=False, device="cpu")
    assert many["hlo_bytes"] == 16 * one["hlo_bytes"]
    assert many["hlo_flops"] == 16 * one["hlo_flops"]
    assert many["predicted_chunk_s"] > one["predicted_chunk_s"] > 0


def test_dryrun_cli_writes_its_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "OUT_DIR", str(tmp_path))
    assert dryrun.main(["--stream", "drift", "--nodes", "4", "--dim", "32",
                        "--chunk-rounds", "8", "--device", "cpu",
                        "--stream-opt", "period=3"]) == 0
    path = tmp_path / "stream-drift__chunk8__host__sim.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["chunk_rounds"] == 8
