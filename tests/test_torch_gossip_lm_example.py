"""The gossip LM example's path on the port
(`repro_torch.figures.gossip_lm_training`, the counterpart of
``examples/gossip_lm_training.py``) against the reference's
(`repro.launch.train.train`).

The example's eps = inf gossip run and its all-reduce AdamW run, 3 steps
each on the CPU at the example's settings (minicpm-2b reduced, 4 nodes,
B 2 a node, T 128, lam 1e-5): the port starts from the reference's
initial state (`repro_torch.convert.train_state_from_jax`) and takes the
reference's token stream (its `repro.data.lm.lm_batches`, replayed in
place of the port's own); the ce of every step within 1e-5 of the
reference's (the step tests' bound, tests/test_torch_lm_steps.py). The
eps = 1 run draws noise the reference's key decides, so it is held by
shape only. The example's arguments, run names and summary lines are the
example's.
"""
import ast
import math
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.lm import lm_batches as jlm_batches  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.train import train as jtrain  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.figures import gossip_lm_training as example  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from test_torch_lm_steps import jax_flat  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
ARCH, NODES, STEPS = "minicpm-2b", 4, 3
CE_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _replay_reference_tokens(vocab, batch, seq, nodes=1, seed=0,
                             device="cpu"):
    """The reference's token stream as the port's `lm_batches` yields it."""
    for b in jlm_batches(vocab, batch, seq, nodes=nodes, seed=seed):
        yield {k: torch.tensor(np.asarray(v), device=device)
               for k, v in b.items()}


def _reference_start(strategy):
    """The state the reference's `train` starts from (its seed 0)."""
    jmodel = jbuild_model(jget_config(ARCH).reduced())
    recipe = jsteps.TrainRecipe(strategy=strategy, eps=math.inf,
                                lam=example.LAM)
    if strategy == "gossip":
        return jsteps.make_gossip_init(
            jmodel, jsteps.make_gossip_dp(NODES, recipe), NODES)(0)
    return jsteps.make_allreduce_train_step(jmodel, recipe)[1](0)


@pytest.mark.parametrize("name", ["gossip eps=inf", "allreduce adamw"])
def test_the_deterministic_runs_follow_the_reference(name, monkeypatch):
    kw = example.runs()[name]
    ref = jtrain(ARCH, nodes=NODES, steps=STEPS,
                 batch_per_node=example.BATCH_PER_NODE,
                 seq_len=example.SEQ_LEN, lam=example.LAM, smoke=True, **kw)
    state = train_state_from_jax(get_config(ARCH).reduced(),
                                 jax_flat(_reference_start(kw["strategy"])),
                                 device="cpu")
    monkeypatch.setattr(train_mod, "lm_batches", _replay_reference_tokens)
    got = example.run_one(ARCH, NODES, STEPS, device="cpu", state=state,
                          **kw)
    want = [h["ce"] for h in ref["history"]]
    ce = [h["ce"] for h in got["history"]]
    assert len(ce) == len(want) == STEPS
    d = max(abs(a - b) for a, b in zip(ce, want))
    assert d <= CE_ATOL, f"{name}: ce off the reference's by {d}"


def test_the_examples_arguments_runs_and_summary(capsys):
    src = (REPO / "examples/gossip_lm_training.py").read_text()
    tree = ast.parse(src)
    flags = {a.args[0].value: a for a in ast.walk(tree)
             if isinstance(a, ast.Call) and getattr(a.func, "attr", "")
             == "add_argument"}
    defaults = {k: next(kw.value.value for kw in v.keywords
                        if kw.arg == "default") for k, v in flags.items()}
    assert defaults == {"--steps": 60, "--arch": "minicpm-2b",
                        "--nodes": 4, "--local-rule": "omd"}
    names = [k.value for n in ast.walk(tree) if isinstance(n, ast.Dict)
             for k in n.keys if isinstance(k, ast.Constant)
             and isinstance(k.value, str) and " " in k.value]
    assert names == list(example.runs())
    assert "batch_per_node=2, seq_len=128, lam=1e-5, smoke=True" in src
    assert (example.BATCH_PER_NODE, example.SEQ_LEN, example.LAM) == \
        (2, 128, 1e-5)
    results = example.main(["--steps", "1", "--nodes", "2", "--device",
                            "cpu"])
    out = capsys.readouterr().out
    for name in example.runs():
        assert f"=== {name} ===" in out
        assert len(results[name]) == 1 and math.isfinite(results[name][0])
    assert "summary (lower is better):" in out
    assert "gossip eps=1.0     final ce" in out


def test_the_example_runs_on_the_card_by_default():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--steps", "1"])
    assert jax.default_backend() == "cpu"
