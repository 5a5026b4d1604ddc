"""End-to-end behaviour of the port's LM train and serve drivers, on the
CPU: the counterpart of tests/test_system.py (same arguments, plus
``device="cpu"``), and the two CLIs with ``--device cpu``.

The port's token stream is not the reference's (tests/test_torch_data_lm.py
holds it by distribution), so the losses are the port's own; what is
held is the reference's claims: the non-private gossip loss falls over 12
steps, a private run stays finite with a positive noise scale, the
all-reduce loss falls, serving gives (batch, 1 + gen) tokens.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import serve_lm, train  # noqa: E402
from repro_torch.launch.serve_lm import serve  # noqa: E402
from repro_torch.launch.steps import (AllreduceTrainState,  # noqa: E402
                                      GossipTrainState)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_gossip_training_end_to_end_loss_decreases():
    res = train.train("minicpm-2b", strategy="gossip", nodes=4, steps=12,
                      batch_per_node=2, seq_len=64, eps=float("inf"),
                      lam=1e-5, smoke=True, device="cpu")
    losses = [h["ce"] for h in res["history"]]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert isinstance(res["state"], GossipTrainState)
    assert res["state"].gossip.t == 12
    assert all(h["noise_scale"] == 0.0 for h in res["history"])
    assert res["result"].privacy["eps_total"] == math.inf


def test_private_gossip_training_runs_and_is_noisier():
    res_p = train.train("minicpm-2b", strategy="gossip", nodes=4, steps=8,
                        batch_per_node=2, seq_len=64, eps=0.5, smoke=True,
                        seed=1, device="cpu")
    assert all(np.isfinite(h["loss"]) for h in res_p["history"])
    assert res_p["history"][0]["noise_scale"] > 0
    assert all(0.0 <= h["theta_sparsity"] <= 1.0
               for h in res_p["history"])
    np.testing.assert_array_equal(res_p["result"].eps_ledger,
                                  np.full(8, 0.5))
    # disjoint rounds: parallel composition, as the reference's accountant
    assert res_p["result"].privacy["eps_total"] == 0.5


def test_allreduce_baseline_end_to_end():
    res = train.train("qwen2-7b", strategy="allreduce", steps=10,
                      batch_per_node=4, seq_len=64, smoke=True,
                      device="cpu")
    losses = [h["ce"] for h in res["history"]]
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert isinstance(res["state"], AllreduceTrainState)
    assert int(res["state"].opt["step"]) == 10


def test_serve_end_to_end():
    out = serve("qwen2-7b", batch=2, prompt_len=8, gen=4, cache_len=32,
                smoke=True, device="cpu")
    # collected tokens = first prompt token + `gen` generated ones
    assert out["tokens"].shape == (2, 1 + 4)
    assert (out["tokens"] >= 0).all() and (out["tokens"] < 512).all()
    assert out["seconds"] > 0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "seamless-m4t-medium"])
def test_serve_recurrent_and_encdec_archs(arch):
    out = serve(arch, batch=2, prompt_len=8, gen=4, cache_len=32,
                smoke=True, device="cpu")
    assert out["tokens"].shape == (2, 5)


def test_train_cli_runs_on_the_cpu(tmp_path, capsys):
    """`python -m repro_torch.launch.train --arch ... --device cpu`, with
    the per-step CSV log and a checkpoint of the train state."""
    log = tmp_path / "lm.csv"
    res = train.main(["--arch", "qwen2-7b", "--steps", "2", "--nodes", "2",
                      "--seq-len", "16", "--eps", "1.0", "--device", "cpu",
                      "--log", str(log), "--checkpoint-every", "2",
                      "--checkpoint-dir", str(tmp_path / "ckpt")])
    out = capsys.readouterr().out
    assert "step    1 loss=" in out and "sparsity=" in out
    assert len(res["history"]) == 2
    assert len(log.read_text().strip().splitlines()) == 3   # header + 2
    from repro_torch.checkpoint import restore_checkpoint
    back = restore_checkpoint(str(tmp_path / "ckpt"), res["state"])
    assert back.gossip.t == 2
    for k, v in res["state"].gossip.theta["embed"].items():
        assert torch.equal(back.gossip.theta["embed"][k], v)
    assert torch.equal(back.gossip.generator.get_state(),
                       res["state"].gossip.generator.get_state())


def test_train_from_a_given_state_equals_the_default_start():
    """`train(state=)` starting from the strategy's own init at the seed
    is the default run, bit for bit (chip_smoke phase 21a hands one
    CPU-made state to the card and to the CPU this way)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    kw = dict(nodes=2, steps=2, seq_len=16, eps=float("inf"), device="cpu")
    model = build_model(get_config("minicpm-2b").reduced(), "cpu")
    gdp = steps.make_gossip_dp(2, steps.TrainRecipe(eps=float("inf")))
    start = steps.make_gossip_init(model, gdp, 2)(0)
    a = train.train("minicpm-2b", **kw)
    b = train.train("minicpm-2b", state=start, **kw)
    assert a["history"] == b["history"]
    got, want = (dict(tree.flatten_with_path(r["state"].gossip.theta))
                 for r in (b, a))
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_serve_cli_runs_on_the_cpu(capsys):
    out = serve_lm.main(["--arch", "qwen2-7b", "--batch", "2",
                         "--prompt-len", "4", "--gen", "3", "--cache-len",
                         "16", "--device", "cpu"])
    assert out["tokens"].shape == (2, 4)
    assert "qwen2-7b: generated 3 tokens x batch 2" in capsys.readouterr().out


def test_lm_entry_points_run_on_cuda_unless_asked_for_the_cpu():
    """Without a card, every LM entry point raises rather than run on
    the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is valid")
    for call in (lambda: train.train("minicpm-2b", steps=1),
                 lambda: train.train("qwen2-7b", strategy="allreduce",
                                     steps=1),
                 lambda: serve("qwen2-7b", gen=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
