"""The plain references against the port, at tiny sizes on the CPU, with the
same inputs handed to both. The tests may import the port; the references
may not."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402
from perfbench.drivers import linear_runs  # noqa: E402
from perfbench.reference import social_linear_paper as ref  # noqa: E402

TOY = {"nodes": 8, "n": 256, "total_samples": 8 * 32}
DCN = {"link_rate": 0.02, "crash_rate": 0.05, "crash_rounds": 8,
       "straggler_rate": 0.1, "straggler_delay": 1}


def toy_config():
    cfg = harness.load_manifest()
    files = harness.cell_files(cfg, "ring_online")
    return harness.merge(files["config"], TOY)


def dcn_seed(m: int, T: int) -> int:
    """A fault seed whose scenario has a crash and a straggler."""
    for seed in range(1000):
        plan = ref.FaultPlan({**DCN, "seed": seed}, m, T,
                             ref.ring_weights(m))
        if plan.has_crashes and plan.lag.max() > 0:
            return seed
    raise AssertionError("no seed draws both a crash and a straggler")


def program(cfg, stream, seed, faults=None, backend="cuda"):
    from repro_torch.api import ExecConfig, run
    params = {"backend": backend, "faults": faults}
    spec = linear_runs.run_spec(cfg, params, 0).replace(
        stream=stream, seed=seed)
    if faults:
        spec = spec.replace(faults_options={
            **{k: v for k, v in faults.items() if k != "name"}})
    res = run(spec, exec=ExecConfig(chunk_rounds=8, compute_regret=False),
              device="cpu")
    return linear_runs.program_outputs(res)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_algorithm1_reference_matches_the_port_clean(backend):
    cfg = toy_config()
    stream = linear_runs.make_stream(cfg, 11, torch.device("cpu"))
    got = program(cfg, stream, seed=123, backend=backend)
    want = ref.run_reference(cfg, stream.xs, stream.ys, 123)
    nums = linear_runs.compare(got, want)
    assert nums["correct_mismatches"] == 0
    assert nums["eps_max_gap"] == 0
    assert nums["sparsity_max_gap"] <= 1e-6
    assert nums["loss_max_gap"] < 1e-5
    assert nums["w_rel_gap"] < 1e-5


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_algorithm1_reference_matches_the_port_under_dcn(backend):
    cfg = toy_config()
    T = cfg["total_samples"] // cfg["nodes"]
    fseed = dcn_seed(cfg["nodes"], T)
    stream = linear_runs.make_stream(cfg, 12, torch.device("cpu"))
    faults = {"name": "dcn", **DCN, "seed": fseed}
    got = program(cfg, stream, seed=7, faults=faults, backend=backend)
    want = ref.run_reference(cfg, stream.xs, stream.ys, 7,
                             faults={**DCN, "seed": fseed})
    nums = linear_runs.compare(got, want)
    assert nums["correct_mismatches"] == 0
    assert nums["eps_max_gap"] == 0
    assert nums["connectivity_max_gap"] < 1e-6
    assert nums["loss_max_gap"] < 1e-5
    assert nums["w_rel_gap"] < 1e-5
    # the faults did something: the clean reference parts from it
    clean = ref.run_reference(cfg, stream.xs, stream.ys, 7)
    assert linear_runs.compare(got, clean)["w_rel_gap"] > 1e-3


def test_fault_plan_draws_the_port_schedule():
    from repro_torch.faults import FaultSpec
    m, T = 16, 64
    for seed in range(20):
        plan = ref.FaultPlan({**DCN, "seed": seed}, m, T,
                             ref.ring_weights(m))
        sched = FaultSpec(seed=seed, **DCN).compile(m=m, horizon=T)
        assert sorted(plan.windows) == sorted(sched.crash_windows)
        np.testing.assert_array_equal(plan.lag, sched.extra)
        np.testing.assert_array_equal(plan.alive, sched.alive_table(0, T))


def test_reference_in_lower_precision_parts_from_float32():
    cfg = toy_config()
    stream = linear_runs.make_stream(cfg, 13, torch.device("cpu"))
    f32 = ref.run_reference(cfg, stream.xs, stream.ys, 5)
    bf16 = ref.run_reference(cfg, stream.xs, stream.ys, 5,
                             dtype=torch.bfloat16)
    assert linear_runs.compare({**f32, "rounds": 32}, f32)["w_rel_gap"] == 0
    assert linear_runs.compare({**bf16, "rounds": 32}, f32)["w_rel_gap"] > 1e-3


def reduced_lm_overrides():
    """minicpm-2b's `reduced()` widths, in float32, as a cell override."""
    from repro_torch.configs import get_config
    cfg = get_config("minicpm-2b").reduced()
    keys = ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim",
            "d_ff", "vocab_size")
    return {"config": {**{k: getattr(cfg, k) for k in keys},
                       "dtype": "float32"},
            "workload": {"params": {"seq_len": 16, "pool_steps": 4}}}


@pytest.mark.parametrize("cell", ["minicpm2b_gossip_eps1",
                                  "minicpm2b_allreduce_adamw"])
def test_minicpm_reference_matches_the_ports_steps(cell):
    # the driver builds launch/steps.py's step from the benchmark's
    # weights and batches; the reference replays its checked steps
    box, _, _ = harness.make_cell(cell, 5, False, device="cpu",
                                  overrides=reduced_lm_overrides())
    box.setup()
    box.release()
    nums = box.check()
    assert nums["loss_rel_gap"] < 1e-5
    assert nums["grad1_leaf_gap"] < 1e-4
    assert nums["grad1_leaf_diff"] < 1e-2
    assert nums["change_leaf_gap"] < 1e-4
