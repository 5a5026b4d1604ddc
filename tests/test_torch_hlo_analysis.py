"""The port's roofline terms and strategy collectives
(`repro_torch.launch.hlo_analysis`) against the JAX package's
(`repro.launch.hlo_analysis`).

`roofline_terms` and `model_flops` are the reference's formulas with the
H100's constants in place of the TPU v5e's: the reference's functions,
run with the port's constants patched in, give the same numbers exactly.
`collective_stats` derives the per-device bytes a strategy exchanges
from specs; for a reduced ring gossip step on a (4, 2) ("data", "model")
mesh, its collective-permute bytes and count equal what
`repro.launch.hlo_cost.analyze` reads from the reference's compiled step
on 8 host devices (a subprocess) exactly. The reference's own text parser
(`hlo_analysis.collective_stats`) counts 33 permutes there, not 22: its
pattern also matches the 11 fusions that take a permute's result as an
operand, so it is not the measure held.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import hlo_analysis as jhlo  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, hlo_analysis  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.sharding.rules import P  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def test_constants_are_the_h100s():
    assert hlo_analysis.PEAK_FLOPS == 989e12        # bf16, dense, SXM
    assert hlo_analysis.HBM_BW == 3.35e12
    assert hlo_analysis.ICI_BW == 50e9              # one 400 Gb/s NDR port
    assert (jhlo.PEAK_FLOPS, jhlo.HBM_BW) == (197e12, 819e9)   # TPU v5e


@pytest.mark.parametrize("flops,nbytes,coll,chips", [
    (1e15, 1e12, 0.0, 1), (3.2e13, 8.1e12, 5e9, 1), (5e16, 1e11, 2e12, 16),
    (0.0, 0.0, 0.0, 1), (7.0, 3e12, 1e12, 256)])
def test_roofline_terms_are_the_references_formula(monkeypatch, flops,
                                                   nbytes, coll, chips):
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(jhlo, name, getattr(hlo_analysis, name))
    assert hlo_analysis.roofline_terms(flops, nbytes, coll, chips) == \
        jhlo.roofline_terms(flops, nbytes, coll, chips)


@pytest.mark.parametrize("n,tokens", [(1.5e9, 2048), (4.7e10, 1_048_576),
                                      (3.0, 1.0)])
def test_model_flops_is_the_references(n, tokens):
    assert hlo_analysis.model_flops(n, tokens) == jhlo.model_flops(n, tokens)


MESH = FakeMesh(data=4, model=2)
LEAVES = [torch.empty((4, 512, 256), device="meta"),
          torch.empty((4, 256), device="meta", dtype=torch.bfloat16)]
SPECS = [P("data", "model", None), P("data", None)]
SHARDS = [1 * 256 * 256 * 4, 1 * 256 * 2]


@pytest.mark.parametrize("kw,kind,nbytes,count", [
    (dict(mixer="RingRollMixer"), "collective-permute", 2 * sum(SHARDS), 4),
    (dict(mixer="AlternatingRingMixer"), "collective-permute", sum(SHARDS),
     2),
    (dict(mixer="SparseMixer"), "all-gather", sum(SHARDS), 2),
    (dict(mixer="RingRollMixer", delay=3), "collective-permute",
     2 * sum(SHARDS), 4),
    (dict(mixer="RingRollMixer", delay=3, delay_dist="uniform"),
     "all-gather", 4 * sum(SHARDS), 2),
    (dict(strategy="allreduce"), "all-reduce", sum(SHARDS), 2)])
def test_collective_stats_per_strategy(kw, kind, nbytes, count):
    c = hlo_analysis.collective_stats(LEAVES, SPECS, MESH, **kw)
    assert c.bytes_by_kind == {kind: nbytes}
    assert c.count_by_kind == {kind: count}
    assert c.total_bytes == nbytes


def test_no_exchange_and_the_model_axis_recorded_as_unknown():
    for c in (hlo_analysis.collective_stats(None, None, MESH,
                                            strategy="serve"),
              hlo_analysis.collective_stats(LEAVES, SPECS, MESH,
                                            mixer="DisconnectedMixer")):
        s = c.summary()
        assert s["total_bytes"] == 0 and s["bytes_by_kind"] == {}
        assert s["model_axis_bytes"] is None
        assert "not derivable" in s["model_axis_note"]
    with pytest.raises(ValueError, match="unknown strategy"):
        hlo_analysis.collective_stats(None, None, MESH, strategy="ps")


@pytest.mark.parametrize("shape,spec,want", [
    ((16, 8), P("data", "model"), 4 * 4 * 2),
    ((16, 8), P(), 16 * 8 * 2),
    ((10, 8), P("data"), 3 * 8 * 2),                # a padded shard
    ((16, 8), P(("data", "model")), 2 * 8 * 2),
    ((2, 16, 8), P(None, None, "model"), 2 * 16 * 4 * 2)])
def test_shard_bytes(shape, spec, want):
    assert hlo_analysis.shard_bytes(shape, 2, spec, MESH) == want


_REFERENCE_RING = r"""
import json, jax
from repro.configs import get_config
from repro.launch import hlo_cost, steps
from repro.launch.mesh import make_mesh
from repro.models import build_model
from repro.models.config import ShapeConfig
from repro.sharding import rules
cfg = get_config("minicpm-2b").reduced()
mesh = make_mesh((4, 2), ("data", "model"))
model = build_model(cfg)
gdp = steps.make_gossip_dp(4, steps.TrainRecipe())
with mesh:
    st = jax.eval_shape(steps.make_gossip_init(model, gdp, 4))
    theta = rules.param_pspecs(st.gossip.theta, node_axes=("data",),
                               mesh=mesh)
    b, bs = steps.train_batch_specs(cfg, ShapeConfig("t", 16, 8, "train"),
                                    mesh, "gossip")
    fn = jax.jit(steps.make_gossip_train_step(model, gdp, 1),
                 in_shardings=(steps.named(mesh, steps.gossip_state_pspecs(
                     st, theta)), steps.named(mesh, bs)))
    hlo = fn.lower(st, b).compile().as_text()
r = hlo_cost.analyze(hlo)
print(json.dumps({"bytes": r.summary()["collective_bytes_by_kind"],
                  "count": r.summary()["collective_count_by_kind"]}))
"""


def test_the_ring_permutes_equal_the_references_compiled_step():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", _REFERENCE_RING],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])

    cfg = get_config("minicpm-2b").reduced()
    mesh = make_mesh((4, 2), ("data", "model"), device="meta")
    program = dryrun.lm_program(cfg, ShapeConfig("t", 16, 8, "train"), mesh)
    leaves, specs = program["exchanged"]
    got = hlo_analysis.collective_stats(leaves, specs, mesh,
                                        mixer=program["mixer"])
    assert program["mixer"] == "RingRollMixer"
    assert got.bytes_by_kind["collective-permute"] == \
        ref["bytes"]["collective-permute"]
    assert got.count_by_kind["collective-permute"] == \
        ref["count"]["collective-permute"]
    # the model axis's all-reduces are the reference's and not derivable
    # here: recorded as unknown, never as 0
    assert ref["bytes"].get("all-reduce", 0) > 0
    assert got.summary()["model_axis_bytes"] is None
