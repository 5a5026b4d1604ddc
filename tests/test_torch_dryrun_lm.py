"""The port's LM dry-run (`repro_torch.launch.dryrun`'s ``--arch/--all``
mode) against the JAX package's (`repro.launch.dryrun`), exactly where
both compute the same thing from shapes:

* ``count_params`` and ``active_param_count`` of all ten architectures at
  their published configs: the port's ``meta`` parameters against
  ``jax.eval_shape`` of the reference's init;
* ``model_flops_6nd`` (the reference's formula per input-shape kind),
  ``skip_reason`` and ``pick_microbatches`` for every architecture x input
  shape on the single-pod and multi-pod meshes (shape-only stand-ins);
* the per-device argument bytes of the train step, both strategies, both
  meshes: the port's (its state, parameters and batch on ``meta``, the
  port's specs) against those summed from the reference's ``eval_shape``
  structs with its ``param_pspecs`` / ``gossip_state_pspecs`` /
  ``train_batch_specs`` (but the reference's round counter and PRNG key,
  12 bytes the port keeps on the host);
* the record's key set (the reference's ``rec`` keys, read from its
  source, plus ``counted_as``), the skip record, the CLI.

The reference module sets XLA's host-device count when imported; the
fixture restores the environment around the import.
"""
import ast
import importlib
import json
import os
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import INPUT_SHAPES, attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


class FakeMesh:
    """A shape-only mesh (tests/test_torch_sharding.py's)."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


SINGLE, MULTI = FakeMesh(data=16, model=16), \
    FakeMesh(pod=2, data=16, model=16)
MESHES = {"single": SINGLE, "multi": MULTI}


@pytest.fixture(scope="module")
def jdryrun():
    old = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old


@pytest.fixture(scope="module")
def params():
    """arch -> (the port's meta params, the reference's shape structs)."""
    out = {}
    for arch in ARCH_IDS:
        jmodel = jbuild_model(jget_config(arch))
        out[arch] = (build_model(get_config(arch), "meta").init(0),
                     jax.eval_shape(lambda m=jmodel: m.init(
                         jax.random.PRNGKey(0))))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parameter_counts_are_the_references(arch, params, jdryrun):
    ours, theirs = params[arch]
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert dryrun.count_params(ours) == jdryrun.count_params(theirs)
    assert dryrun.active_param_count(cfg, ours) == \
        jdryrun.active_param_count(jcfg, theirs)


def _reference_model_flops(jcfg, shape, n_active) -> float:
    """The reference's ``dryrun_one`` formula (inline in its source)."""
    if shape.kind == "train":
        return jhlo.model_flops(n_active, shape.global_batch * shape.seq_len)
    if shape.kind == "prefill":
        return jhlo.model_flops(
            n_active, shape.global_batch * shape.seq_len) / 3.0
    return jhlo.model_flops(n_active, shape.global_batch) / 3.0


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_per_shape_numbers_are_the_references(arch, mesh_name, params,
                                              jdryrun):
    mesh = MESHES[mesh_name]
    ours, theirs = params[arch]
    for name, shape in INPUT_SHAPES.items():
        cfg = steps.effective_config(get_config(arch), shape)
        jcfg = jsteps.effective_config(jget_config(arch), shape)
        assert steps.skip_reason(cfg, shape) == \
            jsteps.skip_reason(jcfg, shape), name
        assert dryrun.pick_microbatches(cfg, shape, mesh) == \
            jdryrun.pick_microbatches(jcfg, shape, mesh), name
        got = dryrun._model_flops(cfg, shape,
                                  dryrun.active_param_count(cfg, ours))
        want = _reference_model_flops(
            jcfg, shape, jdryrun.active_param_count(jcfg, theirs))
        assert got == want, name


def _shard_bytes(shape, itemsize, spec, mesh) -> int:
    dims = list(spec) + [None] * (len(shape) - len(spec))
    n = 1
    for size, axis in zip(shape, dims):
        names = () if axis is None else (
            axis if isinstance(axis, tuple) else (axis,))
        n *= -(-size // int(np.prod([mesh.shape[a] for a in names])))
    return n * itemsize


def _reference_argument_bytes(arch, strategy, jmesh) -> list:
    """Per-device bytes of the reference's (state, batch) structs on its
    specs (``dryrun_one``'s train branch without its opt flags)."""
    P = jax.sharding.PartitionSpec
    jcfg = jget_config(arch)
    shape = INPUT_SHAPES["train_4k"]
    jmodel = jbuild_model(jcfg)
    recipe = jsteps.TrainRecipe(strategy=strategy)
    if strategy == "gossip":
        nodes = int(np.prod([jmesh.shape[a] for a in
                             (("pod",) if "pod" in jmesh.axis_names
                              else ("data",))]))
        gdp = jsteps.make_gossip_dp(nodes, recipe)
        st = jax.eval_shape(jsteps.make_gossip_init(jmodel, gdp, nodes))
        axes = ("pod",) if "pod" in jmesh.axis_names else ("data",)
        theta = jrules.param_pspecs(st.gossip.theta, node_axes=axes,
                                    mesh=jmesh)
        specs = jsteps.gossip_state_pspecs(st, theta)
    else:
        _, init = jsteps.make_allreduce_train_step(jmodel, recipe)
        st = jax.eval_shape(init)
        specs = jsteps.AllreduceTrainState(
            params=jrules.param_pspecs(st.params, mesh=jmesh),
            opt={"step": P(),
                 "m": jrules.param_pspecs(st.opt["m"], mesh=jmesh),
                 "v": jrules.param_pspecs(st.opt["v"], mesh=jmesh)})
    batch, bspecs = jsteps.train_batch_specs(jcfg, shape, jmesh, strategy)
    out = []
    for values, spec_tree in ((st, specs), (batch, bspecs)):
        leaves = jax.tree_util.tree_leaves(values)
        spec_leaves = jax.tree_util.tree_leaves(
            spec_tree, is_leaf=lambda x: isinstance(x, P))
        assert len(leaves) == len(spec_leaves)
        out.append(sum(_shard_bytes(tuple(v.shape), v.dtype.itemsize, s,
                                    jmesh)
                       for v, s in zip(leaves, spec_leaves)))
    if strategy == "gossip":
        # the round counter and the PRNG key (int32, uint32[2]: 12 bytes,
        # replicated) are device arrays of the reference's state; the
        # port's state keeps them on the host (an int, a torch.Generator)
        out[0] -= sum(a.size * a.dtype.itemsize
                      for a in (st.gossip.t, st.gossip.key))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("strategy", ["gossip", "allreduce"])
@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x7b", "rwkv6-3b",
                                  "recurrentgemma-2b", "qwen2-vl-2b",
                                  "seamless-m4t-medium"])
def test_argument_bytes_are_the_references(arch, strategy, mesh_name):
    mesh = make_production_mesh(multi_pod=mesh_name == "multi")
    program = dryrun.lm_program(get_config(arch), INPUT_SHAPES["train_4k"],
                                mesh, strategy=strategy)
    got = dryrun.argument_bytes(program, mesh)
    assert got == _reference_argument_bytes(arch, strategy,
                                            MESHES[mesh_name])


def _reference_record_keys() -> list:
    """The keys of the record the reference's dryrun_one builds."""
    src = ast.parse((REPO / "src/repro/launch/dryrun.py").read_text())
    fn = next(n for n in ast.walk(src) if isinstance(n, ast.FunctionDef)
              and n.name == "dryrun_one")
    recs = [n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            and getattr(n.targets[0], "id", None) == "rec"]
    return [[k.value for k in r.keys] for r in recs]


def test_records_have_the_references_keys(capsys):
    skipped, ok = sorted(_reference_record_keys(),
                         key=lambda keys: "reason" not in keys)
    rec = dryrun.dryrun_one("minicpm-2b", "decode_32k", save=False)
    assert set(rec) == set(ok) | {"counted_as"}
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["xla_cost_analysis_raw"] is None
    assert rec["collectives"]["model_axis_bytes"] is None
    assert rec["collectives"]["total_bytes"] == 0      # serving: none
    assert rec["memory_per_device"]["temp"] is None
    assert set(rec["memory_per_device"]) == {"temp", "arguments", "output",
                                             "alias"}
    assert "divided evenly over the 256 devices" in rec["counted_as"]
    assert rec["hlo_flops"] > 0 and rec["roofline"]["dominant"] in (
        "compute", "memory", "collective")
    skip = dryrun.dryrun_one("seamless-m4t-medium", "long_500k", save=False)
    assert list(skip) == skipped and skip["status"] == "skipped"
    out = capsys.readouterr().out
    assert "[ok] minicpm-2b x decode_32k @ 16x16/gossip" in out
    assert "[skip] seamless-m4t-medium x long_500k" in out


def test_gossip_record_counts_the_strategy_exchange():
    rec = dryrun.dryrun_one("minicpm-2b", "train_4k", save=False,
                            verbose=False)
    coll = rec["collectives"]
    assert set(coll["bytes_by_kind"]) == {"collective-permute"}
    assert coll["total_bytes"] == coll["bytes_by_kind"][
        "collective-permute"] > 0
    assert rec["roofline"]["t_collective_s"] > 0
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops_6nd"] / (rec["hlo_flops"] * 256))


def test_bigq_is_scoped_and_changes_the_flash_count():
    flash = dryrun.dryrun_one("minicpm-2b", "train_4k", opt="flash",
                              save=False, verbose=False)
    bigq = dryrun.dryrun_one("minicpm-2b", "train_4k", opt="flash,bigq",
                             save=False, verbose=False)
    assert attention._FLASH_Q_CHUNK == [512] and attention.Q_CHUNK == 512
    assert bigq["hlo_bytes"] != flash["hlo_bytes"]
    assert bigq["strategy"] == "gossip+flash,bigq"


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_needed_bytes_lie_between_the_io_and_the_eager_count(kind):
    """The step's needed bytes (its roofline's memory term) hold at least
    its arguments and outputs, and no more than the eager op count moves;
    a prefill adds only its layer boundaries, written and read once."""
    cfg = get_config("minicpm-2b").reduced()
    shape = ShapeConfig(kind, 64, 4, kind)
    mesh = make_mesh((2, 1), ("data", "model"), devices=["meta"] * 2)
    program = dryrun.lm_program(cfg, shape, mesh)
    out, cost, _ = dryrun.count_lm_step(program, mesh)
    io = sum(t.numel() * t.element_size()
             for t in tree.leaves((program["args"], out))
             if isinstance(t, torch.Tensor))
    need = dryrun.needed_bytes(program, out, cfg, shape)
    assert io < need < cost.hbm_bytes
    if kind == "prefill":
        item = torch.empty((), dtype=cfg.tdtype).element_size()
        assert need - io == 2 * cfg.num_layers * 4 * 64 * cfg.d_model * item


@pytest.mark.parametrize("arch,shape,opt,multi,change", [
    # the reference's ep puts "model" on a stacked leaf's layer axis (its
    # spec is written for an unstacked (E, d, f) stack): other specs, the
    # same bytes
    ("mixtral-8x7b", "train_4k", "ep", False, 0),
    ("minicpm-2b", "train_4k", "zerotheta", True, -1),
    ("qwen2-7b", "prefill_32k", "repattn", False, 1)])
def test_placement_flags_change_the_specs(arch, shape, opt, multi, change):
    mesh = make_production_mesh(multi_pod=multi)
    plain, placed = (dryrun.lm_program(get_config(arch), INPUT_SHAPES[shape],
                                       mesh, opt=o) for o in ("", opt))
    assert plain["arg_specs"][0] != placed["arg_specs"][0]
    a, b = (sum(dryrun.argument_bytes(p, mesh)) for p in (plain, placed))
    assert (b > a) - (b < a) == change


def test_unknown_opt_flags_are_refused():
    with pytest.raises(ValueError, match="unknown --opt"):
        dryrun.lm_program(get_config("minicpm-2b"),
                          INPUT_SHAPES["train_4k"], make_production_mesh(),
                          opt="fastest")


def test_cli_writes_the_records_apart_from_the_references(tmp_path,
                                                          monkeypatch):
    assert dryrun.OUT_DIR.endswith(os.path.join("experiments",
                                                "torch_dryrun"))
    assert dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k",
                        "--strategy", "allreduce", "--out",
                        str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "qwen2-7b__decode_32k__16x16__"
                      "allreduce.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    monkeypatch.setattr(dryrun, "dryrun_one", lambda *a, **k: 1 / 0)
    assert dryrun.main(["--arch", "qwen2-7b", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 1
    failed = json.loads((tmp_path / "qwen2-7b__decode_32k__16x16__"
                         "gossip.json").read_text())
    assert failed["status"] == "failed" and "ZeroDivisionError" in \
        failed["error"]
