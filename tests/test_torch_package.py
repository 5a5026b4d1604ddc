"""The port as a package: its import boundary, its device rule, and what
it refuses until it is ported."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import ExecConfig, RunSpec, run  # noqa: E402
from repro_torch.api import BACKENDS, MIXERS  # noqa: E402
from repro_torch.api.registry import UnknownEntryError  # noqa: E402
from repro_torch.kernels import round_fused as rf  # noqa: E402

PKG = pathlib.Path(repro_torch.__file__).parent
SPEC = dict(nodes=4, dim=30, horizon=4, eps=1.0, alpha0=0.5, lam=0.01)
CFG = ExecConfig(chunk_rounds=2, warmup=False, compute_regret=False)


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts), path


def test_importing_the_port_loads_neither_jax_nor_repro():
    names = [name for name, _ in _modules()]
    code = (
        "import sys, importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(PKG.parent),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("name,path", list(_modules()),
                         ids=[n for n, _ in _modules()])
def test_no_source_file_imports_jax_or_repro(name, path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path}: imports {mod}"


def test_entry_points_default_to_cuda_and_refuse_without_it():
    assert not torch.cuda.is_available()      # this suite runs on the CPU
    spec = RunSpec(**SPEC)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(spec, exec=CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spec.build_simulator().init(0)
    res = run(spec, exec=CFG, device="cpu")
    assert res.device == "cpu" and res.final_w.shape == (4, 30)


def test_dist_entry_points_default_to_cuda_and_refuse_without_it():
    """The distributed engine's entry points follow the same device rule:
    run(engine="dist"), GossipDP.init, state_from_jax, and a record's
    engine state decoded onto a card."""
    from repro_torch.convert import state_from_jax
    spec = RunSpec(**SPEC)
    gdp = spec.build_distributed()
    params = {"w": torch.zeros((4, 30))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(spec, engine="dist", exec=CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gdp.init(params, 0)
    arrays = {"theta/w": np.zeros((4, 30), np.float32), "t": np.int32(2)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        state_from_jax(arrays)
    assert state_from_jax(arrays, "cpu").theta["w"].device.type == "cpu"
    assert gdp.init(params, 0, device="cpu").theta["w"].device.type == "cpu"
    rec = run(spec, engine="dist", exec=CFG, device="cpu").to_record(
        include_state=True)
    assert repro_torch.RunResult.from_record(rec).final_state.t == 4
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.RunResult.from_record({**rec, "device": "cuda"})


def test_package_exports_the_distributed_engine_and_ops():
    from repro_torch.core import gossip
    for name in ("GossipDP", "GossipState", "gossip_mix_tree",
                 "per_node_clip"):
        assert getattr(repro_torch, name) is getattr(gossip, name)
        assert getattr(repro_torch.api, name) is getattr(gossip, name)
    assert repro_torch.ops is repro_torch.api.ops
    assert callable(repro_torch.ops.pdomd_update)


def test_kernel_wrapper_takes_the_plain_version_for_cpu_tensors():
    from repro_torch.kernels import hinge_grad, pdomd_update
    hinge_grad.reset_launches()
    pdomd_update.reset_launches()
    t = torch.ones((8, 128))
    assert torch.equal(pdomd_update.pdomd_update(t, t, t, t, 0.1, 0.2)[1],
                       pdomd_update.pdomd_update_plain(t, t, t, t, 0.1,
                                                       0.2)[1])
    x, y, w = torch.ones((2, 128)), torch.ones(2), torch.zeros(128)
    assert torch.equal(hinge_grad.hinge_grad(x, y, w)[1],
                       hinge_grad.hinge_grad_plain(x, y, w)[1])
    assert pdomd_update.pdomd_update.launches == 0
    assert hinge_grad.hinge_grad.launches == 0
    rf.reset_launches()
    rng = np.random.default_rng(0)
    mixed, x, theta = (torch.from_numpy(rng.standard_normal((3, 7)).astype(
        np.float32)) for _ in range(3))
    coeff, alive = torch.ones(3), torch.ones(3)
    out = rf.dual_step(mixed, x, theta, coeff, alive, 0.5)
    assert torch.equal(out, rf.dual_step_plain(mixed, x, theta, coeff, alive,
                                               0.5))
    assert rf.dual_step.launches == 0


def test_registries_name_what_the_slice_carries():
    """Every stage registry lists exactly the reference's names (the
    backends aside: 'cuda' stands where the reference has 'pallas')."""
    import repro.api as japi
    import repro_torch.api as api
    for name in ("MIXERS", "MECHANISMS", "LOCAL_RULES", "CLIPPERS",
                 "STREAMS"):
        port, ref = getattr(api, name), getattr(japi, name)
        assert port.names() == ref.names(), name
        assert sorted(port.describe()) == sorted(ref.describe()), name
        assert all(port.describe().values()), name
    assert japi.BACKENDS.names() == ("pallas", "reference")
    assert BACKENDS.names() == ("cuda", "reference")
    assert all(BACKENDS.describe().values())
    with pytest.raises(UnknownEntryError, match="cuda"):
        BACKENDS.build("pallas")
    with pytest.raises(TypeError, match="mode"):
        BACKENDS.build("cuda", {"moed": "auto"})
    with pytest.raises(ValueError, match="mode"):
        BACKENDS.build("cuda", {"mode": "fast"})


@pytest.mark.parametrize("value", ["none", "links", "partition", "crash",
                                   "dcn"])
def test_unported_stages_raise_naming_the_roadmap(value):
    """Every name of the reference's FAULTS registry resolves in the port
    and runs on both engines and both backends, and `repro.faults` is
    ported whole (the node-sharded faulty mixer too); the LM stack's
    production meshes, once refused, are ported (of ``meta`` positions)."""
    import repro_torch.faults as faults
    from repro.faults import FAULTS
    assert value in FAULTS.names() and value in faults.FAULTS.names()
    spec = RunSpec(**SPEC, faults=value)
    assert spec.resolve_faults().spec.name == value
    for backend in ("reference", "cuda"):
        for engine in ("sim", "dist"):
            res = run(spec.replace(backend=backend), engine=engine,
                      exec=CFG, device="cpu")
            assert res.metrics["faults"]["spec"] == value
            assert res.connectivity.shape == (4,)
            assert np.isfinite(res.final_w).all()
    from repro_torch.api.shard_node import ShardedSparseMixer
    from repro_torch.launch import mesh
    assert issubclass(faults.FaultyShardedSparseMixer, ShardedSparseMixer)
    prod = mesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert prod.device_type == "meta"


def test_dist_engine_is_not_ported():
    """The distributed engine was the last engine refused; it is ported
    now (tests/test_torch_gossip.py holds it to the reference), so only an
    engine that exists in neither package is refused."""
    res = run(RunSpec(**SPEC), engine="dist", exec=CFG, device="cpu")
    assert res.engine == "dist" and res.final_w.shape == (4, 30)
    with pytest.raises(ValueError, match="'sim' or 'dist'"):
        run(RunSpec(**SPEC), engine="sharded", exec=CFG, device="cpu")


def test_cuda_backend_refusals_match_the_reference():
    """The fused backend keeps the reference's refusals: a custom loss;
    mode='fused' past max_fused_nodes."""
    with pytest.raises(ValueError, match="reference"):
        run(RunSpec(**SPEC, backend="cuda",
                    loss_and_grad=lambda w, x, y: None), exec=CFG,
            device="cpu")
    with pytest.raises(ValueError, match="hybrid"):
        run(RunSpec(**SPEC, backend="cuda",
                    backend_options={"mode": "fused", "max_fused_nodes": 2}),
            exec=CFG, device="cpu")
    # auto falls back to hybrid past the cap, and agrees with fused
    auto = run(RunSpec(**SPEC, backend="cuda",
                       backend_options={"max_fused_nodes": 2}), exec=CFG,
               device="cpu")
    fused = run(RunSpec(**SPEC, backend="cuda"), exec=CFG, device="cpu")
    assert np.abs(auto.final_w - fused.final_w).max() <= 5e-6
    np.testing.assert_array_equal(auto.sparsity, fused.sparsity)


@pytest.mark.parametrize("name", [n for n, _ in _modules()])
def test_module_docstring_examples_run(name):
    import doctest
    import importlib
    module = importlib.import_module(name)
    result = doctest.testmod(module, optionflags=doctest.ELLIPSIS)
    assert result.failed == 0, f"{name}: {result.failed} doctest failures"


def test_package_exports_the_batch_and_the_sweep():
    """`repro_torch.sweep` carries the names `repro.sweep` does, and the
    port exports `run_batch` and `seed_vectorizable` where `repro.api`
    does."""
    import repro.api as japi
    import repro.sweep as jsweep
    import repro_torch.api as api
    import repro_torch.sweep as sweep
    from repro_torch.api import runner
    assert sweep.__all__ == jsweep.__all__
    assert all(callable(getattr(sweep, name)) or name == "DEFAULT_STORE"
               for name in sweep.__all__)
    for name in ("run_batch", "seed_vectorizable"):
        assert name in api.__all__ and hasattr(japi, name)
        assert getattr(api, name) is getattr(runner, name)
        assert getattr(repro_torch, name) is getattr(runner, name)


def test_package_exports_serving_and_telemetry():
    """`repro_torch.serve` carries the names `repro.serve` does;
    `repro_torch.obs` those of `repro.obs`, the cost loop's included; the
    checkpoint package adds the async writer."""
    import repro.checkpoint as jcheckpoint
    import repro.obs as jobs
    import repro.serve as jserve
    import repro_torch.checkpoint as checkpoint
    import repro_torch.obs as obs
    import repro_torch.serve as serve
    assert serve.__all__ == jserve.__all__
    assert all(hasattr(serve, name) for name in serve.__all__)
    assert obs.__all__ == jobs.__all__
    assert all(hasattr(obs, name) for name in obs.__all__)
    assert checkpoint.__all__ == jcheckpoint.__all__
    assert ExecConfig().obs is None


def test_package_exports_the_runner_surface():
    """`repro_torch.metrics` carries the names `repro.metrics` does;
    `repro_torch.api` those of `repro.api` (the Pallas backend's place is
    the cuda backend's); `repro_torch.launch` has every module of
    `repro.launch`, with `op_cost` for `hlo_cost`."""
    import pkgutil

    import repro.api as japi
    import repro.launch as jlaunch
    import repro.metrics as jmetrics
    import repro_torch.api as api
    import repro_torch.launch as launch
    import repro_torch.metrics as metrics
    assert metrics.__all__ == jmetrics.__all__
    assert all(hasattr(metrics, name) for name in metrics.__all__)
    assert set(japi.__all__) - set(api.__all__) == {"PallasBackend"}
    assert all(hasattr(api, name) for name in api.__all__)
    assert api.sweep is repro_torch.sweep.sweep
    mods = lambda pkg: {m.name for m in pkgutil.iter_modules(  # noqa: E731
        pkg.__path__)}
    assert mods(launch) == (mods(jlaunch) - {"hlo_cost"}) | {"op_cost"}
    import repro.launch.mesh as jmesh
    from repro_torch.launch import mesh
    assert all(hasattr(mesh, name) for name in dir(jmesh)
               if callable(getattr(jmesh, name)) and not name.startswith("_")
               and getattr(jmesh, name).__module__ == jmesh.__name__)
    assert repro_torch.metrics is metrics


def _meta_mesh():
    from repro_torch.launch import mesh
    return mesh.make_production_mesh()


@pytest.mark.parametrize("name,args,want", [
    ("make_production_mesh", (), {"data": 16, "model": 16}),
    ("make_test_mesh", (), {"data": 4, "model": 2}),
    ("gossip_axes", (_meta_mesh,), ("data",)),
    ("gossip_nodes", (_meta_mesh,), 16),
    ("data_axes_for_batch", (_meta_mesh,), ())])
def test_lm_production_meshes_are_ported(name, args, want):
    """The LM stack's meshes, once refused naming ROADMAP queue 1 item 5,
    are ported: the production mesh of ``meta`` positions (counted, not
    run), the test mesh (``cpu`` shards here) and the three functions of
    the gossip layout (tests/test_torch_sharding.py holds each to the
    reference)."""
    from repro_torch.launch import mesh
    fn = getattr(mesh, name)
    got = (fn(*[a() for a in args]) if args else
           fn(device="cpu") if name == "make_test_mesh" else fn())
    if isinstance(got, mesh.Mesh):
        got = got.shape
    assert got == want


def _public(module) -> set:
    """The names a module defines for its users: its ``__all__``, or (the
    reference's `repro.configs` has none) its public functions and
    constants that were not imported from elsewhere."""
    import types
    if hasattr(module, "__all__"):
        return set(module.__all__)
    return {name for name, v in vars(module).items()
            if not name.startswith("_") and not isinstance(v, types.ModuleType)
            and getattr(v, "__module__", module.__name__) == module.__name__}


# package -> the reference's names the port does not carry, and why
_LEFT_OUT = {
    "core": set(),
    "data": set(),
    "sharding": set(),
    "kernels": {"LANE", "SUBLANE", "DEFAULT_BLOCK_COLS"},  # TPU tiling
    "configs": set(),
    "configs.social_linear": set(),
}


@pytest.mark.parametrize("package", list(_LEFT_OUT))
def test_paper_path_packages_export_the_reference_names(package):
    """`__all__` of core, data, sharding, kernels and configs is the
    reference's but for the TPU tiling constants; every exported name
    resolves."""
    import importlib
    mine = importlib.import_module(f"repro_torch.{package}")
    ref = importlib.import_module(f"repro.{package}")
    assert set(mine.__all__) == _public(ref) - _LEFT_OUT[package]
    if hasattr(ref, "__all__"):
        assert list(mine.__all__) == [n for n in ref.__all__
                                      if n not in _LEFT_OUT[package]]
    assert all(hasattr(mine, name) for name in mine.__all__)


def test_core_names_import_from_the_package():
    from repro_torch.core import (Algorithm1, GossipDP, GossipState,
                                  OnlineMirrorDescent, PrivacyConfig)
    from repro_torch.core import algorithm1, gossip, omd, privacy
    assert Algorithm1 is algorithm1.Algorithm1
    assert (GossipDP, GossipState) == (gossip.GossipDP, gossip.GossipState)
    assert OnlineMirrorDescent is omd.OnlineMirrorDescent
    assert PrivacyConfig is privacy.PrivacyConfig
    with pytest.raises(AttributeError, match="no attribute"):
        repro_torch.core.TokenStream


def test_kernels_export_the_round_kernels_and_the_port_s_bound():
    import repro_torch.kernels as kernels
    from repro_torch.api.backends import CudaBackend
    for name in ("round_stats", "round_update", "dual_step"):
        assert getattr(kernels, name) is getattr(rf, name)
    assert kernels.MAX_FUSED_NODES == CudaBackend().max_fused_nodes == 1024
    assert BACKENDS.build("cuda").max_fused_nodes == kernels.MAX_FUSED_NODES


import repro.configs as _jconfigs  # noqa: E402


def _fields(cfg) -> dict:
    import dataclasses
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", _jconfigs.ARCH_IDS)
def test_lm_configs_equal_the_reference(arch):
    """`configs` lists the reference's architecture ids, and each one's
    config is the reference's field for field (the paper's workload still
    resolves to `social_linear.CONFIG`)."""
    from repro_torch import configs
    from repro_torch.models import ModelConfig
    assert configs.ARCH_IDS == _jconfigs.ARCH_IDS
    assert configs.PAPER_WORKLOAD == _jconfigs.PAPER_WORKLOAD
    assert configs.get_config(configs.PAPER_WORKLOAD) is \
        configs.social_linear.CONFIG
    mine, ref = configs.get_config(arch), _jconfigs.get_config(arch)
    assert isinstance(mine, ModelConfig)
    assert _fields(mine) == _fields(ref)
    assert (mine.vocab_padded, mine.kv_heads, mine.dims_per_head,
            mine.rnn_width, mine.is_subquadratic) == \
        (ref.vocab_padded, ref.kv_heads, ref.dims_per_head, ref.rnn_width,
         ref.is_subquadratic)
    assert str(mine.tdtype).split(".")[-1] == str(ref.jdtype)


@pytest.mark.parametrize("arch", _jconfigs.ARCH_IDS)
def test_lm_reduced_configs_equal_the_reference(arch):
    """``reduced()`` — the size every CPU test runs — is the reference's
    field for field, with its defaults and with other sizes."""
    from repro_torch import configs
    mine, ref = configs.get_config(arch), _jconfigs.get_config(arch)
    assert _fields(mine.reduced()) == _fields(ref.reduced())
    kw = dict(layers=3, d_model=128, d_ff=96, vocab=300, experts=2)
    assert _fields(mine.reduced(**kw)) == _fields(ref.reduced(**kw))


def test_all_configs_equal_the_reference():
    from repro_torch import configs
    mine, ref = configs.all_configs(), _jconfigs.all_configs()
    assert list(mine) == list(ref) == configs.ARCH_IDS
    assert all(_fields(mine[a]) == _fields(ref[a]) for a in ref)


@pytest.mark.parametrize("package", ["models", "optim"])
def test_lm_packages_export_the_reference_names(package):
    """`repro_torch.models` and `repro_torch.optim` export the reference's
    `__all__`, in its order, and every name resolves."""
    import importlib
    mine = importlib.import_module(f"repro_torch.{package}")
    ref = importlib.import_module(f"repro.{package}")
    assert mine.__all__ == ref.__all__
    assert all(hasattr(mine, name) for name in mine.__all__)
    from repro.models.config import INPUT_SHAPES
    from repro_torch.models import INPUT_SHAPES as mine_shapes
    assert {k: vars(v) for k, v in mine_shapes.items()} == \
        {k: vars(v) for k, v in INPUT_SHAPES.items()}


@pytest.mark.parametrize("engine", ["sim", "dist"])
def test_make_chunk_fn_is_the_program_run_executes(engine):
    """`make_chunk_fn` returns the chunk program and the state of
    ``spec.seed``: one chunk over the horizon equals `run` bit for bit, and
    the runner exports it as the reference's runner does."""
    import repro.api.runner as jrunner
    from repro_torch.api import runner
    assert "make_chunk_fn" in runner.__all__ and \
        "make_chunk_fn" in jrunner.__all__
    spec = RunSpec(**SPEC, backend="cuda")
    chunk_fn, state = runner.make_chunk_fn(spec, engine, device="cpu")
    assert state.t == 0
    xs, ys = spec.resolve_stream(device="cpu").chunk(0, spec.horizon)
    state, outs = chunk_fn(state, xs, ys)
    res = run(spec, engine=engine, exec=CFG, device="cpu")
    np.testing.assert_array_equal(outs.loss.numpy(), res.loss)
    np.testing.assert_array_equal(outs.correct.numpy(), res.correct)
    assert state.t == spec.horizon
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.make_chunk_fn(spec, engine)
