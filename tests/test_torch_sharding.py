"""The port's sharding rules (`repro_torch.sharding`), LM meshes
(`repro_torch.launch.mesh`) and input specs (`repro_torch.launch.steps`)
against the JAX package's, exactly.

Every architecture at its full published config: the port's parameters
on the ``meta`` device (shapes and dtypes, no storage) against
``jax.eval_shape`` of the reference's init, path for path, and the
`param_pspecs` trees equal leaf for leaf with no mesh, on a shape-only
16 x 16 ("data", "model") mesh, and with a leading node axis over
("data",) and ("pod",). The caches' specs at ``reduced()``, the
sanitizer's move and drop cases (tests/test_sharding.py's), and the batch
specs of every architecture x input shape on the single-pod and
multi-pod production meshes: the port's meshes hold ``meta`` positions,
the reference's functions read a shape-only stand-in (its 256 and 512
devices do not exist here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import INPUT_SHAPES as JINPUT_SHAPES  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import INPUT_SHAPES, build_model  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.rules import P  # noqa: E402


class FakeMesh:
    """A shape-only mesh, as tests/test_sharding.py's."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


SINGLE, MULTI = FakeMesh(data=16, model=16), \
    FakeMesh(pod=2, data=16, model=16)


def jax_paths(tree_) -> dict:
    """{path: leaf} of a reference pytree."""
    return {"/".join(str(getattr(p, "name", getattr(
        p, "key", getattr(p, "idx", None)))) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree_, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}


def assert_same_specs(got, want):
    """Two spec trees equal path for path, entry for entry."""
    g = dict(tree.flatten_with_path(got))
    w = jax_paths(want)
    assert sorted(g) == sorted(w)
    bad = {k: (g[k], w[k]) for k in w if tuple(g[k]) != tuple(w[k])}
    assert not bad, bad


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.fixture(scope="module")
def full_params():
    """arch -> (the port's meta params, the reference's shape structs)."""
    out = {}
    for arch in ARCH_IDS:
        jmodel = jbuild_model(jget_config(arch))
        out[arch] = (build_model(get_config(arch), "meta").init(0),
                     jax.eval_shape(
                         lambda m=jmodel: m.init(jax.random.PRNGKey(0))))
    return out


def test_the_architectures_are_the_references():
    assert list(ARCH_IDS) == list(JARCH_IDS) and len(ARCH_IDS) == 10


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_match_the_reference_at_full_width(arch, full_params):
    params, jparams = full_params[arch]
    got = dict(tree.flatten_with_path(params))
    want = jax_paths(jparams)
    assert sorted(got) == sorted(want)
    for k, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[k].shape), k
        assert _dtype(leaf) == str(want[k].dtype), k
    assert_same_specs(rules.param_pspecs(params),
                      jrules.param_pspecs(jparams))
    assert_same_specs(rules.param_pspecs(params, mesh=SINGLE),
                      jrules.param_pspecs(jparams, mesh=SINGLE))
    for axes, fake, nodes in ((("data",), SINGLE, 16), (("pod",), MULTI, 2)):
        node_params = rules.with_node_axis(params, nodes)
        jnode = jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct((nodes,) + s.shape, s.dtype),
            jparams)
        assert_same_specs(
            rules.param_pspecs(node_params, node_axes=axes, mesh=fake),
            jrules.param_pspecs(jnode, node_axes=axes, mesh=fake))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_match_the_reference(arch):
    jmodel = jbuild_model(jget_config(arch).reduced())
    model = build_model(get_config(arch).reduced(), "meta")
    jcache = jax.eval_shape(lambda: jmodel.init_cache(32, 64))
    cache = model.init_cache(32, 64)
    for axes, fake in ((("data",), None), (("data",), SINGLE),
                       (("pod", "data"), MULTI)):
        assert_same_specs(rules.cache_pspecs(cache, axes, mesh=fake),
                          jrules.cache_pspecs(jcache, axes, mesh=fake))


def test_sanitizer_moves_or_drops_an_indivisible_axis():
    """tests/test_sharding.py's cases, and the move never lands on a
    leading layer-stack dim."""
    assert rules._sanitize(P("model", None), (10, 64),
                           FakeMesh(data=4, model=16)) == P(None, "model")
    assert rules._sanitize(P("model"), (10,), FakeMesh(model=16)) == P()
    assert rules._sanitize(P(None, "model", None), (32, 10, 64),
                           FakeMesh(model=16)) == P(None, None, "model")
    assert rules._sanitize(P(None, None, "model"), (32, 64, 10),
                           FakeMesh(model=16)) == P(None, "model")
    for spec, shape in (((None, "model", None), (32, 10, 64)),
                        (("model", None), (10, 64)),
                        ((None, None, "model"), (32, 64, 10)),
                        ((("pod", "data"), None), (64, 5))):
        assert tuple(rules._sanitize(P(*spec), shape, MULTI)) == tuple(
            jrules._sanitize(jax.sharding.PartitionSpec(*spec), shape,
                             MULTI))


def test_batch_pspec_and_with_node_axis_match_the_reference():
    assert tuple(rules.batch_pspec(("pod", "data"), 3)) == tuple(
        jrules.batch_pspec(("pod", "data"), 3))
    assert rules.batch_pspec(("data",), 2) == P("data", None)
    leaf = torch.arange(6.0).reshape(2, 3)
    tiled = rules.with_node_axis({"w": leaf}, 4)["w"]
    want = jrules.with_node_axis({"w": jnp.arange(6.0).reshape(2, 3)}, 4)
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(want["w"]))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_match_the_reference(monkeypatch, multi_pod):
    """The reference's mesh shape and axes (its `make_mesh` captured:
    the 256/512 devices it asks for do not exist here), and the three
    gossip-layout functions on them."""
    monkeypatch.setattr(jmesh, "make_mesh", lambda shape, axes: (shape,
                                                                 axes))
    shape, axes = jmesh.make_production_mesh(multi_pod=multi_pod)
    prod = mesh.make_production_mesh(multi_pod=multi_pod)
    assert prod.axis_names == axes and tuple(prod.shape.values()) == shape
    assert prod.device_type == "meta" and prod.size == int(np.prod(shape))
    fake = MULTI if multi_pod else SINGLE
    assert mesh.gossip_axes(prod) == jmesh.gossip_axes(fake)
    assert mesh.gossip_nodes(prod) == jmesh.gossip_nodes(fake)
    assert mesh.data_axes_for_batch(prod) == jmesh.data_axes_for_batch(fake)


def test_test_mesh_and_the_cuda_rule():
    """make_test_mesh is the reference's (data, model) grid; a CUDA mesh
    larger than the visible cards still raises, a meta one counts."""
    small = mesh.make_test_mesh(4, 2, device="cpu")
    assert small.shape == {"data": 4, "model": 2}
    assert mesh.gossip_axes(small) == ("data",)
    assert mesh.gossip_nodes(small) == 4
    assert mesh.data_axes_for_batch(small) == ()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mesh.make_production_mesh(device="cuda")
    with pytest.raises(ValueError, match="cuda"):
        mesh.mesh_device(mesh.make_production_mesh(), "cuda")


@pytest.mark.parametrize("strategy", ["gossip", "allreduce"])
@pytest.mark.parametrize("multi_pod", [False, True])
def test_train_and_serve_batch_specs_match_the_reference(strategy,
                                                         multi_pod):
    """Every architecture x INPUT_SHAPES: shapes, dtypes and specs, on
    the production mesh (the reference's on a shape-only stand-in)."""
    prod = mesh.make_production_mesh(multi_pod=multi_pod)
    fake = MULTI if multi_pod else SINGLE
    assert sorted(INPUT_SHAPES) == sorted(JINPUT_SHAPES)
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name, shape in INPUT_SHAPES.items():
            batch, specs = steps.train_batch_specs(cfg, shape, prod,
                                                   strategy)
            jbatch, jspecs = jsteps.train_batch_specs(
                jcfg, JINPUT_SHAPES[name], fake, strategy)
            assert sorted(batch) == sorted(jbatch)
            for k in jbatch:
                assert batch[k].device.type == "meta"
                assert tuple(batch[k].shape) == jbatch[k].shape
                assert _dtype(batch[k]) == str(jbatch[k].dtype)
                assert tuple(specs[k]) == tuple(jspecs[k]), (arch, name, k)
            (tok, pos), (tspec, pspec) = steps.serve_batch_specs(
                cfg, shape, prod)
            (jtok, jpos), (jtspec, jpspec) = jsteps.serve_batch_specs(
                jcfg, JINPUT_SHAPES[name], fake)
            assert (tuple(tok.shape), tuple(pos.shape)) == (jtok.shape,
                                                            jpos.shape)
            assert _dtype(tok) == str(jtok.dtype) == "int32"
            assert (tuple(tspec), tuple(pspec)) == (tuple(jtspec),
                                                    tuple(jpspec))
            B = shape.global_batch
            assert steps.batch_axes_for_serve(prod, B) == \
                jsteps.batch_axes_for_serve(fake, B)
            assert steps.decode_cache_len(cfg, shape) == \
                jsteps.decode_cache_len(jcfg, JINPUT_SHAPES[name])
            assert steps.skip_reason(cfg, shape) == \
                jsteps.skip_reason(jcfg, JINPUT_SHAPES[name])
            assert steps.effective_config(cfg, shape).sliding_window == \
                jsteps.effective_config(
                    jcfg, JINPUT_SHAPES[name]).sliding_window


@pytest.mark.parametrize("delay", [0, 2])
def test_gossip_state_pspecs_and_named_match_the_reference(delay):
    """The state's spec tree (theta by the rules, the ring with an
    unsharded leading axis, t and the noise state replicated), and
    `named` over it, on minicpm-2b reduced."""
    jcfg, cfg = jget_config("minicpm-2b").reduced(), \
        get_config("minicpm-2b").reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg, device="cpu")
    recipe = dict(delay=delay)
    jgdp = jsteps.make_gossip_dp(4, jsteps.TrainRecipe(**recipe))
    gdp = steps.make_gossip_dp(4, steps.TrainRecipe(**recipe))
    jstate = jax.eval_shape(jsteps.make_gossip_init(jmodel, jgdp, 4))
    state = steps.make_gossip_init(model, gdp, 4)(0)
    jspecs = jsteps.gossip_state_pspecs(
        jstate, jrules.param_pspecs(jstate.gossip.theta, ("data",), SINGLE))
    specs = steps.gossip_state_pspecs(
        state, rules.param_pspecs(state.gossip.theta, ("data",), SINGLE))
    assert_same_specs(specs.gossip.theta, jspecs.gossip.theta)
    assert (specs.gossip.history is None) == (delay == 0)
    if delay:
        assert_same_specs(specs.gossip.history, jspecs.gossip.history)
    assert specs.gossip.t == P() and specs.gossip.generator == P()
    shardings = steps.named(SINGLE, specs)
    leaves = tree.leaves(shardings)
    assert len(leaves) == len(tree.leaves(specs))
    assert all(s.mesh is SINGLE for s in leaves)
    assert shardings.gossip.t.spec == P()
