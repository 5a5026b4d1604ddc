"""The port's counted flops (`repro_torch.launch.op_cost` on ``meta``
tensors, the dry-run's counting path) against the reference's
(`repro.launch.hlo_cost.analyze` of the compiled XLA program), at
``reduced()`` on one device: the gossip train step of every family
(2 nodes x B 2 x T 32), the prefill and decode steps of a dense arch.

The two count different programs: the port's eager aten ops, XLA's
optimised HLO (the vmapped nodes, fusions, the backward's scans). What
they share is the matrix products: with `hlo_cost`'s elementwise rules
switched off, the reference's dots and reductions of minicpm-2b's step
come within 1 % of the port's matmul flops (measured 1.4160e9 against
1.4093e9). Elementwise work is where they part: XLA's program holds more
elementwise instructions (converts, broadcast selects, the vmapped
masks), each counted per element. So the totals are held per family,
the port's count over the reference's (measured):

  dense, MoE, rwkv6, rglru, vision   0.724-0.732   held in [0.70, 0.76]
  enc-dec                            0.649         held in [0.62, 0.68]
  prefill, decode (dense)            1.001, 1.022  held in [0.98, 1.04]
"""
import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import op_cost, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

NODES, B, T = 2, 2, 32
TRAIN_BAND = (0.70, 0.76)
BANDS = {"minicpm-2b": TRAIN_BAND, "mixtral-8x7b": TRAIN_BAND,
         "rwkv6-3b": TRAIN_BAND, "recurrentgemma-2b": TRAIN_BAND,
         "qwen2-vl-2b": TRAIN_BAND, "seamless-m4t-medium": (0.62, 0.68)}
SERVE_BAND = (0.98, 1.04)
MATMUL = ("mm", "bmm", "addmm", "mv", "dot", "baddbmm")


def _structs(cfg, lead, labels=True) -> dict:
    s = {"tokens": jax.ShapeDtypeStruct(lead + (T,), jnp.int32)}
    if labels:
        s["labels"] = jax.ShapeDtypeStruct(lead + (T,), jnp.int32)
    if cfg.family == "encdec":
        s["frontend"] = jax.ShapeDtypeStruct(lead + (8, cfg.d_model),
                                             jnp.float32)
    elif cfg.frontend == "vision":
        s["frontend"] = jax.ShapeDtypeStruct(
            lead + (cfg.frontend_tokens, cfg.d_model), jnp.float32)
    return s


def _meta(structs: dict) -> dict:
    return {k: torch.empty(v.shape, device="meta", dtype=(
        torch.int32 if v.dtype == jnp.int32 else torch.float32))
        for k, v in structs.items()}


def _gossip_counts(arch):
    """(the reference's compiled HLO, the port's meta count) of the
    reduced gossip train step."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg, "meta")
    jgdp = jsteps.make_gossip_dp(NODES, jsteps.TrainRecipe())
    state = jax.eval_shape(jsteps.make_gossip_init(jmodel, jgdp, NODES))
    batch = _structs(jcfg, (NODES, B))
    hlo = jax.jit(jsteps.make_gossip_train_step(jmodel, jgdp, 1)).lower(
        state, batch).compile().as_text()
    gdp = steps.make_gossip_dp(NODES, steps.TrainRecipe())
    _, cost = op_cost.count(steps.make_gossip_train_step(model, gdp, 1),
                            steps.make_gossip_init(model, gdp, NODES)(0),
                            _meta(batch))
    return hlo, cost


@pytest.mark.parametrize("arch", sorted(BANDS))
def test_gossip_step_flops_against_the_references(arch, monkeypatch):
    hlo, cost = _gossip_counts(arch)
    ratio = cost.flops / hlo_cost.analyze(hlo).flops
    lo, hi = BANDS[arch]
    assert lo <= ratio <= hi, f"{arch}: port / reference flops {ratio:.4f}"
    if arch == "minicpm-2b":
        monkeypatch.setattr(hlo_cost, "_ELEMWISE_1", set())
        monkeypatch.setattr(hlo_cost, "_ELEMWISE_TRANS", {})
        dots = hlo_cost.analyze(hlo).flops
        matmul = sum(row["flops"] for name, row in cost.ops.items()
                     if name.split(".")[1] in MATMUL)
        assert abs(matmul / dots - 1.0) <= 0.01, (matmul, dots)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serve_step_flops_against_the_references(kind):
    jcfg, cfg = jget_config("minicpm-2b").reduced(), \
        get_config("minicpm-2b").reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg, "meta")
    jparams = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    if kind == "prefill":
        batch = _structs(jcfg, (B,), labels=False)
        hlo = jax.jit(jsteps.make_prefill_step(jmodel)).lower(
            jparams, batch).compile().as_text()
        _, cost = op_cost.count(steps.make_prefill_step(model),
                                model.init(0), _meta(batch))
    else:
        cache = jax.eval_shape(lambda: jmodel.init_cache(B, T))
        tok = jax.ShapeDtypeStruct((B, 1), jnp.int32)
        pos = jax.ShapeDtypeStruct((B,), jnp.int32)
        hlo = jax.jit(jsteps.make_serve_step(jmodel)).lower(
            jparams, cache, tok, pos).compile().as_text()
        _, cost = op_cost.count(
            steps.make_serve_step(model), model.init(0),
            model.init_cache(B, T),
            torch.zeros((B, 1), dtype=torch.int32, device="meta"),
            torch.zeros((B,), dtype=torch.int32, device="meta"))
    ratio = cost.flops / hlo_cost.analyze(hlo).flops
    assert SERVE_BAND[0] <= ratio <= SERVE_BAND[1], f"{kind}: {ratio:.4f}"
