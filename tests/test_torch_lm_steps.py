"""The port's LM steps (`repro_torch.launch.steps`) against the JAX
package's (`repro.launch.steps`), at ``reduced()`` in f32: the gossip train
step, the all-reduce train step, the prefill step (with and without head
padding, and the placement-only context managers) and the serve step.

Both sides start from one reference state, carried across with
`repro_torch.convert.train_state_from_jax`, and take the same numpy-seeded
batches. The reference's Laplace draws (one `jax.random` key per leaf, in
sorted-key leaf order, from the state's key split once a step) are
injected into the port through a mechanism that replays them; nothing
drawn is pinned.

Tolerances, as tests/test_torch_models.py holds the models: the state
(theta, its history ring, the parameters and AdamW moments), the loss and
every metric within 1e-5 absolute over 3 steps (measured: theta 2.4e-7,
grad_norm_mean 2.9e-6 at a norm of ~12, theta_sparsity 8.5e-8); prefill
logits within 1e-4 (the models' logit bound), the port's head-padded
logits within the same bound of its plain ones; the serve step's tokens
equal wherever the reference's top-2 logit gap exceeds 1e-4.
The gossip cases of the MoE and enc-dec families are in
tests/test_torch_lm_steps_families.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.privacy import sample_laplace as jsample_laplace  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.mesh import make_mesh as jmake_mesh  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch.api.mechanisms import LaplaceMechanism  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.core import tree  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import attention, build_model, moe  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ATOL = 1e-5                 # state, loss and metrics
LOGIT_ATOL = 1e-4           # prefill and decode logits
NODES, B, T, STEPS = 3, 2, 16, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors are small, and idle pool threads
    spinning between ops starve parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass(frozen=True, eq=False)
class ReplayLaplace(LaplaceMechanism):
    """The port's Laplace mechanism with the reference's unit draws."""

    draws: object = None      # iterator over float32 arrays

    def unit(self, generator, shape):
        u = next(self.draws)
        assert u.shape == tuple(shape)
        return torch.tensor(u)


def jax_flat(tree_) -> dict:
    """A reference pytree as numpy arrays keyed by path (bf16 as f32)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree_)[0]:
        key = "/".join(str(getattr(p, "name", getattr(
            p, "key", getattr(p, "idx", None)))) for p in path)
        out[key] = np.asarray(leaf.astype(jnp.float32)
                              if leaf.dtype == jnp.bfloat16 else leaf)
    return out


def lm_batch(cfg, lead: tuple, seed: int) -> dict:
    """Tokens, shifted labels (last -1) and, for enc-dec, frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, lead + (T,)).astype(np.int32)
    labels = np.concatenate(
        [toks[..., 1:], np.full(lead + (1,), -1, np.int32)], axis=-1)
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        out["frontend"] = rng.standard_normal(
            lead + (max(T // 4, 8), cfg.d_model)).astype(np.float32)
    return out


def reference_draws(key, theta, steps: int) -> list:
    """The reference update's unit Laplace draws, step by step: the state
    key split once a step, the sub-key split into one key per leaf."""
    shapes = [leaf.shape for leaf in jax.tree_util.tree_leaves(theta)]
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        for k, shape in zip(jax.random.split(sub, len(shapes)), shapes):
            draws.append(np.asarray(jsample_laplace(k, shape, 1.0)))
    return draws


def assert_close_trees(got: dict, want: dict, atol: float, what: str):
    assert set(got) == set(want), what
    for k in want:
        d = float(np.abs(np.asarray(got[k], np.float32) - want[k]).max())
        assert d <= atol, f"{what} {k} off by {d}"


def port_flat(tree_, prefix: str) -> dict:
    return {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.flatten_with_path(tree_, prefix)}


def gossip_case(arch: str, eps: float, microbatches: int, delay: int):
    """Both packages' gossip train step over STEPS steps from one state:
    the port's state, history and per-step metrics within ATOL."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg, device="cpu")
    recipe = dict(eps=eps, microbatches=microbatches, delay=delay)
    jgdp = jsteps.make_gossip_dp(NODES, jsteps.TrainRecipe(**recipe))
    jstate = jsteps.make_gossip_init(jmodel, jgdp, NODES)(0)
    draws = reference_draws(jstate.gossip.key, jstate.gossip.theta, STEPS)
    mech = ReplayLaplace(eps=eps, L=1.0, calibration="coordinate",
                         draws=iter(draws))
    gdp = steps.TrainRecipe(**recipe).to_runspec(NODES).replace(
        mechanism=mech).build_distributed()
    state = train_state_from_jax(cfg, jax_flat(jstate), device="cpu")
    assert state.gossip.t == 0 and (state.gossip.history is None) == \
        (delay == 0)
    jstep = jax.jit(jsteps.make_gossip_train_step(jmodel, jgdp,
                                                  microbatches))
    step = steps.make_gossip_train_step(model, gdp, microbatches)
    for s in range(STEPS):
        nb = lm_batch(cfg, (NODES, B), seed=s)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in nb.items()})
        assert sorted(met) == sorted(jmet)
        for k in jmet:
            d = abs(float(met[k]) - float(jmet[k]))
            assert d <= ATOL, f"step {s}: {k} off by {d}"
    assert state.gossip.t == int(jstate.gossip.t) == STEPS
    want = jax_flat(jstate)
    assert_close_trees(port_flat(state.gossip.theta, "gossip/theta"),
                       {k: v for k, v in want.items()
                        if k.startswith("gossip/theta/")}, ATOL, "theta")
    if delay:
        assert_close_trees(port_flat(state.gossip.history, "gossip/history"),
                           {k: v for k, v in want.items()
                            if k.startswith("gossip/history/")}, ATOL,
                           "history")
    if eps != float("inf"):
        assert next(mech.draws, None) is None    # every draw consumed


# (eps, microbatches, delay): every pair of levels of the three factors
GOSSIP_CASES = [(float("inf"), 1, 0), (1.0, 1, 2), (float("inf"), 2, 2),
                (1.0, 2, 0)]


@pytest.mark.parametrize("eps,microbatches,delay", GOSSIP_CASES)
def test_gossip_train_step_matches_the_reference_dense(eps, microbatches,
                                                       delay):
    gossip_case("minicpm-2b", eps, microbatches, delay)


def test_gossip_step_options_change_no_value():
    """The step's mesh options (``node_axis``, ``batchpar_attn``) place
    nothing, ``head_pad=16`` pads minicpm-2b reduced's 4 heads to 16
    (exact) and ``flash`` only reroutes blockwise attention's backward
    (not reached at T = 16): the port's state and metrics within ATOL of
    the plain step's over STEPS steps."""
    cfg = get_config("minicpm-2b").reduced()
    model = build_model(cfg, device="cpu")
    gdp = steps.make_gossip_dp(NODES, steps.TrainRecipe(eps=float("inf")))
    plain = steps.make_gossip_train_step(model, gdp)
    opts = steps.make_gossip_train_step(model, gdp, node_axis="data",
                                        batchpar_attn=True, head_pad=16,
                                        flash=True)
    a = b = steps.make_gossip_init(model, gdp, NODES)(0)
    for s in range(STEPS):
        nb = {k: torch.from_numpy(v)
              for k, v in lm_batch(cfg, (NODES, B), seed=s).items()}
        a, ma = plain(a, nb)
        with make_test_mesh(NODES, 1, device="cpu"):
            b, mb = opts(b, nb)
        for k in ma:
            assert abs(float(ma[k]) - float(mb[k])) <= ATOL, (s, k)
    assert_close_trees(port_flat(b.gossip.theta, "theta"),
                       port_flat(a.gossip.theta, "theta"), ATOL, "theta")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_allreduce_train_step_matches_the_reference(microbatches):
    """qwen2-7b reduced, three AdamW steps (warmup-cosine lr): the
    parameters, both moments, the step count and the metrics."""
    jcfg, cfg = jget_config("qwen2-7b").reduced(), \
        get_config("qwen2-7b").reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg, device="cpu")
    jstep, jinit = jsteps.make_allreduce_train_step(
        jmodel, jsteps.TrainRecipe(strategy="allreduce",
                                   microbatches=microbatches))
    step, _ = steps.make_allreduce_train_step(
        model, steps.TrainRecipe(strategy="allreduce",
                                 microbatches=microbatches))
    jstate = jinit(0)
    state = train_state_from_jax(cfg, jax_flat(jstate), device="cpu")
    assert isinstance(state, steps.AllreduceTrainState)
    jstep = jax.jit(jstep)
    for s in range(STEPS):
        nb = lm_batch(cfg, (2 * B,), seed=10 + s)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v)
                                      for k, v in nb.items()})
        state, met = step(state, {k: torch.from_numpy(v)
                                  for k, v in nb.items()})
        assert sorted(met) == sorted(jmet) == ["aux", "ce", "loss"]
        for k in jmet:
            assert abs(float(met[k]) - float(jmet[k])) <= ATOL, (s, k)
    want = jax_flat(jstate)
    got = {**port_flat(state.params, "params"),
           **port_flat(state.opt["m"], "opt/m"),
           **port_flat(state.opt["v"], "opt/v")}
    assert_close_trees(got, {k: v for k, v in want.items()
                             if k != "opt/step"}, ATOL, "allreduce")
    assert int(state.opt["step"]) == int(want["opt/step"]) == STEPS


# -- prefill ------------------------------------------------------------------

def _prefill_pair(kv_heads: int | None):
    """qwen2-7b reduced (4 heads over 4 kv: MHA), or over ``kv_heads``
    groups (GQA): both models on the reference's weights."""
    jcfg, cfg = jget_config("qwen2-7b").reduced(), \
        get_config("qwen2-7b").reduced()
    if kv_heads is not None:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv_heads)
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    jmodel, model = jbuild_model(jcfg), build_model(cfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = model_params_from_jax(cfg, jax_flat(jparams), device="cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa"])
def test_prefill_step_matches_the_reference_with_head_padding(kv_heads):
    """`make_prefill_step`'s argmax and the logits under it, without and
    with ``head_pad=16`` (4 heads padded to 16: all of q, k, v for MHA,
    zero query heads per kv group for GQA), against the reference's under
    a 1 x 1 ("data", "model") mesh (its head padding constrains placement,
    which needs one)."""
    jmodel, jparams, model, params = _prefill_pair(kv_heads)
    nb = lm_batch(model.cfg, (B,), seed=5)
    jtok, tok = jnp.asarray(nb["tokens"]), torch.from_numpy(nb["tokens"])
    with jmake_mesh((1, 1), ("data", "model")):
        jplain = jmodel.apply(jparams, jtok)[0]
        with jattention.head_padding(16, "model"):
            jpad = jmodel.apply(jparams, jtok)[0]
        jarg = jax.jit(jsteps.make_prefill_step(jmodel, head_pad=16))(
            jparams, {"tokens": jtok})
    with torch.no_grad():
        plain = model.apply(params, tok)[0]
        with attention.head_padding(16, "model"):
            padded = model.apply(params, tok)[0]
    for got, want in ((plain, jplain), (padded, jpad), (padded, plain)):
        d = float(np.abs(got.numpy() - np.asarray(want)).max())
        assert d <= LOGIT_ATOL, d
    arg = steps.make_prefill_step(model, head_pad=16)(params,
                                                      {"tokens": tok})
    np.testing.assert_array_equal(arg.numpy(), np.asarray(jarg))
    np.testing.assert_array_equal(
        steps.make_prefill_step(model)(params, {"tokens": tok}).numpy(),
        np.asarray(jnp.argmax(jplain[:, -1], axis=-1)))


def test_placement_context_managers_change_no_value(monkeypatch):
    """sequence_parallel (on the blockwise path), batch_parallel,
    sp_residual and grouped_dispatch's axis change the port's logits by
    no bit; each axis is checked against an active mesh."""
    monkeypatch.setattr(attention, "BLOCKWISE_THRESHOLD", 8)
    _, _, model, params = _prefill_pair(2)
    tok = torch.from_numpy(lm_batch(model.cfg, (B,), seed=6)["tokens"])
    with torch.no_grad():
        plain = model.apply(params, tok)[0]
        with attention.sequence_parallel("model"), \
                attention.batch_parallel("model"), \
                transformer.sp_residual("model"):
            placed = model.apply(params, tok)[0]
        with make_test_mesh(2, 2, device="cpu"):
            meshed = steps.make_prefill_step(
                model, seqpar_axis="model", sp_axis="model")(
                    params, {"tokens": tok})
            with pytest.raises(ValueError, match="not an axis"):
                with attention.sequence_parallel("seq"):
                    model.apply(params, tok)
    assert torch.equal(plain, placed)
    np.testing.assert_array_equal(meshed.numpy(),
                                  plain[:, -1].argmax(-1).numpy())
    mcfg = get_config("mixtral-8x7b").reduced()
    mix = build_model(mcfg, device="cpu")
    mparams = mix.init(0)
    mtok = torch.from_numpy(lm_batch(mcfg, (B,), seed=7)["tokens"])
    with torch.no_grad():
        with moe.grouped_dispatch(2):
            grouped = mix.apply(mparams, mtok)[0]
        with make_test_mesh(2, 2, device="cpu"), \
                moe.grouped_dispatch(2, "data"):
            on_axis = mix.apply(mparams, mtok)[0]
    assert torch.equal(grouped, on_axis)


# -- serve --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-3b"])
def test_serve_step_matches_the_reference(arch):
    """8 decode steps of `make_serve_step` on the reference's weights and
    the same prompt tokens: the port's greedy token equals the
    reference's at every step whose top-2 logit gap exceeds LOGIT_ATOL."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jmodel, model = jbuild_model(jcfg), build_model(cfg, device="cpu")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = model_params_from_jax(cfg, jax_flat(jparams), device="cpu")
    tokens = lm_batch(cfg, (B,), seed=8)["tokens"][:, :8]
    jstep = jax.jit(jmodel.decode_step)
    serve = steps.make_serve_step(model)
    jcache, cache = jmodel.init_cache(B, 16), model.init_cache(B, 16)
    compared = 0
    for i in range(8):
        jlogits, jcache = jstep(jparams, jcache,
                                jnp.asarray(tokens[:, i:i + 1]),
                                jnp.full((B,), i, jnp.int32))
        nxt, cache = serve(params, cache,
                           torch.from_numpy(tokens[:, i:i + 1]),
                           torch.full((B,), i, dtype=torch.int32))
        assert nxt.dtype == torch.int32 and nxt.shape == (B,)
        top2 = np.sort(np.asarray(jlogits[:, -1]), axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > LOGIT_ATOL
        want = np.asarray(jnp.argmax(jlogits[:, -1], axis=-1))
        np.testing.assert_array_equal(nxt.numpy()[clear], want[clear])
        compared += int(clear.sum())
    assert compared >= B * 8 - 2
