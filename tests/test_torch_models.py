"""The port's LM stack (`repro_torch.models`, `repro_torch.configs`)
against the reference's (`repro.models`, `repro.configs`): every assigned
architecture at its ``reduced()`` config, both packages on the same
weights (the reference's ``model.init``, carried across by
`repro_torch.convert.model_params_from_jax`) and the same numpy-seeded
batch (B = 2, T = 16).

Tolerances (f32, the reduced widths; XLA:CPU's and ATen's matmuls add in
other orders): logits within 1e-4 absolute; the loss and its CE within
1e-5; the router's aux loss within 1e-6; each gradient leaf within 1e-4
absolute plus 1e-3 relative; the port's decode logits within 1e-4 of the
reference's decode and within 1e-4 of its own apply (tests/test_models.py
holds the reference to 5e-3; the port's pair measured 3.5e-6 at most). recurrentgemma's RG-LRU is a sequential loop in the port and
``jax.lax.associative_scan``'s tree order in the reference: the same
bounds hold it, not bit for bit. One bf16 config (qwen2-7b reduced, bf16
weights and activations) is held to 8 * 2^-8 (bf16's rounding unit) of
the largest |logit|, and the same top-1 token at 90 % of positions or
more: XLA:CPU may keep a bf16 product in f32 where ATen rounds it, and
the two round apart through every layer (measured: 0.039 at a largest
|logit| of 3.73, 2.68 * 2^-8 of it; top-1 equal at every position).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

from repro_torch import optim  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import model_params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.core.tree import flatten_with_path, tree_map  # noqa: E402
from repro_torch.core.tree import leaves as tree_leaves  # noqa: E402

B, T = 2, 16
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-4, 1e-3
DECODE_SELF_TOL = 1e-4      # tests/test_models.py:67-68 holds 5e-3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tensors here are small, and idle pool
    threads spinning between ops starve parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_flat(tree) -> dict:
    """A reference pytree as numpy arrays keyed by path (bf16 as f32)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                       for p in path)
        out[key] = np.asarray(leaf.astype(jnp.float32)
                              if leaf.dtype == jnp.bfloat16 else leaf)
    return out


def make_batch(cfg, seed=7) -> dict:
    """tests/test_models.py's batch, drawn with numpy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        batch["frontend"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        batch["labels"][:, :cfg.frontend_tokens] = -1
    elif cfg.family == "encdec":
        batch["frontend"] = rng.standard_normal(
            (B, max(T // 4, 8), cfg.d_model)).astype(np.float32)
    return batch


def _decode(model, params, batch, lib):
    """Token-by-token decode logits (B, T, V) over the batch's tokens."""
    cache = model.init_cache(B, cache_len=T)
    if lib == "jax":
        tokens, full = jnp.asarray(batch["tokens"]), jnp.full
        as_front = jnp.asarray
    else:
        tokens = torch.from_numpy(batch["tokens"])
        full = lambda shape, v, dt: torch.full(shape, v, dtype=torch.int32)  # noqa: E731
        as_front = torch.from_numpy
    if model.prime_cache is not None:
        cache = model.prime_cache(params, cache, as_front(batch["frontend"]))
    step = jax.jit(model.decode_step) if lib == "jax" else model.decode_step
    outs = []
    for i in range(T):
        logits, cache = step(params, cache, tokens[:, i:i + 1],
                             full((B,), i, jnp.int32))
        outs.append(np.asarray(logits) if lib == "jax"
                    else logits.detach().numpy())
    return np.concatenate(outs, axis=1)


class Pair:
    """One architecture in both packages, with the reference's outputs."""

    def __init__(self, arch: str, dtype: str = "float32"):
        self.jcfg = dataclasses.replace(jget_config(arch).reduced(),
                                        dtype=dtype)
        self.cfg = dataclasses.replace(get_config(arch).reduced(),
                                       dtype=dtype)
        self.jmodel, self.model = jbuild_model(self.jcfg), \
            build_model(self.cfg, device="cpu")
        self.jparams = self.jmodel.init(jax.random.PRNGKey(0))
        self.params = model_params_from_jax(self.cfg, jax_flat(self.jparams),
                                            device="cpu")
        self.batch = make_batch(self.cfg)
        self.jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        self.tbatch = {k: torch.from_numpy(v) for k, v in self.batch.items()}
        self._cache: dict = {}

    def _memo(self, name, fn):
        if name not in self._cache:
            self._cache[name] = fn()
        return self._cache[name]

    def ref_apply(self):
        return self._memo("apply", lambda: self.jmodel.apply(
            self.jparams, self.jbatch["tokens"], self.jbatch.get("frontend")))

    def ref_loss_and_grads(self):
        return self._memo("grad", lambda: jax.value_and_grad(
            self.jmodel.loss_fn, has_aux=True)(self.jparams, self.jbatch))

    def ref_decode(self):
        return self._memo("decode", lambda: _decode(
            self.jmodel, self.jparams, self.batch, "jax"))

    def apply(self, **kw):
        with torch.no_grad():
            return self.model.apply(self.params, self.tbatch["tokens"],
                                    self.tbatch.get("frontend"), **kw)


@pytest.fixture(scope="module")
def pairs():
    made: dict = {}

    def get(arch, dtype="float32"):
        if (arch, dtype) not in made:
            made[arch, dtype] = Pair(arch, dtype)
        return made[arch, dtype]
    return get


def test_the_port_lists_the_reference_s_architectures():
    assert ARCH_IDS == JARCH_IDS


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_has_the_reference_s_paths_shapes_and_dtypes(arch):
    """The port's own seeded init: every leaf at the reference's pytree
    path, shape and dtype, finite."""
    cfg = get_config(arch).reduced()
    jshapes = jax.eval_shape(jbuild_model(jget_config(arch).reduced()).init,
                             jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jax_flat_shapes(jshapes).items()}
    params = build_model(cfg, device="cpu").init(0)
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in flatten_with_path(params)}
    assert got == want
    assert all(bool(torch.isfinite(v).all()) for v in tree_leaves(params))
    again = build_model(cfg, device="cpu").init(0)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


def jax_flat_shapes(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", None)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_apply_matches_the_reference(pairs, arch):
    pair = pairs(arch)
    logits, aux = pair.apply()
    jlogits, jaux = pair.ref_apply()
    assert tuple(logits.shape) == (B, T, pair.cfg.vocab_padded)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    # one row through the unembedding: ATen picks another blocking than
    # for 16 rows, so the last row is held within 1e-5, not bit for bit
    last, _ = pair.apply(last_only=True)
    assert tuple(last.shape) == (B, 1, pair.cfg.vocab_padded)
    np.testing.assert_allclose(last.numpy(), logits[:, -1:].numpy(), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_the_reference(pairs, arch):
    pair = pairs(arch)
    params = tree_map(lambda t: t.clone().requires_grad_(True), pair.params)
    loss, metrics = pair.model.loss_fn(params, pair.tbatch)
    grads = torch.autograd.grad(loss, tree_leaves(params), allow_unused=True)
    (jloss, jmetrics), jgrads = pair.ref_loss_and_grads()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=0,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(float(metrics["ce"].detach()), float(jmetrics["ce"]),
                               rtol=0, atol=LOSS_ATOL)
    assert 0 < float(loss) < 50
    jg = jax_flat(jgrads)
    for (path, _), g in zip(flatten_with_path(params), grads):
        want = jg[path]
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decode_matches_the_reference_decode_and_its_own_apply(pairs, arch):
    """Token-by-token decode: each step's logits the reference's decode
    step's, and the whole the port's own full-sequence apply (text only,
    as tests/test_models.py compares; enc-dec with its frames)."""
    pair = pairs(arch)
    with torch.no_grad():
        got = _decode(pair.model, pair.params, pair.batch, "torch")
        front = pair.tbatch.get("frontend") \
            if pair.cfg.family == "encdec" else None
        full, _ = pair.model.apply(pair.params, pair.tbatch["tokens"], front)
    np.testing.assert_allclose(got, pair.ref_decode(), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(got, full.numpy(), rtol=DECODE_SELF_TOL,
                               atol=DECODE_SELF_TOL)


def test_bf16_config_within_the_bf16_bound(pairs):
    """qwen2-7b reduced in bf16 (the full configs' dtype): the port's
    logits within 8 * 2^-8 of the largest |logit| of the reference's."""
    pair = pairs("qwen2-7b", "bfloat16")
    assert pair.params["layers"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    logits, _ = pair.apply()
    want = np.asarray(pair.ref_apply()[0])
    bound = 8 * 2 ** -8 * float(np.abs(want).max())
    diff = float(np.abs(logits.numpy() - want).max())
    assert diff <= bound, (diff, bound)
    assert (logits.numpy().argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_remat_changes_no_value(pairs):
    """cfg.remat recomputes each layer in the backward pass
    (torch.utils.checkpoint): gradients bit for bit those without it."""
    pair = pairs("mixtral-8x7b")
    out = []
    for remat in (True, False):
        model = build_model(dataclasses.replace(pair.cfg, remat=remat),
                            device="cpu")
        params = tree_map(lambda t: t.clone().requires_grad_(True),
                          pair.params)
        loss, _ = model.loss_fn(params, pair.tbatch)
        out.append(torch.autograd.grad(loss, tree_leaves(params)))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["minicpm-2b", "rwkv6-3b", "mixtral-8x7b"])
def test_train_loss_decreases(pairs, arch):
    """A few AdamW steps of `repro_torch.optim` on a fixed batch reduce
    the loss (tests/test_models.py's, with the port's optimizer)."""
    pair = pairs(arch)
    opt = optim.adamw(optim.constant(1e-2))
    params = tree_map(lambda t: t.clone(), pair.params)
    state = opt.init(params)

    def loss_and_grads(params):
        leaves = tree_map(lambda t: t.requires_grad_(True), params)
        loss, _ = pair.model.loss_fn(leaves, pair.tbatch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
        it = iter(grads)
        return float(loss), tree_map(lambda _: next(it), leaves)

    l0, _ = loss_and_grads(params)
    for _ in range(5):
        _, g = loss_and_grads(params)
        params = tree_map(lambda t: t.detach(), params)
        upd, state = opt.update(g, state, params)
        params = optim.apply_updates(params, upd)
    l1, _ = loss_and_grads(params)
    assert l1 < l0, (l0, l1)
