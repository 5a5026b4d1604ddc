"""The port's attention (`repro_torch.models.attention`) against the
reference's (`repro.models.attention`): the ten cases of
tests/test_attention.py, each run through both packages on the same
weights (the reference's `attn_init`, carried across) and the same inputs,
plus the flash backward.

Tolerances (f32): a port output within 2e-5 absolute plus 1e-5 relative
of the reference's (the two libraries' matmuls add in other orders; the
inputs set to 99 in test_causality give outputs near 20, 2.4e-6 apart
relatively),
and the port's own identities (blockwise == full, GQA == repeated MHA,
decode == full) within tests/test_attention.py's bounds. The flash
backward's gradients within 2e-5 of the reference's ``_flash_bwd`` (via
``jax.vjp`` of its custom VJP) and within 2e-5 of torch autograd through
the port's own blockwise forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as jatt  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402

from repro_torch.models import attention  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ATOL, RTOL = 2e-5, 1e-5     # port vs reference, f32


def _cfgs(**kw):
    base = dict(name="t", family="dense", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(p):
    return {k: _tree(v) if isinstance(v, dict) else _t(v)
            for k, v in p.items()}


def _qkv(jcfg, B=2, T=64, seed=0):
    """The reference's weights and input (tests/test_attention.py's), and
    the same as torch tensors."""
    key = jax.random.PRNGKey(seed)
    p = jatt.attn_init(key, jcfg)
    x = jax.random.normal(jax.random.fold_in(key, 1), (B, T, jcfg.d_model))
    return p, x, _tree(p), _t(x)


def _close(got, want, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=atol)


def _projected(jcfg, cfg, T, seed=0):
    jp, jx, p, x = _qkv(jcfg, T=T, seed=seed)
    jq = jatt._project_qkv(jp, jcfg, jx, jatt.default_positions(2, T, jcfg))
    q = attention._project_qkv(p, cfg, x, attention.default_positions(2, T, cfg))
    for a, b in zip(q, jq):
        _close(a, b)
    return jq, tuple(_t(a) for a in jq)   # both packages on the same q, k, v


@pytest.mark.parametrize("T,window,qc,kc", [(256, None, 64, 32),
                                            (256, 64, 32, 64),
                                            (100, None, 32, 32)],
                         ids=["blockwise_equals_full",
                              "blockwise_equals_full_with_window",
                              "blockwise_nondivisible_lengths"])
def test_blockwise_matches_the_reference(T, window, qc, kc):
    jcfg, cfg = _cfgs()
    (jq, jk, jv), (q, k, v) = _projected(jcfg, cfg, T)
    pos, jpos = torch.arange(T), jnp.arange(T)
    want_full = jatt._full_attention(jq, jk, jv, jpos, jpos, window, None)
    want_block = jatt._blockwise_attention(jq, jk, jv, window, None,
                                           q_chunk=qc, k_chunk=kc)
    full = attention._full_attention(q, k, v, pos, pos, window, None)
    block = attention._blockwise_attention(q, k, v, window, None,
                                           q_chunk=qc, k_chunk=kc)
    _close(full, want_full)
    _close(block, want_block)
    np.testing.assert_allclose(full.numpy(), block.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_gqa_equals_repeated_kv_mha():
    jcfg, cfg = _cfgs(num_heads=4, num_kv_heads=2)
    (jq, jk, jv), (q, k, v) = _projected(jcfg, cfg, 64)
    pos = torch.arange(64)
    o = attention._full_attention(q, k, v, pos, pos, None, None)
    o_rep = attention._full_attention(q, k.repeat_interleave(2, dim=2),
                                      v.repeat_interleave(2, dim=2), pos,
                                      pos, None, None)
    np.testing.assert_allclose(o.numpy(), o_rep.numpy(), rtol=2e-4,
                               atol=1e-5)
    _close(o, jatt._full_attention(jq, jk, jv, jnp.arange(64),
                                   jnp.arange(64), None, None))


def test_causality():
    """Changing future tokens must not change past outputs."""
    jcfg, cfg = _cfgs()
    jp, jx, p, x = _qkv(jcfg, T=32)
    y1 = attention.attention_full(p, cfg, x)
    x2 = x.clone()
    x2[:, 20:] = 99.0
    y2 = attention.attention_full(p, cfg, x2)
    np.testing.assert_allclose(y1[:, :20].numpy(), y2[:, :20].numpy(),
                               rtol=1e-4, atol=1e-5)
    _close(y1, jatt.attention_full(jp, jcfg, jx))
    _close(y2, jatt.attention_full(jp, jcfg, jx.at[:, 20:].set(99.0)))


def test_sliding_window_limits_receptive_field():
    jcfg, cfg = _cfgs(sliding_window=8)
    jp, jx, p, x = _qkv(jcfg, T=32)
    y1 = attention.attention_full(p, cfg, x)
    x2 = x.clone()
    x2[:, :16] = -7.0
    y2 = attention.attention_full(p, cfg, x2)
    np.testing.assert_allclose(y1[:, -1].numpy(), y2[:, -1].numpy(),
                               rtol=1e-4, atol=1e-5)
    _close(y1, jatt.attention_full(jp, jcfg, jx))
    _close(y2, jatt.attention_full(jp, jcfg, jx.at[:, :16].set(-7.0)))


def test_mrope_text_equals_standard_rope():
    """With equal (t, h, w) positions, M-RoPE == standard RoPE."""
    jstd, std = _cfgs(rope_style="standard")
    jmr, mr = _cfgs(rope_style="mrope", mrope_sections=(2, 3, 3))
    jx = jax.random.normal(jax.random.PRNGKey(0), (2, 16, 4, 16))
    x = _t(jx)
    a = attention.apply_rope(x, attention.default_positions(2, 16, std), std)
    b = attention.apply_rope(x, attention.default_positions(2, 16, mr), mr)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    _close(a, jatt.apply_rope(jx, jatt.default_positions(2, 16, jstd), jstd),
           atol=1e-6)
    _close(b, jatt.apply_rope(jx, jatt.default_positions(2, 16, jmr), jmr),
           atol=1e-6)


def test_mrope_diverges_for_spatial_positions():
    jmr, mr = _cfgs(rope_style="mrope", mrope_sections=(2, 3, 3))
    jx = jax.random.normal(jax.random.PRNGKey(0), (1, 8, 4, 16))
    x = _t(jx)
    pos_text = attention.default_positions(1, 8, mr)
    pos_img = pos_text.clone()
    pos_img[..., 1] += 5                      # h channel differs
    a = attention.apply_rope(x, pos_text, mr)
    b = attention.apply_rope(x, pos_img, mr)
    assert not np.allclose(a.numpy(), b.numpy())
    jpos = jatt.default_positions(1, 8, jmr)
    jpos_img = jpos.at[..., 1].set(jpos[..., 1] + 5)
    _close(b, jatt.apply_rope(jx, jpos_img, jmr), atol=1e-6)


@pytest.mark.parametrize("window", [None, 8])
def test_decode_matches_full_apply(window):
    """Ring-buffer decode, token by token, == full-sequence attention, and
    each step == the reference's decode step."""
    jcfg, cfg = _cfgs(sliding_window=window)
    T = 24
    jp, jx, p, x = _qkv(jcfg, T=T)
    y_full = attention.attention_full(p, cfg, x)
    C = T if window is None else window
    cache = attention.init_attn_cache(cfg, 2, cache_len=C,
                                      dtype=torch.float32)
    jcache = jatt.init_attn_cache(jcfg, 2, cache_len=C, dtype=jnp.float32)
    outs = []
    for i in range(T):
        y1, cache = attention.attention_decode(
            p, cfg, x[:, i:i + 1], torch.full((2,), i, dtype=torch.int32),
            cache)
        jy1, jcache = jatt.attention_decode(
            jp, jcfg, jx[:, i:i + 1], jnp.full((2,), i, jnp.int32), jcache)
        _close(y1, jy1)
        np.testing.assert_array_equal(cache["slot_pos"].numpy(),
                                      np.asarray(jcache["slot_pos"]))
        outs.append(y1)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=3e-4, atol=3e-5)


@pytest.mark.parametrize("window,T,qc,kc", [(None, 100, 32, 32),
                                            (16, 96, 32, 16)])
def test_flash_backward_gradients(window, T, qc, kc):
    """`_FlashAttention`'s gradients equal the reference's `_flash_bwd`
    (jax.vjp of its custom VJP) and torch autograd through the port's own
    blockwise forward; its output the blockwise output."""
    jcfg, cfg = _cfgs()
    (jq, jk, jv), (q, k, v) = _projected(jcfg, cfg, T)
    rng = np.random.default_rng(0)
    do = rng.standard_normal(q.shape).astype(np.float32)
    jo, vjp = jax.vjp(lambda a, b, c: jatt._flash_attention_jax(
        a, b, c, window, None, qc, kc), jq, jk, jv)
    want = vjp(jnp.asarray(do))

    def grads(fn):
        qs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*qs, window, None, qc, kc)
        o.backward(torch.from_numpy(do))
        return o.detach(), [t.grad for t in qs]

    o_flash, g_flash = grads(attention._flash_attention)
    o_block, g_block = grads(attention._blockwise_attention)
    np.testing.assert_array_equal(o_flash.numpy(), o_block.numpy())
    _close(o_flash, jo)
    for name, a, b, c in zip("qkv", g_flash, g_block, want):
        _close(a, c)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5,
                                   err_msg=f"d{name}: flash vs autograd")


def test_flash_vjp_routes_long_sequences_through_the_flash_backward(
        monkeypatch):
    """Above BLOCKWISE_THRESHOLD `attention_full` takes the blockwise path,
    and under ``flash_vjp()`` the flash function; both give one output."""
    jcfg, cfg = _cfgs()
    monkeypatch.setattr(attention, "BLOCKWISE_THRESHOLD", 32)
    monkeypatch.setattr(attention, "Q_CHUNK", 16)
    monkeypatch.setattr(attention, "K_CHUNK", 32)
    _, _, p, x = _qkv(jcfg, T=48)
    calls = []
    real = attention._FlashAttention.apply
    monkeypatch.setattr(attention._FlashAttention, "apply",
                        lambda *a: calls.append(1) or real(*a))
    plain = attention.attention_full(p, cfg, x)
    assert not calls
    with attention.flash_vjp():
        flash = attention.attention_full(p, cfg, x)
    assert calls and attention._FLASH_VJP == [False]
    np.testing.assert_array_equal(plain.numpy(), flash.numpy())
