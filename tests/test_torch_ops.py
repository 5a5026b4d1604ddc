"""The port's pytree kernel ops against `repro.kernels.ops`.

`repro_torch.kernels.ops` carries the (rows, 128) tile plumbing of a
parameter pytree and the two seed kernels, ``pdomd_update`` and
``hinge_grad``, each a hand-written CUDA kernel with a plain PyTorch
version beside it. The CUDA kernels run only on a card (``chip_smoke.py``
holds them against their plain versions there); here, on the CPU, each
wrapper computes its plain version, and that is held against the Pallas
kernel in interpret mode (as tests/test_kernels.py runs it) on the same
numpy inputs, at that file's shapes and tolerances: 1e-5 (pdomd_update) and
1e-4 (hinge_grad) in float32, 2e-2 and 3e-2 in bfloat16.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch import RunSpec  # noqa: E402
from repro_torch.core.algorithm1 import hinge_loss_and_grad  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    np_t, torch_t, jax_t = DTYPES[dtype]
    a = np.asarray(a, np.float32).astype(np_t)       # round once, in numpy
    return (jnp.asarray(a, jax_t),
            torch.tensor(a.astype(np.float32)).to(torch_t))


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# -- tile plumbing -----------------------------------------------------------

def test_tree_to_tiles_and_back_match_the_reference_on_unsorted_keys():
    rng = np.random.default_rng(0)
    # keys inserted out of order: JAX flattens them sorted, and so must
    # the port, whatever the insertion order
    arrays = {"z": rng.standard_normal((20, 15)),
              "b": {"y": rng.standard_normal((7,)),
                    "c": rng.standard_normal((3, 2))},
              "a": rng.standard_normal((5, 4))}
    kinds = {"z": "bfloat16", "y": "float32", "c": "bfloat16",
             "a": "float32"}
    jtree, ttree = {}, {}
    for key, val in arrays.items():
        if isinstance(val, dict):
            jtree[key], ttree[key] = {}, {}
            for k2, v2 in val.items():
                jtree[key][k2], ttree[key][k2] = _pair(v2, kinds[k2])
        else:
            jtree[key], ttree[key] = _pair(val, kinds[key])
    assert ops.flat_size(ttree) == jops.flat_size(jtree) == 300 + 7 + 6 + 20
    assert ops.padded_rows(333) == jops.padded_rows(333) == 8
    want = np.asarray(jops.tree_to_tiles(jtree))
    tiles = ops.tree_to_tiles(ttree)
    assert tiles.dtype == torch.float32
    np.testing.assert_array_equal(tiles.numpy(), want)

    back = ops.tiles_to_tree(tiles * 3, ttree)
    jback = jops.tiles_to_tree(jnp.asarray(want) * 3, jtree)
    for path in (("z",), ("b", "y"), ("b", "c"), ("a",)):
        got, ref_leaf, like = back, jback, ttree
        for p in path:
            got, ref_leaf, like = got[p], ref_leaf[p], like[p]
        assert got.dtype == like.dtype and got.shape == like.shape
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(ref_leaf, np.float32))


def test_single_leaf_tiles_are_the_leaf_zero_padded():
    leaf = torch.arange(640.0).reshape(64, 10)
    tiles = ops.tree_to_tiles({"w": leaf})
    assert tuple(tiles.shape) == (8, 128)
    assert torch.equal(tiles.reshape(-1)[:640], leaf.reshape(-1))
    assert not tiles.reshape(-1)[640:].any()


# -- pdomd_update ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [8, 16, 64, 512, 1024])
def test_pdomd_update_matches_pallas(rows, dtype):
    rng = np.random.default_rng(rows)
    pairs = [_pair(rng.standard_normal((rows, 128)), dtype)
             for _ in range(4)]
    alpha, lam = 0.05, 0.02
    w_j, th_j = jops.pdomd_update(*(p[0] for p in pairs), jnp.float32(alpha),
                                  jnp.float32(lam), interpret=True)
    w, th = ops.pdomd_update(*(p[1] for p in pairs), alpha, lam)
    assert w.dtype == th.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else 2e-2
    _close(w, w_j, tol)
    _close(th, th_j, tol)
    # the plain version is the reference's oracle, op for op
    w_r, th_r = jref.pdomd_update_ref(*(p[0] for p in pairs),
                                      jnp.float32(alpha), jnp.float32(lam),
                                      jnp.float32(0.5), jnp.float32(0.25))
    _close(w, w_r, tol)
    _close(th, th_r, tol)


def test_pdomd_update_sign_of_zero_is_zero():
    z = torch.zeros((8, 128))
    w, th = ref.pdomd_update_ref(z, z, z, z, 0.3, 0.0)
    assert not w.any() and not th.any()


@pytest.mark.parametrize("rows8,lam", [
    (1, 0.0), (1, 2.0), (2, 0.5), (4, 0.1), (8, 1.0), (13, 0.01),
    (16, 1.5), (25, 0.8), (32, 0.3), (40, 2.0),
])
def test_pdomd_update_property_sparsity_monotone(rows8, lam):
    rng = np.random.default_rng(7)
    args = [torch.tensor(rng.standard_normal((rows8 * 8, 128)),
                         dtype=torch.float32) for _ in range(4)]
    w1, _ = ops.pdomd_update(*args, 0.0, lam)
    w2, _ = ops.pdomd_update(*args, 0.0, lam + 0.5)
    assert float((w2 == 0).float().mean()) >= float((w1 == 0).float().mean())


def test_pdomd_update_on_tiles_does_the_engines_ring_round():
    """One ring round through the pytree ops: the tiles of theta~, of its
    two ring neighbours and of the clipped gradient give the distributed
    engine's next state and its primal (the on-card check of
    chip_smoke.py's ops phase, at a small size)."""
    m, n = 6, 40
    spec = RunSpec(nodes=m, dim=n, eps=1.0, alpha0=0.5, lam=0.05,
                   calibration="coordinate")
    gdp = spec.build_distributed()
    rng = np.random.default_rng(3)
    state = gdp.init({"w": torch.tensor(rng.standard_normal((m, n)),
                                        dtype=torch.float32)}, 5,
                     device="cpu")
    x = torch.tensor(rng.standard_normal((m, n)), dtype=torch.float32)
    y = torch.tensor(np.sign(rng.standard_normal(m)), dtype=torch.float32)

    _, grad = hinge_loss_and_grad(gdp.primal(state)["w"], x, y)
    g, _ = gdp.clipper.clip({"w": grad})
    ctx = gdp.omd.step_context(state.t + 1)
    gen = torch.Generator()
    gen.set_state(state.generator.get_state())
    tilde = state.theta["w"] + gdp.mechanism.sample(
        gen, (m, n), gdp.mechanism.scale(ctx.alpha_t, n))
    nxt, _ = gdp.update(state, {"w": grad})

    like = {"w": tilde}
    w_t, th_t = ops.pdomd_update(
        ops.tree_to_tiles(like),
        ops.tree_to_tiles({"w": torch.roll(tilde, 1, dims=0)}),
        ops.tree_to_tiles({"w": torch.roll(tilde, -1, dims=0)}),
        ops.tree_to_tiles(g), ctx.alpha_t,
        gdp.omd.step_context(state.t + 2).lam_t)
    theta_new = ops.tiles_to_tree(th_t, like)["w"]
    w_new = ops.tiles_to_tree(w_t, like)["w"]
    assert float((theta_new - nxt.theta["w"]).abs().max()) <= 5e-6
    assert float((w_new - gdp.primal(nxt)["w"]).abs().max()) <= 5e-6


# -- hinge_grad --------------------------------------------------------------

# every earlier (B, n) in both dtypes; then the small batches the card's
# slab path takes: one row (the ops round's per-node launch, at the paper's
# padded width too) and one ring round's 64 rows at that width
@pytest.mark.parametrize("B,n,dtype", [
    *((B, n, dtype) for B, n in ((8, 128), (32, 256), (128, 1024), (100, 384))
      for dtype in ("float32", "bfloat16")),
    (1, 128, "float32"), (1, 128, "bfloat16"),
    (1, 10_112, "float32"), (1, 10_112, "bfloat16"),
    (64, 10_112, "float32")])
def test_hinge_grad_matches_pallas(B, n, dtype):
    rng = np.random.default_rng(B + n)
    xj, xt = _pair(rng.standard_normal((B, n)) / np.sqrt(n), dtype)
    yj, yt = _pair(np.sign(rng.standard_normal(B)), dtype)
    wj, wt = _pair(rng.standard_normal(n), dtype)
    loss_j, g_j, margin_j = jops.hinge_grad(xj, yj, wj, interpret=True)
    loss, g, margin = ops.hinge_grad(xt, yt, wt)
    assert loss.dtype == g.dtype == margin.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 3e-2
    _close(loss, loss_j, tol)
    _close(g, g_j, tol)
    _close(margin, margin_j, tol)
    loss_r, g_r, _ = jref.hinge_grad_ref(xj, yj, wj)
    _close(loss, loss_r, tol)
    _close(g, g_r, tol)


def test_hinge_grad_matches_torch_autograd():
    rng = np.random.default_rng(0)
    B, n = 64, 256
    x = torch.tensor(rng.standard_normal((B, n)) / np.sqrt(n),
                     dtype=torch.float32)
    y = torch.tensor(np.sign(rng.standard_normal(B)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal(n), dtype=torch.float32,
                     requires_grad=True)
    torch.mean(torch.clamp_min(1 - y * (x @ w), 0.0)).backward()
    _, g, _ = ops.hinge_grad(x, y, w.detach())
    np.testing.assert_allclose(g.numpy(), w.grad.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("B", [50, 1])
def test_hinge_grad_padded_columns_get_exactly_zero(B):
    rng = np.random.default_rng(1)
    x = np.zeros((B, 256), np.float32)
    x[:, :200] = rng.standard_normal((B, 200))
    _, g, _ = ops.hinge_grad(torch.tensor(x),
                             torch.tensor(np.sign(rng.standard_normal(B)),
                                          dtype=torch.float32),
                             torch.zeros(256))
    assert g[:200].abs().min() > 0 and not g[200:].any()


# -- refusals ----------------------------------------------------------------

@pytest.mark.parametrize("shape,msg", [((8, 64), "last dim must be 128"),
                                       ((12, 128), "rows must be a multiple "
                                                   "of 8")])
def test_pdomd_update_refuses_what_the_reference_refuses(shape, msg):
    a = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match=msg):
        jops.pdomd_update(*[jnp.asarray(a)] * 4, jnp.float32(0.1),
                          jnp.float32(0.1), interpret=True)
    with pytest.raises(ValueError, match=msg):
        ops.pdomd_update(*[torch.tensor(a)] * 4, 0.1, 0.1)


def test_hinge_grad_refuses_what_the_reference_refuses():
    x, y, w = np.zeros((4, 100), np.float32), np.ones(4, np.float32), \
        np.zeros(100, np.float32)
    with pytest.raises(ValueError, match="n must be a multiple of 128"):
        jops.hinge_grad(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                        interpret=True)
    with pytest.raises(ValueError, match="n must be a multiple of 128"):
        ops.hinge_grad(torch.tensor(x), torch.tensor(y), torch.tensor(w))
