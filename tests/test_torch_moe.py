"""The port's MoE layer (`repro_torch.models.moe`) against the reference's
(`repro.models.moe`): tests/test_moe.py's cases, each run through both
packages on the same weights (the reference's `moe_init`, carried across)
and inputs, plus the drop set at the production capacity factor 1.25 and
grouped dispatch at G = 2.

Tolerances (f32): the port's output within 2e-5 absolute plus 1e-5
relative of the reference's (matmul order); the router's expert choice
and the set of dropped assignments exactly the reference's; the port's
sort dispatch within tests/test_moe.py's bounds of the port's dense
all-experts product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402

from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

ATOL, RTOL = 2e-5, 1e-5


def _cfgs(E=4, k=2, cf=8.0, shared=False):
    kw = dict(name="m", family="moe", num_layers=1, d_model=32, num_heads=4,
              num_kv_heads=2, d_ff=64, vocab_size=64, num_experts=E,
              num_experts_per_tok=k, moe_capacity_factor=cf,
              shared_expert=shared, dtype="float32")
    return JModelConfig(**kw), ModelConfig(**kw)


def _tree(p):
    return {k: _tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in p.items()}


def _layer(jcfg, shape, pseed=0, xseed=1, skew=0.0):
    """The reference's weights and inputs (tests/test_moe.py's seeds), and
    the same as torch tensors. ``skew`` shifts every token along expert
    0's router column, so that expert 0 is in nearly every token's top k
    and overflows its capacity: drops are live."""
    jp = jmoe.moe_init(jax.random.PRNGKey(pseed), jcfg)
    jx = jax.random.normal(jax.random.PRNGKey(xseed), shape)
    w0 = jp["router"]["w"][:, 0]
    jx = jx + skew * w0 / jnp.linalg.norm(w0)
    return jp, jx, _tree(jp), torch.from_numpy(np.array(jx))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _dense_reference(p, cfg, x):
    """Dense einsum over ALL experts weighted by the (sparse) combine
    weights (tests/test_moe.py's, in torch)."""
    B, T, D = x.shape
    xf = x.reshape(-1, D)
    weights, top_idx, _ = moe._router(p, cfg, xf)
    N, E = xf.shape[0], cfg.num_experts
    comb = torch.zeros((N, E))
    for j in range(cfg.num_experts_per_tok):
        comb[torch.arange(N), top_idx[:, j]] += weights[:, j]
    h = torch.nn.functional.silu(torch.einsum("nd,edf->nef", xf, p["gate"])) \
        * torch.einsum("nd,edf->nef", xf, p["up"])
    y = torch.einsum("ned,ne->nd", torch.einsum("nef,efd->ned", h, p["down"]),
                     comb)
    if cfg.shared_expert:
        from repro_torch.models import mlp
        y = y + mlp.mlp(p["shared"], cfg, xf)
    return y.reshape(B, T, D)


def _reference_keep(top_idx: np.ndarray, E: int, C: int) -> np.ndarray:
    """The reference's drop rule (src/repro/models/moe.py:122-132) in numpy:
    kept[i] for assignment i of the flattened (N*k,) top_idx."""
    eid = top_idx.reshape(-1)
    order = np.argsort(eid, kind="stable")
    eid_s = eid[order]
    starts = np.searchsorted(eid_s, np.arange(E), side="left")
    keep = np.empty(eid.shape, bool)
    keep[order] = (np.arange(eid.size) - starts[eid_s]) < C
    return keep


@pytest.mark.parametrize("E,k,shared", [(4, 2, False), (4, 1, False),
                                        (4, 1, True)])
def test_moe_matches_dense_reference(E, k, shared):
    jcfg, cfg = _cfgs(E=E, k=k, shared=shared)
    jp, jx, p, x = _layer(jcfg, (2, 16, 32))
    y, aux = moe.moe_apply(p, cfg, x)
    np.testing.assert_allclose(y.numpy(), _dense_reference(p, cfg, x).numpy(),
                               rtol=2e-4, atol=2e-5)
    assert float(aux) >= 0
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx)
    _close(y, jy)
    _close(aux, jaux)


@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_capacity_drops_the_reference_s_assignments(cf):
    """Below drop-free capacity the port drops exactly the assignments the
    reference drops (same router choice, same stable sort and slot rule),
    and its output is the reference's — never NaN, never the dense one."""
    jcfg, cfg = _cfgs(cf=cf)
    jp, jx, p, x = _layer(jcfg, (1, 64, 32), skew=3.0)
    xf = x.reshape(-1, 32)
    _, top_idx, _ = moe._router(p, cfg, xf)
    _, jtop, _ = jmoe._router(jp, jcfg, jx.reshape(-1, 32))
    np.testing.assert_array_equal(top_idx.numpy(), np.asarray(jtop))
    C = moe.capacity(cfg, 64)
    assert C == int(max(1, round(64 * 2 / 4 * cf)))
    order, _, _, _, keep = moe._dispatch(top_idx, 4, C)
    kept = np.empty(keep.shape, bool)
    kept[order.numpy()] = keep.numpy()
    want = _reference_keep(np.asarray(jtop), 4, C)
    np.testing.assert_array_equal(kept, want)
    assert 0 < (~want).sum() < want.size          # drops are live
    y, _ = moe.moe_apply(p, cfg, x)
    assert not torch.isnan(y).any()
    assert not np.allclose(y.numpy(), _dense_reference(p, cfg, x).numpy())
    _close(y, jmoe.moe_apply(jp, jcfg, jx)[0])


def test_router_aux_loss_penalizes_imbalance():
    """The router's load-balance loss: larger for collapsed assignments
    than for balanced ones, and the reference's value for both."""
    jcfg, cfg = _cfgs()
    n, E = 512, cfg.num_experts
    xs = {"balanced": np.tile(np.eye(E, 32, dtype=np.float32), (n // E, 1)),
          "collapsed": np.tile(np.eye(1, 32, dtype=np.float32), (n, 1))}
    w = (10 * np.eye(32, E)).astype(np.float32)
    aux = {}
    for name, xf in xs.items():
        _, _, aux[name] = moe._router({"router": {"w": torch.from_numpy(w)}},
                                      cfg, torch.from_numpy(xf))
        _, _, jaux = jmoe._router({"router": {"w": jnp.asarray(w)}}, jcfg,
                                  jnp.asarray(xf))
        _close(aux[name], jaux)
    assert float(aux["collapsed"]) > float(aux["balanced"])


def test_moe_grads_flow_to_experts_and_router():
    jcfg, cfg = _cfgs()
    jp, jx, p, x = _layer(jcfg, (2, 8, 32))

    def jloss(p):
        y, aux = jmoe.moe_apply(p, jcfg, jx)
        return jnp.sum(jnp.square(y)) + aux

    leaves = {"gate": p["gate"], "up": p["up"], "down": p["down"],
              "router": p["router"]["w"]}
    for t in leaves.values():
        t.requires_grad_(True)
    y, aux = moe.moe_apply(p, cfg, x)
    (torch.sum(torch.square(y)) + aux).backward()
    assert float(torch.sum(torch.abs(p["gate"].grad))) > 0
    assert float(torch.sum(torch.abs(p["router"]["w"].grad))) > 0
    jg = jax.grad(jloss)(jp)
    for name, t in leaves.items():
        want = jg["router"]["w"] if name == "router" else jg[name]
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_grouped_dispatch_matches_the_reference():
    """G = 2 dispatch groups (capacity C/G each; a group is a half of the
    tokens) at capacity 1.25, where drops are live: the reference's
    output and aux; the context sets the groups and refuses a mesh axis."""
    jcfg, cfg = _cfgs(cf=1.25)
    jp, jx, p, x = _layer(jcfg, (2, 32, 32), skew=3.0)
    y, aux = moe.moe_apply(p, cfg, x, dispatch_groups=2)
    jy, jaux = jmoe.moe_apply(jp, jcfg, jx, dispatch_groups=2)
    _close(y, jy)
    _close(aux, jaux)
    assert not np.allclose(y.numpy(), moe.moe_apply(p, cfg, x)[0].numpy())
    with moe.grouped_dispatch(2):
        assert moe.current_dispatch_groups() == 2
    assert moe.current_dispatch_groups() == 1
    with pytest.raises(NotImplementedError, match="item 5.3"):
        with moe.grouped_dispatch(2, axis="data"):
            pass
