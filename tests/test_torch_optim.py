"""The port's optimizers and LR schedules (`repro_torch.optim`) against the
reference's (`repro.optim`): tests/test_optim.py's optimizer and schedule
cases on both packages, every schedule at steps 0..N, and the sgd /
momentum / adamw states and updates over several steps on the same
parameters and gradients, leaf by leaf.

Tolerances: a schedule within 2 float32 ulps of its peak lr of the
reference's value (the two libraries' cos rounds one ulp apart at a few
steps, and near a cosine's floor 1 + cos cancels, which turns that ulp of
cos into up to 5 ulps of a small result: measured); an
optimizer's state and updates within 1e-6 relative plus 1e-7 absolute
(f32 division and sqrt, one pow); the step counter exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as joptim  # noqa: E402

import repro_torch.optim as optim  # noqa: E402
from repro_torch.core.tree import leaves as tree_leaves  # noqa: E402

SCHEDULES = [("constant", (0.1,)), ("cosine", (1.0, 100)),
             ("cosine", (3e-4, 50, 0.0)), ("warmup_cosine", (1.0, 10, 110)),
             ("warmup_cosine", (2e-3, 0, 40, 0.2)),
             ("wsd", (1.0, 10, 50, 40, 0.1)), ("wsd", (5e-3, 0, 5, 1, 0.5))]


@pytest.mark.parametrize("name,args", SCHEDULES,
                         ids=[f"{n}{a}" for n, a in SCHEDULES])
def test_schedule_equals_the_reference_at_every_step(name, args):
    mine, ref = getattr(optim, name)(*args), getattr(joptim, name)(*args)
    steps = range(0, 130)
    got = np.array([float(mine(torch.tensor(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    want = np.array([float(ref(jnp.asarray(s, jnp.int32))) for s in steps],
                    np.float32)
    assert mine(torch.tensor(3, dtype=torch.int32)).dtype == torch.float32
    peak = np.float32(args[0])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * float(np.spacing(peak)))


def _quadratic_losses(opt, steps=200):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(steps):
        g = {"w": 2 * (params["w"] - target)}
        upd, state = opt.update(g, state, params)
        params = optim.apply_updates(params, upd)
    return float(torch.sum(torch.square(params["w"] - target)))


def test_sgd_converges_quadratic():
    assert _quadratic_losses(optim.sgd(optim.constant(0.1))) < 1e-3


def test_sgd_momentum_converges():
    assert _quadratic_losses(optim.sgd(optim.constant(0.05),
                                       momentum=0.9)) < 1e-3


def test_adamw_converges_quadratic():
    assert _quadratic_losses(optim.adamw(optim.constant(0.05),
                                         weight_decay=0.0)) < 1e-2


def test_adamw_weight_decay_shrinks():
    opt = optim.adamw(optim.constant(0.1), weight_decay=1.0)
    params = {"w": torch.full((3,), 10.0)}
    state = opt.init(params)
    upd, state = opt.update({"w": torch.zeros(3)}, state, params)
    assert float(optim.apply_updates(params, upd)["w"][0]) < 10.0


def test_schedules_shapes():
    assert float(optim.constant(0.1)(torch.tensor(1000))) == \
        pytest.approx(0.1)
    cs = optim.cosine(1.0, 100)
    assert float(cs(torch.tensor(0))) == pytest.approx(1.0)
    assert float(cs(torch.tensor(100))) == pytest.approx(0.1, rel=1e-3)
    wc = optim.warmup_cosine(1.0, 10, 110)
    assert float(wc(torch.tensor(5))) == pytest.approx(0.5)


def test_wsd_phases():
    f = optim.wsd(1.0, warmup=10, stable=50, decay=40, final_frac=0.1)
    assert float(f(torch.tensor(5))) == pytest.approx(0.5)      # warmup
    assert float(f(torch.tensor(30))) == pytest.approx(1.0)     # stable
    assert float(f(torch.tensor(100))) == pytest.approx(0.1, rel=1e-3)
    vals = [float(f(torch.tensor(60 + i))) for i in range(0, 41, 10)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


OPTIMIZERS = {
    "sgd": lambda lib: lib.sgd(lib.warmup_cosine(0.1, 2, 10)),
    "momentum": lambda lib: lib.sgd(lib.cosine(0.05, 6), momentum=0.9),
    "adamw": lambda lib: lib.adamw(lib.wsd(1e-2, 2, 2, 4)),
    "adamw_no_decay": lambda lib: lib.adamw(lib.constant(3e-3), b1=0.8,
                                            b2=0.99, weight_decay=0.0),
}


def _tree(rng, dtype):
    """Nested params with a list level and a bf16 leaf (the reference's
    mixed pytrees)."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"dense": {"w": a(4, 3), "b": a(3)},
            "layers": [{"w": a(2, 3)}, {"w": a(2, 3)}],
            "table": (a(5, 2), dtype)}


def _as(tree, lib):
    def leaf(v):
        arr, dt = v if isinstance(v, tuple) else (v, "float32")
        if lib == "jax":
            return jnp.asarray(arr).astype(dt)
        return torch.from_numpy(arr).to(getattr(torch, dt))
    if isinstance(tree, dict):
        return {k: _as(v, lib) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(v, lib) for v in tree]
    return leaf(tree)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_states_and_updates_equal_the_reference(name, dtype):
    """Five steps from the same params and gradients: every state leaf
    (f32 moments, the step), every update and the applied params."""
    rng = np.random.default_rng(0)
    spec = _tree(rng, dtype)
    grads_np = [_tree(rng, dtype) for _ in range(5)]
    opt, jopt = OPTIMIZERS[name](optim), OPTIMIZERS[name](joptim)
    p, jp = _as(spec, "torch"), _as(spec, "jax")
    state, jstate = opt.init(p), jopt.init(jp)
    for step, g_np in enumerate(grads_np):
        g, jg = _as(g_np, "torch"), _as(g_np, "jax")
        upd, state = opt.update(g, state, p)
        jupd, jstate = jopt.update(jg, jstate, jp)
        p, jp = optim.apply_updates(p, upd), joptim.apply_updates(jp, jupd)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        assert state["step"].dtype == torch.int32
        for key in ("mu", "m", "v"):
            if key not in jstate:
                continue
            if jstate[key] is None:
                assert state[key] is None
                continue
            mine, ref = tree_leaves(state[key]), \
                jax.tree_util.tree_leaves(jstate[key])
            assert len(mine) == len(ref)
            for a, b in zip(mine, ref):
                assert a.dtype == torch.float32
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                           atol=1e-7, err_msg=key)
        for a, b in zip(tree_leaves(upd), jax.tree_util.tree_leaves(jupd)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)
        for a, b in zip(tree_leaves(p), jax.tree_util.tree_leaves(jp)):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            # a bf16 leaf rounds the f32 sum: one bf16 ulp apart at most
            tol = 2 ** -7 if a.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=1e-7)
