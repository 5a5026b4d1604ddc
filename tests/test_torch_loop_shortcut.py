"""The dry-run's counting path (`repro_torch.core.loops`' shortened loops
on ``meta`` tensors, under `repro_torch.launch.op_cost.count`) against the
full count, exactly.

A count over ``meta`` tensors runs each fixed-trip loop as weighted
representative iterations, one gossip node for all, one micro-batch for
all; on ``meta`` nothing is stored. Its flops, bytes and every op row
(name, weighted calls, flops, bytes) must equal the CPU count of the same
call with every iteration run:

* each family's reduced gossip train step (5 layers, so the layer loop is
  shortened too; T = 16, so the RWKV-6 and RG-LRU time loops are), the
  all-reduce step with micro-batches, the prefill and decode steps (a
  delayed ring's step differs by the host-to-device copies of its mixer's
  diagonal alone, which meta makes as a card does and the CPU does not);
* the RWKV-6 and RG-LRU time loops and the blockwise attention's chunk
  loops (plain and flash backward, with and without a window, chunks of
  either order) at a small T, forward and backward.

And the shortcut is nothing else: outside a count, or over a real
tensor, a loop runs every iteration. The private autograd hooks the
weights read behave as the shortcut needs (an upgrade of torch that
changes them fails here).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import loops, tree  # noqa: E402
from repro_torch.launch import op_cost, steps  # noqa: E402
from repro_torch.models import attention, build_model, rglru  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402

LAYERS, NODES, B, T = 5, 3, 2, 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_count(full, short):
    names = sorted(set(full.ops) | set(short.ops))
    differ = [(n, full.ops.get(n), short.ops.get(n)) for n in names
              if full.ops.get(n) != short.ops.get(n)]
    assert not differ, differ[:6]
    assert (full.flops, full.hbm_bytes) == (short.flops, short.hbm_bytes)


def lm_batch(cfg, lead, dev):
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, lead + (T,), generator=gen,
                         dtype=torch.int32).to(dev)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        batch["frontend"] = torch.zeros(lead + (8, cfg.d_model),
                                        dtype=cfg.tdtype, device=dev)
    elif cfg.frontend == "vision":
        batch["frontend"] = torch.zeros(lead + (cfg.frontend_tokens,
                                                cfg.d_model),
                                        dtype=cfg.tdtype, device=dev)
    return batch


def step_count(arch, dev, kind, **kw):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=LAYERS)
    model = build_model(cfg, dev)
    if kind == "gossip":
        recipe = steps.TrainRecipe(eps=1.0, **kw)
        gdp = steps.make_gossip_dp(NODES, recipe)
        state = steps.make_gossip_init(model, gdp, NODES)(0)
        fn = steps.make_gossip_train_step(model, gdp, recipe.microbatches)
        args = (state, lm_batch(cfg, (NODES, B), dev))
    elif kind == "allreduce":
        fn, init = steps.make_allreduce_train_step(
            model, steps.TrainRecipe(strategy="allreduce", **kw))
        args = (init(0), lm_batch(cfg, (2 * B,), dev))
    elif kind == "prefill":
        fn = steps.make_prefill_step(model)
        batch = lm_batch(cfg, (B,), dev)
        batch.pop("labels")
        args = (model.init(0), batch)
    else:
        fn = steps.make_serve_step(model)
        args = (model.init(0), model.init_cache(B, T),
                torch.zeros((B, 1), dtype=torch.int32, device=dev),
                torch.full((B,), 3, dtype=torch.int32, device=dev))
    return op_cost.count(fn, *args)[1]


@pytest.mark.parametrize("arch", ["minicpm-2b", "mixtral-8x7b", "rwkv6-3b",
                                  "recurrentgemma-2b", "qwen2-vl-2b",
                                  "seamless-m4t-medium"])
def test_gossip_step_meta_count_equals_the_cpu_count(arch):
    assert_same_count(step_count(arch, "cpu", "gossip"),
                      step_count(arch, "meta", "gossip"))


@pytest.mark.parametrize("arch,kind,kw", [
    ("minicpm-2b", "gossip", {"microbatches": 2}),
    ("llama4-scout-17b-a16e", "allreduce", {"microbatches": 2}),
    ("rwkv6-3b", "prefill", {}), ("recurrentgemma-2b", "decode", {}),
    ("qwen2-7b", "decode", {})])
def test_other_steps_meta_count_equals_the_cpu_count(arch, kind, kw):
    assert_same_count(step_count(arch, "cpu", kind, **kw),
                      step_count(arch, "meta", kind, **kw))


def test_delayed_gossip_meta_count_adds_only_the_host_copies():
    """A delayed ring's mix moves its (m,) host diagonal to the theta
    leaf's device once a leaf (`mixers._bcast`): a copy on meta, as on a
    card, and none on the CPU, where the tensor is already. That is the
    whole difference."""
    cpu = step_count("minicpm-2b", "cpu", "gossip", delay=2)
    meta = step_count("minicpm-2b", "meta", "gossip", delay=2)
    leaves = len(tree.leaves(build_model(get_config("minicpm-2b").reduced(),
                                         "meta").init(0)))
    copies = meta.ops["aten._to_copy"]
    assert copies["calls"] - cpu.ops["aten._to_copy"]["calls"] == leaves
    assert copies["bytes"] - cpu.ops["aten._to_copy"]["bytes"] == \
        leaves * 2 * 4 * NODES
    for name in set(cpu.ops) | set(meta.ops):
        if name != "aten._to_copy":
            assert cpu.ops.get(name) == meta.ops.get(name), name


def _leaves(dev, *shapes, grad=True):
    gen = torch.Generator().manual_seed(1)
    return [torch.randn(s, generator=gen).to(dev).requires_grad_(grad)
            for s in shapes]


def _loop_count(dev, fn, shapes, grad=True):
    ins = _leaves(dev, *shapes, grad=grad)

    def run():
        out = fn(*ins)
        if grad:
            return torch.autograd.grad((out * out).sum(), ins)
        return out
    return op_cost.count(run)[1]


def _wkv(r, k, v, w, u):
    s0 = torch.zeros(r.shape[0], r.shape[2], r.shape[3], r.shape[3],
                     device=r.device)
    y, s = rwkv6._wkv_scan(r, k, v, torch.sigmoid(w), u, s0)
    return y.sum() + s.sum()


def _lru(x, wa, wx, lam):
    p = {"wa": {"w": wa, "b": wa[0] * 0}, "wx": {"w": wx, "b": wx[0] * 0},
         "lam": lam}
    h, last = rglru.rglru_apply(p, x, torch.zeros_like(x[:, 0]))
    return h.sum() + last.sum()


LOOPS = {
    "rwkv6 time steps": (_wkv, [(2, 12, 3, 4)] * 4 + [(3, 4)]),
    "rg-lru time steps": (_lru, [(2, 9, 6), (6, 6), (6, 6), (6,)]),
}


@pytest.mark.parametrize("grad", [True, False])
@pytest.mark.parametrize("name", sorted(LOOPS))
def test_time_loop_shortcut_equals_the_full_loop(name, grad):
    fn, shapes = LOOPS[name]
    assert_same_count(_loop_count("cpu", fn, shapes, grad),
                      _loop_count("meta", fn, shapes, grad))


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("T,qc,kc,window", [
    (40, 4, 8, None), (40, 8, 4, None), (64, 4, 8, 12), (37, 4, 4, None)])
def test_attention_chunk_loop_shortcut_equals_the_full_loop(T, qc, kc,
                                                            window, flash):
    def blockwise(q, k, v):
        if flash:
            return attention._flash_attention(q, k, v, window, None, qc, kc)
        return attention._blockwise_attention(q, k, v, window, None, qc, kc)
    shapes = [(2, T, 4, 8), (2, T, 2, 8), (2, T, 2, 8)]
    for grad in (True, False):
        assert_same_count(_loop_count("cpu", blockwise, shapes, grad),
                          _loop_count("meta", blockwise, shapes, grad))


def test_representatives_and_weights():
    x = torch.empty(3, device="meta")
    seen = []

    def body():
        lp = loops.loop(9, x, key=lambda i: i % 2)
        for i in lp:
            seen.append(i)
            torch.exp(x)                # one op an iteration
        return lp
    lp, cost = op_cost.count(body)
    # first, one of each key among 1..6, the last two
    assert seen == [0, 1, 2, 7, 8]
    assert [(i, w) for i, w, _ in lp.reps] == [(0, 1), (1, 3), (2, 3),
                                              (7, 1), (8, 1)]
    assert cost.ops["aten.exp"]["calls"] == 9
    items = lp.full(["a0", x, x + 0, "a7", "a8"])
    assert len(items) == 9 and items[3] is items[5] is not x

    def independent():
        for _ in loops.loop(7, x, independent=True):
            torch.exp(x)
    assert op_cost.count(independent)[1].ops["aten.exp"][
        "calls"] == 7


def test_outside_a_count_or_over_a_real_tensor_every_iteration_runs():
    x = torch.ones(3)
    assert list(loops.loop(9, x)) == list(range(9))
    lp, cost = op_cost.count(lambda: loops.loop(9, x))
    assert lp.reps is None and list(lp) == list(range(9))
    assert list(loops.loop(4, torch.empty(1, device="meta"))) == \
        [0, 1, 2, 3]
    assert loops.replayed(len) is len and not loops.stands_in(x)


class _Probe(torch.autograd.Function):
    """Records the node its backward runs under."""

    seen: list = []

    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        node = torch._C._current_autograd_node()
        _Probe.seen.append(node._sequence_nr())
        return g * 2


def test_the_private_autograd_hooks_the_weights_read():
    """`loops.Tracker` tags autograd nodes by the sequence number current
    when they are made and finds a backward's node by
    ``_current_autograd_node()._sequence_nr()``: a node made after a
    reading carries that number or a later one, and the running backward's
    node is the one the forward made."""
    get_seq = torch._C._autograd._get_sequence_nr
    assert torch._C._current_autograd_node() is None
    x = torch.ones(3, requires_grad=True)
    before = get_seq()
    assert isinstance(before, int)
    y = _Probe.apply(x)
    made = y.grad_fn._sequence_nr()
    assert isinstance(made, int) and made >= before
    assert get_seq() > made
    _Probe.seen.clear()
    y.sum().backward()
    assert _Probe.seen == [made]
