"""The tied unembedding's kernel path (`repro_torch.kernels.unembed_gemm`).

On the CPU: the three-way bf16 split of a float32 logit gradient adds back
to it exactly across the range a gradient takes; `TiedUnembed` (on the CPU,
the wrapper's plain versions) equals today's ``x.to(f32) @ table.to(f32).T``
and its autograd gradients bit for bit, for bfloat16 and float32 operands;
`layers.unembed` takes the kernel path for bf16 x bf16 operands alone, on
every device (the wrapper runs the plain versions on CPU and meta tensors,
so an op count sees the kernels' rows on meta as on the card), and its
counters ``unembed.kernel_calls`` and ``unembed.plain_calls`` say which
path a call took; the split count, the work count and the wrapper's
refusals.

The tests marked ``card`` need an NVIDIA card and skip elsewhere: the
kernels against a float64 product at the benchmark cells' shapes (M 4,096
and 1,024, V 122,880, d 2,304) and at decode shapes (M 1 and 7), each error
no more than twice that of torch's float32 product of the same operands; a
gradient whose exact value cancels down to the split's low terms; a repeated
run bit for bit; the launches a forward and backward pass makes; a
minicpm-2b (reduced, bf16) step on the kernel path, its loss and gradients
held to the same step through the plain f32 product. On the card, without JAX (the
repository's conftest imports it):
``python -m pytest -q --noconftest -m card tests/test_torch_unembed_gemm.py``
"""
from __future__ import annotations

import types

import pytest
import torch

import repro_torch.obs as obs
from repro_torch.kernels import unembed_gemm as ug
from repro_torch.kernels.work import work
from repro_torch.models import layers

BF16, F32 = torch.bfloat16, torch.float32
SPLIT_EXACT = 2.0 ** -110     # below it the low term meets bf16 subnormals


# -- the split ----------------------------------------------------------------

def _softmax_grads(M, V, seed):
    """A cross-entropy logit gradient, (softmax - onehot) / M, in f32."""
    g = torch.Generator().manual_seed(seed)
    logits = 4.0 * torch.randn(M, V, generator=g)
    labels = torch.randint(0, V, (M,), generator=g)
    p = torch.softmax(logits, dim=-1)
    p[torch.arange(M), labels] -= 1.0
    return (p / M).float()


VALUES = {
    "logspace": lambda: torch.logspace(-38, 0, 40_001,
                                       dtype=torch.float64).float(),
    "softmax_m4096": lambda: _softmax_grads(8, 4_096, 0).flatten() * 8 / 4096,
    "softmax_m1024": lambda: _softmax_grads(16, 2_048, 1).flatten() * 16
    / 1024,
    "normal": lambda: torch.randn(50_000, generator=torch.Generator()
                                  .manual_seed(2)),
}


@pytest.mark.parametrize("case", sorted(VALUES))
def test_the_split_adds_back_to_the_gradient_exactly(case):
    g = VALUES[case]()
    g = torch.cat([g, -g])
    hi, mid, lo = ug.split3(g)
    assert hi.dtype == mid.dtype == lo.dtype == BF16
    # the kernel's order: lo, then mid, then hi, into one f32 sum
    back = (lo.float() + mid.float()) + hi.float()
    normal = g.abs() >= SPLIT_EXACT
    assert torch.equal(back[normal], g[normal])
    assert torch.equal(hi.float() + mid.float() + lo.float(), back)
    # below 2^-110 the low term rounds to bf16's subnormal step, 2^-133
    assert float((back - g).abs().max()) <= 2.0 ** -134
    if case == "logspace":
        assert int((~normal).sum()) > 0


# -- the autograd Function against today's product ------------------------------

def _operands(dtype, lead, V=96, d=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*lead, d, generator=g).to(dtype)
    table = (torch.randn(V, d, generator=g) / d ** 0.5).to(dtype)
    w = torch.randn(*lead, V, generator=g)
    return x, table, w


def _todays(x, table, w):
    x = x.detach().requires_grad_(True)
    table = table.detach().requires_grad_(True)
    out = x.to(F32) @ table.to(F32).T
    (out * w).sum().backward()
    return out.detach(), x.grad, table.grad


def _function(x, table, w):
    x = x.detach().requires_grad_(True)
    table = table.detach().requires_grad_(True)
    out = ug.TiedUnembed.apply(x, table)
    (out * w).sum().backward()
    return out.detach(), x.grad, table.grad


@pytest.mark.parametrize("lead", [(24,), (3, 8), (1, 1)],
                         ids=["2d", "3d", "one_row"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_the_function_equals_todays_unembed_bit_for_bit(dtype, lead):
    x, table, w = _operands(dtype, lead)
    want, got = _todays(x, table, w), _function(x, table, w)
    for a, b, what in zip(got, want, ("logits", "dx", "dtable")):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a, b), what


def test_the_function_through_the_loss_equals_todays_model_path():
    """The tied unembedding under the padded-vocab mask and the softmax
    cross entropy, as the LM's loss runs it."""
    x, table, _ = _operands(BF16, (2, 12), V=64)
    labels = torch.randint(0, 60, (2, 12), generator=torch.Generator()
                           .manual_seed(5))

    def loss(unembed):
        xr = x.detach().requires_grad_(True)
        tr = table.detach().requires_grad_(True)
        logits = layers.mask_padded_vocab(unembed(xr, tr), 60)
        layers.softmax_cross_entropy(logits, labels).mean().backward()
        return xr.grad, tr.grad

    want = loss(lambda a, b: a.to(F32) @ b.to(F32).T)
    got = loss(ug.TiedUnembed.apply)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_the_function_gives_no_gradient_where_none_is_asked():
    x, table, w = _operands(BF16, (8,))
    table = table.detach().requires_grad_(True)
    (ug.TiedUnembed.apply(x, table) * w).sum().backward()
    assert table.grad is not None and x.grad is None


# -- the gate and its counters --------------------------------------------------

def _fake(dtype, device, d=64, V=96):
    return types.SimpleNamespace(dtype=dtype, device=torch.device(device),
                                 shape=(V, d))


@pytest.mark.parametrize("xd,td,device,d,V,want", [
    (BF16, BF16, "cuda", 64, 96, True),
    (BF16, BF16, "cpu", 64, 96, True),
    (BF16, BF16, "meta", 64, 96, True),
    (F32, F32, "cuda", 64, 96, False),
    (BF16, F32, "cuda", 64, 96, False),
    (F32, BF16, "cuda", 64, 96, False),
    (torch.float16, torch.float16, "cuda", 64, 96, False),
    (BF16, BF16, "cuda", 60, 96, False),
    (BF16, BF16, "cuda", 64, 98, False),
], ids=["bf16_cuda", "bf16_cpu", "bf16_meta", "f32_cuda", "mixed_cuda",
        "mixed_cuda_2", "f16_cuda", "ragged_rows", "ragged_vocab"])
def test_the_kernel_path_is_bf16_operands_on_any_device(xd, td, device, d,
                                                        V, want):
    assert layers.kernel_path(_fake(xd, device, d), _fake(td, device, d, V)) \
        is want


@pytest.mark.parametrize("dtype,rows", [
    (BF16, {"kernel.unembed_logits": 1, "kernel.unembed_grad_x": 1,
            "kernel.unembed_grad_table": 1}),
    (F32, {})], ids=["bf16", "f32"])
def test_an_op_count_on_meta_sees_the_kernel_rows(dtype, rows):
    """A bf16 forward and backward counts one row a product on meta, as on
    the card (the wrapper's scope masks the plain versions' ops); f32
    counts today's products."""
    from repro_torch.launch import op_cost
    x = torch.empty(2, 6, 40, dtype=dtype, device="meta", requires_grad=True)
    table = torch.empty(96, 40, dtype=dtype, device="meta",
                        requires_grad=True)

    def step():
        layers.unembed({"table": table}, x).sum().backward()

    _, cost = op_cost.count(step)
    got = {k: v["calls"] for k, v in cost.ops.items()
           if k.startswith("kernel.")}
    assert got == rows
    if not rows:
        assert cost.flops >= 3 * 2 * 12 * 96 * 40


def _counted_unembed(x, table):
    tel = obs.enable()
    try:
        out = layers.unembed({"table": table}, x)
    finally:
        obs.disable()
    return out, tel.metrics.snapshot()


def test_a_backward_on_another_thread_counts_in_the_forwards_count():
    """Autograd runs a CUDA backward on a thread of its own: the products
    of a backward run on another thread still report to the op count that
    the forward reported to, one row each."""
    import threading

    from repro_torch.launch import op_cost
    x, table, _ = _operands(BF16, (6,))
    x.requires_grad_(True)
    table.requires_grad_(True)

    def step():
        out = ug.TiedUnembed.apply(x, table)
        worker = threading.Thread(target=lambda: out.sum().backward())
        worker.start()
        worker.join()

    _, cost = op_cost.count(step)
    assert {k: v["calls"] for k, v in cost.ops.items()
            if k.startswith("kernel.")} == {
        f"kernel.{name}": 1 for name in ug.OPS.values()}
    assert x.grad.dtype == table.grad.dtype == BF16


@pytest.mark.parametrize("dtype,counter", [
    (BF16, "unembed.kernel_calls"), (F32, "unembed.plain_calls")],
    ids=["bf16", "f32"])
def test_the_counters_say_which_path_a_call_took(dtype, counter):
    x, table, _ = _operands(dtype, (2, 5))
    out, snap = _counted_unembed(x, table)
    assert snap == {counter: 1}
    assert torch.equal(out, x.to(F32) @ table.to(F32).T)


# -- the split count, the work count, the refusals --------------------------------

@pytest.mark.parametrize("M,want", [(4_096, 5), (1_024, 11), (1, 7),
                                    (7, 7)])
def test_the_split_count_fills_the_card(M, want):
    """dx's (M/128 x 18) tiles at d 2,304 times the splits keep the 132 SMs
    of an H100 more than 90 % busy, in waves of 1,920 / s k-blocks."""
    s = ug.splits(M, 2_304, 122_880, 132)
    assert s == want
    units = -(-M // 128) * 18 * s
    assert units / (132 * -(-units // 132)) > 0.9
    assert ug.splits(M, 2_304, 96, 132) <= 3      # never past the k-blocks


def test_the_work_counts_the_bf16_passes():
    M, d, V = 4_096, 2_304, 122_880
    fwd = work("unembed_logits", M, V, k=d)
    dx = work("unembed_grad_x", M, d, k=V)
    dt = work("unembed_grad_table", V, d, k=M)
    assert fwd == (2 * (M + V) * d + 4 * M * V, 2 * M * V * d)
    assert dx[1] == dt[1] == 3 * fwd[1]
    assert dx[0] == 4 * M * V + 2 * V * d + 2 * M * d
    assert dt[0] == 4 * M * V + 2 * M * d + 2 * V * d
    total = fwd[1] + dx[1] + dt[1]
    assert round(total / 1e12, 1) == 16.2
    assert round(2 * M * V * d * 3 / 1e12, 2) == 6.96


def test_an_op_count_sees_one_kernel_row_a_product():
    from repro_torch.launch import op_cost
    x, table, _ = _operands(BF16, (6,))
    g = torch.randn(6, 96)
    _, cost = op_cost.count(lambda: (ug.logits(x, table),
                                     ug.grad_x(g, table),
                                     ug.grad_table(g, x)))
    for op, name in ug.OPS.items():
        assert cost.ops[f"kernel.{name}"]["calls"] == 1, op
    assert cost.ops["kernel.unembed_logits"]["bytes"] == \
        work("unembed_logits", 6, 96, k=40)[0]


@pytest.mark.parametrize("bad", ["op", "rank", "chain", "g_dtype", "depth",
                                 "device"])
def test_the_wrapper_refuses_what_the_kernels_do_not_take(bad):
    x, table, _ = _operands(BF16, (6,))
    g = torch.randn(6, 96)
    call = {"op": lambda: ug.unembed_gemm("logit", x, table),
            "rank": lambda: ug.logits(x[None], table),
            "chain": lambda: ug.grad_x(g, table[:50]),
            "g_dtype": lambda: ug.grad_table(g.to(BF16), x),
            "depth": lambda: ug.logits(x, table[:, :30]),
            "device": lambda: ug.logits(x, table.to("meta"))}[bad]
    with pytest.raises(ValueError):
        call()


def test_the_plain_versions_run_on_meta_tensors():
    x = torch.empty(4, 16, dtype=BF16, device="meta")
    table = torch.empty(32, 16, dtype=BF16, device="meta")
    out = ug.TiedUnembed.apply(x, table)
    assert out.shape == (4, 32) and out.dtype == F32
    assert ug.grad_table(torch.empty(4, 32, device="meta"), x).shape \
        == (32, 16)


# -- on the card ------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the unembedding's kernels run "
                    "only there")
    return torch.device("cuda")


def _card_operands(M, V, d, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(M, d, generator=g, device=dev).to(BF16)
    table = (torch.randn(V, d, generator=g, device=dev) / d ** 0.5).to(BF16)
    # a cross-entropy gradient: (softmax - onehot) / M
    logits = 2.0 * torch.randn(M, V, generator=g, device=dev)
    labels = torch.randint(0, V, (M,), generator=g, device=dev)
    grad = torch.softmax(logits, dim=-1)
    del logits
    grad[torch.arange(M, device=dev), labels] -= 1.0
    return x, table, grad.div_(M)


def _err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want).abs().max() / want.abs().max())


@pytest.mark.card
@pytest.mark.parametrize("M", [4_096, 1_024, 1, 7])
def test_the_kernels_against_a_float64_product(card, M):
    V, d = 122_880, 2_304
    x, table, g = _card_operands(M, V, d, card, seed=M)
    xd, td, gd = x.double(), table.double(), g.double()
    got = {"logits": ug.logits(x, table), "grad_x": ug.grad_x(g, table),
           "grad_table": ug.grad_table(g, x)}
    lib = {"logits": x.float() @ table.float().T,
           "grad_x": (g @ table.float()).to(BF16),
           "grad_table": (g.T @ x.float()).to(BF16)}
    want = {"logits": xd @ td.T, "grad_x": gd @ td, "grad_table": gd.T @ xd}
    for op in got:
        assert got[op].dtype == lib[op].dtype, op
        e, e_lib = _err(got[op], want[op]), _err(lib[op], want[op])
        print(f"M={M} {op}: kernel {e:.3e}, torch f32 {e_lib:.3e}")
        assert e <= 2 * e_lib, (op, e, e_lib)
    # a repeated run is bit for bit: split-K adds its partials in order
    assert torch.equal(ug.grad_x(g, table), got["grad_x"])
    assert torch.equal(ug.logits(x, table), got["logits"])
    assert torch.equal(ug.grad_table(g, x), got["grad_table"])


def _pairs(rows, cols, gen, dev):
    """(rows, 2 cols) f32: column pairs (1 + r, -1), r ~ 2^-12: each pair's
    high terms cancel exactly, leaving r to the low terms."""
    rem = 2.0 ** -12 * torch.randn(rows, cols, generator=gen, device=dev)
    return torch.stack([1.0 + rem, -torch.ones_like(rem)],
                       dim=-1).reshape(rows, 2 * cols)


@pytest.mark.card
def test_a_cancelling_gradient_needs_the_low_terms(card):
    """g whose pairs of entries meet equal rows of the other operand and
    cancel down to a remainder 2^-12 small: the products are the low
    terms'. The kernels hold them as torch's f32 product does; g's high
    terms alone are far off."""
    M, V, d = 256, 4_096, 512
    gen = torch.Generator(device=card).manual_seed(3)
    table = torch.randn(V // 2, d, generator=gen, device=card).to(
        BF16).repeat_interleave(2, dim=0)
    x = torch.randn(M // 2, d, generator=gen, device=card).to(
        BF16).repeat_interleave(2, dim=0)
    g_x = _pairs(M, V // 2, gen, card)            # pairs along V, for dx
    g_t = _pairs(V, M // 2, gen, card).T.contiguous()   # along M, dtable
    for name, got, lib, hi, want in (
            ("dx", ug.grad_x(g_x, table), (g_x @ table.float()).to(BF16),
             (g_x.to(BF16).float() @ table.float()).to(BF16),
             g_x.double() @ table.double()),
            ("dtable", ug.grad_table(g_t, x), (g_t.T @ x.float()).to(BF16),
             (g_t.to(BF16).float().T @ x.float()).to(BF16),
             g_t.double().T @ x.double())):
        e, e_lib, e_hi = (_err(t, want) for t in (got, lib, hi))
        print(f"cancelling {name}: kernel {e:.3e}, torch f32 {e_lib:.3e}, "
              f"high terms alone {e_hi:.3e}")
        assert e <= 2 * e_lib and e_hi > 10 * e, name


@pytest.mark.card
def test_a_forward_and_backward_pass_launches_four_kernels(card):
    x, table, _ = _card_operands(7, 4_096, 256, card)
    x.requires_grad_(True)
    table.requires_grad_(True)
    before = ug.unembed_gemm.launches
    out, snap = _counted_unembed(x, table)
    out.square().sum().backward()
    assert ug.unembed_gemm.launches - before == 4
    assert snap == {"unembed.kernel_calls": 1}
    assert x.grad.dtype == table.grad.dtype == BF16


@pytest.mark.card
def test_a_minicpm_step_takes_the_kernel_path(card):
    """minicpm-2b (reduced, bf16, tied) forward and backward on the card:
    one kernel call, and the loss and gradients those of the same step
    through the plain ``x.to(f32) @ table.to(f32).T``: the loss within
    1e-4 of it relatively, each gradient within 2^-5 of its largest entry
    (bf16 gradients, rounded once in the unembedding and again in every
    layer below it)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config("minicpm-2b").reduced(),
                              dtype="bfloat16")
    model = build_model(cfg, device=card)
    params = model.init(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=card,
                         generator=torch.Generator(device=card).manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}

    def run():
        tel = obs.enable()
        try:
            loss, _, grads = steps._loss_and_grads(model.loss_fn, params,
                                                   batch)
        finally:
            obs.disable()
        return float(loss), grads, tel.metrics.snapshot()

    loss, grads, snap = run()
    assert snap["unembed.kernel_calls"] == 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "kernel_path", lambda x, t: False)
        loss_p, grads_p, snap_p = run()
    assert snap_p["unembed.plain_calls"] == 1
    print(f"loss {loss!r} against the plain path's {loss_p!r}")
    assert abs(loss - loss_p) <= 1e-4 * abs(loss_p)
    assert len(grads) == len(grads_p)
    for i, (g, g_p) in enumerate(zip(grads, grads_p)):
        want = g_p.double()
        scale = float(want.abs().max())
        e = float((g.double() - want).abs().max()) / (scale or 1.0)
        print(f"gradient {i} {tuple(g.shape)}: {e:.3e}")
        assert g.dtype == g_p.dtype and e <= 2.0 ** -5, (i, e)
