"""The tied unembedding's three products on the card: ``unembed_gemm``.

Replaces no TPU kernel: the reference leaves ``x @ table.T`` to XLA. On the
card it replaces the port's ``x.to(f32) @ table.to(f32).T`` and its autograd
backward, three full-f32 products on the CUDA cores, by bf16 tensor-core
passes that round no operand below what it holds (the CUDA C++ lives in
``src/repro_torch/csrc/unembed_gemm.cu``, whose header says why each pass
is exact, what bounds it on an H100 and what the design does about it). For
x (M, d) and table (V, d) bfloat16 and the logit gradient g (M, V) float32:

    logits = x . table^T   (M, V) float32     one bf16 pass
    dx     = g . table     (M, d) bfloat16    g split into three bf16 terms
    dtable = g^T . x       (V, d) bfloat16    the same split

`TiedUnembed` is the autograd Function around the three, which
`repro_torch.models.layers.unembed` takes for bf16 operands. Given CPU
(or meta) tensors each product computes its plain PyTorch version, the ops
autograd runs today for ``x.to(f32) @ table.to(f32).T`` (any float dtype);
given CUDA tensors it launches the kernel on the current stream and raises
if the launch failed, never falling back. ``unembed_gemm.launches`` counts
kernel launches: one for the logits, two for dx (the split-K product and
the sum of its partials), one for dtable.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.launch import aligned, check, on_card

__all__ = ["unembed_gemm", "TiedUnembed", "logits", "grad_x", "grad_table",
           "split3", "splits", "reset_launches", "library", "SOURCE", "OPS"]

SOURCE = "unembed_gemm.cu"
F32 = torch.float32
# op -> the work count's name (`kernels.work`)
OPS = {"logits": "unembed_logits", "grad_x": "unembed_grad_x",
       "grad_table": "unembed_grad_table"}
TILE_M, TILE_N, DEPTH = 128, 128, 64     # the gradients' tile and k-block
UNIT_COST = 8                            # a tile's fixed cost, in k-blocks
MAX_SPLITS = 32


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load(SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ug_logits.argtypes = [P, P, P, I, I, I, I, P]
    lib.ug_grad_x.argtypes = [P, P, P, P, I, I, I, I, I, P]
    lib.ug_grad_table.argtypes = [P, P, P, I, I, I, I, P]
    for fn in (lib.ug_logits, lib.ug_grad_x, lib.ug_grad_table):
        fn.restype = I
    lib.ug_error_string.argtypes = [I]
    lib.ug_error_string.restype = ctypes.c_char_p
    return lib


def reset_launches() -> None:
    unembed_gemm.launches = 0


def split3(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(hi, mid, lo), three bfloat16 tensors whose float32 sum is ``g``
    exactly (for |g| above 2^-110): each residual is exact in float32. The
    kernel splits its f32 tiles of g this way in registers."""
    hi = g.to(torch.bfloat16)
    r = g - hi.to(F32)
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.to(F32)).to(torch.bfloat16)


def splits(M: int, d: int, V: int, sms: int) -> int:
    """How many ranges of the vocabulary dx's product is split into: the
    count that fills the card's ``sms`` best, by waves of (M/128 x d/128 x
    splits) tiles times each tile's k-blocks plus its fixed cost; the
    fewest partials among equals."""
    tiles = -(-M // TILE_M) * -(-d // TILE_N)
    blocks = -(-V // DEPTH)

    def cost(s):
        return -(-tiles * s // sms) * (-(-blocks // s) + UNIT_COST)

    return min(range(1, max(1, min(MAX_SPLITS, blocks)) + 1),
               key=lambda s: (cost(s), s))


# -- the plain versions: the ops autograd runs for x.to(f32) @ t.to(f32).T --

def logits_plain(x, table):
    return x.to(F32).mm(table.to(F32).t())


def grad_x_plain(g, table):
    return g.mm(table.to(F32)).to(table.dtype)


def grad_table_plain(g, x):
    return g.t().mm(x.to(F32)).to(x.dtype)


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _card_operand(name: str, t: torch.Tensor, dtype) -> torch.Tensor:
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on the card, got {t.dtype}")
    return aligned(t.contiguous())


def unembed_gemm(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One of the three products: ``"logits"`` (a = x (M, d), b = table
    (V, d)), ``"grad_x"`` (a = g (M, V), b = table) or ``"grad_table"``
    (a = g, b = x). The logits come in float32, each gradient in b's
    dtype, rounded once from f32 sums (on the card b is bfloat16)."""
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor) or t.dim() != 2 \
                or not t.dtype.is_floating_point:
            raise ValueError(f"{name} must be a 2-d float tensor")
    if a.device != b.device:
        raise ValueError(f"b is on {b.device}, expected {a.device}")
    if op == "logits":
        (M, d), V = a.shape, b.shape[0]
        if b.shape[1] != d:
            raise ValueError(f"table must be (V, {d}), got {tuple(b.shape)}")
    else:
        M, V = a.shape
        d = b.shape[1]
        if a.dtype != F32:
            raise ValueError(f"g must be float32, got {a.dtype}")
        if b.shape[0] != (V if op == "grad_x" else M):
            raise ValueError(f"{op}: operand shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)} do not chain")
    dev = a.device
    out_shape, k = {"logits": ((M, V), d), "grad_x": ((M, d), V),
                    "grad_table": ((V, d), M)}[op]
    with work.scope(OPS[op], *out_shape, k=k):
        if not on_card(dev, "unembed_gemm"):
            if op == "logits":
                return logits_plain(a, b)
            if op == "grad_x":
                return grad_x_plain(a, b)
            return grad_table_plain(a, b)
        if d % 8 or V % 4:
            raise ValueError("the kernel reads rows of 16 bytes: d must be a "
                             f"multiple of 8 and V of 4, got d={d}, V={V}")
        if op == "logits":
            a = _card_operand("x", a, torch.bfloat16)
            b = _card_operand("table", b, torch.bfloat16)
            out = torch.empty(out_shape, dtype=F32, device=dev)
        else:
            a = _card_operand("g", a, F32)
            b = _card_operand("table" if op == "grad_x" else "x", b,
                              torch.bfloat16)
            out = torch.empty(out_shape, dtype=torch.bfloat16, device=dev)
        if out.numel() == 0:
            return out
        if k == 0:
            return out.zero_()
        lib = library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            sms = _sms(dev)
            if op == "logits":
                code = lib.ug_logits(a.data_ptr(), b.data_ptr(),
                                     out.data_ptr(), M, V, d, sms, stream)
                launched = 1
            elif op == "grad_x":
                s = splits(M, d, V, sms)
                part = torch.empty((s, M, d), dtype=F32, device=dev)
                code = lib.ug_grad_x(a.data_ptr(), b.data_ptr(),
                                     part.data_ptr(), out.data_ptr(), M, V,
                                     d, s, sms, stream)
                launched = 2     # the split-K product and its sum
            else:
                code = lib.ug_grad_table(a.data_ptr(), b.data_ptr(),
                                         out.data_ptr(), M, V, d, sms, stream)
                launched = 1
        check(code, "unembed_gemm", lib.ug_error_string)
        unembed_gemm.launches += launched
        return out


def logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(M, V) float32 logits of x (M, d) against table (V, d)."""
    return unembed_gemm("logits", x, table)


def grad_x(g: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """dx = g . table."""
    return unembed_gemm("grad_x", g, table)


def grad_table(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dtable = g^T . x."""
    return unembed_gemm("grad_table", g, x)


class TiedUnembed(torch.autograd.Function):
    """``x.to(f32) @ table.to(f32).T`` for x (..., d) and table (V, d),
    through `unembed_gemm`: saves x and table as they are (no f32 copy of
    the table), and rounds each gradient to its operand's dtype once."""

    @staticmethod
    def forward(ctx, x, table):
        ctx.save_for_backward(x, table)
        # autograd runs a CUDA backward on a thread of its own: the op
        # count the forward reports to goes along, so the backward's
        # products count on the card as on meta
        ctx.count = work.active()
        out = logits(x.reshape(-1, x.shape[-1]), table)
        return out.view(*x.shape[:-1], table.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dx = dtable = None
        with work.counting(ctx.count if ctx.count is not None
                           else work.active()):
            if ctx.needs_input_grad[0]:
                dx = grad_x(g2, table).to(x.dtype).view(x.shape)
            if ctx.needs_input_grad[1]:
                dtable = grad_table(g2, x.reshape(-1, x.shape[-1])).to(
                    table.dtype)
        return dx, dtable


reset_launches()
