#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) once on one NVIDIA
card, and check it.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. card      — require CUDA; print the card's name and power limit; TF32 off.
2. build     — compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a),
               one nvcc per source, all started together.
3. kernels   — hold ``round_stats``, ``round_update`` and ``dual_step``
               against their plain PyTorch versions at the main path's shape
               (m=64, n=10,000), the fused mode's largest (m=1024,
               n=65,536) and a ragged one (m=7, n=1,000) — ``round_update``
               on both paths: the main path's ring through its CSR form
               (sparse) and a dense softmax A (dense). With the ring A the
               sparse path must equal the dense one bit for bit at
               (64, 10,000) and (7, 1,000); two calls of a redesigned kernel
               on one input must agree bit for bit; ``round_stats`` must put
               one kernel and no memset on the card per call. Hold
               ``pdomd_update`` at (rows, 128) for rows = 5,000 (the paper's
               node stack), 262,144 and 8, and ``hinge_grad`` at
               (B, n) = (64, 10,112) (one round of the ring, n zero-padded
               to a multiple of 128), (99,968, 10,112) (the whole paper
               stream), (100, 384) (ragged), (256, 65,536) (too wide to
               stage in shared memory) and (1, 10,112) (the ops round's
               per-node launch). ``hinge_grad`` at (1, 10,112), (64, 10,112)
               and the whole stream must give the same bits on two calls;
               the two small batches must take the slab path and put one
               kernel and no memset on the card per call, the whole stream
               the row path. Time each kernel at its first shape by the
               profiler's device time, beside its bound (``round_update``
               with the ring through the sparse path, and on a line before
               it the dense path with the softmax A); ``hinge_grad`` also
               at (1, 10,112), and each small batch beside one
               ``torch.mv`` of the same x and w (a floor: one cuBLAS pass
               that reads x once).
4. main path — ``repro_torch.run`` at the paper's scale (m=64, n=10,000,
               T=1,562 rounds = 100,000 samples, social_sparse, ring,
               Laplace eps=1 coordinate, L2 clip 1, alpha0=1, lam=1e-3),
               fused ``backend="cuda"``, with regret; the fused kernels must
               have launched once per round. Then the device idle share of
               64 rounds (profiler busy time over the round loop's time).
5. agreement — the first 64 rounds on ``backend="reference"`` (torch ops)
               against the fused backend, same seed and generator.
6. hybrid    — 64 rounds with ``mode="hybrid"`` (torch-op mix, then
               ``dual_step``) against the fused run.
7. dist      — the main path's run on the distributed engine
               (``run(..., engine="dist")``, `GossipDP`): the fused kernels
               must launch once per round, and every field of its RunResult
               must equal the simulator's (phase 4) exactly.
8. ops       — one ring round at paper width through the pytree kernel ops:
               from a dist state at round 64, each node's hinge subgradient
               by ``ops.hinge_grad`` (64 launches of B = 1, all on its slab
               path), clipped, then ``ops.pdomd_update`` on
               the (rows, 128) tiles of theta~, its two ring neighbours and
               the gradient; held against the engine's own next state and
               primal (``GossipDP.update``, ``GossipDP.primal``).

Before the last line it prints one ``{"kernels": [...]}`` JSON line (time,
bound, plain-version time and launches of every kernel), and last
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import functools
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
KERNEL_TOL = 1e-5           # kernel vs plain version, float outputs
FLOAT_TOL = 5e-6            # the port's float contract between backends
MAIN_M, MAIN_N = 64, 10_000
KERNEL_SHAPES = ((MAIN_M, MAIN_N), (1024, 65_536), (7, 1_000))
BITWISE_SHAPES = ((MAIN_M, MAIN_N), (7, 1_000))   # sparse == dense, ring A
UPDATE_FLAGS = tuple(itertools.product((0, 1), (True, False)))
SOURCE = "src/repro_torch/csrc/round_fused.cu"
ROUND_KERNELS = ("round_stats", "round_update", "dual_step")
REPLACES = {
    "round_stats": "src/repro/kernels/round_fused.py:130",
    "round_update": "src/repro/kernels/round_fused.py:194",
    "round_update_dense": "src/repro/kernels/round_fused.py:194",
    "dual_step": "src/repro/kernels/round_fused.py:249",
    "pdomd_update": "src/repro/kernels/pdomd_update.py:49",
    "hinge_grad": "src/repro/kernels/hinge_grad.py:57",
}
SEED_SOURCES = {"pdomd_update": "src/repro_torch/csrc/pdomd_update.cu",
                "hinge_grad": "src/repro_torch/csrc/hinge_grad.cu"}
PAPER_T = 100_000 // MAIN_M                  # 1,562 rounds
N_PAD = -(-MAIN_N // 128) * 128              # 10,112: n to a multiple of 128
PDOMD_ROWS = (MAIN_M * MAIN_N // 128, 262_144, 8)
HINGE_SHAPES = ((MAIN_M, N_PAD), (PAPER_T * MAIN_M, N_PAD), (100, 384),
                (256, 65_536), (1, N_PAD))
HINGE_SMALL = ((1, N_PAD), (MAIN_M, N_PAD))      # hinge_grad's slab path
HINGE_BITWISE = (*HINGE_SMALL, (PAPER_T * MAIN_M, N_PAD))
L2_BYTES = 50e6
PROFILER_TRIES = 5          # profiler sessions tried before giving up
SLEEP_CYCLES = 20_000_000   # ~11 ms at 1.98 GHz: the host queues meanwhile


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- 1. card -----------------------------------------------------------------

def card_check():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script needs one CUDA card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run it from the repository root "
                         f"(no {SRC / 'repro_torch'} here)")
    sys.path.insert(0, str(SRC))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"card: {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | TF32 off")
    log(smi)
    return name, smi


# -- 2. build ----------------------------------------------------------------

def build_phase() -> float:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build(*sorted(p.name for p in build.CSRC.glob("*.cu")))
    secs = time.perf_counter() - t0
    for lib in libs:
        ptxas = [ln for ln in lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"built {lib.name}: " + " | ".join(ln.strip() for ln in ptxas))
    from repro_torch.kernels import hinge_grad, pdomd_update, round_fused
    for module in (round_fused, pdomd_update, hinge_grad):
        module.library()
    log(f"build: {secs:.1f} s")
    return secs


# -- 3. kernels --------------------------------------------------------------

def _inputs(m: int, n: int, seed: int, dev):
    """Random round inputs, a dense softmax A and the main path's ring
    (its dense A, self weights and CSR form)."""
    import torch
    from repro_torch.core.graph import ring_edges
    from repro_torch.kernels.round_fused import MixCSR
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    A = torch.softmax(randn(m, m), dim=1)   # dense row-stochastic mix
    alive = torch.ones(m, device=dev)
    alive[m // 2] = 0.0                      # one crash-frozen row
    ring = ring_edges(m)
    return dict(theta=randn(m, n), x=randn(m, n) / math.sqrt(n),
                delta=0.1 * randn(m, n), recv=randn(m, n),
                mixed=randn(m, n), coeff=randn(m), A=A,
                diag=A.diagonal().contiguous(), alive=alive,
                ring_A=torch.as_tensor(ring.to_dense(), device=dev),
                ring_diag=torch.as_tensor(ring.diag(), device=dev),
                ring_csr=MixCSR.from_graph(ring, dev))


def _update_args(d, mix: str, use_recv=0, noise_self=True) -> tuple:
    """round_update's positional arguments with the ring's or the softmax
    A."""
    A, diag = (d["ring_A"], d["ring_diag"]) if mix == "ring" \
        else (d["A"], d["diag"])
    return (A, d["theta"], d["delta"], d["x"], d["recv"], d["coeff"], diag,
            d["alive"], 0.25, use_recv, noise_self)


def _calls(rf, d, use_recv=0, noise_self=True):
    """(kernel call, plain call) per kernel on one input set:
    ``round_update`` mixes with the main path's ring through the sparse
    path (its CSR form), ``round_update_dense`` with the softmax A through
    the dense path."""
    stats = (d["theta"], d["x"], 0.5, d["theta"].shape[0])
    ring = _update_args(d, "ring", use_recv, noise_self)
    dense = _update_args(d, "softmax", use_recv, noise_self)
    dual = (d["mixed"], d["x"], d["theta"], d["coeff"], d["alive"], 0.25)
    return {
        "round_stats": (lambda: rf.round_stats(*stats),
                        lambda: rf.round_stats_plain(*stats)),
        "round_update": (lambda: rf.round_update(*ring, csr=d["ring_csr"]),
                         lambda: rf.round_update_plain(*ring)),
        "round_update_dense": (lambda: rf.round_update(*dense),
                               lambda: rf.round_update_plain(*dense)),
        "dual_step": (lambda: rf.dual_step(*dual),
                      lambda: rf.dual_step_plain(*dual)),
    }


# outputs that are sums over a node's row or a column (round_stats' four
# float outputs; round_update's next, through A @ r) — see _compare
REDUCED = {"round_stats": (0, 1, 3, 4), "round_update": (0,),
           "round_update_dense": (0,), "dual_step": (), "pdomd_update": (),
           "hinge_grad": (0, 1, 2)}
REDESIGNED = ("round_stats", "round_update", "round_update_dense")


def _compare(name, got, want, where) -> float:
    """Max abs difference of a kernel's outputs from its plain version's.

    nnz must match exactly. Elementwise outputs are held to
    |kernel - plain| <= 1e-5 + 1e-5 * |plain| per element. A reduced
    output is a sum of up to 65,536 terms taken in another order than the
    plain version's, and cancellation leaves some sums near zero, where an
    elementwise relative bound means nothing: those are held to 1e-5
    relative to the output's largest magnitude (norm-wise, as BLAS tests
    hold products), |kernel - plain| <= 1e-5 * max(1, max |plain|).
    """
    import torch
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for k, (a, b) in enumerate(zip(got, want)):
        require(a.shape == b.shape and a.dtype == b.dtype,
                f"{name} output {k} at {where}: {a.shape}/{a.dtype} vs "
                f"{b.shape}/{b.dtype}")
        if a.dtype == torch.int32:           # nnz: exact
            require(torch.equal(a, b), f"{name} nnz differs at {where}")
            continue
        require(bool(torch.isfinite(a).all()), f"{name} output {k} not "
                f"finite at {where}")
        diff = (a - b).abs()
        if k in REDUCED[name]:
            bound = KERNEL_TOL * max(1.0, float(b.abs().max()))
            bad = diff > bound
        else:
            bad = diff > KERNEL_TOL + KERNEL_TOL * b.abs()
        require(not bool(bad.any()), f"{name} output {k} at {where}: max "
                f"abs diff {float(diff.max())} beyond the 1e-5 tolerance")
        err = max(err, float(diff.max()))
    return err


def _call_ms(fn, reps: int = 50, repeats: int = 7) -> float:
    """Median over ``repeats`` of the mean time per call of ``reps``
    back-to-back calls, by CUDA events: the card's time per call when the
    host issues calls as fast as it can (host overhead included)."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def _profiled(fn, reps: int) -> list:
    """The device events (kernels, memsets, copies) of one profiler session
    over ``reps`` calls of ``fn``. The CUDA activity trace now and then
    hands back a session with no device event at all, while the calls did
    run; such a session is taken again, up to PROFILER_TRIES times. Returns
    [] if every try came back empty."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILER_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA]
        if events:
            return events
        log(f"profiler session {attempt} of {PROFILER_TRIES} recorded no "
            "device event")
    return []


def _queued_ms(fn, reps: int, repeats: int) -> float:
    """Median over ``repeats`` of the time per call of ``reps`` calls that
    the host queues behind a sleeping kernel, by CUDA events: the calls run
    back to back without the host's launch gaps, but with the card's own
    gaps between kernels, so it reads a little above the profiler's sum."""
    import torch
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def _device_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the device time per call: the summed
    durations of the kernels (and memsets) a call puts on the card, from
    the profiler's device events — the time the card spends on the call's
    work, without the host's launch gaps. Where the profiler records no
    device event in any try, the time is taken by ``_queued_ms`` instead,
    and the log says so."""
    import torch
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        events = _profiled(fn, reps)
        if not events:
            ms = _queued_ms(fn, reps, repeats)
            log(f"device time by CUDA events over queued calls (the "
                f"profiler recorded nothing): {ms * 1e3:.2f} us per call")
            return ms
        samples.append(sum(e.time_range.elapsed_us() for e in events)
                       / reps / 1e3)
    return statistics.median(samples)


def _work(name: str, m: int, n: int, nnz: int | None = None
          ) -> tuple[int, int]:
    """(bytes, flops) the function needs at the main path's flags: each
    input read once, each output written once. For ``round_update`` the
    mix is the dense (m, m) A (m^2 floats in, 2 m^2 n flops) unless ``nnz``
    is given: then A's CSR form with nnz non-zeros (m + 1 + 2 nnz words
    in, 2 nnz n flops) — the ring's 3 m at the main path."""
    mn = m * n
    if name == "round_stats":      # theta, x in; dot, xsq, nnz, wbdot, wsum
        return 4 * (2 * mn + 4 * m + n), 12 * mn
    if name.startswith("round_update"):   # A, theta, delta, x, coeff, diag,
        a_words, mix_flops = ((m * m, 2 * m * m * n) if nnz is None  # alive
                              else (m + 1 + 2 * nnz, 2 * nnz * n))   # in;
        return (4 * (a_words + 3 * mn + 3 * m + 2 * mn),  # next, tilde out
                mix_flops + 8 * mn)
    if name == "pdomd_update":     # four (rows, 128) in; w, theta_new out
        return 4 * 6 * mn, 10 * mn
    if name == "hinge_grad":       # x, y, w in; loss, margin, g out
        return 4 * (mn + 3 * m + 2 * n), 4 * mn
    return 4 * (3 * mn + 2 * m + mn), 3 * mn   # dual_step


def _rotate(fns):
    """One call per invocation, cycling over ``fns`` (input sets)."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def _measure(name: str, kern, plain, m: int, n: int, err: float,
             source: str, card: str, nnz: int | None = None) -> dict:
    """Time a kernel (lists of calls over rotating input sets) and its plain
    version at shape (m, n); the kernels line's entry for it."""
    ms = _device_ms(_rotate(kern))
    plain_ms = _device_ms(_rotate(plain))
    call_ms = _call_ms(_rotate(kern))
    nbytes, flops = _work(name, m, n, nnz)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    bound_ms = max(t_bytes, t_ops) * 1e3
    entry = dict(
        name=name, route="cuda", source=source, replaces=REPLACES[name],
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=None, call_ms=call_ms)
    label = {"round_update": "round_update (ring A, sparse path)",
             "round_update_dense": "round_update (softmax A, dense path)"}
    log(f"kernel {label.get(name, name)}: {ms * 1e3:.2f} us device time "
        f"(median) at "
        f"{m}x{n} | {nbytes / 1e6:.2f} MB, bound {bound_ms * 1e3:.2f} us at "
        f"3.35 TB/s ({entry['bound_by']}) | plain version "
        f"{plain_ms * 1e3:.2f} us device time | {call_ms * 1e3:.2f} us per "
        f"back-to-back wrapper call (host included) | max abs err "
        f"{err:.3g} | {card}")
    return entry


def _device_events(fn, reps: int = 5) -> list[str]:
    """Names of the device events (kernels, memsets, copies) that ``reps``
    calls of ``fn`` put on the card, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = _profiled(fn, reps)
    require(bool(events), f"the profiler recorded no device event in "
            f"{PROFILER_TRIES} sessions")
    return [e.name for e in events]


def kernel_checks(card: str) -> dict:
    """Hold each round kernel against its plain version at every shape of
    KERNEL_SHAPES and flag set; the redesigned ones also against a second
    call on the same input (bit for bit: no float atomics), and the sparse
    ``round_update`` against the dense one with the ring A (bit for bit).
    Returns each kernel's largest difference from its plain version."""
    import torch
    from repro_torch.kernels import round_fused as rf
    dev = torch.device("cuda")
    errs = {k: 0.0 for k in (*ROUND_KERNELS, "round_update_dense")}
    for m, n in KERNEL_SHAPES:
        d = _inputs(m, n, seed=m * 7919 + n, dev=dev)
        for use_recv, noise_self in UPDATE_FLAGS:
            where = (f"m={m} n={n} use_recv={use_recv} "
                     f"noise_self={noise_self}")
            calls = _calls(rf, d, use_recv, noise_self)
            for name, (kern, plain) in calls.items():
                if not name.startswith("round_update") and (
                        use_recv or not noise_self):
                    continue
                got = kern()
                errs[name] = max(errs[name], _compare(name, got, plain(),
                                                      where))
                if name in REDESIGNED:
                    again = kern()
                    require(all(torch.equal(a, b)
                                for a, b in zip(got, again)),
                            f"{name}: two calls on one input differ at "
                            f"{where}")
            if (m, n) in BITWISE_SHAPES:
                sparse = calls["round_update"][0]()
                dense = rf.round_update(*_update_args(d, "ring", use_recv,
                                                      noise_self))
                require(all(torch.equal(a, b) for a, b in zip(sparse, dense)),
                        f"round_update: sparse and dense paths differ with "
                        f"the ring A at {where}")
        del d, calls
        torch.cuda.synchronize()
        log(f"kernels agree with their plain versions at m={m}, n={n}"
            + ("; round_update sparse == dense bit for bit with the ring A"
               if (m, n) in BITWISE_SHAPES else "")
            + "; two calls of each redesigned kernel equal bit for bit")
    d = _inputs(MAIN_M, MAIN_N, seed=1, dev=dev)
    calls = _calls(rf, d)
    for name in ("round_stats", "round_update"):
        names = _device_events(calls[name][0])
        require(len(names) == 5 and not any("emset" in e for e in names),
                f"{name}: 5 calls put {len(names)} device events on the "
                f"card: {sorted(set(names))}")
        log(f"{name}: one kernel per call, no memset ({names[0][:60]})")
    del d, calls
    torch.cuda.empty_cache()
    return errs


def kernel_phase(card: str):
    """Hold each kernel against its plain version; time it. Returns the
    per-kernel measurements (launch counts are filled in later)."""
    import torch
    from repro_torch.kernels import round_fused as rf
    dev = torch.device("cuda")
    errs = kernel_checks(card)

    # time at the main path's shape, rotating over input sets that together
    # exceed the 50 MB L2, so every launch reads its inputs from HBM
    sets = [_inputs(MAIN_M, MAIN_N, seed=s, dev=dev) for s in range(10)]
    ring_nnz = sets[0]["ring_csr"].indices.numel()
    results = {}
    for name in ("round_stats", "round_update_dense", "round_update",
                 "dual_step"):
        results[name] = _measure(
            name, [_calls(rf, d)[name][0] for d in sets],
            [_calls(rf, d)[name][1] for d in sets], MAIN_M, MAIN_N,
            errs[name], SOURCE, card,
            nnz=ring_nnz if name == "round_update" else None)
    dense = results.pop("round_update_dense")
    results["round_update"]["dense_path"] = {
        k: dense[k] for k in ("ms", "plain_ms", "bound_ms", "call_ms",
                              "max_abs_err")}
    del sets
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def _pdomd_inputs(rows: int, seed: int, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn((rows, 128), generator=g, device=dev)
            for _ in range(4)]


def _hinge_inputs(B: int, n: int, seed: int, dev):
    """x (B, n) with features ~ N(0, 1/n) (the stream's feature scale),
    zero past MAIN_N when n is the padded paper width N_PAD; labels +-1;
    w ~ N(0, 1), so the margins straddle 1."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((B, n), generator=g, device=dev) / math.sqrt(n)
    if n == N_PAD:
        x[:, MAIN_N:] = 0.0
    y = torch.where(torch.rand(B, generator=g, device=dev) < 0.5, -1.0, 1.0)
    return x, y, torch.randn(n, generator=g, device=dev)


def _paper_stream_batch(dev):
    """The whole paper stream as one (99,968, 10,112) batch — the regret
    comparator's full batch, its features zero-padded to a multiple of 128
    — labels from the stream, and a random w of the padded width."""
    import torch
    stream = paper_spec().resolve_stream(device=dev)
    x = torch.zeros((PAPER_T * MAIN_M, N_PAD), device=dev)
    y = torch.empty(PAPER_T * MAIN_M, device=dev)
    for a in range(0, PAPER_T, 256):
        b = min(a + 256, PAPER_T)
        xs, ys = stream.chunk(a, b)
        x[a * MAIN_M:b * MAIN_M, :MAIN_N] = xs.reshape(-1, MAIN_N)
        y[a * MAIN_M:b * MAIN_M] = ys.reshape(-1)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    w = torch.randn(N_PAD, generator=g, device=dev)
    w[MAIN_N:] = 0.0
    return x, y, w


def seed_kernel_phase(card: str) -> dict:
    """Hold ``pdomd_update`` and ``hinge_grad`` against their plain versions
    at every shape of PDOMD_ROWS and HINGE_SHAPES; time each at its first
    shape. Zero-padded feature columns must get a gradient of exactly 0."""
    import torch
    from repro_torch.kernels import hinge_grad as hg
    from repro_torch.kernels import pdomd_update as pu
    dev = torch.device("cuda")
    err = {"pdomd_update": 0.0, "hinge_grad": 0.0}
    for rows in PDOMD_ROWS:
        args = _pdomd_inputs(rows, seed=rows, dev=dev)
        for alpha, lam in ((0.05, 0.02), (0.0, 0.8)):
            err["pdomd_update"] = max(err["pdomd_update"], _compare(
                "pdomd_update", pu.pdomd_update(*args, alpha, lam),
                pu.pdomd_update_plain(*args, alpha, lam),
                f"rows={rows} alpha={alpha} lam={lam}"))
        del args
        log(f"pdomd_update agrees with its plain version at ({rows}, 128)")
    for B, n in HINGE_SHAPES:
        if B == PAPER_T * MAIN_M:
            x, y, w = _paper_stream_batch(dev)
        else:
            x, y, w = _hinge_inputs(B, n, seed=B + n, dev=dev)
        slabs = hg.hinge_grad.slab_launches
        got = hg.hinge_grad(x, y, w)
        path = "slab" if hg.hinge_grad.slab_launches > slabs else "row"
        err["hinge_grad"] = max(err["hinge_grad"], _compare(
            "hinge_grad", got, hg.hinge_grad_plain(x, y, w), f"B={B} n={n}"))
        if n == N_PAD:
            require(not bool(got[1][MAIN_N:].any()),
                    f"hinge_grad at B={B}: zero-padded columns got a "
                    "non-zero gradient")
        checked = ""
        if (B, n) in HINGE_BITWISE:
            require(path == ("slab" if (B, n) in HINGE_SMALL else "row"),
                    f"hinge_grad at B={B} n={n} took the {path} path")
            again = hg.hinge_grad(x, y, w)
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"hinge_grad: two calls on one input differ at B={B} "
                    f"n={n}")
            checked = "; two calls equal bit for bit"
            del again
        if (B, n) in HINGE_SMALL:
            names = _device_events(lambda: hg.hinge_grad(x, y, w))
            require(len(names) == 5 and not any("emset" in e for e in names),
                    f"hinge_grad at B={B}: 5 calls put {len(names)} device "
                    f"events on the card: {sorted(set(names))}")
            checked += "; one kernel per call, no memset"
        active = float((got[2] < 1).float().mean())
        if B == PAPER_T * MAIN_M:       # the one-read design's real size
            full = dict(
                full_batch_ms=_device_ms(lambda: hg.hinge_grad(x, y, w),
                                         reps=3, repeats=3),
                full_batch_plain_ms=_device_ms(
                    lambda: hg.hinge_grad_plain(x, y, w), reps=3,
                    repeats=3),
                full_batch_bound_ms=_work("hinge_grad", B, n)[0]
                / HBM_BYTES_PER_S * 1e3)
            log(f"hinge_grad over the whole paper stream ({B}x{n}): "
                f"{full['full_batch_ms']:.3f} ms device time, bound "
                f"{full['full_batch_bound_ms']:.3f} ms, plain version "
                f"{full['full_batch_plain_ms']:.3f} ms | {card}")
        del x, y, w, got
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        log(f"hinge_grad agrees with its plain version at B={B}, n={n} "
            f"(active share {active:.3f}, {path} path{checked})")

    results = {}
    rows = PDOMD_ROWS[0]
    nbytes = _work("pdomd_update", rows, 128)[0]
    sets = [_pdomd_inputs(rows, seed=s, dev=dev)
            for s in range(max(10, math.ceil(3 * L2_BYTES / nbytes)))]
    results["pdomd_update"] = _measure(
        "pdomd_update",
        [functools.partial(pu.pdomd_update, *a, 0.05, 0.02) for a in sets],
        [functools.partial(pu.pdomd_update_plain, *a, 0.05, 0.02)
         for a in sets], rows, 128, err["pdomd_update"],
        SEED_SOURCES["pdomd_update"], card)
    B, n = HINGE_SHAPES[0]
    nbytes = _work("hinge_grad", B, n)[0]
    sets = [_hinge_inputs(B, n, seed=s, dev=dev)
            for s in range(max(10, math.ceil(3 * L2_BYTES / nbytes)))]
    results["hinge_grad"] = _measure(
        "hinge_grad", [functools.partial(hg.hinge_grad, *a) for a in sets],
        [functools.partial(hg.hinge_grad_plain, *a) for a in sets], B, n,
        err["hinge_grad"], SEED_SOURCES["hinge_grad"], card)
    results["hinge_grad"].update(full)
    del sets
    results["hinge_grad"].update(_hinge_small_timing(
        err["hinge_grad"], card))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


def _hinge_small_timing(err: float, card: str) -> dict:
    """``hinge_grad``'s small batches: at (1, 10,112), the ops round's
    launch shape, its device time, bound and plain version (the ``b1_*``
    keys of the hinge_grad entry), and at both small batches the device
    time of one ``torch.mv(x, w)`` (a floor, not the function: it reads x
    once and computes only x @ w)."""
    import torch
    from repro_torch.kernels import hinge_grad as hg
    dev = torch.device("cuda")
    out = {}
    for B, n in HINGE_SMALL:
        nbytes = _work("hinge_grad", B, n)[0]
        sets = [_hinge_inputs(B, n, seed=s, dev=dev)
                for s in range(max(10, math.ceil(3 * L2_BYTES / nbytes)))]
        key = "" if B == MAIN_M else f"b{B}_"
        if B != MAIN_M:
            entry = _measure(
                "hinge_grad",
                [functools.partial(hg.hinge_grad, *a) for a in sets],
                [functools.partial(hg.hinge_grad_plain, *a) for a in sets],
                B, n, err, SEED_SOURCES["hinge_grad"], card)
            out.update({key + k: entry[k] for k in ("ms", "plain_ms",
                                                    "bound_ms", "call_ms")})
        mv = _device_ms(_rotate([functools.partial(torch.mv, a[0], a[2])
                                 for a in sets]))
        out[key + "mv_floor_ms"] = mv
        log(f"torch.mv(x, w) at {B}x{n}: {mv * 1e3:.2f} us device time "
            f"(hinge_grad's floor) | {card}")
        del sets
    return out


# -- 4-6. the port's run -----------------------------------------------------

DEVICE = "cuda"
AGREE_ROUNDS = 64


def paper_spec(**kw):
    """The paper's §V run (configs/social_linear.py at
    benchmarks/common.py::Scale.paper) on the fused backend."""
    from repro_torch import RunSpec
    base = dict(nodes=MAIN_M, dim=MAIN_N, horizon=PAPER_T,
                stream="social_sparse", mixer="ring", mechanism="laplace",
                eps=1.0, calibration="coordinate", clip_norm=1.0,
                alpha0=1.0, schedule="sqrt_t", lam=1e-3, seed=0,
                backend="cuda")
    base.update(kw)
    return RunSpec(**base)


def _hold(ref, got, what: str, card: str) -> None:
    """Hold run ``got`` to run ``ref`` over their first AGREE_ROUNDS
    rounds: correct, sparsity and eps_ledger exact; final_w, loss and
    w_bar_loss within FLOAT_TOL. Logs every field's max difference first."""
    import numpy as np
    d = {f: float(np.abs(np.asarray(getattr(got, f))[:AGREE_ROUNDS]
                         - np.asarray(getattr(ref, f))[:AGREE_ROUNDS]).max())
         for f in ("correct", "sparsity", "eps_ledger", "loss",
                   "w_bar_loss")}
    d["final_w"] = float(np.abs(got.final_w - ref.final_w).max())
    log(f"{what}, {AGREE_ROUNDS} rounds, max abs differences: {d} | {card}")
    for f in ("correct", "sparsity", "eps_ledger"):
        require(d[f] == 0, f"{what}: {f} differs")
    for f in ("final_w", "loss", "w_bar_loss"):
        require(d[f] <= FLOAT_TOL, f"{what}: {f} off by {d[f]}")


def main_path(card: str):
    import numpy as np
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf

    spec = paper_spec()
    T = spec.horizon
    # warmup=False: the kernels were built and loaded in phase 2, and a
    # warm-up round would add one launch to each count
    cfg = ExecConfig(chunk_rounds=256, compute_regret=True, warmup=False)
    rf.reset_launches()
    t0 = time.perf_counter()
    res = run(spec, exec=cfg, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = {k: getattr(rf, k).launches for k in ROUND_KERNELS}
    sparse = rf.round_update.sparse_launches
    log(f"main path: {T} rounds, run() {wall:.2f} s with regret; round "
        f"loop {res.wall_clock:.3f} s = {res.rounds_per_sec:.1f} rounds/s; "
        f"launches {launches}, round_update's sparse path {sparse} | {card}")
    require(launches["round_stats"] == T and launches["round_update"] == T
            and sparse == T,
            f"fused kernels launched {launches} ({sparse} sparse), expected "
            f"{T} each, every round_update on the sparse path")
    launches["round_update_sparse"] = sparse
    for f in ("final_w", "loss", "w_bar_loss", "sparsity", "regret"):
        v = np.asarray(getattr(res, f))
        require(bool(np.isfinite(v).all()), f"main path: {f} not finite")
    require(res.final_w.shape == (MAIN_M, MAIN_N), "final_w shape")
    require(res.correct.shape == (T, MAIN_M), "correct shape")
    require(res.regret.shape == (T,), "regret shape")
    require(float(res.eps_ledger[-1]) == 1.0,
            f"eps_ledger[-1] = {res.eps_ledger[-1]}, expected 1.0 "
            "(parallel composition)")
    log(f"main path: accuracy {res.accuracy:.4f} (last 20% of rounds), "
        f"final sparsity {float(res.sparsity[-1]):.6g}, regret[-1] "
        f"{float(res.regret[-1]):.1f}, eps {float(res.eps_ledger[-1])}")
    return res, launches


def idle_share(card: str) -> None:
    """Device idle share of 64 fused rounds: the profiler's device busy
    time over the round loop's time in an unprofiled run of the same
    rounds (stream generation included in both)."""
    from repro_torch import ExecConfig, run
    spec = paper_spec(horizon=AGREE_ROUNDS)
    cfg = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                     warmup=False)
    run(spec, exec=cfg, device=DEVICE)      # allocator and caches warm
    loop_us = run(spec, exec=cfg, device=DEVICE).wall_clock * 1e6
    busy_us = sum(e.time_range.elapsed_us() for e in _profiled(
        lambda: run(spec, exec=cfg, device=DEVICE), reps=1))
    if busy_us <= 0:
        log("device idle share: not measured (the profiler saw no device "
            "time)")
        return
    log(f"device busy {busy_us / 1e3:.3f} ms of a {loop_us / 1e3:.3f} ms "
        f"round loop over {AGREE_ROUNDS} fused rounds: idle share "
        f"{max(0.0, 1 - busy_us / loop_us):.3f} | {card}")


def agreement_phase(main, card: str):
    """The fused backend's first 64 rounds again (bit-identical to the main
    run's), then the reference backend on the same spec and seed."""
    import numpy as np
    from repro_torch import ExecConfig, run
    cfg = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                     warmup=False)
    spec = paper_spec(horizon=AGREE_ROUNDS)
    fused = run(spec, exec=cfg, device=DEVICE)
    for f in ("correct", "sparsity", "loss", "w_bar_loss"):
        require(np.array_equal(np.asarray(getattr(fused, f)),
                               np.asarray(getattr(main, f))[:AGREE_ROUNDS]),
                f"fused rerun of 64 rounds: {f} differs from the main run")
    ref = run(spec.replace(backend="reference"), exec=cfg, device=DEVICE)
    _hold(fused, ref, "reference vs fused backend", card)
    return fused


def hybrid_phase(fused, card: str) -> int:
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    cfg = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                     warmup=False)
    spec = paper_spec(horizon=AGREE_ROUNDS,
                      backend_options={"mode": "hybrid"})
    rf.reset_launches()
    hyb = run(spec, exec=cfg, device=DEVICE)
    launched = rf.dual_step.launches
    log(f"hybrid path: launches round_stats {rf.round_stats.launches}, "
        f"round_update {rf.round_update.launches}, dual_step {launched}")
    require(launched == AGREE_ROUNDS and rf.round_update.launches == 0,
            f"hybrid run: dual_step launched {launched}, expected "
            f"{AGREE_ROUNDS}, and round_update not at all")
    _hold(fused, hyb, "hybrid vs fused", card)
    return launched


def dist_phase(sim, card: str) -> dict:
    """The main path's run on the distributed engine: the fused kernels
    launch once per round, and its RunResult equals the simulator's field
    by field, exactly (wall-clock fields and the engine's name aside)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    spec = paper_spec()
    T = spec.horizon
    cfg = ExecConfig(chunk_rounds=256, compute_regret=True, warmup=False)
    rf.reset_launches()
    dist = run(spec, engine="dist", exec=cfg, device=DEVICE)
    launches = {k: getattr(rf, k).launches for k in ROUND_KERNELS}
    log(f"dist path: {T} rounds, round loop {dist.wall_clock:.3f} s = "
        f"{dist.rounds_per_sec:.1f} rounds/s (sim, phase 4: "
        f"{sim.rounds_per_sec:.1f} rounds/s); launches {launches} | {card}")
    require(launches == {"round_stats": T, "round_update": T,
                         "dual_step": 0}
            and rf.round_update.sparse_launches == T,
            f"dist run launched {launches} ({rf.round_update.sparse_launches}"
            f" sparse), expected {T} fused launches each, round_update on "
            "the sparse path")
    skip = {"engine", "wall_clock", "rounds_per_sec", "final_state"}
    for f in dataclasses.fields(dist):
        if f.name in skip:
            continue
        a, b = getattr(dist, f.name), getattr(sim, f.name)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b)
        require(bool(same), f"dist vs sim: {f.name} differs")
    st, sst = dist.final_state, sim.final_state
    require(st.t == sst.t and torch.equal(st.theta["w"], sst.theta)
            and torch.equal(st.generator.get_state(),
                            sst.generator.get_state()),
            "dist vs sim: final engine state differs")
    log(f"dist vs sim: every RunResult field and the final state equal, "
        f"bit for bit, over {T} rounds")
    # the two engines' speed in turns (sim, dist, dist, sim), 256 rounds
    # each: one sample apiece above is within the host's noise
    short = spec.replace(horizon=256)
    cfg = cfg.replace(chunk_rounds=256, compute_regret=False)
    rates = {"sim": [], "dist": []}
    for engine in ("sim", "dist", "dist", "sim"):
        rates[engine].append(run(short, engine=engine, exec=cfg,
                                 device=DEVICE).rounds_per_sec)
    log(f"rounds/s over 256 rounds in turns sim, dist, dist, sim: "
        f"sim {rates['sim']}, dist {rates['dist']} | {card}")
    return launches


def ops_phase(card: str) -> dict:
    """One ring round at paper width through the pytree kernel ops, held
    against the distributed engine's own round (see module docstring).
    Returns the ops' launch counts in that round."""
    import torch
    from repro_torch import ExecConfig, ops, run
    from repro_torch.core.algorithm1 import hinge_loss_and_grad
    from repro_torch.kernels import hinge_grad as hg
    from repro_torch.kernels import pdomd_update as pu
    spec = paper_spec()
    t = AGREE_ROUNDS
    state = run(spec, engine="dist", horizon=t,
                exec=ExecConfig(chunk_rounds=t, compute_regret=False,
                                warmup=False), device=DEVICE).final_state
    require(state.t == t, f"dist state at round {state.t}, expected {t}")
    gdp = spec.build_distributed()
    xs, ys = spec.resolve_stream(device=DEVICE).chunk(t, t + 1)
    x, y = xs[0], ys[0]
    ctx = gdp.omd.step_context(t + 1)
    lam_next = gdp.omd.step_context(t + 2).lam_t
    # the round's theta~: the noise the engine will draw, from a copy of
    # its generator
    gen = torch.Generator(device=DEVICE)
    gen.set_state(state.generator.get_state())
    theta = state.theta["w"]
    tilde = theta + gdp.mechanism.sample(
        gen, tuple(theta.shape), gdp.mechanism.scale(ctx.alpha_t, MAIN_N))
    w = gdp.primal(state)["w"]
    loss_e, grad_e = hinge_loss_and_grad(w, x, y)
    nxt, _ = gdp.update(state, {"w": grad_e})      # mix, then dual step

    hg.reset_launches()
    pu.reset_launches()
    pad = lambda a: torch.nn.functional.pad(a, (0, N_PAD - MAIN_N))  # noqa
    xp, wp = pad(x), pad(w)
    outs = [ops.hinge_grad(xp[i:i + 1], y[i:i + 1], wp[i])
            for i in range(MAIN_M)]           # each node's batch of one
    loss = torch.cat([o[0] for o in outs])
    grad = torch.stack([o[1] for o in outs])
    require(not bool(grad[:, MAIN_N:].any()),
            "ops: zero-padded columns got a non-zero gradient")
    g, _ = gdp.clipper.clip({"w": grad[:, :MAIN_N].contiguous()})
    like = {"w": tilde}
    w_t, th_t = ops.pdomd_update(
        ops.tree_to_tiles(like),
        ops.tree_to_tiles({"w": torch.roll(tilde, 1, dims=0)}),
        ops.tree_to_tiles({"w": torch.roll(tilde, -1, dims=0)}),
        ops.tree_to_tiles(g), ctx.alpha_t, lam_next)
    theta_new = ops.tiles_to_tree(th_t, like)["w"]
    w_new = ops.tiles_to_tree(w_t, like)["w"]
    launches = {"hinge_grad": hg.hinge_grad.launches,
                "pdomd_update": pu.pdomd_update.launches}
    slab = hg.hinge_grad.slab_launches
    d = {"loss": float((loss - loss_e).abs().max()),
         "grad": float((grad[:, :MAIN_N] - grad_e).abs().max()),
         "theta_next": float((theta_new - nxt.theta["w"]).abs().max()),
         "w_next": float((w_new - gdp.primal(nxt)["w"]).abs().max())}
    log(f"ops path: one ring round at m={MAIN_M}, n={MAIN_N} "
        f"({tuple(th_t.shape)} tiles), round {t + 1}; launches {launches} "
        f"(hinge_grad's slab path {slab}); "
        f"max abs differences from the engine's round: {d} | {card}")
    require(launches == {"hinge_grad": MAIN_M, "pdomd_update": 1}
            and slab == MAIN_M,
            f"ops path launched {launches} ({slab} on hinge_grad's slab "
            f"path), expected {MAIN_M} hinge_grad launches, all on the slab "
            "path, and one pdomd_update")
    launches["hinge_grad_slab"] = slab
    for k, v in d.items():
        require(v <= FLOAT_TOL, f"ops path: {k} off by {v}")
    return launches


PATHS = {"round_stats": "main", "round_update": "main", "dual_step": "hybrid",
         "pdomd_update": "ops", "hinge_grad": "ops"}


def main() -> int:
    card, smi = card_check()
    import torch
    build_phase()
    kernels = kernel_phase(card)
    kernels.update(seed_kernel_phase(card))
    main_res, launches = main_path(card)
    idle_share(card)
    fused = agreement_phase(main_res, card)
    launches["dual_step"] = hybrid_phase(fused, card)
    dist_launches = dist_phase(main_res, card)
    launches.update(ops_phase(card))
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
        entry["path"] = PATHS[name]
        if name in dist_launches and dist_launches[name]:
            entry["dist_launches"] = dist_launches[name]
    kernels["round_update"]["sparse_launches"] = launches[
        "round_update_sparse"]
    kernels["hinge_grad"]["slab_launches"] = launches["hinge_grad_slab"]
    log(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
