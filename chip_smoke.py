#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``src/repro_torch``) once on one NVIDIA
card, and check it.

Run from the repository root, on a machine with one CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. card      — require CUDA; print the card's name and power limit; TF32 off.
2. build     — compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a).
3. kernels   — hold ``round_stats``, ``round_update`` and ``dual_step``
               against their plain PyTorch versions at the main path's shape
               (m=64, n=10,000), the fused mode's largest (m=1024,
               n=65,536) and a ragged one (m=7, n=1,000); time each at the
               main path's shape with CUDA events beside its bound.
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

Before the last line it prints one ``{"kernels": [...]}`` JSON line (time,
bound, plain-version time and launches of every kernel), and last
``{"ok": true, "device": {...}}``. Without a CUDA card, or outside the
repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

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
SOURCE = "src/repro_torch/csrc/round_fused.cu"
REPLACES = {
    "round_stats": "src/repro/kernels/round_fused.py:130",
    "round_update": "src/repro/kernels/round_fused.py:194",
    "dual_step": "src/repro/kernels/round_fused.py:249",
}


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
    from repro_torch.kernels import round_fused
    round_fused.library()
    log(f"build: {secs:.1f} s")
    return secs


# -- 3. kernels --------------------------------------------------------------

def _inputs(m: int, n: int, seed: int, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    A = torch.softmax(randn(m, m), dim=1)   # dense row-stochastic mix
    alive = torch.ones(m, device=dev)
    alive[m // 2] = 0.0                      # one crash-frozen row
    return dict(theta=randn(m, n), x=randn(m, n) / math.sqrt(n),
                delta=0.1 * randn(m, n), recv=randn(m, n),
                mixed=randn(m, n), coeff=randn(m), A=A,
                diag=A.diagonal().contiguous(), alive=alive)


def _calls(rf, d, use_recv=0, noise_self=True):
    """(kernel call, plain call) per kernel on one input set."""
    stats = (d["theta"], d["x"], 0.5, d["theta"].shape[0])
    upd = (d["A"], d["theta"], d["delta"], d["x"], d["recv"], d["coeff"],
           d["diag"], d["alive"], 0.25, use_recv, noise_self)
    dual = (d["mixed"], d["x"], d["theta"], d["coeff"], d["alive"], 0.25)
    return {
        "round_stats": (lambda: rf.round_stats(*stats),
                        lambda: rf.round_stats_plain(*stats)),
        "round_update": (lambda: rf.round_update(*upd),
                         lambda: rf.round_update_plain(*upd)),
        "dual_step": (lambda: rf.dual_step(*dual),
                      lambda: rf.dual_step_plain(*dual)),
    }


# outputs that are sums over a node's row or a column (round_stats' four
# float outputs; round_update's next, through A @ r) — see _compare
REDUCED = {"round_stats": (0, 1, 3, 4), "round_update": (0,), "dual_step": ()}


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


def _device_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the device time per call: the summed
    durations of the kernels (and memsets) a call puts on the card, from
    the profiler's device events — the time the card spends on the call's
    work, without the host's launch gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if getattr(e, "device_type", None) == DeviceType.CUDA)
        require(busy_us > 0, "the profiler saw no device time")
        samples.append(busy_us / reps / 1e3)
    return statistics.median(samples)


def _work(name: str, m: int, n: int) -> tuple[int, int]:
    """(bytes, flops) the function needs at the main path's flags: each
    input read once, each output written once."""
    mn = m * n
    if name == "round_stats":      # theta, x in; dot, xsq, nnz, wbdot, wsum
        return 4 * (2 * mn + 4 * m + n), 12 * mn
    if name == "round_update":     # A, theta, delta, x, coeff, diag, alive in;
        return (4 * (m * m + 3 * mn + 3 * m + 2 * mn),   # next, tilde out
                2 * m * m * n + 8 * mn)
    return 4 * (3 * mn + 2 * m + mn), 3 * mn   # dual_step


def kernel_phase(card: str):
    """Hold each kernel against its plain version; time it. Returns the
    per-kernel measurements (launch counts are filled in later)."""
    import torch
    from repro_torch.kernels import round_fused as rf
    dev = torch.device("cuda")
    errs = {k: 0.0 for k in REPLACES}
    for m, n in KERNEL_SHAPES:
        d = _inputs(m, n, seed=m * 7919 + n, dev=dev)
        for use_recv in (0, 1):
            for noise_self in (True, False):
                calls = _calls(rf, d, use_recv, noise_self)
                for name, (kern, plain) in calls.items():
                    if name != "round_update" and (use_recv or not noise_self):
                        continue
                    errs[name] = max(errs[name], _compare(
                        name, kern(), plain(),
                        f"m={m} n={n} use_recv={use_recv} "
                        f"noise_self={noise_self}"))
        del d
        torch.cuda.synchronize()
        log(f"kernels agree with their plain versions at m={m}, n={n}")
    torch.cuda.empty_cache()

    # time at the main path's shape, rotating over input sets that together
    # exceed the 50 MB L2, so every launch reads its inputs from HBM
    sets = [_inputs(MAIN_M, MAIN_N, seed=s, dev=dev) for s in range(10)]
    results = {}
    for name in REPLACES:
        kern = [_calls(rf, d)[name][0] for d in sets]
        plain = [_calls(rf, d)[name][1] for d in sets]

        def rotate(fns):
            it = itertools.cycle(fns)
            return lambda: next(it)()

        ms = _device_ms(rotate(kern))
        plain_ms = _device_ms(rotate(plain))
        call_ms = _call_ms(rotate(kern))
        nbytes, flops = _work(name, MAIN_M, MAIN_N)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
        bound_ms = max(t_bytes, t_ops) * 1e3
        results[name] = dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=None, max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms,
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None, call_ms=call_ms)
        log(f"kernel {name}: {ms * 1e3:.2f} us device time (median) at "
            f"m={MAIN_M} n={MAIN_N} | {nbytes / 1e6:.2f} MB, bound "
            f"{bound_ms * 1e3:.2f} us at 3.35 TB/s "
            f"({results[name]['bound_by']}) | plain version "
            f"{plain_ms * 1e3:.2f} us device time | {call_ms * 1e3:.2f} us "
            f"per back-to-back wrapper call (host included) | max abs err "
            f"{errs[name]:.3g} | {card}")
    del sets
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# -- 4-6. the port's run -----------------------------------------------------

DEVICE = "cuda"
AGREE_ROUNDS = 64


def paper_spec(**kw):
    """The paper's §V run (configs/social_linear.py at
    benchmarks/common.py::Scale.paper) on the fused backend."""
    from repro_torch import RunSpec
    base = dict(nodes=MAIN_M, dim=MAIN_N, horizon=100_000 // MAIN_M,
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
    launches = {k: getattr(rf, k).launches for k in REPLACES}
    log(f"main path: {T} rounds, run() {wall:.2f} s with regret; round "
        f"loop {res.wall_clock:.3f} s = {res.rounds_per_sec:.1f} rounds/s; "
        f"launches {launches} | {card}")
    require(launches["round_stats"] == T and launches["round_update"] == T,
            f"fused kernels launched {launches}, expected {T} each")
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
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import ExecConfig, run
    spec = paper_spec(horizon=AGREE_ROUNDS)
    cfg = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                     warmup=False)
    run(spec, exec=cfg, device=DEVICE)      # allocator and caches warm
    loop_us = run(spec, exec=cfg, device=DEVICE).wall_clock * 1e6
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(spec, exec=cfg, device=DEVICE)
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if getattr(e, "device_type", None) == DeviceType.CUDA)
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


def main() -> int:
    card, smi = card_check()
    import torch
    build_phase()
    kernels = kernel_phase(card)
    main_res, launches = main_path(card)
    idle_share(card)
    fused = agreement_phase(main_res, card)
    launches["dual_step"] = hybrid_phase(fused, card)
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
        entry["path"] = "hybrid" if name == "dual_step" else "main"
    log(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
