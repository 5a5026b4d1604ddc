"""Closed loop of whole `repro_torch.run` calls on the paper's stream.

Each run is the paper's deployment end to end: ``total_samples`` social
samples over ``nodes`` data centres, T = total_samples // nodes rounds.
Run k of a window has the run seed ``seed * 1000 + k``; before its clock
starts, the benchmark draws its stream on the device (`make_stream`, the
benchmark's own copy of the ``social_sparse`` generator) and hands it in
through ``RunSpec.stream``. The next run starts when the previous returns.
The window's rate is every sample the runs consumed (rounds x nodes,
crashed nodes' rounds too) over the window's wall time, the streams'
making included.

Once the window has closed, a sample of the window's runs drawn from the
seed (``checked_runs`` of them, the last among them) is replayed by the
configuration's plain reference on the same stream and noise seed, and the
largest gaps over those runs are the numbers compared with the cell's
limits.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

__all__ = ["Cell", "faults", "make_stream", "derive", "compare",
           "program_outputs"]

FIELDS = ("loss", "correct", "sparsity", "final_w", "eps_ledger")


def faults(params: dict) -> tuple:
    """The faults of `perfbench.breakers` a cell of this driver can have."""
    return ("unchanged", "half_batch", "no_exchange", "altered")


def derive(seed: int, *key: int) -> int:
    """A 63-bit seed from the run seed and a purpose key."""
    st = np.random.SeedSequence((int(seed),) + key).generate_state(2)
    return ((int(st[0]) << 31) ^ int(st[1])) & (2**63 - 1)


class Stream:
    """A whole stream held on the device; `chunk` hands out views."""

    disjoint = True   # round t touches only round t's samples (Thm 1)

    def __init__(self, xs: torch.Tensor, ys: torch.Tensor):
        self.xs, self.ys = xs, ys
        self.rounds, self.nodes, self.n = xs.shape

    def chunk(self, t0: int, t1: int):
        return self.xs[t0:t1], self.ys[t0:t1]


def make_stream(cfg: dict, seed: int, device) -> Stream:
    """The paper's social stream for one run: a sparse unit-norm w*
    (each feature in its support with probability ``sparsity_true``),
    gaussian features over sqrt(n), labels sign(<w*, x>) with 0 -> +1;
    all drawn on ``device`` from one generator seeded from ``seed``."""
    m, n = cfg["nodes"], cfg["n"]
    T = cfg["total_samples"] // m
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, 1))
    mask = torch.rand(n, generator=g, device=device) < cfg["sparsity_true"]
    w = torch.randn(n, generator=g, device=device) * mask
    w = w / torch.clamp_min(torch.linalg.norm(w), 1e-9)
    xs = torch.randn((T, m, n), generator=g, device=device)
    xs /= math.sqrt(n)
    ys = torch.where(torch.mv(xs.view(T * m, n), w) >= 0, 1.0, -1.0)
    return Stream(xs, ys.view(T, m))


def run_spec(cfg: dict, params: dict, seed: int):
    """The program's RunSpec of one run seeded ``seed``."""
    from repro_torch.api import RunSpec
    faults = params.get("faults")
    extra = {}
    if faults:
        opts = {k: v for k, v in faults.items() if k != "name"}
        opts["seed"] = derive(seed, 2)
        extra = dict(faults=faults["name"], faults_options=opts)
    return RunSpec(
        nodes=cfg["nodes"], dim=cfg["n"],
        horizon=cfg["total_samples"] // cfg["nodes"],
        mixer=cfg["topology"],
        mixer_options={"self_weight": cfg["self_weight"]},
        mechanism=cfg["mechanism"], eps=cfg["eps"],
        calibration=cfg["calibration"], clip_norm=cfg["clip_norm"],
        alpha0=cfg["alpha0"], schedule=cfg["schedule"], lam=cfg["lam"],
        seed=derive(seed, 0), backend=params["backend"], **extra)


def fault_options(params: dict, seed: int) -> dict | None:
    """The reference's fault scenario of the run seeded ``seed``."""
    faults = params.get("faults")
    if not faults:
        return None
    return {**{k: v for k, v in faults.items() if k != "name"},
            "seed": derive(seed, 2)}


def program_outputs(result) -> dict:
    """What a RunResult is judged by, as numpy arrays."""
    out = {f: np.asarray(getattr(result, f)) for f in FIELDS}
    if result.connectivity is not None:
        out["connectivity"] = np.asarray(result.connectivity)
    out["rounds"] = result.rounds
    return out


def compare(got: dict, ref: dict) -> dict:
    """The numbers one run is judged by: the largest gaps between the
    program's outputs and the reference's."""
    T = ref["loss"].shape[0]
    if got["rounds"] != T or any(got[f].shape != ref[f].shape
                                 for f in FIELDS):
        return {k: math.inf for k in ("loss_max_gap", "correct_mismatches",
                                      "sparsity_max_gap", "w_rel_gap",
                                      "eps_max_gap")}
    dw = got["final_w"].astype(np.float64) - ref["final_w"]
    nums = {
        "loss_max_gap": float(np.abs(got["loss"] - ref["loss"]).max()),
        "correct_mismatches": float((got["correct"] != ref["correct"]).sum()),
        "sparsity_max_gap": float(np.abs(got["sparsity"]
                                         - ref["sparsity"]).max()),
        "w_rel_gap": float(np.linalg.norm(dw)
                           / max(np.linalg.norm(ref["final_w"]), 1e-30)),
        "eps_max_gap": float(np.abs(got["eps_ledger"].astype(np.float64)
                                    - ref["eps_ledger"]).max()),
    }
    if "connectivity" in got:
        nums["connectivity_max_gap"] = float(np.abs(
            got["connectivity"].astype(np.float64)
            - ref["connectivity"]).max())
    for k, v in nums.items():
        if not math.isfinite(v):
            nums[k] = math.inf
    return nums


class Cell:
    """One linear cell: `setup`, `measure`, `release`, `check`."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.params = ctx.workload["params"]
        self.dev = ctx.device
        self.runs = []          # (run seed, program outputs, wall seconds)

    # -- the program -----------------------------------------------------

    def program(self, seed: int, stream: Stream, horizon: int | None = None):
        """One timed call of the program: run() of run seed ``seed`` (cut
        to ``horizon`` rounds for the warm-up). Under ``ctx.control`` the
        reference in bfloat16 stands in its place."""
        if self.ctx.control:
            return self.control(seed, stream, horizon)
        from repro_torch.api import ExecConfig, run
        spec = run_spec(self.cfg, self.params, seed).replace(stream=stream)
        return run(spec, engine=self.params["engine"], horizon=horizon,
                   exec=ExecConfig(chunk_rounds=self.params["chunk_rounds"],
                                   compute_regret=False),
                   device=self.dev)

    def setup(self) -> None:
        """Build the kernels and warm every shape of the window: a run
        over one full chunk and the last, shorter one, on a stream of
        the window's size."""
        import repro_torch.api.backends  # noqa: F401  (registers)
        T = self.cfg["total_samples"] // self.cfg["nodes"]
        chunk = self.params["chunk_rounds"]
        warm = chunk + (T % chunk) if T > chunk else T
        stream = make_stream(self.cfg, derive(self.ctx.seed, 9), self.dev)
        self.program(derive(self.ctx.seed, 8), stream, horizon=warm)
        del stream
        self._sync()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the window --------------------------------------------------------

    def measure(self, seconds: float) -> dict:
        m = self.cfg["nodes"]
        t0 = time.perf_counter()
        k, samples, trace_k = 0, 0, 1
        while True:
            seed = self.ctx.seed * 1000 + k
            stream = make_stream(self.cfg, seed, self.dev)
            a = time.perf_counter()
            if k == trace_k:
                with self.ctx.tracer.slice():
                    res = self.program(seed, stream)
            else:
                res = self.program(seed, stream)
            wall = time.perf_counter() - a
            del stream
            self.runs.append((seed, program_outputs(res), wall))
            samples += res.rounds * m
            k += 1
            end = time.perf_counter()
            if end - t0 >= seconds and k > trace_k:
                break
        window = end - t0
        untraced = [r for i, r in enumerate(self.runs) if i != trace_k]
        rounds = sum(r[1]["rounds"] for r in untraced)
        self.counts = {
            "nodes": m, "n": self.cfg["n"],
            "nnz": 3 * m if self.cfg["topology"] == "ring" else None,
            "rounds_traced": self.runs[trace_k][1]["rounds"],
            "rounds_untraced": rounds,
            "wall_untraced_s": sum(r[2] for r in untraced),
        }
        return {"metrics": {"train_samples_per_s": samples / window},
                "attempted": k, "failed": 0,
                "walls": [r[2] for r in self.runs]}

    def release(self) -> None:
        """Free what the program holds on the device (the outputs judged
        are on the host)."""
        import gc
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ------------------------------------------------------

    def check(self) -> dict:
        """The largest of each number over a sample of the window's runs,
        drawn from the seed: ``checked_runs`` of them, the last one among
        them (every run where the window holds no more)."""
        runs = self.runs
        n = self.params.get("checked_runs", len(runs))
        if len(runs) > n:
            rng = np.random.default_rng(derive(self.ctx.seed, 3))
            pick = set(rng.choice(len(runs) - 1, n - 1, replace=False))
            runs = [r for i, r in enumerate(runs)
                    if i in pick or i == len(runs) - 1]
        worst = {}
        for seed, got, _ in runs:
            nums = compare(got, self.reference(seed))
            for k, v in nums.items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst

    def control(self, seed: int, stream: Stream, horizon: int | None = None):
        """The reference in bfloat16, returning what a RunResult would."""
        import types
        out = self.ctx.reference.run_reference(
            self.cfg, stream.xs[:horizon], stream.ys[:horizon],
            derive(seed, 0), faults=fault_options(self.params, seed),
            dtype=torch.bfloat16)
        return types.SimpleNamespace(
            rounds=out["loss"].shape[0],
            connectivity=(out["connectivity"] if self.params.get("faults")
                          else None),
            **{f: out[f] for f in FIELDS})

    def calibration_reading(self) -> dict:
        """One run at the cell's seed, judged as a window's runs are."""
        seed = self.ctx.seed
        stream = make_stream(self.cfg, seed, self.dev)
        got = program_outputs(self.program(seed, stream))
        del stream
        return compare(got, self.reference(seed))

    def reference(self, seed: int):
        """The configuration's plain reference of the run seeded ``seed``,
        on the stream the run had."""
        stream = make_stream(self.cfg, seed, self.dev)
        out = self.ctx.reference.run_reference(
            self.cfg, stream.xs, stream.ys, derive(seed, 0),
            faults=fault_options(self.params, seed))
        del stream
        return out
