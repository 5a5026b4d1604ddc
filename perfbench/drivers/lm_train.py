"""Closed loop of LM training steps through the port's step builders.

``strategy`` "gossip": the paper's private gossip over ``nodes`` replicas
on a ring (`repro_torch.launch.steps.make_gossip_train_step`, the step
``launch/train.py --arch`` drives), each node a batch of ``batch`` x
``seq_len`` tokens. "allreduce": the AdamW baseline on one replica
(`make_allreduce_train_step`) over the same tokens a step.

The benchmark makes the inputs from the seed, on the device, in a few
large calls: every parameter leaf from a generator of its own (normal with
std 1/sqrt(rows) for matrices, 1/sqrt(d) for the embedding, ones for the
norms), cast to the dtype the model stores it in; and a pool of token
batches from its own copy of the Zipf/Markov walk (a Zipf draw, then each
next token (prev * 31 + 7) mod V with probability 1/2, else a fresh draw;
labels the next token, the last -1), every row different.

Set-up builds the step and its state once, drives it through the first
``checked_steps`` steps (the first rows of the pool) and hands the same
state to the window, which steps on until ``--seconds`` have passed,
synchronising after each step. What the comparison needs of those first
steps is kept on the way (their losses; on the host, what step 1's
gradient is worked out from: theta_1 for gossip, AdamW's first moment
for AdamW; each leaf's change after the last step as a norm); the time
that takes is left out of the set-up. After the window the
configuration's reference replays the checked steps from the same
inputs, and step 1's gradient of each side is compared leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

__all__ = ["Cell", "weight", "make_weights", "make_batches", "derive",
           "compare"]

MATMUL_NAMES = ("gemm", "xmma", "cutlass", "nvjet", "cublas", "wgmma",
                "sm90_", "sm80_", "ampere_", "flash", "fmha", "attention")


def derive(seed: int, *key: int) -> int:
    st = np.random.SeedSequence((int(seed),) + key).generate_state(2)
    return ((int(st[0]) << 31) ^ int(st[1])) & (2**63 - 1)


def faults(params: dict) -> tuple:
    """The faults of `perfbench.breakers` a cell of this driver can have:
    one replica exchanges nothing."""
    return (("unchanged", "half_batch", "no_exchange", "altered")
            if params["strategy"] == "gossip"
            else ("unchanged", "half_batch", "altered"))


def weight(specs: list, i: int, dtypes: dict, seed: int, device):
    """Leaf i of ``specs`` in its stored dtype, from a generator of its
    own."""
    path, shape, kind = specs[i]
    if kind == "scale":
        return torch.ones(shape, dtype=dtypes[path], device=device)
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, 10, i))
    std = 1.0 / math.sqrt(shape[-1] if kind == "table" else shape[-2])
    return torch.randn(shape, generator=g, device=device).mul_(std).to(
        dtypes[path])


def make_weights(specs: list, dtypes: dict, seed: int, device) -> dict:
    """path -> tensor in its stored dtype, every leaf of ``specs``."""
    return {s[0]: weight(specs, i, dtypes, seed, device)
            for i, s in enumerate(specs)}


def make_batches(vocab: int, count: int, lead: tuple, seq: int, seed: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens and labels (count, *lead, seq) int32 of the Zipf/Markov
    walk, drawn on ``device`` in bulk."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, 20))
    shape = (count,) + tuple(lead) + (seq,)
    n = int(np.prod(shape))
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
    p = ranks ** -1.2
    draws = torch.multinomial((p / p.sum()).float(), n, replacement=True,
                              generator=g).view(shape)
    follow = torch.rand(shape, generator=g, device=device) < 0.5
    follow[..., 0] = False
    pos = torch.arange(seq, device=device).expand(shape)
    start = torch.where(follow, 0, pos).cummax(dim=-1).values
    k = pos - start
    # (31^k x + c_k) mod V: k steps of x -> 31 x + 7 from the last fresh draw
    a = torch.ones(seq, dtype=torch.int64)
    c = torch.zeros(seq, dtype=torch.int64)
    for i in range(1, seq):
        a[i] = a[i - 1] * 31 % vocab
        c[i] = (c[i - 1] * 31 + 7) % vocab
    a, c = a.to(device), c.to(device)
    base = torch.gather(draws, -1, start)
    tokens = ((a[k] * base + c[k]) % vocab).to(torch.int32)
    labels = torch.cat([tokens[..., 1:],
                        torch.full(shape[:-1] + (1,), -1, dtype=torch.int32,
                                   device=device)], dim=-1)
    return tokens, labels


class Cell:
    """One LM training cell: `setup`, `measure`, `release`, `check`."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.train = ctx.workload["params"]
        self.dev = ctx.device
        self.strategy = self.train["strategy"]
        self.nodes = self.train.get("nodes", 1)
        self.lead = ((self.nodes, self.train["batch"])
                     if self.strategy == "gossip" else (self.train["batch"],))
        self.tokens_per_step = int(np.prod(self.lead)) * self.train["seq_len"]
        self.check_s = 0.0          # set-up time spent keeping readings
        self.readings = {}
        self.first = None           # step 1's state on the host

    # -- the program -------------------------------------------------------

    def port_config(self):
        from repro_torch.configs import get_config
        base = get_config(self.cfg["architecture"])
        keys = {f.name for f in dataclasses.fields(base)}
        return dataclasses.replace(base, **{
            k: (tuple(v) if isinstance(v, list) else v)
            for k, v in self.cfg.items() if k in keys and k != "name"})

    def build(self):
        """The port's model, state and step, from the benchmark's weights."""
        from repro_torch.core import tree
        from repro_torch.launch import steps
        from repro_torch.models import build_model
        from repro_torch.sharding.rules import with_node_axis
        pcfg = self.port_config()
        model = build_model(pcfg, device=self.dev)
        meta = build_model(pcfg, device="meta").init(0)
        paths = tree.flatten_with_path(meta)
        specs = self.ctx.reference.leaf_specs(self.cfg)
        if [p for p, _ in paths] != [s[0] for s in specs] or any(
                tuple(leaf.shape) != s[1] for (_, leaf), s in
                zip(paths, specs)):
            raise ValueError("the port's parameters are not the reference's")
        self.dtypes = {p: leaf.dtype for p, leaf in paths}
        self.specs = specs
        weights = make_weights(specs, self.dtypes, self.ctx.seed, self.dev)
        params = tree.unflatten(tree.flatten(meta)[1],
                                [weights[p] for p, _ in paths])
        del weights
        recipe = steps.TrainRecipe(
            strategy=self.strategy, eps=self.train.get("eps", 1.0),
            L=self.train.get("clip_norm", 1.0), lam=self.train.get("lam", 0),
            alpha0=self.train.get("alpha0", 0.01),
            topology=self.train.get("topology", "ring"),
            lr=self.train.get("lr", 3e-4), clip_style="coordinate")
        if self.strategy == "gossip":
            gdp = steps.make_gossip_dp(self.nodes, recipe)
            state = steps.GossipTrainState(gossip=gdp.init(
                with_node_axis(params, self.nodes),
                seed=derive(self.ctx.seed, 1), device=self.dev))
            theta = tree.tree_map(lambda t: t.contiguous(),
                                  state.gossip.theta)
            state = steps.GossipTrainState(
                gossip=state.gossip._replace(theta=theta))
            step = steps.make_gossip_train_step(model, gdp)
        else:
            step, _ = steps.make_allreduce_train_step(
                model, recipe, total_steps=self.train["total_steps"])
            # AdamW's state: zero moments, the step count at
            # ``start_step`` (the end of warm-up: every step at full lr)
            def zeros(p):
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            state = steps.AllreduceTrainState(params, {
                "step": torch.tensor(self.train["start_step"],
                                     dtype=torch.int32, device=self.dev),
                "m": tree.tree_map(zeros, params),
                "v": tree.tree_map(zeros, params)})
        del params
        return step, state

    def leaves(self, state) -> dict:
        """path -> the state's parameters (theta for gossip)."""
        from repro_torch.core import tree
        src = (state.gossip.theta if self.strategy == "gossip"
               else state.params)
        return dict(tree.flatten_with_path(src))

    def start_leaf(self, path: str) -> torch.Tensor:
        """A leaf of the start state (theta_0 for gossip), made again."""
        i = [sp[0] for sp in self.specs].index(path)
        w = weight(self.specs, i, self.dtypes, self.ctx.seed, self.dev)
        if self.strategy == "gossip":
            return w.float()[None].expand((self.nodes,) + tuple(w.shape))
        return w.float()

    def batch(self, k: int) -> dict:
        i = k % self.tokens.shape[0]
        return {"tokens": self.tokens[i], "labels": self.labels[i]}

    def setup(self) -> None:
        pool = self.train["pool_steps"]
        self.tokens, self.labels = make_batches(
            self.cfg["vocab_size"], pool, self.lead, self.train["seq_len"],
            self.ctx.seed, self.dev)
        self.step, self.state = self.build()
        losses = []
        for k in range(self.train["checked_steps"]):
            self.state, out = self.step(self.state, self.batch(k))
            losses.append(out["loss"])
            if k == 0:
                # the step's own device work is set-up: wait for it first
                self._sync()
                t = time.perf_counter()
                self._keep_first(self.state)
                self.check_s += time.perf_counter() - t
        self._sync()
        t = time.perf_counter()
        self.readings["losses"] = [float(x) for x in losses]
        self.readings["change"] = {
            p: float(torch.linalg.vector_norm(leaf.float()
                                              - self.start_leaf(p)))
            for p, leaf in self.leaves(self.state).items()}
        self._sync()
        self.check_s += time.perf_counter() - t
        self.done = self.train["checked_steps"]

    def _keep_first(self, state):
        """What step 1's gradient is worked out from, on the host: theta_1
        for gossip, AdamW's first moment m_1 = (1 - b1) g_1 for AdamW."""
        if self.strategy == "gossip":
            src = self.leaves(state)
        else:
            from repro_torch.core import tree
            src = dict(tree.flatten_with_path(state.opt["m"]))
        self.first = {p: leaf.cpu() for p, leaf in src.items()}

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- the window ------------------------------------------------------------

    def measure(self, seconds: float) -> dict:
        traced = range(1, 1 + self.train.get("traced_steps", 2))
        walls = []
        t0 = time.perf_counter()
        k = 0
        while True:
            a = time.perf_counter()
            if k == traced.start:
                with self.ctx.tracer.slice():
                    for _ in traced:
                        self.state, _ = self.step(self.state,
                                                  self.batch(self.done + k))
                        k += 1
                    self._sync()
                walls.append((len(traced), time.perf_counter() - a, True))
            else:
                self.state, _ = self.step(self.state,
                                          self.batch(self.done + k))
                self._sync()
                k += 1
                walls.append((1, time.perf_counter() - a, False))
            end = time.perf_counter()
            if end - t0 >= seconds and k > traced.stop:
                break
        untraced = [w for w in walls if not w[2]]
        from perfbench import work
        c = self.cfg
        self.counts = {
            "steps_traced": len(traced),
            "steps_untraced": sum(w[0] for w in untraced),
            "wall_untraced_s": sum(w[1] for w in untraced),
            "flops_per_step": work.lm_step_flops(
                self.tokens_per_step, self.train["seq_len"], c["d_model"],
                c["num_layers"], c["num_heads"], c["num_kv_heads"],
                c["head_dim"], c["d_ff"], c["vocab_size"]),
            "matmul_names": MATMUL_NAMES,
        }
        return {"metrics": {"lm_train_tokens_per_s":
                            k * self.tokens_per_step / (end - t0)},
                "attempted": k, "failed": 0,
                "walls": [w[1] for w in walls]}

    def release(self) -> None:
        import gc
        del self.step, self.state
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------------------

    def reference_inputs(self):
        """The start state and the checked steps' batches, made again."""
        n = self.train["checked_steps"]
        weights = make_weights(self.specs, self.dtypes, self.ctx.seed,
                               self.dev)
        batches = [(self.tokens[k], self.labels[k]) for k in range(n)]
        return weights, batches

    def run_reference(self, precision: str = "fp32", on_first=None) -> dict:
        ref = self.ctx.reference
        weights, batches = self.reference_inputs()
        if self.strategy == "gossip":
            theta0 = {p: w.float()[None].expand(
                (self.nodes,) + tuple(w.shape)).contiguous()
                for p, w in weights.items()}
            del weights
            return ref.gossip_steps(self.cfg, self.train, theta0, batches,
                                    derive(self.ctx.seed, 1), precision,
                                    on_first)
        return ref.allreduce_steps(self.cfg, self.train, weights, batches,
                                   self.dtypes, precision, on_first)

    def program_grad1(self, path: str, mixed) -> torch.Tensor:
        """Step 1's gradient of ``path`` as the program's update took it:
        for gossip (the ring mix of theta_0 + step 1's noise - theta_1) /
        alpha_1, for AdamW m_1 / (1 - b1)."""
        kept = self.first.pop(path).to(self.dev)
        if self.strategy == "gossip":
            alpha1 = self.ctx.reference.schedule(self.train, 1)[0]
            return (mixed - kept) / alpha1
        return kept / 0.1

    def calibration_reading(self) -> dict:
        """The checked steps of the cell's seed, judged as a measuring run
        judges them (set-up already ran them)."""
        self.release()
        return self.check()

    def check(self) -> dict:
        """The checked steps' numbers; under ``ctx.control`` the reference
        in fp8 stands in the program's place."""
        if self.ctx.control:
            kept = {}

            def keep(path, mixed, g):
                kept[path] = g.cpu()

            def program_g1(path, mixed):
                return kept.pop(path).to(self.dev)

            got = self.run_reference("fp8", on_first=keep)
        else:
            got, program_g1 = dict(self.readings), self.program_grad1
        norms, diffs = {}, {}

        def first(path, mixed, g):
            gp = program_g1(path, mixed).double()
            norms[path] = float(torch.linalg.vector_norm(gp))
            diffs[path] = float(torch.linalg.vector_norm(gp - g.double()))

        want = self.run_reference(on_first=first)
        self.first = None
        return compare(dict(got, grad1=norms, grad1_diff=diffs), want)


def leaf_gap(got: dict, want: dict, counted: list) -> float:
    """The worst leaf's gap between two per-leaf norms, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = float(np.median([want[p] for p in counted]))
    return max(abs(got[p] - want[p]) / max(want[p], med) for p in counted)


def compare(got: dict, want: dict) -> dict:
    """The numbers an LM cell is judged by."""
    med = float(np.median(list(want["grad1"].values())))
    # leaves whose reference gradient is nought to rounding move by
    # round-off alone: a rule on the reference's gradient, not on names
    counted = [p for p, v in want["grad1"].items() if v >= 1e-3 * med]
    losses = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                  want["losses"])]
    nums = {
        "loss_rel_gap": max(losses) if len(losses) == len(want["losses"])
        else math.inf,
        "grad1_leaf_gap": leaf_gap(got["grad1"], want["grad1"], counted),
        # the norms agree to rounding whatever the precision: the norm of
        # the difference is what separates bfloat16 from fp8
        "grad1_leaf_diff": max(got["grad1_diff"][p]
                               / max(want["grad1"][p], med)
                               for p in counted),
        "change_leaf_gap": leaf_gap(got["change"], want["change"], counted),
    }
    return {k: (v if math.isfinite(v) else math.inf) for k, v in nums.items()}
