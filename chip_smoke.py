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
               (sparse) and a dense softmax A (dense), and at the main
               path's shape the hypercube and random (seed 0) A of Fig. 3
               through their CSR forms. With the ring A the sparse path
               must equal the dense one bit for bit at (64, 10,000) and
               (7, 1,000), with the hypercube and random A at (64, 10,000);
               two calls of a redesigned kernel
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
               with the ring through the sparse path, and on lines before
               it the dense path with the softmax A and the sparse path
               with the hypercube and random A); ``hinge_grad`` also
               at (1, 10,112), and each small batch beside one
               ``torch.mv`` of the same x and w (a floor: one cuBLAS pass
               that reads x once). Then the seed axis of ``round_stats`` and
               ``round_update`` (`run_batch`'s launches): at S = 3 and 8
               seeds of (64, 10,000), each batched launch (ring and
               hypercube CSR, softmax A) must equal S one-seed launches on
               the seeds' slices bit for bit and hold to its batched plain
               version, ``round_stats`` one kernel and no memset per
               call; each timed at S = 1, 3, 8 beside its bound and beside
               S back-to-back one-seed launches.
4. main path — ``repro_torch.run`` at the paper's scale (m=64, n=10,000,
               T=1,562 rounds = 100,000 samples, social_sparse, ring,
               Laplace eps=1 coordinate, L2 clip 1, alpha0=1, lam=1e-3),
               fused ``backend="cuda"``, with regret; every round must have
               replayed from the CUDA graph (``round.graph_rounds``) and the
               fused kernels' counts must read one launch per round. Then
               the device idle share of 64 rounds (profiler busy time over
               the round loop's time), whose trace must hold one
               ``stats_kernel`` and one ``update_sparse_kernel`` a round,
               and one more of each for the eager round the capture runs
               first.
5. agreement — the first 64 rounds on ``backend="reference"`` (torch ops)
               against the fused backend, same seed and generator; then
               the whole horizon (1,562 rounds) at seeds 0, 1 and 2.
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
9. topology  — the paper's Fig. 3 axis at its scale (the main path's spec
               with another mixer; fused backend, auto mode, regret on):
               hypercube, random and an 8x8 torus (``mixer="sparse"``)
               must take round_update's sparse path every round, a complete
               ``dense`` mixer its dense path, complete and time_varying
               the hybrid path (``dual_step`` every round). Each run's
               rounds/s, accuracy and regret are logged, its first 64
               rounds held against the reference backend; hypercube and
               random also run on the dist engine, equal to the sim run
               field by field.
10. stages   — 64 rounds each at the paper's width: the Gaussian
               mechanism and the drift (both modes), heterogeneous and
               bursty streams on the fused path, per-edge delays
               (``delay_dist``) on the hybrid path, each held against the
               reference backend; the tg and rda rules, the value clipper
               and the group prox on the reference backend (finite).
11. faults   — the main path's spec under the ``dcn`` preset (link drops,
               crashes, stragglers), fused backend in auto mode: it must
               take the hybrid path (``round_stats`` and ``dual_step``
               every round, ``round_update`` never: a faulty mixer has no
               fixed form), hold to the reference backend over all 1,562
               rounds (connectivity exact too), charge its five crashed
               nodes 1,554 rounds of eps and the rest 1,562, and equal the
               sim run on the dist engine; its rounds/s beside the clean
               ring's in turns, and device events a round and idle share
               of its round body (stream made beforehand) beside the clean
               fused and hybrid rounds'. Then 64 rounds
               of a zero-rate scenario, bit for bit the clean sparse ring
               in hybrid mode, and 64 of a partition (rounds 16-31, cut at
               node 32) on the 8x8 torus, held to the reference backend,
               its connectivity below 1 exactly while the cut is up.
12. batch    — ``run_batch`` of the paper's run at seeds 0, 1, 2 (fused,
               regret on): ``round_stats`` and ``round_update`` launch once
               a round for the three seeds (1,562 each, all sparse), every
               seed's RunResult equals its own ``run()`` field by field and
               the dist batch the sim batch; 64 rounds of a ``complete``
               batch and 256 of a ``dcn`` batch (hybrid) equal per seed to
               ``run()``; seed-rounds/s of batches of 3 and 8 seeds against
               three sequential runs, in turns, three times each.
13. sweep    — the paper's Fig. 2 axis (eps 0.1, 1, 10, inf x seeds 0-2,
               paper scale, regret on) through ``repro_torch.sweep`` into a
               temporary store; reloaded with ``reuse=True,
               require_store=True`` it must run nothing and give the same
               accuracy and regret aggregates (logged per point, mean +-
               std over the seeds).
14. serve    — ``repro_torch.serve`` at the paper's width on the bursty
               stream (the main path's spec with ``stream="bursty"``,
               nothing cut): a ``ServeService`` (chunk 64, max batch 32,
               1 ms batching window, queue 1,024, every snapshot kept)
               trains all 1,562 rounds in its trainer thread while
               ``BurstyReplay`` drives 256 ticks of the stream's burst
               counts (~124 requests a tick, 40 KB each) at open throttle.
               The trainer must launch ``round_stats`` and ``round_update``
               once a round, all sparse; a served request's snapshot must
               equal a fresh ``run`` to its round and its margin and label
               a re-run of the predict step, bit for bit; the last snapshot
               ``run(spec).final_w``. A service crashed at round 640
               restarts once from its async checkpoint and ends bit for bit
               on the clean one; a sequential-composition service with eps
               budget 10 (chunk 4) exhausts at round 8 and refuses the
               next request. Logs served/shed/refused, QPS, p50/p99
               latency, staleness and the trainer's rounds/s under the
               replay's load and without it, in turns, and the same
               service with the replay paced at 64 ticks/s.
15. obs      — 256 rounds of the main path (chunks of 64) with
               ``repro_torch.obs`` telemetry on (event stream, spans,
               metrics, ``torch.profiler`` capture) equal to the run with it
               off, bit for bit; the stream holds run_start, chunk x 4 and
               run_end and ``launch.obs report`` renders it; the profiler's
               Chrome trace holds the round kernels' device events. Then
               rounds/s with telemetry off and on (no profiler), in turns.
16. runner   — the rest of ``run``'s surface at the paper's width, each
               held to phase 4's run: custom mode (``step_fn=`` one fused
               round of the main path's chunk program a step, the stream's
               rounds as ``batches``, 1,562 steps: final primal and the
               history's losses bit for bit, 1,562 sparse launches of each
               round kernel); ``ExecConfig(log_path=...)`` (1,563 lines,
               every row the RunResult's trajectories, the run bit for bit;
               rounds/s with and without the log in turns); 64 rounds via
               the legacy kwargs (one DeprecationWarning, bit for bit the
               ``exec=`` run); ``Telemetry(events, cost=True)`` (bit for
               bit; run_start, chunk x 7, chunk_cost, run_end; the
               report's cost line; the calibrated peaks, one round's op
               count — equal on the card and on the CPU, op by op — split
               into the round kernels' and the torch ops' share, predicted
               and measured chunk seconds, the error ratio); then
               ``python -m repro_torch.launch.train --stream social_sparse``
               at the paper's width (equal to ``run`` of its spec) and
               ``launch.dryrun``'s count of a 256-round chunk and the peak
               device memory of its counted round.
17. shard    — the node and seed axes over device meshes at the paper's width,
               every shard on cuda:0 (the program a mesh of cards runs):
               ``round_stats`` and ``dual_step`` held against their plain
               versions and timed at each shard's (16 and 22, 10,000); the run
               on 4 node shards (block 16) over all 1,562 rounds — 4 launches
               of each a round, no ``round_update``, 2 halo copies a shard a
               round — equal on the dist engine and on a rerun bit for bit,
               equal to phase 4 in final_w, correct, sparsity and eps_ledger
               bit for bit in every round (the sharded ring adds each row in
               the unsharded ring's order; loss and w_bar_loss within 5e-6,
               the metric sums add in shard order), the reference backend's
               sharded run bit for bit (or where they part, logged, within the
               contract); 64 rounds on 4, 3 (block 22, padding live) and 1
               shard held to the unsharded run and each other;
               ``node_devices=1`` equal to phase 4; link and crash faults on 4
               shards held to the unsharded faulty runs, a zero-rate run bit
               for bit the clean sparse ring (the edge list a faulty mixer
               lowers the ring to), ``dcn`` refused (stragglers); seeds 0-2 on
               2 seed shards (pad 1) equal to phase 12's batch, a (seed, node)
               grid of 2 x 4 equal to each seed's 4-shard run; a checkpoint at
               round 768 resumed across 4 -> 1 and 1 -> 4 shards; rounds/s of
               1, 3 and 4 shards beside the unsharded run, in turns.
18. figures  — the paper's Figs. 2-5 through ``repro_torch.figures`` at
               ``Scale.paper()`` (configs/social_linear.py: n=10,000, m=64,
               T=1,562; Fig. 5 m=4, 8, 16, 32 at the same total samples),
               seeds 0-2, into a temporary store and output directory:
               per figure one line with its rows, wall time, rounds/s and
               the launches of each round kernel (counted from 0 before the
               figure: every point's rounds plus its warm-up round, on the
               path each point takes — sparse ``round_update``, or
               ``dual_step`` for Fig. 3's complete and time_varying); the
               rows finite, with the reference figures' keys and points in
               their order; Fig. 2's per-(eps, seed) results equal phase
               13's bit for bit (chunk 1,562 against 256); the derived
               checks printed, not required.
19. ablations — the two ablations through ``repro_torch.figures`` at
               ``Scale.paper()``, seeds 0-2, into a temporary store and
               output directory, the launches counted from 0 before each:
               the sparse methods (omd on the fused kernels: one batch,
               1,562 + 1 launches of each round kernel; truncated gradient
               and RDA on the reference backend: none), rows finite with
               the reference's labels and keys in order; the delay
               ablation at delays 0, 1, 4, 16, 64 on both engines (every
               point 1,563 launches of ``round_stats`` and sparse
               ``round_update``, its ``use_recv`` branch past delay 0), the
               dist run equal to the sim run in final_w, correct, sparsity
               and eps_ledger bit for bit at every delay and seed; the
               launches per delay, wall, seed-rounds/s and ``graceful``
               printed.
20. LM stack  — (a) each of the ten architectures at ``reduced()`` in f32:
               apply and loss on the card equal to the port's CPU result
               (1e-4 / 1e-5), token-by-token decode equal to apply (5e-3),
               one AdamW step of ``repro_torch.optim`` finite; (b) qwen2-7b
               at its full published config in bf16 (15.2 GB of weights):
               prefill through ``apply(last_only=True)`` at B = 1, T =
               2,048 (full attention, 28 calls) and 4,096 (blockwise, held
               to the full path at the same T), then 64 tokens of
               ``decode_step`` against ``apply`` over them (max |delta
               logit| and top-1 agreement within the bf16 bounds below);
               prefill and decode tokens/s and peak memory printed; (c)
               mixtral-8x7b at full width, 2 of 32 layers, bf16, capacity
               factor 1.25 (drops live, counted): apply, loss and backward,
               five AdamW steps on one batch (B = 2, T = 512), the loss
               falling; step time and peak memory printed.
21. LM train/serve — (a) ``launch.train.train`` of minicpm-2b at
               ``reduced()`` in f32, eps = inf, 3 steps of each strategy,
               from one CPU-made state on one token stream, on the card
               and on the CPU: states, losses and metrics within 1e-5;
               (b) minicpm-2b at its published width in bf16, 8 of 40
               layers, 4 ring nodes x batch 2 x T = 512: 5 gossip steps at
               eps = 1 and 5 at eps = inf (one batch on every node, the
               nodes' theta equal bit for bit under deterministic
               algorithms) through ``make_gossip_train_step`` and run()'s
               custom mode, then 5 all-reduce AdamW steps; losses finite,
               noise scale > 0 iff private, sparsity in [0, 1], the eps
               ledger; step time, tokens/s and peak memory printed; (c)
               ``launch.serve_lm.serve`` of qwen2-7b at its full config
               (batch 4, prompt 32, 16 tokens, cache 128): tokens (4, 17)
               in the vocabulary, the first generated token the prefill
               step's argmax where the top-2 gap is clear of the bf16
               bound; prefill at B = 1, T = 2,048 with head_pad=16 within
               the bound of the plain one, the same argmax, and the
               placement-only context managers bit for bit.
22. LM dry-run — (b) minicpm-2b's gossip step of 21b (published
               width, 8 of 40 layers, 4 nodes x B 2 x T 512, bf16) and
               qwen2-7b's prefill at B 1 x T 2,048 (published config),
               each counted through the dry-run's path on cuda:0 and on
               meta: the two counts equal op by op; then each step's time
               on the card (median and spread) beside two bounds over the
               counted flops, the roofline (memory term: the bytes the
               step needs, from its shapes) and the eager-op budget
               (memory term: the counted op sequence's bytes), and their
               shares, with the card's name and power limit; after (b),
               (a) ``python -m repro_torch.launch.dryrun --all`` in a
               process of its own, beside (c): every architecture x input
               shape counted on meta tensors on the 16 x 16 mesh, each
               cell ok or skipped as the reference skips it, the wall
               time printed; (c) the gossip LM example's
               three runs (`repro_torch.figures.gossip_lm_training`: eps
               inf, eps 1, all-reduce AdamW; minicpm-2b reduced, 4 nodes,
               60 steps) with finite losses, ce start and end, wall.

23. gossip update — ``GossipDP.update`` on the card with the paper's
               stages (ring, Laplace eps 1 coordinate, l1, per-node L2)
               takes its one-pass kernel (``kernels.gossip_update``, one
               launch a leaf, ``gossip.fused_leaves``) and equals its eager
               chain bit for bit (theta, sparsity, gradient norm, the
               generator's next draw) on the leaves of 21b's gossip step
               (4 nodes, read from the model on meta: the embedding, then
               the ten others, each layer kind stacked over the 8 layers,
               with their gradients' dtypes), at the gossip cell's lam and
               at one that zeroes most of the primal; then the kernel's
               time (CUDA events over queued calls) on the embedding leaf
               and on the ten others beside its bound and its plain
               version (the stages' own ops). The kernels line's ``launches`` are 21b's eps-1 steps
               (one a leaf a step, required there), ``check_launches``
               this phase's.
24. unembedding — the tied unembedding's three products
               (``kernels.unembed_gemm``: the logits, dx and dtable, bf16
               tensor-core passes with the f32 logit gradient split into
               three exact bf16 terms) at the LM cells' shapes (M 4,096,
               AdamW's step, and 1,024, a gossip node's; d 2,304, V
               122,880): each within twice the error of torch's f32
               product against a float64 one, then timed by CUDA events
               beside its bound (bf16 MMA at 989 TFLOP/s), the f32 work's
               bound at 67 TFLOP/s, its plain version and torch's f32
               ``mm`` (``library_ms``). At the same shapes, a gradient
               whose pairs of entries cancel down to the split's low
               terms (meeting equal rows of the other operand): dx and
               dtable within twice torch's f32 error, and the kernel fed
               g's high terms alone (g cast to bf16, the lower precision)
               outside it. Phase 21b requires every node's unembedding of
               every gossip step, and of every AdamW step, on the kernel
               path (``unembed.kernel_calls``, no ``unembed.plain_calls``)
               and counts its launches, four a forward and backward.

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
import re
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
# the fixed graphs of the paper's Fig. 3 beside the ring whose CSR form
# round_update's sparse path takes at the main path's shape (hypercube: 7
# non-zeros a row; random, seed 0: 6-7, ragged)
FIG3_GRAPHS = ("hypercube", "random")
UPDATE_FLAGS = tuple(itertools.product((0, 1), (True, False)))
SOURCE = "src/repro_torch/csrc/round_fused.cu"
ROUND_KERNELS = ("round_stats", "round_update", "dual_step")
REPLACES = {
    "gossip_update": "none (GossipDP.update's eager chain, "
                     "src/repro_torch/core/gossip.py)",
    "unembed_gemm": "none (the tied unembedding's f32 products and their "
                    "autograd backward, src/repro_torch/models/layers.py)",
    "round_stats": "src/repro/kernels/round_fused.py:130",
    "round_update": "src/repro/kernels/round_fused.py:194",
    "round_update_dense": "src/repro/kernels/round_fused.py:194",
    "round_update_hypercube": "src/repro/kernels/round_fused.py:194",
    "round_update_random": "src/repro/kernels/round_fused.py:194",
    "dual_step": "src/repro/kernels/round_fused.py:249",
    "pdomd_update": "src/repro/kernels/pdomd_update.py:49",
    "hinge_grad": "src/repro/kernels/hinge_grad.py:57",
}
SEED_SOURCES = {"gossip_update": "src/repro_torch/csrc/gossip_update.cu",
                "unembed_gemm": "src/repro_torch/csrc/unembed_gemm.cu",
                "pdomd_update": "src/repro_torch/csrc/pdomd_update.cu",
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
    from repro_torch.kernels import (gossip_update, hinge_grad,
                                     pdomd_update, round_fused, unembed_gemm)
    for module in (round_fused, pdomd_update, hinge_grad, gossip_update,
                   unembed_gemm):
        module.library()
    log(f"build: {secs:.1f} s")
    return secs


# -- 3. kernels --------------------------------------------------------------

def _graph(name: str, m: int):
    """The fixed graph ``name`` at m nodes (random: seed 0)."""
    from repro_torch.core.graph import SparseGraph, ring_edges
    return ring_edges(m) if name == "ring" else SparseGraph.make(name, m,
                                                                 seed=0)


def _inputs(m: int, n: int, seed: int, dev):
    """Random round inputs, a dense softmax A and, per fixed graph, its
    dense A, self weights and CSR form: the main path's ring at every
    shape, the Fig. 3 hypercube and random graphs at the main path's."""
    import torch
    from repro_torch.kernels.round_fused import MixCSR
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    A = torch.softmax(randn(m, m), dim=1)   # dense row-stochastic mix
    alive = torch.ones(m, device=dev)
    alive[m // 2] = 0.0                      # one crash-frozen row
    graphs = {}
    for name in ("ring",) + (FIG3_GRAPHS if (m, n) == (MAIN_M, MAIN_N)
                             else ()):
        graph = _graph(name, m)
        graphs[name] = (torch.as_tensor(graph.to_dense(), device=dev),
                        torch.as_tensor(graph.diag(), device=dev),
                        MixCSR.from_graph(graph, dev))
    return dict(theta=randn(m, n), x=randn(m, n) / math.sqrt(n),
                delta=0.1 * randn(m, n), recv=randn(m, n),
                mixed=randn(m, n), coeff=randn(m), A=A,
                diag=A.diagonal().contiguous(), alive=alive, graphs=graphs)


def _update_args(d, mix: str, use_recv=0, noise_self=True) -> tuple:
    """round_update's positional arguments with a fixed graph's A (by
    name) or the softmax A."""
    A, diag = d["graphs"][mix][:2] if mix in d["graphs"] \
        else (d["A"], d["diag"])
    return (A, d["theta"], d["delta"], d["x"], d["recv"], d["coeff"], diag,
            d["alive"], 0.25, use_recv, noise_self)


def _sparse_call(rf, d, mix: str, use_recv=0, noise_self=True):
    """(kernel call, plain call) of round_update with a fixed graph's A
    through the sparse path (its CSR form)."""
    args = _update_args(d, mix, use_recv, noise_self)
    csr = d["graphs"][mix][2]
    return (lambda: rf.round_update(*args, csr=csr),
            lambda: rf.round_update_plain(*args))


def _calls(rf, d, use_recv=0, noise_self=True):
    """(kernel call, plain call) per kernel on one input set:
    ``round_update`` mixes with the main path's ring through the sparse
    path (its CSR form), ``round_update_<graph>`` with the Fig. 3 graphs
    the same way where the input set has them, ``round_update_dense`` with
    the softmax A through the dense path."""
    stats = (d["theta"], d["x"], 0.5, d["theta"].shape[0])
    dense = _update_args(d, "softmax", use_recv, noise_self)
    dual = (d["mixed"], d["x"], d["theta"], d["coeff"], d["alive"], 0.25)
    calls = {
        "round_stats": (lambda: rf.round_stats(*stats),
                        lambda: rf.round_stats_plain(*stats)),
        "round_update": _sparse_call(rf, d, "ring", use_recv, noise_self),
        "round_update_dense": (lambda: rf.round_update(*dense),
                               lambda: rf.round_update_plain(*dense)),
        "dual_step": (lambda: rf.dual_step(*dual),
                      lambda: rf.dual_step_plain(*dual)),
    }
    for name in FIG3_GRAPHS:
        if name in d["graphs"]:
            calls[f"round_update_{name}"] = _sparse_call(rf, d, name,
                                                         use_recv, noise_self)
    return calls


# outputs that are sums over a node's row or a column (round_stats' four
# float outputs; round_update's next, through A @ r) — see _compare
REDUCED = {"round_stats": (0, 1, 3, 4), "round_update": (0,),
           "round_update_dense": (0,), "round_update_hypercube": (0,),
           "round_update_random": (0,), "dual_step": (), "pdomd_update": (),
           "hinge_grad": (0, 1, 2)}
REDESIGNED = ("round_stats", "round_update", "round_update_dense",
              "round_update_hypercube", "round_update_random")


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


def _work(name: str, m: int, n: int, nnz: int | None = None,
          seeds: int = 1) -> tuple[int, int]:
    """(bytes, flops) of one launch: the package's one count of a kernel's
    work (`repro_torch.kernels.work.work`, which the cost loop reads too):
    each input read once, each output written once, at the main path's
    flags; ``nnz`` selects round_update's CSR form, ``seeds`` a batch."""
    from repro_torch.kernels.work import work
    return work(name, m, n, nnz, seeds)


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
             "round_update_dense": "round_update (softmax A, dense path)",
             **{f"round_update_{g}": f"round_update ({g} A, sparse path, "
                f"{nnz} non-zeros)" for g in FIG3_GRAPHS}}
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
    ``round_update`` against the dense one with each fixed graph's A (bit
    for bit): the ring at BITWISE_SHAPES, the Fig. 3 hypercube and random
    graphs at the main path's shape.
    Returns each kernel's largest difference from its plain version."""
    import torch
    from repro_torch.kernels import round_fused as rf
    dev = torch.device("cuda")
    errs = {k: 0.0 for k in (*ROUND_KERNELS, "round_update_dense",
                             *(f"round_update_{g}" for g in FIG3_GRAPHS))}
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
            bitwise = list(d["graphs"]) if (m, n) in BITWISE_SHAPES else []
            for graph in bitwise:
                sparse = _sparse_call(rf, d, graph, use_recv, noise_self)[0]()
                dense = rf.round_update(*_update_args(d, graph, use_recv,
                                                      noise_self))
                require(all(torch.equal(a, b) for a, b in zip(sparse, dense)),
                        f"round_update: sparse and dense paths differ with "
                        f"the {graph} A at {where}")
        nnz = {g: int(torch.diff(f[2].indptr).max()) for g, f in
               d["graphs"].items()}
        del d, calls
        torch.cuda.synchronize()
        log(f"kernels agree with their plain versions at m={m}, n={n}"
            + (f"; round_update sparse == dense bit for bit with the "
               f"{', '.join(bitwise)} A (at most {nnz} non-zeros a row)"
               if bitwise else "")
            + "; two calls of each redesigned kernel equal bit for bit")
    _mixers_match_the_kernel(rf, dev)
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


def _mixers_match_the_kernel(rf, dev) -> None:
    """The reference backend's torch-op mixers against round_update's
    sparse-path mix (no noise, no step: out = A @ r), at the main path's
    shape: the edge-list mixer and the dense mixer must both equal it bit
    for bit on every fixed Fig. 3 graph and the torus, so the two
    backends' iterates part only by the clip and the dual step."""
    import torch
    from repro_torch.api import MIXERS
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    r = torch.randn(MAIN_M, MAIN_N, generator=g, device=dev)
    zeros = torch.zeros_like(r)
    zm, ones = torch.zeros(MAIN_M, device=dev), torch.ones(MAIN_M, device=dev)
    for name in ("torus", *FIG3_GRAPHS, "ring"):
        graph = _graph(name, MAIN_M)
        A = torch.as_tensor(graph.to_dense(), device=dev)
        diag = torch.as_tensor(graph.diag(), device=dev)
        kern = rf.round_update(A, r, zeros, zeros, r, zm, diag, ones, 0.0, 0,
                               True, csr=rf.MixCSR.from_graph(graph, dev))[0]
        for mixer in ("sparse", "dense"):
            got = MIXERS.build(mixer, {"topology": name}, m=MAIN_M,
                               seed=0).apply(r, 0)
            require(torch.equal(got, kern), f"the {mixer} mixer's {name} "
                    f"mix differs from round_update's at "
                    f"{int((got != kern).sum())} coordinates")
    log("the sparse and dense mixers equal round_update's mix bit for bit "
        "with the torus, hypercube, random and ring A")


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
    nnz = {f"round_update_{g}" if g != "ring" else "round_update":
           f[2].indices.numel() for g, f in sets[0]["graphs"].items()}
    results = {}
    for name in ("round_stats", "round_update_dense", "round_update",
                 *(f"round_update_{g}" for g in FIG3_GRAPHS), "dual_step"):
        results[name] = _measure(
            name, [_calls(rf, d)[name][0] for d in sets],
            [_calls(rf, d)[name][1] for d in sets], MAIN_M, MAIN_N,
            errs[name], SOURCE, card, nnz=nnz.get(name))
    keep = ("ms", "plain_ms", "bound_ms", "call_ms", "max_abs_err")
    dense = results.pop("round_update_dense")
    results["round_update"]["dense_path"] = {k: dense[k] for k in keep}
    for g in FIG3_GRAPHS:
        entry = results.pop(f"round_update_{g}")
        results["round_update"][f"{g}_sparse"] = {
            **{k: entry[k] for k in keep}, "nnz": nnz[f"round_update_{g}"]}
    del sets
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return results


# -- 3b. the round kernels' seed axis ---------------------------------------------

BATCH_SIZES = (3, 8)        # seeds of a batched launch held to S launches
BATCH_TIMED = (1, 3, 8)     # and timed
BATCH_MIXES = ("ring", "hypercube", "softmax")   # sparse, sparse, dense


def _batch_inputs(S: int, seed: int, dev) -> dict:
    """S seeds' round inputs at the main path's shape, each seed with one
    crash-frozen row of its own."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    m, n = MAIN_M, MAIN_N

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    alive = torch.ones((S, m), device=dev)
    alive[torch.arange(S), (7 * torch.arange(S) + 3) % m] = 0.0
    return dict(theta=randn(S, m, n), x=randn(S, m, n) / math.sqrt(n),
                delta=0.1 * randn(S, m, n), recv=randn(S, m, n),
                coeff=randn(S, m), alive=alive)


def _batch_calls(rf, b: dict, mixes: dict, mix: str, use_recv=0,
                 noise_self=True):
    """(batched kernel call, S one-seed kernel calls, batched plain call)
    of round_stats and of round_update with ``mix``'s A (its CSR form for
    the fixed graphs: the sparse path; the softmax A: the dense path)."""
    S = b["theta"].shape[0]
    A, diag, csr = mixes[mix]
    stats = (b["theta"], b["x"], 0.5, MAIN_M)
    upd = lambda d: (A, d["theta"], d["delta"], d["x"], d["recv"],  # noqa
                     d["coeff"], diag, d["alive"], 0.25, use_recv,
                     noise_self)
    seeds = [{k: v[i] for k, v in b.items()} for i in range(S)]
    return {
        "round_stats": (
            lambda: rf.round_stats(*stats),
            lambda: [rf.round_stats(d["theta"], d["x"], 0.5, MAIN_M)
                     for d in seeds],
            lambda: rf.round_stats_plain(*stats)),
        "round_update": (
            lambda: rf.round_update(*upd(b), csr=csr),
            lambda: [rf.round_update(*upd(d), csr=csr) for d in seeds],
            lambda: rf.round_update_plain(*upd(b), csr=csr)),
    }


def _mixes(d: dict) -> dict:
    """name -> (A, diag, CSR form or None) from an `_inputs` set."""
    out = {g: d["graphs"][g] for g in ("ring", "hypercube")}
    out["softmax"] = (d["A"], d["diag"], None)
    return out


def batch_kernel_phase(card: str) -> dict:
    """The seed axis of round_stats and round_update (`run_batch`'s
    launches) at S = 3 and 8 and the main path's shape: each batched
    launch equal bit for bit to S one-seed launches on the seeds' slices,
    and held to its batched plain version; round_stats one kernel and no
    memset per batched call. Then each timed at S = 1, 3, 8 beside its
    bound and beside S back-to-back one-seed launches. Returns the entries
    for the kernels line."""
    import torch
    from repro_torch.kernels import round_fused as rf
    dev = torch.device(DEVICE)
    mixes = _mixes(_inputs(MAIN_M, MAIN_N, seed=2, dev=dev))
    names = {"ring": "round_update", "hypercube": "round_update_hypercube",
             "softmax": "round_update_dense"}
    errs = {"round_stats": 0.0, **{v: 0.0 for v in names.values()}}
    for S in BATCH_SIZES:
        b = _batch_inputs(S, seed=100 + S, dev=dev)
        for mix in BATCH_MIXES:
            flags = UPDATE_FLAGS if mix == "ring" else ((0, True),)
            for use_recv, noise_self in flags:
                calls = _batch_calls(rf, b, mixes, mix, use_recv, noise_self)
                for kernel, (batched, one, plain) in calls.items():
                    if kernel == "round_stats" and (
                            mix != "ring" or use_recv or not noise_self):
                        continue
                    where = (f"S={S} m={MAIN_M} n={MAIN_N} mix={mix} "
                             f"use_recv={use_recv} noise_self={noise_self}")
                    got, ones = batched(), one()
                    for k, out in enumerate(got):
                        require(torch.equal(out, torch.stack(
                            [o[k] for o in ones])), f"batched {kernel} "
                            f"output {k} differs from {S} one-seed "
                            f"launches at {where}")
                    name = kernel if kernel == "round_stats" else names[mix]
                    errs[name] = max(errs[name], _compare(name, got,
                                                          plain(), where))
        names_ev = _device_events(_batch_calls(rf, b, mixes, "ring")[
            "round_stats"][0])
        require(len(names_ev) == 5 and not any("emset" in e
                                               for e in names_ev),
                f"batched round_stats (S={S}): 5 calls put {len(names_ev)} "
                f"device events on the card: {sorted(set(names_ev))}")
        del b
        log(f"batched round_stats and round_update (ring and hypercube "
            f"CSR, softmax A) at S={S}, {MAIN_M}x{MAIN_N}: bit for bit {S} "
            f"one-seed launches, within tolerance of the batched plain "
            f"versions; round_stats one kernel and no memset per call")
    torch.cuda.synchronize()

    out = {"round_stats": {}, "round_update": {}}
    nnz_ring = int(mixes["ring"][2].indices.numel())
    for S in BATCH_TIMED:
        # input sets rotated past the 50 MB L2, as the one-seed timing does
        sets = [_batch_inputs(S, seed=1000 * S + k, dev=dev)
                for k in range(max(3, -(-24 // S)))]
        for kernel in ("round_stats", "round_update"):
            calls = [_batch_calls(rf, b, mixes, "ring")[kernel]
                     for b in sets]
            ms = _device_ms(_rotate([c[0] for c in calls]))
            one_ms = (ms if S == 1 else
                      _device_ms(_rotate([c[1] for c in calls])))
            nbytes, flops = _work(kernel, MAIN_M, MAIN_N,
                                  nnz_ring if kernel == "round_update"
                                  else None, seeds=S)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            out[kernel][f"S{S}"] = dict(
                ms=ms, one_seed_launches_ms=one_ms, bound_ms=bound_ms,
                bytes=nbytes, max_abs_err=errs[kernel])
            what = (f"{kernel} (ring A, sparse path)"
                    if kernel == "round_update" else kernel)
            log(f"batched {what} S={S}: {ms * 1e3:.2f} us device time per "
                f"launch at "
                f"{S}x{MAIN_M}x{MAIN_N} | {nbytes / 1e6:.2f} MB, bound "
                f"{bound_ms * 1e3:.2f} us | {S} back-to-back one-seed "
                f"launches {one_ms * 1e3:.2f} us | {card}")
        del sets, calls
        torch.cuda.synchronize()
    out["round_update"]["errs"] = {k: v for k, v in errs.items()
                                   if k != "round_stats"}
    torch.cuda.empty_cache()
    return out


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
    """The paper's §V run, `repro_torch.configs.social_linear.CONFIG`, on
    the fused backend (the Laplace mechanism in its per-coordinate
    calibration, as the figures run it)."""
    from repro_torch import RunSpec
    from repro_torch.configs import social_linear
    cfg = social_linear.CONFIG
    base = dict(nodes=cfg.nodes, dim=cfg.n, horizon=cfg.rounds,
                stream="social_sparse", mixer=cfg.topology,
                mechanism="laplace", eps=cfg.eps, calibration="coordinate",
                clip_norm=cfg.L, alpha0=cfg.alpha0, schedule=cfg.schedule,
                lam=cfg.lam, seed=cfg.seed, backend="cuda")
    base.update(kw)
    return RunSpec(**base)


def _hold(ref, got, what: str, card: str,
          rounds: int = AGREE_ROUNDS) -> None:
    """Hold run ``got`` to run ``ref`` over their first ``rounds`` rounds:
    correct, sparsity, eps_ledger (and connectivity, where the runs carry
    one) exact; final_w, loss and w_bar_loss within FLOAT_TOL. Logs every
    field's max difference, and the first round where an exact field
    differs, before it requires anything."""
    import numpy as np
    exact = ("correct", "sparsity", "eps_ledger") + (
        ("connectivity",) if ref.connectivity is not None else ())
    d, first = {}, {}
    for f in exact + ("loss", "w_bar_loss"):
        diff = np.abs(np.asarray(getattr(got, f))[:rounds]
                      - np.asarray(getattr(ref, f))[:rounds])
        d[f] = float(diff.max())
        off = np.flatnonzero(diff.reshape(diff.shape[0], -1).max(axis=1))
        if f in exact and off.size:
            first[f] = int(off[0])
    d["final_w"] = float(np.abs(got.final_w - ref.final_w).max())
    log(f"{what}, {rounds} rounds, max abs differences: {d}"
        + (f"; first round differing: {first}" if first else "")
        + f" | {card}")
    for f in exact:
        require(d[f] == 0, f"{what}: {f} differs from round {first.get(f)}"
                f" on (max abs difference {d[f]})")
    for f in ("final_w", "loss", "w_bar_loss"):
        require(d[f] <= FLOAT_TOL, f"{what}: {f} off by {d[f]}")


def _launches() -> dict:
    """The round kernels' launch counts, round_update's sparse path apart."""
    from repro_torch.kernels import round_fused as rf
    out = {k: getattr(rf, k).launches for k in ROUND_KERNELS}
    out["round_update_sparse"] = rf.round_update.sparse_launches
    return out


def _require_path(launches: dict, path: str, T: int, what: str) -> None:
    """The kernels a run of T rounds must have launched on its path: every
    round through round_stats, then round_update on its sparse (CSR) or
    dense path, or dual_step after a torch-op mix (hybrid)."""
    want = {"round_stats": T,
            "round_update": T if path in ("sparse", "dense") else 0,
            "round_update_sparse": T if path == "sparse" else 0,
            "dual_step": T if path == "hybrid" else 0}
    require(launches == want, f"{what}: launches {launches}, expected "
            f"{want} on the {path} path")


def main_path(card: str):
    import numpy as np
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    from repro_torch.obs import Telemetry

    spec = paper_spec()
    T = spec.horizon
    # warmup=False: the kernels were built and loaded in phase 2, and a
    # warm-up chunk would add its rounds to each count; the run's own
    # telemetry (not the ambient one: the round's spans stay off) counts
    # the rounds replayed from the graph
    tel = Telemetry()
    cfg = ExecConfig(chunk_rounds=256, compute_regret=True, warmup=False,
                     obs=tel)
    rf.reset_launches()
    t0 = time.perf_counter()
    res = run(spec, exec=cfg, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = _launches()
    snap = tel.metrics.snapshot()
    rounds = (snap.get("round.graph_rounds"), snap.get("round.eager_rounds"))
    log(f"main path: {T} rounds, run() {wall:.2f} s with regret; round "
        f"loop {res.wall_clock:.3f} s = {res.rounds_per_sec:.1f} rounds/s; "
        f"launches {launches}; graphed/eager rounds {rounds} | {card}")
    require(rounds == (T, 0), f"main path: graphed/eager rounds {rounds}, "
            f"expected ({T}, 0)")
    _require_path(launches, "sparse", T, "main path")
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


def _kernel_events(events: list) -> dict:
    """How many of ``events`` each hand-written round kernel is, by the
    kernel's name in the trace."""
    return {k: sum(1 for e in events if re.search(rf"\b{k}\b", e.name))
            for k in ("stats_kernel", "update_sparse_kernel",
                      "update_dense_kernel", "dual_kernel")}


def idle_share(card: str) -> None:
    """Device idle share of 64 fused rounds: the profiler's device busy
    time over the round loop's time in an unprofiled run of the same
    rounds (stream generation included in both). The traced run's round
    kernels are counted on the card: one ``stats_kernel`` and one
    ``update_sparse_kernel`` a replayed round, and one of each for the
    eager round the capture runs before it captures."""
    from repro_torch import ExecConfig, run
    spec = paper_spec(horizon=AGREE_ROUNDS)
    cfg = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                     warmup=False)
    run(spec, exec=cfg, device=DEVICE)      # allocator and caches warm
    loop_us = run(spec, exec=cfg, device=DEVICE).wall_clock * 1e6
    events = _profiled(lambda: run(spec, exec=cfg, device=DEVICE), reps=1)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    if busy_us <= 0:
        log("device idle share: not measured (the profiler saw no device "
            "time)")
        return
    kernels = _kernel_events(events)
    want = {"stats_kernel": AGREE_ROUNDS + 1,
            "update_sparse_kernel": AGREE_ROUNDS + 1,
            "update_dense_kernel": 0, "dual_kernel": 0}
    log(f"traced run of {AGREE_ROUNDS} rounds: round kernels on the card "
        f"{kernels}")
    require(kernels == want, f"traced run: round kernels {kernels} on the "
            f"card, expected {want}")
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


HOLD_SEEDS = (0, 1, 2)


def long_agreement_phase(main, card: str) -> None:
    """The main path's fused run against the reference backend over the
    whole horizon (1,562 rounds) at seeds 0, 1 and 2 (seed 0's fused run is
    phase 4's)."""
    from repro_torch import ExecConfig, run
    cfg = ExecConfig(chunk_rounds=256, compute_regret=False, warmup=False)
    for seed in HOLD_SEEDS:
        spec = paper_spec(seed=seed)
        fused = main if seed == 0 else run(spec, exec=cfg, device=DEVICE)
        ref = run(spec.replace(backend="reference"), exec=cfg, device=DEVICE)
        _hold(fused, ref, f"main path, seed {seed}: reference vs fused "
              f"backend (reference {ref.rounds_per_sec:.1f} rounds/s)",
              card, rounds=spec.horizon)


def hybrid_phase(fused, card: str) -> int:
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    cfg = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                     warmup=False)
    spec = paper_spec(horizon=AGREE_ROUNDS,
                      backend_options={"mode": "hybrid"})
    rf.reset_launches()
    hyb = run(spec, exec=cfg, device=DEVICE)
    launches = _launches()
    log(f"hybrid path: launches {launches}")
    _require_path(launches, "hybrid", AGREE_ROUNDS, "hybrid run")
    _hold(fused, hyb, "hybrid vs fused", card)
    return launches["dual_step"]


def _same_run(dist, sim, what: str, ignore: tuple = ()) -> None:
    """Require a run's RunResult (a dist run, or one seed of a batch) to
    equal another's (the sim run, or the seed's own run) field by field,
    exactly (wall-clock fields, a batch's totals and the engine's name
    aside, and the telemetry run id in ``metrics``; ``ignore`` names more
    fields to leave out), and its final engine state too."""
    import dataclasses
    import numpy as np
    import torch
    skip = {"engine", "wall_clock", "rounds_per_sec", "final_state",
            *ignore}
    timing = {"engine", "wall_clock_s", "rounds_per_sec", "batch", "obs"}
    for f in dataclasses.fields(dist):
        if f.name in skip:
            continue
        a, b = getattr(dist, f.name), getattr(sim, f.name)
        if f.name == "metrics":         # summary() carries the timing
            a, b = ({k: v for k, v in m.items() if k not in timing}
                    for m in (a, b))
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b)
        require(bool(same), f"{what}: {f.name} differs")
    st, sst = dist.final_state, sim.final_state
    theta = lambda s: s.theta["w"] if isinstance(s.theta, dict) \
        else s.theta  # noqa: E731
    require(st.t == sst.t and torch.equal(theta(st), theta(sst))
            and torch.equal(st.generator.get_state(),
                            sst.generator.get_state()),
            f"{what}: final engine state differs")


def dist_phase(sim, card: str) -> dict:
    """The main path's run on the distributed engine: the fused kernels
    launch once per round, and its RunResult equals the simulator's field
    by field, exactly (wall-clock fields and the engine's name aside)."""
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    spec = paper_spec()
    T = spec.horizon
    cfg = ExecConfig(chunk_rounds=256, compute_regret=True, warmup=False)
    rf.reset_launches()
    dist = run(spec, engine="dist", exec=cfg, device=DEVICE)
    launches = _launches()
    log(f"dist path: {T} rounds, round loop {dist.wall_clock:.3f} s = "
        f"{dist.rounds_per_sec:.1f} rounds/s (sim, phase 4: "
        f"{sim.rounds_per_sec:.1f} rounds/s); launches {launches} | {card}")
    _require_path(launches, "sparse", T, "dist run")
    _same_run(dist, sim, "dist vs sim")
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


# -- 9-10. the topologies of Fig. 3 and the other stages ---------------------

# (name, RunSpec fields, path the fused backend's auto mode must take): the
# paper's Fig. 3 topology axis (benchmarks/fig3_topology.py) at its width
TOPOLOGY_RUNS = (
    ("hypercube", dict(mixer="hypercube"), "sparse"),
    ("random", dict(mixer="random"), "sparse"),
    ("torus", dict(mixer="sparse", mixer_options={"topology": "torus"}),
     "sparse"),
    ("dense-complete", dict(mixer="dense",
                            mixer_options={"topology": "complete"}), "dense"),
    ("complete", dict(mixer="complete"), "hybrid"),
    ("time_varying", dict(mixer="time_varying"), "hybrid"),
)
DIST_TOPOLOGIES = ("hypercube", "random")


def topology_phase(card: str) -> dict:
    """Each Fig. 3 topology at the paper's scale on the fused backend in
    auto mode, with regret: its rounds/s, accuracy, regret and launches
    per kernel and path (which must be its path's); its first 64 rounds
    held against the reference backend; hypercube and random also on the
    dist engine, equal to the sim run exactly. Returns per run its path,
    rounds/s and launches."""
    import numpy as np
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    cfg = ExecConfig(chunk_rounds=256, compute_regret=True, warmup=False)
    short = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                       warmup=False)
    out = {}
    for name, fields, path in TOPOLOGY_RUNS:
        spec = paper_spec(**fields)
        T = spec.horizon
        rf.reset_launches()
        res = run(spec, exec=cfg, device=DEVICE)
        launches = _launches()
        log(f"topology {name}: {path} path, {T} rounds, round loop "
            f"{res.wall_clock:.3f} s = {res.rounds_per_sec:.1f} rounds/s; "
            f"accuracy {res.accuracy:.4f}, regret[-1] "
            f"{float(res.regret[-1]):.1f}; launches {launches} | {card}")
        _require_path(launches, path, T, f"topology {name}")
        for f in ("final_w", "loss", "w_bar_loss", "sparsity", "regret"):
            require(bool(np.isfinite(np.asarray(getattr(res, f))).all()),
                    f"topology {name}: {f} not finite")
        out[name] = dict(path=path, rounds_per_sec=res.rounds_per_sec,
                         accuracy=res.accuracy,
                         regret_last=float(res.regret[-1]),
                         launches=launches)
        if name in DIST_TOPOLOGIES:
            rf.reset_launches()
            dist = run(spec, engine="dist", exec=cfg, device=DEVICE)
            _require_path(_launches(), path, T, f"topology {name} on dist")
            _same_run(dist, res, f"topology {name}: dist vs sim")
            log(f"topology {name}: dist {dist.rounds_per_sec:.1f} rounds/s; "
                f"every RunResult field and the final state equal to the "
                f"sim run, bit for bit | {card}")
            out[name]["dist_rounds_per_sec"] = dist.rounds_per_sec
        spec = spec.replace(horizon=AGREE_ROUNDS)
        fused = run(spec, exec=short, device=DEVICE)
        for f in ("correct", "sparsity", "loss", "w_bar_loss"):
            require(np.array_equal(
                np.asarray(getattr(fused, f)),
                np.asarray(getattr(res, f))[:AGREE_ROUNDS]),
                f"topology {name}: a rerun of 64 rounds differs in {f}")
        ref = run(spec.replace(backend="reference"), exec=short,
                  device=DEVICE)
        _hold(fused, ref, f"topology {name}: reference vs fused backend",
              card)
        del res
    return out


# (name, RunSpec fields, path) of the other stages, 64 rounds each at the
# paper's width, held against the reference backend
STAGE_RUNS = (
    ("gaussian", dict(mechanism="gaussian"), "sparse"),
    ("drift-reshuffle", dict(stream="drift", stream_options={"period": 16}),
     "sparse"),
    ("drift-rotate", dict(stream="drift", stream_options={
        "period": 16, "mode": "rotate"}), "sparse"),
    ("heterogeneous", dict(stream="heterogeneous"), "sparse"),
    ("bursty", dict(stream="bursty"), "sparse"),
    ("het_delayed", dict(delay=2, delay_dist="uniform"), "hybrid"),
)
# the stages only the reference backend runs (the fused round hard-codes
# the paper's rule and the per-node L2 clip)
REFERENCE_STAGES = (("tg", dict(local_rule="tg")),
                    ("rda", dict(local_rule="rda")),
                    ("value", dict(clipper="value")),
                    ("group", dict(prox_kind="group")))


def stages_phase(card: str) -> dict:
    """The ported mechanisms, streams and per-edge delays on the fused
    backend (64 rounds each, on their kernel path, held against the
    reference backend), and the rules, clipper and prox that only the
    reference backend runs (finite outputs). Returns per run its launches."""
    import numpy as np
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    cfg = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                     warmup=False)
    out = {}
    for name, fields, path in STAGE_RUNS:
        spec = paper_spec(horizon=AGREE_ROUNDS, **fields)
        rf.reset_launches()
        fused = run(spec, exec=cfg, device=DEVICE)
        launches = _launches()
        _require_path(launches, path, AGREE_ROUNDS, f"stage {name}")
        out[name] = launches
        ref = run(spec.replace(backend="reference"), exec=cfg, device=DEVICE)
        _hold(fused, ref, f"stage {name} ({path} path, launches {launches}):"
              " reference vs fused backend", card)
    for name, fields in REFERENCE_STAGES:
        res = run(paper_spec(horizon=AGREE_ROUNDS, backend="reference",
                             **fields), exec=cfg, device=DEVICE)
        for f in ("final_w", "loss", "w_bar_loss", "sparsity"):
            require(bool(np.isfinite(np.asarray(getattr(res, f))).all()),
                    f"stage {name}: {f} not finite")
        log(f"stage {name} on the reference backend: {AGREE_ROUNDS} rounds,"
            f" finite; final sparsity {float(res.sparsity[-1]):.4f}, "
            f"accuracy {res.accuracy:.4f} | {card}")
    return out


# -- 11. faults -----------------------------------------------------------------

DCN_CRASHED = (7, 10, 18, 35, 41)   # the dcn preset's crash windows at m=64,
#                                     horizon 1,562, fault seed 0 (8 rounds)
PARTITION = {"start": 16, "end": 32, "cut": 32}


def _per_round_profile(spec, rounds: int) -> tuple[float, float, float]:
    """(device events a round, device busy us, loop us) of the round body
    alone: ``rounds`` rounds of the spec's chunk program over a stream
    chunk made beforehand, from a fresh state. The events and busy time
    come from one profiled call, the loop's time from an unprofiled one
    (caches warm)."""
    import torch
    from repro_torch.api.runner import make_chunk_program
    from repro_torch.device import resolve_device, synchronize
    dev = resolve_device(DEVICE)
    chunk_fn, init_fn = make_chunk_program(spec, "sim", dev)
    for graph in chunk_fn.graphs:       # replayed, as run() would
        graph.plan(0, rounds, rounds)
    xs, ys = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in
              spec.resolve_stream(device=dev).chunk(0, rounds))

    def body():
        chunk_fn(init_fn(spec.seed), xs, ys)

    body()
    synchronize(dev)
    t0 = time.perf_counter()
    body()
    synchronize(dev)
    loop_us = (time.perf_counter() - t0) * 1e6
    events = _profiled(body, reps=1)
    busy_us = sum(e.time_range.elapsed_us() for e in events)
    return len(events) / rounds, busy_us, loop_us


def faults_phase(clean, card: str) -> dict:
    """Phase 11: the paper's run under the dcn preset (hybrid path: the
    faulty mixer has no fixed form), held to the reference backend over the
    whole horizon, its crashes in the accountant, the dist engine equal to
    the sim; a zero-rate scenario bit-identical to the clean hybrid run;
    a partition on the 8x8 torus held to the reference backend, its
    connectivity dipping exactly while it is up. Returns per run its
    dual_step launches."""
    import numpy as np
    from repro_torch import ExecConfig, degradation, run
    from repro_torch.kernels import round_fused as rf
    cfg = ExecConfig(chunk_rounds=256, compute_regret=True, warmup=False)
    short = ExecConfig(chunk_rounds=AGREE_ROUNDS, compute_regret=False,
                       warmup=False)
    out = {}

    spec = paper_spec(faults="dcn")
    T = spec.horizon
    rf.reset_launches()
    dcn = run(spec, exec=cfg, device=DEVICE)
    launches = _launches()
    log(f"faults dcn: hybrid path, {T} rounds, round loop "
        f"{dcn.wall_clock:.3f} s = {dcn.rounds_per_sec:.1f} rounds/s (clean "
        f"ring, phase 4: {clean.rounds_per_sec:.1f}); accuracy "
        f"{dcn.accuracy:.4f}, regret[-1] {float(dcn.regret[-1]):.1f}; "
        f"launches {launches}; metrics {json.dumps(dcn.metrics['faults'])}"
        f" | {card}")
    _require_path(launches, "hybrid", T, "faults dcn")
    out["dcn"] = launches["dual_step"]
    for f in ("final_w", "loss", "w_bar_loss", "sparsity", "regret",
              "connectivity"):
        require(bool(np.isfinite(np.asarray(getattr(dcn, f))).all()),
                f"faults dcn: {f} not finite")
    part = dcn.privacy["participated_rounds"]
    want = [T - 8 if i in DCN_CRASHED else T for i in range(MAIN_M)]
    require(part == want, f"faults dcn: participated_rounds {part}, "
            f"expected {T - 8} for nodes {DCN_CRASHED} and {T} elsewhere")
    require(dcn.metrics["faults"]["crash_windows"] == len(DCN_CRASHED),
            "faults dcn: crash windows")
    require(0.9 < dcn.metrics["faults"]["mean_connectivity"] < 1.0,
            "faults dcn: mean connectivity out of (0.9, 1)")
    log(f"faults dcn: degradation against the clean ring (phase 4): "
        f"{json.dumps(degradation(clean, dcn))}")
    ref = run(spec.replace(backend="reference"), exec=cfg.replace(
        compute_regret=False), device=DEVICE)
    _hold(dcn, ref, f"faults dcn: reference vs fused backend (reference "
          f"{ref.rounds_per_sec:.1f} rounds/s)", card, rounds=T)
    rf.reset_launches()
    dist = run(spec, engine="dist", exec=cfg, device=DEVICE)
    _require_path(_launches(), "hybrid", T, "faults dcn on dist")
    out["dcn-dist"] = T
    _same_run(dist, dcn, "faults dcn: dist vs sim")
    log(f"faults dcn: dist {dist.rounds_per_sec:.1f} rounds/s; every "
        f"RunResult field and the final state equal to the sim run, bit "
        f"for bit | {card}")
    # rounds/s of the clean ring and the dcn run in turns, 256 rounds
    # each; then device events a round and idle share of their round body
    turns = {"clean": [], "dcn": []}
    for name in ("clean", "dcn", "dcn", "clean", "clean", "dcn"):
        s = paper_spec(horizon=256,
                       **({"faults": "dcn"} if name == "dcn" else {}))
        turns[name].append(run(s, exec=short.replace(chunk_rounds=256),
                               device=DEVICE).rounds_per_sec)
    log(f"rounds/s over 256 rounds in turns clean, dcn, dcn, clean, "
        f"clean, dcn: clean {turns['clean']}, dcn {turns['dcn']} | {card}")
    for name, s in (("clean fused", paper_spec()),
                    ("clean hybrid",
                     paper_spec(backend_options={"mode": "hybrid"})),
                    ("dcn", paper_spec(faults="dcn"))):
        per_round, busy, loop = _per_round_profile(s, AGREE_ROUNDS)
        log(f"{name} round body: {per_round:.2f} device events a round; "
            f"busy {busy / 1e3:.3f} ms of {loop / 1e3:.3f} ms over "
            f"{AGREE_ROUNDS} rounds: idle share "
            f"{max(0.0, 1 - busy / loop):.3f} | {card}")

    # zero rates: bit-identical to the same clean sparse ring, hybrid mode
    spec = paper_spec(horizon=AGREE_ROUNDS, mixer="sparse",
                      backend_options={"mode": "hybrid"})
    base = run(spec, exec=short, device=DEVICE)
    rf.reset_launches()
    zero = run(spec.replace(faults="links",
                            faults_options={"link_rate": 0.0}),
               exec=short, device=DEVICE)
    _require_path(_launches(), "hybrid", AGREE_ROUNDS, "faults zero-rate")
    out["zero-rate"] = AGREE_ROUNDS
    for f in ("final_w", "loss", "correct", "w_bar_loss", "sparsity",
              "eps_ledger"):
        require(np.array_equal(getattr(zero, f), getattr(base, f)),
                f"faults zero-rate: {f} differs from the clean run")
    require(np.array_equal(zero.connectivity,
                           np.ones(AGREE_ROUNDS, np.float32)),
            "faults zero-rate: connectivity is not all ones")
    log(f"faults zero-rate (links, link_rate 0, sparse ring, hybrid): "
        f"{AGREE_ROUNDS} rounds bit for bit the clean run's | {card}")

    # a partition on the 8x8 torus, rounds 16-31, held to the reference
    spec = paper_spec(horizon=AGREE_ROUNDS, mixer="sparse",
                      mixer_options={"topology": "torus"},
                      faults="partition", faults_options=PARTITION)
    rf.reset_launches()
    cut = run(spec, exec=short, device=DEVICE)
    _require_path(_launches(), "hybrid", AGREE_ROUNDS, "faults partition")
    out["partition"] = AGREE_ROUNDS
    dips = np.flatnonzero(cut.connectivity < 1.0).tolist()
    log(f"faults partition: connectivity below 1 on rounds {dips} (min "
        f"{float(cut.connectivity.min()):.4f}) | {card}")
    require(dips == list(range(PARTITION["start"], PARTITION["end"])),
            "faults partition: connectivity must dip exactly on rounds "
            f"{PARTITION['start']}-{PARTITION['end'] - 1}")
    ref = run(spec.replace(backend="reference"), exec=short, device=DEVICE)
    _hold(cut, ref, "faults partition: reference vs fused backend", card)
    return out


# -- 12-13. seed batches and the Fig. 2 sweep ------------------------------------

BATCH_SEEDS = (0, 1, 2)
TURN_ROUNDS = 512
DCN_BATCH_ROUNDS = 256      # the dcn preset's first crash starts at 172
FIG2_EPS = (0.1, 1.0, 10.0, math.inf)   # benchmarks/fig2_privacy.py's axis


def batch_phase(main, card: str) -> dict:
    """Phase 12: `run_batch` at the paper's scale, seeds 0-2, fused, with
    regret — one launch of each round kernel a round for the three seeds
    (1,562 each, all sparse), every seed equal to its own `run()` field by
    field (seed 0's is phase 4's), the dist batch equal to the sim batch;
    64 rounds of a hybrid batch (complete) and 256 of a dcn batch (the
    fault schedule of the paper's horizon, so its crash windows), each
    seed equal to its run();
    then seed-rounds/s of the batch (S = 3, and S = 8) against three
    sequential runs, in turns. Returns the batch's launches."""
    import statistics as st
    from repro_torch import ExecConfig, run, run_batch
    from repro_torch.kernels import round_fused as rf
    spec = paper_spec()
    T, S = spec.horizon, len(BATCH_SEEDS)
    cfg = ExecConfig(chunk_rounds=256, compute_regret=True, warmup=False)
    rf.reset_launches()
    t0 = time.perf_counter()
    batch = run_batch(spec, BATCH_SEEDS, exec=cfg, device=DEVICE)
    wall = time.perf_counter() - t0
    launches = _launches()
    info = batch[0].metrics["batch"]
    log(f"batch: seeds {list(BATCH_SEEDS)}, {T} rounds, run_batch() "
        f"{wall:.2f} s with regret; round loop {info['wall_clock_s']:.3f} s "
        f"= {info['seed_rounds_per_sec']:.1f} seed-rounds/s; launches "
        f"{launches} | {card}")
    _require_path(launches, "sparse", T, "batch of seeds 0-2")
    for seed, res in zip(BATCH_SEEDS, batch):
        one = main if seed == 0 else run(paper_spec(seed=seed), exec=cfg,
                                         device=DEVICE)
        _same_run(res, one, f"batch seed {seed} vs its run()")
        log(f"batch seed {seed}: every RunResult field and the final state "
            f"equal to its run() ({one.rounds_per_sec:.1f} rounds/s), bit "
            f"for bit; accuracy {res.accuracy:.4f}, regret[-1] "
            f"{float(res.regret[-1]):.1f} | {card}")
    rf.reset_launches()
    dist = run_batch(spec, BATCH_SEEDS, "dist", exec=cfg, device=DEVICE)
    _require_path(_launches(), "sparse", T, "dist batch")
    for seed, d, sim in zip(BATCH_SEEDS, dist, batch):
        _same_run(d, sim, f"dist batch seed {seed} vs sim batch")
    log(f"dist batch: {dist[0].metrics['batch']['seed_rounds_per_sec']:.1f} "
        f"seed-rounds/s; every seed equal to the sim batch's, bit for bit "
        f"| {card}")
    del dist

    short = cfg.replace(chunk_rounds=AGREE_ROUNDS, compute_regret=False)
    for name, s, horizon, path in (
            ("complete", paper_spec(mixer="complete"), AGREE_ROUNDS,
             "hybrid"),
            ("dcn", paper_spec(faults="dcn"),
             min(DCN_BATCH_ROUNDS, PAPER_T), "hybrid")):
        rf.reset_launches()
        got = run_batch(s, BATCH_SEEDS, exec=short, horizon=horizon,
                        device=DEVICE)
        _require_path(_launches(), path, horizon, f"{name} batch")
        for seed, res in zip(BATCH_SEEDS, got):
            _same_run(res, run(s.replace(seed=seed), exec=short,
                               horizon=horizon, device=DEVICE),
                      f"{name} batch seed {seed} vs its run()")
        part = got[0].privacy.get("participated_rounds")
        log(f"{name} batch: {horizon} rounds on the {path} path, every seed "
            f"equal to its run(), bit for bit; fewest rounds a node took "
            f"part in: {min(part) if part else horizon} | {card}")

    # seed-rounds/s of a batch against S sequential runs, in turns
    turn = cfg.replace(compute_regret=False)
    short_spec = paper_spec(horizon=TURN_ROUNDS)
    rates = {"batch3": [], "sequential": [], "batch8": []}
    order = ("batch3", "sequential", "batch8", "batch8", "sequential",
             "batch3", "sequential", "batch3", "batch8")
    for kind in order:
        if kind == "sequential":
            walls = [run(short_spec.replace(seed=s), exec=turn,
                         device=DEVICE).wall_clock for s in BATCH_SEEDS]
            rates[kind].append(S * TURN_ROUNDS / sum(walls))
        else:
            seeds = BATCH_SEEDS if kind == "batch3" else tuple(range(8))
            rates[kind].append(run_batch(
                short_spec, seeds, exec=turn, device=DEVICE)[0].metrics[
                "batch"]["seed_rounds_per_sec"])
    ratio = st.median(rates["batch3"]) / st.median(rates["sequential"])
    log(f"seed-rounds/s over {TURN_ROUNDS} rounds in turns {order}: "
        f"{json.dumps(rates)}; median batch of 3 / sequential {ratio:.2f} "
        f"| {card}")
    return {"launches": launches, "seed_rounds_per_sec": rates,
            "batch3_over_sequential": ratio, "results": batch}


def sweep_phase(card: str) -> dict:
    """Phase 13: the paper's Fig. 2 axis (eps 0.1, 1, 10, inf x seeds 0-2,
    the paper's scale, fused, regret on) through `repro_torch.sweep` into a
    temporary store; a second sweep with reuse=True, require_store=True
    must run nothing and give the same aggregates."""
    import tempfile
    from repro_torch.sweep import SweepSpec, sweep
    sw = SweepSpec(base=paper_spec(), axes={"eps": FIG2_EPS},
                   seeds=BATCH_SEEDS, name="fig2_eps", chunk_rounds=256,
                   compute_regret=True)
    with tempfile.TemporaryDirectory() as store:
        t0 = time.perf_counter()
        out = sweep(sw, store=store, warmup=False, device=DEVICE)
        ran_s = time.perf_counter() - t0
        require(out.ran_points == len(FIG2_EPS), "fig2 sweep: ran "
                f"{out.ran_points} points")
        t0 = time.perf_counter()
        again = sweep(sw, store=store, reuse=True, require_store=True,
                      warmup=False, device=DEVICE)
        load_s = time.perf_counter() - t0
    require(again.ran_points == 0 and again.loaded_points == len(FIG2_EPS),
            f"fig2 sweep from the store: ran {again.ran_points}")
    rows = {}
    for metric in ("accuracy", "regret_final"):
        rows[metric] = out.aggregate(metric)
        require(again.aggregate(metric) == rows[metric],
                f"fig2 sweep: the store's {metric} aggregates differ")
    for acc, reg in zip(rows["accuracy"], rows["regret_final"]):
        require(all(math.isfinite(v) for v in acc["values"] + reg["values"]),
                f"fig2 sweep eps={acc['eps']}: non-finite values")
        log(f"fig2 eps={acc['eps']}: accuracy {acc['mean']:.4f} +- "
            f"{acc['std']:.4f}, regret_final {reg['mean']:.1f} +- "
            f"{reg['std']:.1f} over seeds {list(BATCH_SEEDS)} | {card}")
    log(f"fig2 sweep: {len(FIG2_EPS)} points x {len(BATCH_SEEDS)} seeds ran "
        f"in {ran_s:.1f} s (runs and store); reloaded from the store in "
        f"{load_s:.1f} s, nothing re-run, the same aggregates | {card}")
    return {"ran_s": ran_s, "load_s": load_s, "sweep": out}


# -- 14-15. serving while learning, and telemetry ----------------------------

SERVE_CHUNK = 64
SERVE_TICKS = 256
SERVE_CRASH = 640
SERVE_BUDGET = 10.0
SERVE_TURNS = ("loaded", "idle", "idle", "loaded", "loaded", "idle")
SERVE_PACED = 64.0          # ticks/s: ~7,900 requests/s offered
OBS_ROUNDS = 256
OBS_CHUNK = 64
OBS_TURNS = ("off", "on", "on", "off", "off", "on")


class _HostStream:
    """A bursty stream's first rounds, made beforehand and kept on the host:
    the replay's requests are ready before the service starts, so the
    replay overlaps the trainer from its first round."""

    def __init__(self, stream, rounds: int):
        self._counts = stream.counts(0, rounds).cpu().numpy()
        self._xs = stream.chunk(0, rounds)[0].cpu().numpy()

    def counts(self, t0: int, t1: int):
        return self._counts[t0:t1]

    def chunk(self, t0: int, t1: int):
        return self._xs[t0:t1], None


def _serve_config(spec, **kw):
    from repro_torch.serve import ServeConfig
    base = dict(spec=spec, chunk_rounds=SERVE_CHUNK, max_batch=32,
                max_wait_ms=1.0, queue_capacity=1024,
                keep_snapshots=spec.horizon // SERVE_CHUNK + 2,
                warmup=False, device=DEVICE)
    return ServeConfig(**{**base, **kw})


def _serve_once(spec, replay, rate: float | None = None,
                timeout_s: float = 600.0) -> dict:
    """One service over the whole horizon, with ``replay`` driving
    SERVE_TICKS ticks from the trainer's first publication (open throttle,
    or ``rate`` ticks/s), or no replay; the trainer joined at the last
    round before stop(). Returns the service, the replay's result, the
    trainer's rounds/s over its run and over the replay's window (its
    rounds there counted by ``round_stats`` launches, one a round, up to
    the trainer's last publication), and the round kernels' launches of
    this service's trainer."""
    from repro_torch.kernels import round_fused as rf
    from repro_torch.serve import ServeService
    svc = ServeService(_serve_config(spec))
    stamps = []
    publish = svc.trainer.on_publish
    svc.trainer.on_publish = lambda snap: (
        stamps.append((time.perf_counter(), snap.round)), publish(snap))
    rf.reset_launches()
    svc.start()
    out, window = None, None
    if replay is not None:
        # the first trained snapshot is out before the burst, so every
        # response names a snapshot the trainer published
        deadline = time.perf_counter() + timeout_s
        while svc.state.published < 2 and time.perf_counter() < deadline:
            time.sleep(1e-3)
        r0, t0 = rf.round_stats.launches, time.perf_counter()
        out = replay.drive(svc, 0, SERVE_TICKS, rate_ticks_per_s=rate,
                           timeout_s=timeout_s)
        window = (r0, t0, rf.round_stats.launches, time.perf_counter())
    svc.trainer.join(timeout_s)
    launches = _launches()
    svc.stop(timeout_s)
    rate_in_window = None
    if window is not None:
        r0, t0, r1, t1 = window
        end = min(t1, stamps[-1][0])      # the trainer may finish first
        if r1 > r0 and end > t0:
            rate_in_window = (r1 - r0) / (end - t0)
    return {"svc": svc, "replay": out, "window": window,
            "rate": svc.trainer.result.rounds_per_sec,
            "rate_in_window": rate_in_window, "launches": launches}


def _serve_stats(run: dict) -> str:
    """The replay's counts, QPS, latency, staleness (rounds of publication
    lag, the reference's measure: 0 while nothing is published) and the
    served snapshot's age (publication to answer: grows while the trainer
    stalls) of one service."""
    import numpy as np
    svc, out = run["svc"], run["replay"]
    lat = np.asarray(svc.stats_.latencies_s) * 1e3
    stale = np.asarray(svc.stats_.staleness, np.float64)
    age = np.asarray(svc.stats_.snapshot_ages_s) * 1e3
    adm = svc.stats()["admission"]
    return (f"{out['submitted']} requests over {SERVE_TICKS} ticks (40 KB "
            f"each): served {out['served']}, shed {out['shed']} "
            f"({adm['shed_reasons']}), refused {out['refused']} in "
            f"{out['wall_s']} s = {out['qps']} QPS; {adm['batches']} "
            f"batches (mean {adm['mean_batch']}); latency p50 "
            f"{float(np.percentile(lat, 50))} ms, p99 "
            f"{float(np.percentile(lat, 99))} ms; staleness (publication "
            f"lag) mean {float(stale.mean())}, max {int(stale.max())} "
            f"rounds; served snapshot's age mean {float(age.mean())} ms, "
            f"max {float(age.max())} ms; trainer {run['rate_in_window']} "
            f"rounds/s in the replay's window")


def serve_phase(card: str) -> dict:
    """Phase 14: `repro_torch.serve` at the paper's width on the bursty
    stream (m=64, n=10,000, T=1,562, ring, Laplace eps=1, fused): a
    service whose trainer publishes every 64 rounds while `BurstyReplay`
    drives 256 ticks at open throttle. The trainer launches each round
    kernel once a round, all sparse; a served request's snapshot equals a
    fresh run to its round bit for bit and its margin and label a re-run of
    the predict step; the last snapshot equals ``run(spec).final_w``. A
    service crashed at round 640 restarts once from its checkpoint and ends
    bit for bit on the clean one; a sequential-composition service with
    eps budget 10 (chunk 4) exhausts at round 8 and refuses. The trainer's
    rounds/s with and without the replay's load, in turns; and one more
    service with the replay paced at SERVE_PACED ticks/s. Returns the
    launches of the first loaded service."""
    import statistics as st
    import tempfile
    import numpy as np
    import torch
    from repro_torch import ExecConfig, run
    from repro_torch.serve import BurstyReplay, ServeService
    spec = paper_spec(stream="bursty")
    T = spec.horizon
    host = _HostStream(spec.resolve_stream(device=DEVICE), SERVE_TICKS)
    replay = BurstyReplay(host)
    runs = {"loaded": [], "idle": []}
    for kind in SERVE_TURNS:
        runs[kind].append(_serve_once(spec, replay if kind == "loaded"
                                      else None))
    first = runs["loaded"][0]
    _require_path(first["launches"], "sparse", T, "serve trainer")
    svc, out = first["svc"], first["replay"]
    require(out["submitted"] == replay.total_requests(0, SERVE_TICKS)
            and out["served"] + out["shed"] + out["refused"]
            == out["submitted"], f"serve: requests lost: {out}")
    require(out["served"] > 0 and out["refused"] == 0,
            f"serve: served {out['served']}, refused {out['refused']}")
    final = svc.state.current
    require(final.round == T and svc.trainer.round == T,
            f"serve: trainer stopped at {svc.trainer.round}")

    served = [r for r in out["requests"] if r.status == "ok"]
    sample = max(served, key=lambda r: r.snapshot_version)
    require(sample.snapshot_round > 0, "serve: no request was served "
            "from a trained snapshot")
    require(svc.verify(sample), f"serve: the request served from round "
            f"{sample.snapshot_round} differs from a fresh run to it")
    full = run(spec, exec=ExecConfig(chunk_rounds=256, compute_regret=False,
                                     warmup=False), device=DEVICE)
    require(np.array_equal(final.w.cpu().numpy(), full.final_w),
            "serve: the last snapshot differs from run(spec).final_w")
    log(f"serve: request at node {sample.node} served from snapshot "
        f"{sample.snapshot_version} (round {sample.snapshot_round}) equals "
        f"a fresh run to that round and a re-run of the predict step, bit "
        f"for bit; the last snapshot (round {final.round}) equals "
        f"run(spec).final_w, bit for bit | {card}")

    log(f"serve, open throttle: {_serve_stats(first)} | {card}")
    paced = _serve_once(spec, replay, rate=SERVE_PACED)
    log(f"serve, paced at {SERVE_PACED} ticks/s: {_serve_stats(paced)} "
        f"| {card}")
    loaded = [r["rate_in_window"] for r in runs["loaded"]]
    whole = [r["rate"] for r in runs["loaded"]]
    idle = [r["rate"] for r in runs["idle"]]
    measured = [x for x in loaded if x is not None]
    ratio = (st.median(measured) / st.median(idle) if measured
             else "not measured (the trainer ran no round in a window)")
    log(f"serve: trainer rounds/s in turns {SERVE_TURNS}: under the "
        f"replay's load (its rounds in the replay's window) {loaded}, whole "
        f"loaded runs {whole}, no load {idle}; median under load / no load "
        f"{ratio}; replay windows "
        f"{[r['replay']['wall_s'] for r in runs['loaded']]} s | {card}")
    for r in runs["loaded"][1:] + runs["idle"] + [paced]:
        require(torch.equal(r["svc"].state.current.w, final.w),
                "serve: the services' last snapshots differ")

    with tempfile.TemporaryDirectory() as ckpt:
        crashed = ServeService(_serve_config(
            spec, crash_at_round=SERVE_CRASH, checkpoint_dir=ckpt)).start()
        crashed.trainer.join(600)
        crashed.stop()
    snap = crashed.state.current
    require(crashed.trainer.restarts == 1,
            f"serve crash: {crashed.trainer.restarts} restarts")
    require(snap.round == T and all(torch.equal(getattr(snap, f),
                                                getattr(final, f))
                                    for f in ("theta", "w", "w_bar")),
            "serve crash: the restarted trainer's last snapshot differs")
    log(f"serve crash at round {SERVE_CRASH}: one restart from the round "
        f"{SERVE_CRASH - SERVE_CHUNK} checkpoint, last snapshot (round {T}) "
        f"equal to the clean service's, bit for bit | {card}")

    seq = ServeService(_serve_config(
        spec, chunk_rounds=4, composition="sequential",
        eps_budget=SERVE_BUDGET)).start()
    deadline = time.perf_counter() + 120
    while not seq.exhausted() and time.perf_counter() < deadline:
        time.sleep(0.01)
    refused = seq.submit(np.ones(spec.dim, np.float32), node=0).wait(60)
    seq.stop()
    require(seq.exhausted() and seq.state.current.round == 8
            and refused.status == "refused",
            f"serve sequential: exhausted {seq.exhausted()} at round "
            f"{seq.state.current.round}, request {refused.status}")
    log(f"serve sequential, eps budget {SERVE_BUDGET}: exhausted at round "
        f"{seq.state.current.round} (eps {seq.eps_spent()}), next request "
        f"{refused.status} | {card}")
    return {"launches": first["launches"], "qps": out["qps"],
            "loaded": loaded, "idle": idle}


def _trace_kernels(trace_dir) -> dict:
    """The device events of the round kernels in the profiler's Chrome
    traces under ``trace_dir``: {kernel: count} (host-side launch events
    are named after the runtime call, not the kernel)."""
    counts = {"round_stats": 0, "round_update": 0}
    for path in Path(trace_dir).glob("trace_*.json"):
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        for e in events:
            name = str(e.get("name", ""))
            if e.get("ph") == "X" and "stats_kernel" in name:
                counts["round_stats"] += 1
            elif e.get("ph") == "X" and "update_sparse_kernel" in name:
                counts["round_update"] += 1
    return counts


def telemetry_phase(card: str) -> dict:
    """Phase 15: 256 rounds of the main path in chunks of 64 with
    `repro_torch.obs` telemetry on (event stream, spans, metrics, the
    profiler) equal to the run with it off, field by field and state, bit
    for bit; the stream holds run_start, chunk x 4 and run_end, and
    ``launch.obs report`` renders it; the profiler's Chrome trace holds the
    round kernels' device events. Then rounds/s off and on (events and
    spans, no profiler) in turns."""
    import contextlib
    import io
    import statistics as st
    import tempfile
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    from repro_torch.launch import obs as obs_cli
    from repro_torch.obs import Telemetry, read_events
    spec = paper_spec(horizon=OBS_ROUNDS)
    cfg = ExecConfig(chunk_rounds=OBS_CHUNK, compute_regret=False,
                     warmup=False)
    off = run(spec, exec=cfg, device=DEVICE)
    with tempfile.TemporaryDirectory() as d:
        for attempt in range(1, PROFILER_TRIES + 1):
            events, prof = Path(d) / f"events{attempt}.jsonl", \
                Path(d) / f"prof{attempt}"
            tel = Telemetry(events=str(events), profile_dir=str(prof))
            rf.reset_launches()
            on = run(spec, exec=cfg.replace(obs=tel), device=DEVICE)
            launches = _launches()
            tel.close()
            kernels = _trace_kernels(prof)
            if all(kernels.values()):
                break
            log(f"telemetry: profiler session {attempt} of {PROFILER_TRIES}"
                f" recorded no round kernel: {kernels}")
        _require_path(launches, "sparse", OBS_ROUNDS, "telemetry run")
        _same_run(on, off, "telemetry on vs off")
        kinds = [e["event"] for e in read_events(str(events))]
        require(kinds == ["run_start"] + ["chunk"] * (OBS_ROUNDS // OBS_CHUNK)
                + ["run_end"], f"telemetry: event stream {kinds}")
        require(all(kernels.values()), f"telemetry: the profiler's trace "
                f"holds no round kernel event: {kernels}")
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            code = obs_cli.main(["report", "--events", str(events)])
        report = text.getvalue()
        require(code == 0 and f"run {on.metrics['obs']['run_id']}" in report
                and f"chunks: {OBS_ROUNDS // OBS_CHUNK}" in report,
                f"telemetry: report rendered {report!r} (exit {code})")
    spans = tel.tracer.summary()
    log(f"telemetry: {OBS_ROUNDS} rounds with events, spans and the "
        f"profiler equal to the run without, bit for bit; events {kinds}; "
        f"spans {json.dumps(spans)}; trace device events {kernels}; "
        f"profiled run {on.rounds_per_sec} rounds/s | {card}")
    log("telemetry: launch.obs report:\n" + report.rstrip())
    rates = {"off": [], "on": []}
    for kind in OBS_TURNS:
        tel = Telemetry() if kind == "on" else None
        rates[kind].append(run(spec, exec=cfg.replace(obs=tel),
                               device=DEVICE).rounds_per_sec)
    ratio = st.median(rates["on"]) / st.median(rates["off"])
    log(f"telemetry: rounds/s over {OBS_ROUNDS} rounds in turns "
        f"{OBS_TURNS} (on: spans, metrics and events, no profiler): "
        f"{json.dumps(rates)}; median on / off {ratio} | {card}")
    return {"launches": launches, "rates": rates,
            "profiled_rate": on.rounds_per_sec}


RUNNER_CHUNK = 256
RUNNER_TURNS = ("plain", "log", "log", "plain", "plain", "log")
SHIM_ROUNDS = 64


def _custom_mode(spec, main, card: str) -> dict:
    """Phase 16a: ``run(spec, step_fn=, state=, batches=, horizon=)`` with
    one fused round of the main path's chunk program a step, the stream's
    rounds as the batches; equal to phase 4's run bit for bit."""
    import numpy as np
    from repro_torch import run
    from repro_torch.api.runner import (_final_primal, _stream_chunk,
                                        make_chunk_program)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import round_fused as rf
    dev = resolve_device(DEVICE)
    T = spec.horizon
    chunk_fn, init_fn = make_chunk_program(spec, "sim", dev)
    stream = spec.resolve_stream(device=dev)

    def step_fn(state, batch):
        state, out = chunk_fn(state, *batch)
        # the means numpy takes of phase 4's host trajectories, so the
        # history holds to them bit for bit (one host read a step)
        return state, {"loss": out.loss.cpu().numpy().mean(),
                       "accuracy": out.correct.cpu().numpy().mean()}

    def rounds():
        for t in range(T):
            yield _stream_chunk(stream, t, t + 1, dev)

    rf.reset_launches()
    res = run(spec, step_fn=step_fn, state=init_fn(spec.seed),
              batches=rounds(), horizon=T, device=DEVICE)
    launches = _launches()
    _require_path(launches, "sparse", T, "custom mode")
    final_w = _final_primal(spec, "sim", res.final_state)
    require(np.array_equal(final_w, main.final_w),
            "custom mode: final primal differs from phase 4's final_w")
    losses = [h["loss"] for h in res.history]
    require(losses == [float(row.mean()) for row in main.loss],
            "custom mode: history's losses differ from phase 4's row means")
    require(np.array_equal(res.eps_ledger, main.eps_ledger),
            "custom mode: eps ledger differs")
    log(f"runner surface, custom mode: {T} steps of one fused round, "
        f"final primal and {len(losses)} losses equal to phase 4 bit for "
        f"bit; {res.rounds_per_sec:.1f} rounds/s (a host read every step; "
        f"phase 4 {main.rounds_per_sec:.1f}); launches {launches} | {card}")
    return {"launches": launches, "rate": res.rounds_per_sec}


def _csv_log(spec, main, card: str) -> dict:
    """Phase 16b: the main path with ``ExecConfig(log_path=...)`` — one
    row a round, each the RunResult's trajectories as ``str(float)``
    writes them, the result equal to phase 4's — then rounds/s with and
    without the log, in turns."""
    import statistics as st
    import tempfile
    from repro_torch import ExecConfig, run
    T = spec.horizon
    cfg = ExecConfig(chunk_rounds=RUNNER_CHUNK, compute_regret=True,
                     warmup=False)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "run.csv")
        res = run(spec, exec=cfg.replace(log_path=path), device=DEVICE)
        lines = Path(path).read_text().strip().splitlines()
        _same_run(res, main, "CSV-logged run vs phase 4")
        require(len(lines) == T + 1, f"CSV log: {len(lines)} lines")
        require(lines[0] == "step,accuracy,eps,loss,sparsity,w_bar_loss",
                f"CSV log: header {lines[0]!r}")
        want = [",".join((str(t), str(float(res.correct[t].mean())),
                          str(float(res.eps_ledger[t])),
                          str(float(res.loss[t].mean())),
                          str(float(res.sparsity[t])),
                          str(float(res.w_bar_loss[t])))) for t in range(T)]
        require(lines[1:] == want, "CSV log: rows differ from the "
                "RunResult's trajectories")
        log(f"runner surface, CSV log: {len(lines)} lines, every row the "
            f"RunResult's trajectories; the run equal to phase 4 bit for "
            f"bit; {res.rounds_per_sec:.1f} rounds/s | {card}")
        rates = {"plain": [], "log": []}
        turn = cfg.replace(compute_regret=False)
        for i, kind in enumerate(RUNNER_TURNS):
            c = turn.replace(log_path=str(Path(d) / f"t{i}.csv")) \
                if kind == "log" else turn
            rates[kind].append(run(spec, exec=c,
                                   device=DEVICE).rounds_per_sec)
    ratio = st.median(rates["log"]) / st.median(rates["plain"])
    log(f"runner surface, CSV log: rounds/s over {T} rounds in turns "
        f"{RUNNER_TURNS}: {json.dumps(rates)}; median log / plain {ratio}"
        f" | {card}")
    return {"rates": rates}


def _shim(spec, card: str) -> None:
    """Phase 16c: 64 rounds through the legacy kwargs — one
    DeprecationWarning — equal to the ``exec=`` run bit for bit."""
    import warnings
    from repro_torch import ExecConfig, run
    from repro_torch.api import exec_config
    short = spec.replace(horizon=SHIM_ROUNDS)
    via_exec = run(short, exec=ExecConfig(chunk_rounds=16, warmup=False,
                                          compute_regret=False),
                   device=DEVICE)
    exec_config._warned_legacy = False
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        via_legacy = run(short, chunk_rounds=16, warmup=False,
                         compute_regret=False, device=DEVICE)
        run(short, chunk_rounds=16, warmup=False, compute_regret=False,
            device=DEVICE)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    require(len(dep) == 1 and "ExecConfig" in str(dep[0].message),
            f"shim: {len(dep)} DeprecationWarnings")
    _same_run(via_legacy, via_exec, "legacy kwargs vs exec=")
    log(f"runner surface, legacy shim: {SHIM_ROUNDS} rounds via "
        f"chunk_rounds=/warmup=/compute_regret= kwargs equal to the exec= "
        f"run bit for bit; one DeprecationWarning over two calls | {card}")


def _count_differences(card_cost, cpu_cost) -> list:
    """The ops whose rows differ between two counts, by name."""
    names = sorted(set(card_cost.ops) | set(cpu_cost.ops))
    return [(n, card_cost.ops.get(n), cpu_cost.ops.get(n)) for n in names
            if card_cost.ops.get(n) != cpu_cost.ops.get(n)]


def _cost_loop(spec, main, card: str) -> dict:
    """Phase 16d: the main path with ``Telemetry(events, cost=True)``:
    equal to phase 4 bit for bit, events run_start, chunk x 7, chunk_cost,
    run_end, ``launch.obs report`` renders the cost line; one round's op
    count on the card equal to the CPU's (plain versions), op by op."""
    import contextlib
    import io
    import tempfile
    import torch
    from repro_torch import ExecConfig, run
    from repro_torch.api.runner import (_copy_state, _stream_chunk,
                                        make_chunk_program)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import round_fused as rf
    from repro_torch.launch import obs as obs_cli
    from repro_torch.launch.op_cost import count
    from repro_torch.obs import Telemetry, read_events
    T = spec.horizon
    chunks = -(-T // RUNNER_CHUNK)
    cfg = ExecConfig(chunk_rounds=RUNNER_CHUNK, compute_regret=True,
                     warmup=False)
    with tempfile.TemporaryDirectory() as d:
        events = str(Path(d) / "events.jsonl")
        tel = Telemetry(events=events, cost=True)
        rf.reset_launches()
        res = run(spec, exec=cfg.replace(obs=tel), device=DEVICE)
        launches = _launches()
        tel.close()
        kinds = [e["event"] for e in read_events(events)]
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            code = obs_cli.main(["report", "--events", events])
    report = text.getvalue()
    # the counting round is one more launch of each kernel
    _require_path(launches, "sparse", T + 1, "cost-loop run")
    _same_run(res, main, "cost-loop run vs phase 4")
    require(kinds == ["run_start"] + ["chunk"] * chunks
            + ["chunk_cost", "run_end"], f"cost loop: events {kinds}")
    require(code == 0 and "cost: predicted" in report,
            f"cost loop: report {report!r} (exit {code})")
    cost = res.metrics["obs"]["cost"]
    model = cost["model"]          # the run's calibration (obs.calibrate)
    log(f"runner surface, cost loop: {T} rounds with Telemetry(cost=True) "
        f"equal to phase 4 bit for bit; events {kinds}; launches "
        f"{launches} | {card}")
    log(f"cost loop: calibrated peaks {model['peak_bandwidth'] / 1e12} "
        f"TB/s (saxpy; data sheet 3.35) and {model['peak_flops'] / 1e12} "
        f"TFLOP/s (512^2 matmul; data sheet 67 fp32) | {card}")
    log(f"cost loop: predicted {cost['predicted_s']} s a chunk of "
        f"{RUNNER_CHUNK} rounds, measured mean {cost['measured_mean_s']} s "
        f"over {cost['measured_chunks']} chunks; error_ratio "
        f"{cost['error_ratio']} | {card}")
    log("cost loop: launch.obs report:\n" + report.rstrip())

    # one round's count on the card and on the CPU (plain versions)
    counts = {}
    for where in (DEVICE, "cpu"):
        dev = resolve_device(where)
        chunk_fn, init_fn = make_chunk_program(spec, "sim", dev)
        xs, ys = _stream_chunk(spec.resolve_stream(device=dev), 0, 1, dev)
        _, counts[where] = count(chunk_fn, _copy_state(init_fn(spec.seed)),
                                 xs, ys)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    diff = _count_differences(counts[DEVICE], counts["cpu"])
    require(not diff, f"cost loop: one round counts differently on the "
            f"card and the CPU, op by op (name, card, cpu): {diff}")
    one = counts[DEVICE]
    kf, kb = one.share("kernel.")
    af, ab = one.share("aten.")
    top = [(name, row["calls"], row["bytes"], row["flops"])
           for name, row in one.top(10)]
    log(f"cost loop: one round counts {one.hbm_bytes} bytes, {one.flops} "
        f"flops on the card and on the CPU alike: round kernels {kb} bytes "
        f"{kf} flops, torch ops {ab} bytes {af} flops; top ten (name, "
        f"calls, bytes, flops): {json.dumps(top)}")
    return {"launches": launches, "cost": cost,
            "peaks": model, "round_bytes": one.hbm_bytes,
            "round_flops": one.flops, "kernel_bytes": kb,
            "torch_bytes": ab}


def _clis(card: str) -> dict:
    """Phase 16e: ``launch.train --stream`` at the paper's width on the
    card (its result equal to `run` of the same spec) and
    ``launch.dryrun``'s count of the main path's chunk."""
    import contextlib
    import io
    from repro_torch import ExecConfig, run
    from repro_torch.kernels import round_fused as rf
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.steps import TrainRecipe
    argv = ["--stream", "social_sparse", "--nodes", str(MAIN_M), "--dim",
            str(MAIN_N), "--steps", str(PAPER_T), "--engine", "sim",
            "--device", DEVICE]
    text = io.StringIO()
    rf.reset_launches()
    with contextlib.redirect_stdout(text):
        got = train.main(argv)["result"]
    launches = _launches()
    line = text.getvalue().strip()
    require(line.startswith(f"stream=social_sparse engine=sim nodes="
                            f"{MAIN_M} dim={MAIN_N} rounds={PAPER_T}: acc="),
            f"train CLI printed {line!r}")
    # ExecConfig's default warm-up round is one more launch of each kernel
    _require_path(launches, "sparse", PAPER_T + 1, "train CLI")
    spec = TrainRecipe().to_runspec(MAIN_M).replace(
        dim=MAIN_N, horizon=PAPER_T, seed=0, stream="social_sparse",
        stream_options={}, backend="cuda")
    _same_run(got, run(spec, exec=ExecConfig(), device=DEVICE),
              "train CLI vs run")
    log(f"runner surface, train CLI: python -m repro_torch.launch.train "
        f"{' '.join(argv)}: {line!r}; equal to run() of its spec bit for "
        f"bit; launches {launches} | {card}")
    rec = dryrun.dryrun_stream("social_sparse", nodes=MAIN_M, dim=MAIN_N,
                               chunk_rounds=RUNNER_CHUNK, save=False,
                               verbose=False, device=DEVICE)
    log(f"runner surface, dryrun: social_sparse m={MAIN_M} n={MAIN_N} "
        f"chunk={RUNNER_CHUNK}: {rec['hlo_bytes']} bytes, {rec['hlo_flops']}"
        f" flops, predicted {rec['predicted_chunk_s']} s a chunk; peak "
        f"device memory over the counted round {rec['memory_peak_bytes']} "
        f"bytes ({rec['memory_round_bytes']} above the state and data "
        f"before it; {rec['compile_s']} s to count) | {card}")
    return {"launches": launches, "dryrun": rec}


def runner_phase(main, card: str) -> dict:
    """Phase 16: the rest of the runner's surface at the paper's width —
    custom mode, the per-round CSV log, the legacy-kwarg shim, the cost
    loop and the stream CLIs — each held to phase 4's run."""
    spec = paper_spec()
    out = {"custom": _custom_mode(spec, main, card),
           "csv": _csv_log(spec, main, card)}
    _shim(spec, card)
    out["cost"] = _cost_loop(spec, main, card)
    out["clis"] = _clis(card)
    return out


# -- 17. node and seed sharding ----------------------------------------------

SHARD_COUNTS = (4, 3)       # blocks of 16 and 22 rows (m_pad 66: padding)
SHARD_ROUNDS = 256          # the grid's rounds and each speed turn's
SHARD_CKPT = 768            # the checkpoint round of the cross-count resume
SHARD_TURNS = ("plain", "D4", "D3", "D1", "D1", "D3", "D4", "plain")
SHARD_GRID_SEEDS = (0, 1)
SHARD_CRASH = {"crash_rate": 0.05, "crash_rounds": 8}


def _card_mesh(shards: int, axes=("node",), shape=None):
    """A mesh of ``shards`` positions that all repeat cuda:0: the
    ``shards``-shard program (partition, padding, halo copies, the kernels
    per shard) on the one card."""
    from repro_torch.launch.mesh import make_mesh
    dev = "cuda:0" if DEVICE == "cuda" else DEVICE
    return make_mesh(shape or (shards,), axes, devices=[dev] * shards)


def _shard_counts() -> dict:
    """The round kernels' launches and the sharded mixer's halo copies."""
    from repro_torch.api.shard_node import ShardedSparseMixer
    return {**_launches(), "halo_copies": ShardedSparseMixer.halo_copies}


def _reset_shard_counts() -> None:
    from repro_torch.api.shard_node import ShardedSparseMixer
    from repro_torch.kernels import round_fused as rf
    rf.reset_launches()
    ShardedSparseMixer.reset_halo_copies()


def _max_differences(a, b) -> dict:
    """Every field's largest difference between two runs, over all
    rounds (and final_w)."""
    import numpy as np
    return {f: float(np.abs(np.asarray(getattr(a, f), np.float64)
                            - np.asarray(getattr(b, f), np.float64)).max())
            for f in ("correct", "sparsity", "eps_ledger", "loss",
                      "w_bar_loss", "final_w")}


def _first_parting(a, b) -> str:
    """The first round and field where two runs' trajectories differ."""
    import numpy as np
    for f in ("correct", "sparsity", "loss", "w_bar_loss"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        off = np.flatnonzero((x != y).reshape(x.shape[0], -1).any(axis=1))
        if off.size:
            t = int(off[0])
            return (f"round {t}, field {f}, difference "
                    f"{float(np.abs(x[t] - y[t]).max())}")
    return "no trajectory field differs (final_w only)"


def _shard_kernel_rows(card: str) -> dict:
    """The round kernels at each shard's (block, n): held against their
    plain versions, then timed (inputs rotated past the L2) beside their
    bounds — the kernels line's per-shard entries."""
    import torch
    from repro_torch.kernels import round_fused as rf
    dev = torch.device(DEVICE)
    rows = {}
    for D in SHARD_COUNTS:
        block = -(-MAIN_M // D)
        d = _inputs(block, MAIN_N, seed=block, dev=dev)
        errs = {}
        for name in ("round_stats", "dual_step"):
            kern, plain = _calls(rf, d)[name]
            got = kern()
            errs[name] = _compare(name, got, plain(), f"block={block}")
            if name == "round_stats":
                require(all(torch.equal(a, b) for a, b in zip(got, kern())),
                        f"round_stats: two calls differ at block={block}")
        per_set = 4 * 2 * block * MAIN_N
        sets = [_inputs(block, MAIN_N, seed=s, dev=dev)
                for s in range(int(L2_BYTES // per_set) + 2)]
        for name in ("round_stats", "dual_step"):
            entry = _measure(name, [_calls(rf, s)[name][0] for s in sets],
                             [_calls(rf, s)[name][1] for s in sets], block,
                             MAIN_N, errs[name], SOURCE, card)
            entry["name"] = f"{name}_block{block}"
            entry["shards"] = D
            rows[entry["name"]] = entry
        del d, sets
        torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows


def _shard_rows_counts(rows: dict, D: int, counts: dict) -> None:
    """The launches (and halo copies) of the D-shard run into its rows."""
    block = -(-MAIN_M // D)
    for name in ("round_stats", "dual_step"):
        rows[f"{name}_block{block}"]["launches"] = counts[name]
        rows[f"{name}_block{block}"]["halo_copies"] = counts["halo_copies"]


def shard_phase(main, fused, batch: dict, card: str) -> dict:
    """Phase 17: the node axis and the seed axis over device meshes, at the
    paper's width, every shard on cuda:0 (the program a mesh of cards
    runs, on one card). Returns the per-shard kernel rows with their
    launches."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch import ExecConfig, run, run_batch
    from repro_torch.checkpoint import restore_checkpoint
    spec = paper_spec()
    T = spec.horizon
    cfg = ExecConfig(chunk_rounds=256, compute_regret=False, warmup=False)
    short = cfg.replace(chunk_rounds=AGREE_ROUNDS)
    mesh = {D: _card_mesh(D) for D in (4, 3, 1)}
    rows = _shard_kernel_rows(card)

    # D = 4 over the whole horizon: launches and halo copies, sim == dist,
    # a rerun, the reference backend
    _reset_shard_counts()
    d4 = run(spec, exec=cfg.replace(node_mesh=mesh[4]), device=DEVICE)
    counts = _shard_counts()
    log(f"shard D=4: {T} rounds, round loop {d4.wall_clock:.3f} s = "
        f"{d4.rounds_per_sec:.1f} rounds/s (unsharded, phase 4: "
        f"{main.rounds_per_sec:.1f}); launches and halo copies {counts} | "
        f"{card}")
    want = {"round_stats": 4 * T, "round_update": 0,
            "round_update_sparse": 0, "dual_step": 4 * T,
            "halo_copies": 2 * 4 * T}
    require(counts == want, f"shard D=4: counts {counts}, expected {want}")
    _shard_rows_counts(rows, 4, counts)
    for f in ("final_w", "loss", "w_bar_loss", "sparsity"):
        require(bool(np.isfinite(np.asarray(getattr(d4, f))).all()),
                f"shard D=4: {f} not finite")
    require(d4.final_w.shape == (MAIN_M, MAIN_N), "shard D=4: final_w shape")
    dist = run(spec, engine="dist", exec=cfg.replace(node_mesh=mesh[4]),
               device=DEVICE)
    _same_run(dist, d4, "shard D=4: dist vs sim")
    again = run(spec, exec=cfg.replace(node_mesh=mesh[4]), device=DEVICE)
    _same_run(again, d4, "shard D=4: rerun")
    log(f"shard D=4: dist == sim and a rerun == the run, every field and "
        f"the final state bit for bit over {T} rounds | {card}")
    diffs = _max_differences(d4, main)
    log(f"shard D=4 vs phase 4's unsharded run, all {T} rounds, max abs "
        f"differences: {diffs} | {card}")
    # the sharded ring adds each row in the unsharded ring's order, so the
    # state and the exact fields are bit for bit; the metric sums (loss's
    # w_bar term aside, w_bar_loss) add in shard order
    for f in ("final_w", "correct", "sparsity", "eps_ledger"):
        require(diffs[f] == 0.0, f"shard D=4 vs phase 4: {f} differs "
                f"({_first_parting(d4, main)})")
    for f in ("loss", "w_bar_loss"):
        require(diffs[f] <= FLOAT_TOL, f"shard D=4 vs phase 4: {f} off by "
                f"{diffs[f]}")
    log(f"shard D=4: final_w, correct, sparsity and eps_ledger equal phase "
        f"4's bit for bit over all {T} rounds | {card}")
    ref = run(spec.replace(backend="reference"),
              exec=cfg.replace(node_mesh=mesh[4]), device=DEVICE)
    # held as phase 5 holds the unsharded pair: final_w bit for bit, the
    # rest within the contract (the per-node dot, so the loss, adds in
    # another order in round_stats)
    if np.array_equal(ref.final_w, d4.final_w):
        log(f"shard D=4: the reference backend's sharded run "
            f"({ref.rounds_per_sec:.1f} rounds/s) has the cuda backend's "
            f"final_w bit for bit | {card}")
        _hold(ref, d4, "shard D=4: reference vs cuda backend", card,
              rounds=T)
    else:
        log(f"shard D=4: the backends PART: {_first_parting(ref, d4)}; "
            f"over all rounds {_max_differences(ref, d4)} | {card}")
        _hold(ref, d4, "shard D=4: reference vs cuda backend", card)

    # 64 rounds: D = 4, 3, 1 against the unsharded run and each other
    runs64 = {}
    for D in (4, 3, 1):
        _reset_shard_counts()
        runs64[D] = run(spec.replace(horizon=AGREE_ROUNDS),
                        exec=short.replace(node_mesh=mesh[D]), device=DEVICE)
        counts = _shard_counts()
        log(f"shard D={D} (block {-(-MAIN_M // D)}): {AGREE_ROUNDS} rounds, "
            f"counts {counts} | {card}")
        require(counts["round_stats"] == D * AGREE_ROUNDS
                and counts["dual_step"] == D * AGREE_ROUNDS
                and counts["round_update"] == 0,
                f"shard D={D}: launches {counts}")
        if D == 3:
            _shard_rows_counts(rows, 3, counts)
        _hold(fused, runs64[D], f"shard D={D} vs the unsharded run", card)
    _hold(runs64[4], runs64[3], "shard D=3 vs D=4", card)
    plain1 = run(spec, exec=cfg.replace(node_devices=1,
                                        compute_regret=True), device=DEVICE)
    _same_run(plain1, main, "node_devices=1 vs phase 4")
    log(f"shard: node_devices=1 is phase 4's run bit for bit | {card}")

    # faults at D = 4, 64 rounds
    for name, opts in (("links", {}), ("crash", SHARD_CRASH)):
        fs = spec.replace(horizon=AGREE_ROUNDS, faults=name,
                          faults_options=opts)
        flat = run(fs, exec=short, device=DEVICE)
        sharded = run(fs, exec=short.replace(node_mesh=mesh[4]),
                      device=DEVICE)
        _hold(flat, sharded, f"shard D=4, faults={name}: sharded vs "
              f"unsharded", card)
        require(sharded.privacy.get("participated_rounds")
                == flat.privacy.get("participated_rounds"),
                f"shard faults={name}: participation differs")
    # zero rates: bit for bit the clean run of the ring a faulty mixer
    # lowers to, the sparse edge list (ascending source; phase 11's pair)
    sparse = spec.replace(horizon=AGREE_ROUNDS, mixer="sparse")
    clean = run(sparse, exec=short.replace(node_mesh=mesh[4]),
                device=DEVICE)
    zero = run(sparse.replace(faults="links",
                              faults_options={"link_rate": 0.0}),
               exec=short.replace(node_mesh=mesh[4]), device=DEVICE)
    for f in ("final_w", "loss", "correct", "w_bar_loss", "sparsity"):
        require(np.array_equal(getattr(zero, f), getattr(clean, f)),
                f"shard zero-rate links: {f} differs from the clean run")
    try:
        run(spec.replace(horizon=AGREE_ROUNDS, faults="dcn"),
            exec=short.replace(node_mesh=mesh[4]), device=DEVICE)
        raise AssertionError("shard: faults='dcn' ran on the sharded path")
    except ValueError as e:
        require("straggler" in str(e), f"shard dcn refusal: {e}")
    log(f"shard D=4 faults: links and crash (rate 0.05, 8 rounds) held to "
        f"the unsharded runs; zero-rate links == the clean sparse ring bit "
        f"for bit; dcn refused (stragglers) | {card}")

    # the seed axis: 2 seed shards (pad 1) == phase 12's batch; the grid
    _reset_shard_counts()
    seeds = run_batch(spec, BATCH_SEEDS, device=DEVICE,
                      exec=cfg.replace(compute_regret=True,
                                       mesh=_card_mesh(2, ("seed",))))
    counts = _shard_counts()
    info = seeds[0].metrics["batch"]
    require((info["devices"], info["pad_seeds"]) == (2, 1),
            f"seed shards: batch info {info}")
    require(counts["round_stats"] == 2 * T and counts["round_update"] == 2 * T,
            f"seed shards: launches {counts}")
    for s, a, b in zip(BATCH_SEEDS, seeds, batch["results"]):
        # a sharded run names the mesh's first device ("cuda:0")
        _same_run(a, b, f"seed-sharded batch seed {s} vs phase 12's batch",
                  ignore=("device",))
    log(f"seed axis: seeds {list(BATCH_SEEDS)} on 2 seed shards (pad 1) "
        f"equal phase 12's batch bit for bit; "
        f"{info['seed_rounds_per_sec']:.1f} seed-rounds/s; launches "
        f"{counts} | {card}")
    grid_spec = spec.replace(horizon=SHARD_ROUNDS)
    grid = run_batch(grid_spec, SHARD_GRID_SEEDS, device=DEVICE,
                     exec=cfg.replace(mesh=_card_mesh(
                         8, ("seed", "node"), (2, 4))))
    for s, g in zip(SHARD_GRID_SEEDS, grid):
        one = run(grid_spec.replace(seed=s), device=DEVICE,
                  exec=cfg.replace(node_mesh=mesh[4]))
        _same_run(g, one, f"grid 2x4 seed {s} vs its D=4 run")
    log(f"seed x node grid 2x4: seeds {list(SHARD_GRID_SEEDS)}, "
        f"{SHARD_ROUNDS} rounds, each equal to its D=4 run bit for bit; "
        f"{grid[0].metrics['batch']['seed_rounds_per_sec']:.1f} "
        f"seed-rounds/s | {card}")

    # checkpoints across shard counts: 4 -> 1 and 1 -> 4 at round 768
    for save, resume in ((4, 1), (1, 4)):
        with tempfile.TemporaryDirectory() as d:
            ck = cfg.replace(checkpoint_every=SHARD_CKPT, checkpoint_dir=d)
            if save > 1:
                ck = ck.replace(node_mesh=mesh[save])
            half = run(spec, horizon=SHARD_CKPT, exec=ck, device=DEVICE)
            back = restore_checkpoint(d, half.final_state, step=SHARD_CKPT)
            require(torch.equal(back.theta, half.final_state.theta)
                    and back.t == SHARD_CKPT
                    and torch.equal(back.generator.get_state(),
                                    half.final_state.generator.get_state()),
                    f"checkpoint {save}->{resume}: the restored state "
                    "differs from the saved one")
            rs = cfg.replace(resume=True, checkpoint_dir=d)
            if resume > 1:
                rs = rs.replace(node_mesh=mesh[resume])
            end = run(spec, exec=rs, device=DEVICE)
        # the uninterrupted runs of the layout it ends in, and of the other
        same, other = (d4, main) if resume == 4 else (main, d4)
        off = float(np.abs(end.final_w - same.final_w).max())
        log(f"checkpoint D={save} -> D={resume} at round {SHARD_CKPT}: the "
            f"restored state equals the saved one bit for bit; the end's "
            f"final_w within {off} of the uninterrupted D={resume} run, "
            f"{float(np.abs(end.final_w - other.final_w).max())} of the "
            f"D={save} one | {card}")
        require(end.start_round == SHARD_CKPT and off <= FLOAT_TOL,
                f"checkpoint {save}->{resume}: final_w off by {off}")

    # rounds/s of D = 1, 3, 4 against the unsharded run, in turns
    rates = {k: [] for k in ("plain", "D1", "D3", "D4")}
    turn = spec.replace(horizon=SHARD_ROUNDS)
    for kind in SHARD_TURNS:
        c = cfg if kind == "plain" else cfg.replace(
            node_mesh=mesh[int(kind[1:])])
        rates[kind].append(run(turn, exec=c, device=DEVICE).rounds_per_sec)
    log(f"shard rounds/s over {SHARD_ROUNDS} rounds in turns {SHARD_TURNS}: "
        f"{json.dumps(rates)} | {card}")
    return {"kernels": rows, "rounds_per_sec": rates}


# -- 18. the paper's figures -------------------------------------------------

FIGURE_SEEDS = (0, 1, 2)
# the reference figures' row keys (benchmarks/fig2..fig5)
FIGURE_KEYS = {
    "fig2": ["regret_final", "regret_final_std", "regret_curve", "accuracy",
             "accuracy_std", "seeds", "eps_total", "seconds"],
    "fig3": ["regret_final", "regret_final_std", "accuracy", "accuracy_std",
             "seeds", "seconds"],
    "fig4": ["lambda", "sparsity", "sparsity_std", "accuracy",
             "accuracy_std", "seeds", "seconds"],
    "fig5": ["nodes", "horizon", "accuracy", "accuracy_std", "seeds",
             "seconds"],
}
# the derived check each reference figure returns beside its rows
FIGURE_CHECKS = {"fig2": "ordering_holds", "fig3": "spread",
                 "fig4": "interior_best", "fig5": "declines"}


def _figure_launches(out) -> dict:
    """The round kernels' launches a figure's sweep must have made: each
    point's rounds plus its warm-up round, once for a batch of its seeds or
    once a seed where the sweep ran them one by one; round_update on its
    sparse path, or dual_step where the mixer has no fixed sparse form; a
    point on the reference backend none."""
    from repro_torch.api.runner import seed_vectorizable
    from repro_torch.api.shard_node import sparse_graph_and_delay
    want = {k: 0 for k in ("round_stats", "round_update",
                           "round_update_sparse", "dual_step")}
    for point in out.points:
        spec = point.spec
        if spec.backend != "cuda":
            continue            # the ablation's tg / rda: torch ops only
        runs = 1 if seed_vectorizable(spec, list(FIGURE_SEEDS)) \
            else len(FIGURE_SEEDS)
        rounds = runs * (spec.horizon + 1)
        try:
            sparse_graph_and_delay(spec.resolve_mixer())
            fused = True
        except ValueError:
            fused = False
        want["round_stats"] += rounds
        for k in (("round_update", "round_update_sparse") if fused
                  else ("dual_step",)):
            want[k] += rounds
    return want


def _compact_rows(rows):
    """A figure's rows for the log: each regret curve as its length."""
    def short(row):
        return {k: f"{len(v)} points" if k == "regret_curve" else v
                for k, v in row.items()}
    if isinstance(rows, dict):
        return {k: short(v) for k, v in rows.items()}
    return [short(r) for r in rows]


def figures_phase(sweep13: dict, card: str) -> dict:
    """Phase 18: the paper's Figs. 2-5 at the paper's scale through
    `repro_torch.figures`, seeds 0-2, each figure's launches counted from 0
    before it. Returns each figure's launches, wall and rounds/s."""
    import tempfile
    import numpy as np
    from repro_torch.figures import (Scale, fig2_privacy, fig3_topology,
                                     fig4_sparsity, fig5_nodes)
    from repro_torch.kernels import round_fused as rf
    scale = Scale.paper()
    require((scale.n, scale.m, scale.T) == (MAIN_N, MAIN_M, PAPER_T),
            f"figures: Scale.paper() is {scale}")
    modules = {"fig2": fig2_privacy, "fig3": fig3_topology,
               "fig4": fig4_sparsity, "fig5": fig5_nodes}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for fig, module in modules.items():
            rf.reset_launches()
            t0 = time.perf_counter()
            res = module.run(scale, out_dir=tmp, seeds=FIGURE_SEEDS,
                             device=DEVICE, store=f"{tmp}/store")
            wall = time.perf_counter() - t0
            launches = _launches()
            sw = res["sweep"]
            want = _figure_launches(sw)
            # a batch's results share its loop time; seeds run one by one
            # (a seeded mixer) each have their own
            loop = sum(rs[0].metrics["batch"]["wall_clock_s"]
                       if "batch" in rs[0].metrics
                       else sum(r.wall_clock for r in rs)
                       for rs in sw.results)
            rounds = sum(r.rounds for rs in sw.results for r in rs)
            log(f"{fig}: {len(sw.points)} points x {len(FIGURE_SEEDS)} seeds,"
                f" wall {wall:.1f} s, {rounds} seed-rounds in "
                f"{loop:.2f} s of round loops = {rounds / loop:.1f} "
                f"seed-rounds/s; launches {launches} | {card}")
            log(f"{fig} rows: {json.dumps(_compact_rows(res['rows']))} | "
                f"{card}")
            log(f"{fig} {FIGURE_CHECKS[fig]}: {res[FIGURE_CHECKS[fig]]} "
                f"(printed, not required) | {card}")
            require(launches == want, f"{fig}: launches {launches}, "
                    f"expected {want}")
            rows = res["rows"]
            table = list(rows.values()) if isinstance(rows, dict) else rows
            require(len(table) == len(sw.points), f"{fig}: {len(table)} rows")
            for row in table:
                require(list(row) == FIGURE_KEYS[fig],
                        f"{fig}: row keys {list(row)}")
                for k, v in row.items():
                    if isinstance(v, (int, float)) and v is not None:
                        require(math.isfinite(v), f"{fig}: {k} = {v}")
                    elif isinstance(v, list):
                        require(bool(np.isfinite(np.asarray(v, float)).all()),
                                f"{fig}: {k} not finite")
            out[fig] = {"launches": launches, "wall_s": wall,
                        "seed_rounds_per_sec": rounds / loop, "result": res}
    order = {
        "fig2": [str(e) for e in fig2_privacy.EPS_SWEEP],
        "fig3": list(fig3_topology.TOPOLOGIES),
        "fig4": list(fig4_sparsity.LAMBDAS),
        "fig5": list(fig5_nodes.NODE_SWEEP)}
    got = {"fig2": list(out["fig2"]["result"]["rows"]),
           "fig3": list(out["fig3"]["result"]["rows"]),
           "fig4": [r["lambda"] for r in out["fig4"]["result"]["rows"]],
           "fig5": [r["nodes"] for r in out["fig5"]["result"]["rows"]]}
    require(got == order, f"figures: points {got}, expected {order}")
    require([r["horizon"] for r in out["fig5"]["result"]["rows"]]
            == [PAPER_T * MAIN_M // m for m in fig5_nodes.NODE_SWEEP],
            "fig5: horizons")
    # Fig. 2 is phase 13's sweep at one chunk of 1,562 rounds a run
    # (phase 13: 256): the runner is chunk-size invariant
    fig2, p13 = out["fig2"]["result"]["sweep"], sweep13["sweep"]
    require([p.coords for p in fig2.points] == [p.coords for p in p13.points],
            "fig2 vs phase 13: points differ")
    for point, a_runs, b_runs in zip(fig2.points, fig2.results, p13.results):
        for s, a, b in zip(FIGURE_SEEDS, a_runs, b_runs):
            _same_run(a, b, f"fig2 {point.label()} seed {s} vs phase 13",
                      ignore=("metrics",))
    log(f"fig2: every (eps, seed) result equals phase 13's bit for bit "
        f"(chunk 1,562 against 256) | {card}")
    for fig in out:
        out[fig].pop("result")
    return out


# -- 19. the two ablations ---------------------------------------------------

# the reference ablations' row keys (benchmarks/ablation_*.py)
SPARSE_KEYS = ["accuracy", "accuracy_std", "sparsity", "sparsity_std",
               "seeds"]
SPARSE_LABELS = ["omd (paper)", "truncated-gradient [11]", "rda [12]"]
DELAY_KEYS = ["delay", "accuracy", "accuracy_std", "accuracy_distributed",
              "seeds"]
DELAY_BENCH_KEYS = ["delay", "accuracy", "regret_final", "regret_final_std",
                    "regret_per_round", "simulator_seconds",
                    "distributed_seconds"]


def _per_point_launches(fn):
    """``fn()`` with the round kernels' launches recorded around each
    sweep point the sweep engine runs: (fn's result, [(label, engine,
    launches), ...])."""
    from repro_torch.sweep import engine as sweep_engine
    real, seen = sweep_engine._run_point, []

    def counted(point, spec, **kw):
        before = _launches()
        out = real(point, spec, **kw)
        after = _launches()
        seen.append((point.label(), spec.engine,
                     {k: after[k] - before[k] for k in after}))
        return out

    sweep_engine._run_point = counted
    try:
        return fn(), seen
    finally:
        sweep_engine._run_point = real


def _finite_rows(what: str, rows, keys: list) -> None:
    for row in rows:
        require(list(row) == keys, f"{what}: row keys {list(row)}")
        for k, v in row.items():
            if isinstance(v, (int, float)) and v is not None:
                require(math.isfinite(v), f"{what}: {k} = {v}")


def ablations_phase(card: str) -> dict:
    """Phase 19: the two ablations at the paper's scale through
    `repro_torch.figures`, seeds 0-2, into a temporary store and output
    directory, each with the launches counted from 0 before it. Returns
    each ablation's launches, wall and seed-rounds/s."""
    import tempfile
    import numpy as np
    from repro_torch.figures import Scale, ablation_delay, \
        ablation_sparse_methods
    from repro_torch.kernels import round_fused as rf
    scale = Scale.paper()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(out_dir=tmp, seeds=FIGURE_SEEDS, device=DEVICE,
                  store=f"{tmp}/store")
        # -- Lasso-OMD against truncated gradient and RDA
        rf.reset_launches()
        t0 = time.perf_counter()
        res, points = _per_point_launches(
            lambda: ablation_sparse_methods.run(scale, **kw))
        wall = time.perf_counter() - t0
        launches, sw = _launches(), res["sweep"]
        for label, _, n in points:
            log(f"ablation_sparse_methods {label}: launches {n} | {card}")
        log(f"ablation_sparse_methods: {len(sw.points)} points x "
            f"{len(FIGURE_SEEDS)} seeds, wall {wall:.1f} s; launches "
            f"{launches} | {card}")
        log(f"ablation_sparse_methods rows: {json.dumps(res['rows'])} | "
            f"{card}")
        want = _figure_launches(sw)
        require(launches == want, f"ablation_sparse_methods: launches "
                f"{launches}, expected {want}")
        require(want["round_stats"] == scale.T + 1,
                f"ablation_sparse_methods: omd's batch should launch "
                f"{scale.T + 1} times, expected {want}")
        require(list(res["rows"]) == SPARSE_LABELS,
                f"ablation_sparse_methods: rows {list(res['rows'])}")
        _finite_rows("ablation_sparse_methods", res["rows"].values(),
                     SPARSE_KEYS)
        out["ablation_sparse_methods"] = {"launches": launches,
                                          "wall_s": wall}

        # -- delayed gossip on both engines
        rf.reset_launches()
        t0 = time.perf_counter()
        res, points = _per_point_launches(
            lambda: ablation_delay.run(scale, delays=ablation_delay.DELAYS,
                                       **kw))
        wall = time.perf_counter() - t0
        launches = _launches()
        sim, dist = res["sim"], res["dist"]
        for label, engine, n in points:
            log(f"ablation_delay {label} {engine}: launches {n} "
                f"(round_update {n['round_update']}) | {card}")
            require(n["round_update"] == n["round_update_sparse"]
                    == n["round_stats"] == scale.T + 1 and
                    n["dual_step"] == 0, f"ablation_delay {label} {engine}: "
                    f"launches {n}, expected {scale.T + 1} of round_stats "
                    "and sparse round_update")
        want = {k: a + b for (k, a), b in zip(
            _figure_launches(sim).items(), _figure_launches(dist).values())}
        require(launches == want, f"ablation_delay: launches {launches}, "
                f"expected {want}")
        for point, sim_rs, dist_rs in zip(sim.points, sim.results,
                                          dist.results):
            for s, a, b in zip(FIGURE_SEEDS, sim_rs, dist_rs):
                for f in ("final_w", "correct", "sparsity", "eps_ledger"):
                    require(np.array_equal(np.asarray(getattr(a, f)),
                                           np.asarray(getattr(b, f))),
                            f"ablation_delay {point.label()} seed {s}: "
                            f"dist {f} differs from sim")
        rounds = sum(r.rounds for rs in sim.results + dist.results
                     for r in rs)
        loop = sum(rs[0].metrics["batch"]["wall_clock_s"]
                   for rs in sim.results + dist.results)
        log(f"ablation_delay: sim == dist in final_w, correct, sparsity and "
            f"eps_ledger bit for bit at delays {list(ablation_delay.DELAYS)}"
            f", seeds {list(FIGURE_SEEDS)} | {card}")
        log(f"ablation_delay: {len(sim.points)} delays x 2 engines x "
            f"{len(FIGURE_SEEDS)} seeds, wall {wall:.1f} s, {rounds} "
            f"seed-rounds in {loop:.2f} s of round loops = "
            f"{rounds / loop:.1f} seed-rounds/s; launches {launches} | "
            f"{card}")
        log(f"ablation_delay rows: {json.dumps(res['rows'])} | {card}")
        log(f"ablation_delay bench: {json.dumps(res['bench']['rows'])} | "
            f"{card}")
        log(f"ablation_delay graceful: {res['graceful']} (printed, not "
            f"required) | {card}")
        require([r["delay"] for r in res["rows"]]
                == list(ablation_delay.DELAYS), "ablation_delay: delays")
        _finite_rows("ablation_delay", res["rows"], DELAY_KEYS)
        _finite_rows("ablation_delay bench", res["bench"]["rows"],
                     DELAY_BENCH_KEYS)
        files = sorted(p.name for p in Path(tmp).iterdir() if p.is_file())
        require(files == ["BENCH_delay.json", "ablation_delay.json",
                          "ablation_sparse_methods.json"],
                f"ablations: files {files}")
        out["ablation_delay"] = {"launches": launches, "wall_s": wall,
                                 "seed_rounds_per_sec": rounds / loop,
                                 "per_point": points}
    return out


# -- 20. the LM stack --------------------------------------------------------

LM_B, LM_T = 2, 16          # the CPU tests' batch
LM_LOGIT_TOL = 1e-4         # card vs CPU, f32 (the CPU tests' bounds)
LM_LOSS_TOL = 1e-5
LM_DECODE_TOL = 5e-3        # decode vs apply (tests/test_models.py:67-68)
QWEN = "qwen2-7b"
QWEN_PREFILL = (2048, 4096)  # the full-attention path, the blockwise path
QWEN_DECODE = 64
# decode vs apply in bf16 (PERF.md §6): max |delta logit| within
# 16 * 2^-8 of the largest |logit|, the same top-1 token at 3/4 of the
# positions or more
QWEN_BF16_REL = 16 * 2 ** -8
QWEN_TOP1 = 0.75
MIXTRAL = "mixtral-8x7b"
MIXTRAL_LAYERS = 2          # of 32: the depth is the one cut
MIXTRAL_B, MIXTRAL_T = 2, 512
MIXTRAL_STEPS = 5
MIXTRAL_LR = 1e-3


def _lm_config(arch: str, **kw):
    """``arch``'s published config (fields in ``kw`` replaced)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **kw)


def _lm_batch(cfg, seed: int = 7) -> dict:
    """The CPU tests' batch (tests/test_torch_models.py::make_batch)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (LM_B, LM_T)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (LM_B, LM_T)).astype(np.int32)
    batch = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "vision":
        batch["frontend"] = rng.standard_normal(
            (LM_B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        batch["labels"][:, :cfg.frontend_tokens] = -1
    elif cfg.family == "encdec":
        batch["frontend"] = rng.standard_normal(
            (LM_B, max(LM_T // 4, 8), cfg.d_model)).astype(np.float32)
    return batch


def _decode_all(model, params, tokens, frontend=None):
    """Token-by-token decode logits (B, T, V) over ``tokens``."""
    import torch
    B, T = tokens.shape
    cache = model.init_cache(B, cache_len=T)
    if model.prime_cache is not None:
        cache = model.prime_cache(params, cache, frontend)
    outs = []
    for i in range(T):
        logits, cache = model.decode_step(
            params, cache, tokens[:, i:i + 1],
            torch.full((B,), i, dtype=torch.int32, device=tokens.device))
        outs.append(logits)
    return torch.cat(outs, dim=1)


def _grads(model, params, batch):
    """(loss, gradients as a list in `tree_leaves` order)."""
    import torch
    from repro_torch.core.tree import leaves as tree_leaves, tree_map
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = model.loss_fn(leaves, batch)
    return loss.detach(), list(torch.autograd.grad(loss,
                                                   tree_leaves(leaves)))


def lm_reduced_phase(card: str) -> dict:
    """Phase 20a: every architecture at its reduced config, f32 (TF32 off):
    apply and loss on the card equal the port's CPU result; token-by-token
    decode equals apply; one AdamW step gives finite parameters."""
    import torch
    from repro_torch import optim
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import build_model
    from repro_torch.core.tree import leaves as tree_leaves, tree_map
    out = {}
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        cpu, card_model = build_model(cfg, "cpu"), build_model(cfg, DEVICE)
        params = cpu.init(0)
        gparams = tree_map(lambda t: t.to(DEVICE), params)
        nb = _lm_batch(cfg)
        batch = {k: torch.from_numpy(v) for k, v in nb.items()}
        gbatch = {k: v.to(DEVICE) for k, v in batch.items()}
        with torch.no_grad():
            want, want_aux = cpu.apply(params, batch["tokens"],
                                       batch.get("frontend"))
            got, aux = card_model.apply(gparams, gbatch["tokens"],
                                        gbatch.get("frontend"))
            want_loss, _ = cpu.loss_fn(params, batch)
            loss, _ = card_model.loss_fn(gparams, gbatch)
            front = gbatch.get("frontend") if cfg.family == "encdec" \
                else None
            full, _ = card_model.apply(gparams, gbatch["tokens"], front)
            dec = _decode_all(card_model, gparams, gbatch["tokens"], front)
        d_logits = float((got.cpu() - want).abs().max())
        d_loss = abs(float(loss) - float(want_loss))
        d_aux = abs(float(aux) - float(want_aux))
        d_dec = float((dec - full).abs().max())
        opt = optim.adamw(optim.constant(1e-3))
        state = opt.init(gparams)
        loss_g, grads = _grads(card_model, gparams, gbatch)
        it = iter(grads)
        upd, state = opt.update(tree_map(lambda _: next(it), gparams),
                                state, gparams)
        stepped = optim.apply_updates(gparams, upd)
        finite = all(bool(torch.isfinite(t).all())
                     for t in tree_leaves(stepped))
        secs = time.perf_counter() - t0
        log(f"lm {arch} reduced ({cfg.num_layers}L d{cfg.d_model}, f32): "
            f"card vs CPU logits {d_logits:.3g}, loss {d_loss:.3g}, aux "
            f"{d_aux:.3g}; decode vs apply {d_dec:.3g}; AdamW step finite "
            f"{finite} (loss {float(loss_g):.4f}); {secs:.1f} s | {card}")
        require(tuple(got.shape) == (LM_B, LM_T, cfg.vocab_padded),
                f"lm {arch}: logits shape {tuple(got.shape)}")
        require(d_logits <= LM_LOGIT_TOL, f"lm {arch}: card logits off the "
                f"CPU's by {d_logits}")
        require(d_loss <= LM_LOSS_TOL and d_aux <= LM_LOSS_TOL,
                f"lm {arch}: loss off by {d_loss}, aux by {d_aux}")
        require(d_dec <= LM_DECODE_TOL, f"lm {arch}: decode off apply by "
                f"{d_dec}")
        require(finite, f"lm {arch}: an AdamW step gave a non-finite leaf")
        out[arch] = {"logits": d_logits, "loss": d_loss, "decode": d_dec,
                     "seconds": secs}
    return out


def _count_calls(module, name: str, counts: dict):
    """Wrap ``module.name`` to count its calls into ``counts[name]``;
    returns the undo."""
    real = getattr(module, name)
    counts[name] = 0

    def counted(*a, **kw):
        counts[name] += 1
        return real(*a, **kw)

    setattr(module, name, counted)
    return lambda: setattr(module, name, real)


def _param_bytes(params) -> int:
    from repro_torch.core.tree import leaves as tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def qwen_phase(card: str) -> dict:
    """Phase 20b: qwen2-7b at its full published config (bf16, nothing
    cut): prefill through ``apply(last_only=True)`` at B = 1, T = 2,048
    (full attention) and 4,096 (blockwise; held to the full-attention
    path at the same T), then 64 tokens of `decode_step` against `apply`
    over them."""
    import torch
    from repro_torch.device import synchronize
    from repro_torch.models import attention, build_model
    dev = torch.device(DEVICE)
    cfg = _lm_config(QWEN)
    model = build_model(cfg, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0)
    synchronize(dev)
    init_s = time.perf_counter() - t0
    nbytes = _param_bytes(params)
    log(f"lm {QWEN}: {cfg.num_layers}L d{cfg.d_model} {cfg.num_heads}/"
        f"{cfg.kv_heads} heads d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
        f"{cfg.dtype}: {nbytes / 1e9:.2f} GB of weights, init {init_s:.1f} s"
        f" | {card}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = {"weights_gb": nbytes / 1e9, "prefill": {}}
    with torch.inference_mode():
        for T in QWEN_PREFILL:
            tokens = torch.randint(0, cfg.vocab_size, (1, T), generator=gen,
                                   device=dev)
            model.apply(params, tokens, last_only=True)      # warm-up
            counts, undo = {}, []
            for name in ("_full_attention", "_blockwise_attention"):
                undo.append(_count_calls(attention, name, counts))
            try:
                synchronize(dev)
                t0 = time.perf_counter()
                logits, _ = model.apply(params, tokens, last_only=True)
                synchronize(dev)
                secs = time.perf_counter() - t0
            finally:
                for u in undo:
                    u()
            path = "full" if T <= attention.BLOCKWISE_THRESHOLD \
                else "blockwise"
            require(counts[f"_{path}_attention"] == cfg.num_layers and
                    sum(counts.values()) == cfg.num_layers,
                    f"lm {QWEN} prefill T={T}: attention calls {counts}, "
                    f"expected {cfg.num_layers} on the {path} path")
            require(tuple(logits.shape) == (1, 1, cfg.vocab_padded) and
                    bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
                    f"lm {QWEN} prefill T={T}: logits not finite")
            row = {"seconds": secs, "tokens_per_s": T / secs, "path": path}
            if path == "blockwise":
                # the same prefill through the full-attention path
                threshold = attention.BLOCKWISE_THRESHOLD
                attention.BLOCKWISE_THRESHOLD = T
                try:
                    ref, _ = model.apply(params, tokens, last_only=True)
                finally:
                    attention.BLOCKWISE_THRESHOLD = threshold
                real = slice(0, cfg.vocab_size)
                d = float((logits[..., real] - ref[..., real]).abs().max())
                top = float(ref[..., real].abs().max())
                row.update(vs_full=d, max_logit=top,
                           top1_same=bool(logits[..., real].argmax()
                                          == ref[..., real].argmax()))
                require(d <= QWEN_BF16_REL * top, f"lm {QWEN} T={T}: "
                        f"blockwise off the full path by {d} (bound "
                        f"{QWEN_BF16_REL * top})")
            out["prefill"][T] = row
            log(f"lm {QWEN} prefill B=1 T={T} ({path} attention, "
                f"{counts}): {secs * 1e3:.1f} ms = {T / secs:.1f} tokens/s"
                + (f"; last logits vs the full-attention path max |delta| "
                   f"{row['vs_full']:.4g} (largest |logit| "
                   f"{row['max_logit']:.4g}), top-1 same "
                   f"{row['top1_same']}" if "vs_full" in row else "")
                + f" | {card}")
        tokens = torch.randint(0, cfg.vocab_size, (1, QWEN_DECODE),
                               generator=gen, device=dev)
        full, _ = model.apply(params, tokens)
        _decode_all(model, params, tokens[:, :2])          # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        dec = _decode_all(model, params, tokens)
        synchronize(dev)
        dec_s = time.perf_counter() - t0
    real = slice(0, cfg.vocab_size)
    d = float((dec[..., real] - full[..., real]).abs().max())
    top = float(full[..., real].abs().max())
    top1 = float((dec[..., real].argmax(-1) == full[..., real].argmax(-1))
                 .float().mean())
    peak = torch.cuda.max_memory_allocated() / 1e9
    out.update(decode_tokens_per_s=QWEN_DECODE / dec_s, decode_vs_apply=d,
               max_logit=top, top1=top1, peak_gb=peak)
    log(f"lm {QWEN} decode {QWEN_DECODE} tokens (B=1): {dec_s:.2f} s = "
        f"{QWEN_DECODE / dec_s:.1f} tokens/s; vs apply over the same tokens:"
        f" max |delta logit| {d:.4g} (largest |logit| {top:.4g}, bound "
        f"{QWEN_BF16_REL * top:.4g}), top-1 same at {top1:.4f} of positions "
        f"(bound {QWEN_TOP1}); peak memory {peak:.2f} GB | {card}")
    require(bool(torch.isfinite(dec[..., real]).all()),
            f"lm {QWEN}: decode logits not finite")
    require(d <= QWEN_BF16_REL * top, f"lm {QWEN}: decode off apply by {d}")
    require(top1 >= QWEN_TOP1, f"lm {QWEN}: top-1 agreement {top1}")
    del params
    torch.cuda.empty_cache()
    return out


def mixtral_phase(card: str) -> dict:
    """Phase 20c: mixtral-8x7b at full width, 2 of its 32 layers, bf16,
    capacity factor 1.25 (drops live): apply, loss and backward, then five
    AdamW steps on one fixed batch (B = 2, T = 512); the loss must fall.
    The optimizer runs leaf by leaf (each leaf its own one-leaf tree and
    state: the whole tree's update, leaf for leaf), so that only one
    leaf's new moments exist beside the old ones."""
    import torch
    from repro_torch import optim
    from repro_torch.device import synchronize
    from repro_torch.models import build_model, moe
    from repro_torch.core.tree import leaves as tree_leaves, tree_map
    dev = torch.device(DEVICE)
    cfg = _lm_config(MIXTRAL, num_layers=MIXTRAL_LAYERS,
                     moe_capacity_factor=1.25)
    model = build_model(cfg, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (MIXTRAL_B, MIXTRAL_T),
                              generator=gen, device=dev)
             for k in ("tokens", "labels")}
    kept = []
    real = moe._dispatch

    def counted(top_idx, E, C):
        res = real(top_idx, E, C)
        kept.append((int(res[-1].sum()), res[-1].numel(), C))
        return res

    moe._dispatch = counted
    try:
        with torch.no_grad():
            logits, aux = model.apply(params, batch["tokens"])
    finally:
        moe._dispatch = real
    require(bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()) and
            bool(torch.isfinite(aux)), f"lm {MIXTRAL}: apply not finite")
    require(len(kept) == cfg.num_layers and any(k < n for k, n, _ in kept),
            f"lm {MIXTRAL}: no assignment dropped at capacity 1.25 ({kept})")
    log(f"lm {MIXTRAL}: {cfg.num_layers} of "
        f"{_lm_config(MIXTRAL).num_layers} layers at full width "
        f"(d{cfg.d_model}, {cfg.num_experts} experts top-"
        f"{cfg.num_experts_per_tok}, d_ff {cfg.d_ff}), bf16, "
        f"{_param_bytes(params) / 1e9:.2f} GB of weights; apply B="
        f"{MIXTRAL_B} T={MIXTRAL_T}: kept/assigned per layer "
        f"{[(k, n) for k, n, _ in kept]} at capacity {kept[0][2]} | {card}")
    opt = optim.adamw(optim.constant(MIXTRAL_LR))
    nbytes = _param_bytes(params)
    leaves, skeleton = tree_leaves(params), tree_map(lambda _: 0, params)
    del params, logits
    states = [opt.init({"p": t}) for t in leaves]
    losses, times = [], []
    for _ in range(MIXTRAL_STEPS + 1):
        synchronize(dev)
        t0 = time.perf_counter()
        it = iter(leaves)
        loss, grads = _grads(model, tree_map(lambda _: next(it), skeleton),
                             batch)
        losses.append(float(loss))
        if len(losses) > MIXTRAL_STEPS:
            break
        for i, g in enumerate(grads):
            upd, states[i] = opt.update({"p": g}, states[i],
                                        {"p": leaves[i]})
            leaves[i] = optim.apply_updates({"p": leaves[i]}, upd)["p"]
            grads[i] = upd = None
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"lm {MIXTRAL}: loss over {MIXTRAL_STEPS} AdamW steps (lr "
        f"{MIXTRAL_LR}) {[round(v, 4) for v in losses]}; step (loss, "
        f"backward, update) {[round(t * 1e3, 1) for t in times]} ms; peak "
        f"memory {peak:.2f} GB | {card}")
    require(all(math.isfinite(v) for v in losses), f"lm {MIXTRAL}: loss "
            "not finite")
    require(losses[-1] < losses[0], f"lm {MIXTRAL}: loss did not fall "
            f"({losses})")
    del leaves, states
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": [t * 1e3 for t in times],
            "peak_gb": peak, "kept": kept, "weights_gb": nbytes / 1e9}


def lm_phase(card: str) -> dict:
    """Phase 20: the LM stack (see 20a, 20b, 20c)."""
    return {"reduced": lm_reduced_phase(card), "qwen": qwen_phase(card),
            "mixtral": mixtral_phase(card)}


# -- 21. LM train and serve ------------------------------------------------

LM_TRAIN_TOL = 1e-5         # card vs CPU state, loss and metrics (f32)
LM_TRAIN_STEPS = 3
MINICPM = "minicpm-2b"
MINICPM_LAYERS = 8          # of 40: the depth is the one cut
MINICPM_NODES, MINICPM_B, MINICPM_T = 4, 2, 512
MINICPM_STEPS = 5
MINICPM_LAM = 1e-5
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_CACHE = 4, 32, 16, 128
PREFILL_T = 2048
PREFILL_PAD = 16            # 28 heads -> 32 (4 kv groups of 7 -> 8)


def _state_to(state, dev):
    """A train state's tensors moved to ``dev``; a gossip state's noise
    generator re-seeded there (eps = inf: it draws nothing)."""
    import torch
    from repro_torch.core import tree
    from repro_torch.launch.steps import GossipTrainState
    if isinstance(state, GossipTrainState):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        g = state.gossip
        return GossipTrainState(gossip=g._replace(
            theta=tree.tree_map(lambda t: t.to(dev), g.theta),
            generator=gen))
    return tree.tree_map(lambda t: t.to(dev), state)


def _state_leaves(state) -> dict:
    """{path: tensor} of a train state's tensors (the generator aside)."""
    import torch
    from repro_torch.core import tree
    return {k: v for k, v in tree.flatten_with_path(state)
            if isinstance(v, torch.Tensor)}


def lm_card_vs_cpu(card: str) -> dict:
    """Phase 21a: `launch.train.train` of minicpm-2b at ``reduced()`` in
    f32, eps = inf, both strategies, from one CPU-made state and on one
    token stream (drawn on the host), on the card and on the CPU: the
    final states, losses and metrics within LM_TRAIN_TOL."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train as train_mod
    from repro_torch.models import build_model
    cfg = get_config(MINICPM).reduced()
    cpu_model = build_model(cfg, "cpu")
    recipe = steps_lib.TrainRecipe(eps=math.inf)
    starts = {
        "gossip": steps_lib.make_gossip_init(
            cpu_model, steps_lib.make_gossip_dp(4, recipe), 4)(0),
        "allreduce": steps_lib.make_allreduce_train_step(
            cpu_model, recipe)[1](0)}
    out = {}
    for strategy, start in starts.items():
        runs = {}
        for dev in (DEVICE, "cpu"):
            runs[dev] = train_mod.train(
                MINICPM, strategy=strategy, nodes=4, steps=LM_TRAIN_STEPS,
                batch_per_node=2, seq_len=64, eps=math.inf, smoke=True,
                device=dev, state=_state_to(start, torch.device(dev)))
        got, want = (_state_leaves(runs[d]["state"]) for d in (DEVICE,
                                                                "cpu"))
        require(sorted(got) == sorted(want), f"lm {strategy}: state trees")
        d_state = max(float((got[k].cpu().float() - want[k].float())
                            .abs().max()) for k in want)
        d_metrics = max(abs(a[k] - b[k]) for a, b in zip(
            runs[DEVICE]["history"], runs["cpu"]["history"]) for k in b)
        log(f"lm {MINICPM} reduced {strategy} x{LM_TRAIN_STEPS} steps "
            f"(f32, eps inf): card vs CPU state {d_state:.3g}, losses and "
            f"metrics {d_metrics:.3g} (bound {LM_TRAIN_TOL}); losses "
            f"{[round(h['loss'], 5) for h in runs[DEVICE]['history']]} | "
            f"{card}")
        require(d_state <= LM_TRAIN_TOL, f"lm {strategy}: card state off "
                f"the CPU's by {d_state}")
        require(d_metrics <= LM_TRAIN_TOL, f"lm {strategy}: card metrics "
                f"off the CPU's by {d_metrics}")
        out[strategy] = {"state": d_state, "metrics": d_metrics}
    return out


def _timed_run(spec, strategy, step_fn, state, batches, dev) -> tuple:
    """``repro_torch.run``'s custom mode over MINICPM_STEPS steps after one
    warm-up step (outside the count): (result, per-step seconds)."""
    from repro_torch import ExecConfig, run
    from repro_torch.device import synchronize
    times = []

    def timed(st, batch):
        synchronize(dev)
        t0 = time.perf_counter()
        st, metrics = step_fn(st, batch)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
        return st, metrics

    res = run(spec, engine=strategy, step_fn=timed, state=state,
              batches=batches, horizon=MINICPM_STEPS,
              exec=ExecConfig())
    return res, times


def lm_minicpm_phase(card: str) -> dict:
    """Phase 21b: the paper's strategy at minicpm-2b's published width
    (d 2,304, 36 heads, d_ff 5,760, vocab 122,753, tied, bf16), 8 of 40
    layers, 4 ring nodes, per-node batch 2, T = 512, lam 1e-5: 5 gossip
    steps at eps = 1 (coordinate calibration) and 5 at eps = inf (the
    same batch on every node from equal params, deterministic algorithms
    on: the nodes' theta must stay equal bit for bit), through
    `make_gossip_train_step` and run()'s custom mode, with the ambient
    telemetry on: at eps = 1 every leaf of every step takes the fused
    update (``gossip.fused_leaves`` and one `gossip_update` launch a leaf
    a step), at eps = inf the eager chain (no launch); then 5 all-reduce
    AdamW steps on the same 8 x 512 tokens a step.

    Its multi-GB leaves fragment the caching allocator past the card's
    80 GB, so the phase runs with expandable segments, and turns them off
    again at its end. The deterministic algorithms run with
    ``warn_only=True``: strict mode also asks for a cuBLAS workspace
    setting that must be made before the process's first cuBLAS call,
    and that setting slowed phase 20b's B = 1 decode (tools/decode_ab.py,
    PERF.md §6); the warnings are counted and logged."""
    import torch
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return _lm_minicpm_phase(card)
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")


def _unembed_calls(tel, ug, calls: int, what: str) -> int:
    """Require ``calls`` tied unembeddings on the kernel path
    (``unembed.kernel_calls``) and four `unembed_gemm` launches each (the
    logits, dx's product and its sum, dtable) since the last
    ``ug.reset_launches()``; return the launches."""
    snap = tel.metrics.snapshot()
    got = (snap.get("unembed.kernel_calls", 0),
           snap.get("unembed.plain_calls", 0), ug.unembed_gemm.launches)
    require(got == (calls, 0, 4 * calls),
            f"lm {MINICPM} {what}: (kernel path, plain path, launches) "
            f"{got}, want {(calls, 0, 4 * calls)}")
    return got[2]


def _lm_minicpm_phase(card: str) -> dict:
    import dataclasses
    import warnings
    import torch
    import repro_torch.obs as obs
    from repro_torch.core import tree
    from repro_torch.data import lm_batches
    from repro_torch.device import synchronize
    from repro_torch.kernels import gossip_update as gu
    from repro_torch.kernels import unembed_gemm as ug
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import build_model
    dev = torch.device(DEVICE)
    full = _lm_config(MINICPM)
    cfg = dataclasses.replace(full, num_layers=MINICPM_LAYERS)
    model = build_model(cfg, DEVICE)
    tokens = MINICPM_NODES * MINICPM_B * MINICPM_T
    out = {}

    def node_batches(same: bool):
        for b in lm_batches(cfg.vocab_size, MINICPM_B, MINICPM_T,
                            nodes=MINICPM_NODES, seed=3, device=DEVICE):
            if same:
                b = tree.tree_map(lambda x: x[:1].expand(
                    (MINICPM_NODES,) + tuple(x.shape[1:])), b)
            yield b

    for eps in (1.0, math.inf):
        recipe = steps_lib.TrainRecipe(eps=eps, lam=MINICPM_LAM)
        gdp = steps_lib.make_gossip_dp(MINICPM_NODES, recipe)
        torch.cuda.reset_peak_memory_stats()
        state = steps_lib.make_gossip_init(model, gdp, MINICPM_NODES)(1)
        theta_gb = sum(t.numel() * t.element_size()
                       for t in tree.leaves(state.gossip.theta)) / 1e9
        step_fn = steps_lib.make_gossip_train_step(model, gdp)
        same = eps == math.inf
        batches = node_batches(same)
        torch.use_deterministic_algorithms(same, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                state, _ = step_fn(state, next(batches))   # warm-up
                gu.reset_launches()
                ug.reset_launches()
                tel = obs.enable()
                res, times = _timed_run(recipe.to_runspec(MINICPM_NODES),
                                        "gossip", step_fn, state, batches,
                                        dev)
        finally:
            obs.disable()
            torch.use_deterministic_algorithms(False)
        # every leaf of every timed step: the fused update at eps = 1, the
        # eager chain at eps = inf (no noise drawn)
        leaves = MINICPM_STEPS * len(tree.leaves(state.gossip.theta))
        counts = {k: v for k, v in tel.metrics.snapshot().items()
                  if k.startswith("gossip.")}
        unembed = _unembed_calls(tel, ug, MINICPM_STEPS * MINICPM_NODES,
                                 f"gossip eps={eps}")
        launches = gu.gossip_update.launches
        want = ({"gossip.eager_leaves": leaves}, 0) if same else (
            {"gossip.fused_leaves": leaves}, leaves)
        require((counts, launches) == want,
                f"lm {MINICPM} gossip eps={eps}: {counts}, {launches} "
                f"gossip_update launches over {MINICPM_STEPS} steps, want "
                f"{want}")
        warned = sorted({str(w.message).split(".")[0][:80] for w in caught})
        del state
        hist = res.history
        peak = torch.cuda.max_memory_allocated() / 1e9
        theta = res.final_state.gossip.theta
        step_ms = statistics.median(times) * 1e3
        row = {"losses": [h["loss"] for h in hist], "step_ms": step_ms,
               "tokens_per_s": tokens / statistics.median(times),
               "peak_gb": peak, "theta_gb": theta_gb,
               "noise_scale": hist[0]["noise_scale"],
               "sparsity": [h["theta_sparsity"] for h in hist],
               "update_leaves": counts, "launches": launches,
               "unembed_launches": unembed}
        require(all(math.isfinite(v) for v in row["losses"]),
                f"lm {MINICPM} gossip eps={eps}: loss not finite")
        require((row["noise_scale"] > 0) == (eps != math.inf) and
                all((h["noise_scale"] > 0) == (eps != math.inf)
                    for h in hist),
                f"lm {MINICPM} gossip eps={eps}: noise scale "
                f"{[h['noise_scale'] for h in hist]}")
        require(all(0.0 <= v <= 1.0 for v in row["sparsity"]),
                f"lm {MINICPM} gossip: theta_sparsity {row['sparsity']}")
        ledger = res.eps_ledger
        require(len(ledger) == MINICPM_STEPS and
                float(sum(ledger)) == MINICPM_STEPS * eps,
                f"lm {MINICPM} gossip eps={eps}: eps ledger {ledger}")
        # the step's model share: one node's forward and backward alone
        node_params = tree.tree_map(lambda t: t[0].to(cfg.tdtype), theta)
        node_batch = tree.tree_map(lambda x: x[0], next(batches))
        for _ in range(2):                      # the second one is timed
            synchronize(dev)
            t0 = time.perf_counter()
            _grads(model, node_params, node_batch)
            synchronize(dev)
        row["node_grad_ms"] = (time.perf_counter() - t0) * 1e3
        del node_params
        if same:
            unequal = [k for k, t in tree.flatten_with_path(theta)
                       if not all(torch.equal(t[0], t[i])
                                  for i in range(1, MINICPM_NODES))]
            require(not unequal, f"lm {MINICPM} eps=inf, same batch: the "
                    f"nodes' theta part at {unequal[:4]}")
            row["nodes_equal"] = (
                f"bit for bit (deterministic algorithms, warn_only: "
                f"{len(caught)} warnings {warned})")
        log(f"lm {MINICPM} {cfg.num_layers} of {full.num_layers} layers at "
            f"full width (d{cfg.d_model}, {cfg.num_heads} heads, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}) gossip "
            f"{MINICPM_NODES} ring nodes x B={MINICPM_B} T={MINICPM_T}, "
            f"eps={eps}{' same batch a node' if same else ''}: losses "
            f"{[round(v, 4) for v in row['losses']]}, noise_scale "
            f"{row['noise_scale']:.4g}, sparsity {row['sparsity'][-1]:.4g}, "
            f"eps ledger {list(map(float, ledger))}; step (primal, 4 node "
            f"grads, GossipDP.update) median {step_ms:.1f} ms "
            f"{[round(t * 1e3, 1) for t in times]} = "
            f"{row['tokens_per_s']:.0f} tokens/s, of which one node's "
            f"forward and backward alone {row['node_grad_ms']:.1f} ms (x "
            f"{MINICPM_NODES}); update {counts}, {launches} gossip_update "
            f"launches; theta {theta_gb:.2f} GB "
            f"f32, peak memory {peak:.2f} GB"
            + (f"; nodes' theta {row['nodes_equal']}" if same else "")
            + f" | {card}")
        out[f"gossip_eps_{eps}"] = row
        del res, theta, hist
        torch.cuda.empty_cache()

    recipe = steps_lib.TrainRecipe(strategy="allreduce")
    step_fn, init = steps_lib.make_allreduce_train_step(model, recipe)
    torch.cuda.reset_peak_memory_stats()
    state = init(1)

    def flat_batches():
        for b in lm_batches(cfg.vocab_size, MINICPM_NODES * MINICPM_B,
                            MINICPM_T, seed=3, device=DEVICE):
            yield b

    batches = flat_batches()
    state, _ = step_fn(state, next(batches))               # warm-up
    ug.reset_launches()
    tel = obs.enable()
    try:
        res, times = _timed_run(None, "allreduce", step_fn, state, batches,
                                dev)
    finally:
        obs.disable()
    unembed = _unembed_calls(tel, ug, MINICPM_STEPS, "all-reduce")
    del state
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in res.history]
    step_ms = statistics.median(times) * 1e3
    log(f"lm {MINICPM} {cfg.num_layers}L all-reduce AdamW, B="
        f"{MINICPM_NODES * MINICPM_B} T={MINICPM_T}: losses "
        f"{[round(v, 4) for v in losses]}; step median {step_ms:.1f} ms "
        f"{[round(t * 1e3, 1) for t in times]} = "
        f"{tokens / statistics.median(times):.0f} tokens/s; {unembed} "
        f"unembed_gemm launches; peak memory {peak:.2f} GB | {card}")
    require(all(math.isfinite(v) for v in losses),
            f"lm {MINICPM} all-reduce: loss not finite")
    out["allreduce"] = {"losses": losses, "step_ms": step_ms,
                        "tokens_per_s": tokens / statistics.median(times),
                        "peak_gb": peak, "unembed_launches": unembed}
    del res, model
    torch.cuda.empty_cache()
    return out


def lm_serve_phase(card: str) -> dict:
    """Phase 21c: `launch.serve_lm.serve` of qwen2-7b at its full published
    config (bf16): batch 4, prompt 32, 16 generated tokens, cache 128;
    the first generated token held to `make_prefill_step`'s argmax over
    the prompt wherever the top-2 gap exceeds 16 * 2^-8 of the largest
    |logit|; then prefill at B = 1, T = 2,048 with and without
    ``head_pad=16``, and the placement-only context managers bit for bit
    off."""
    import torch
    from repro_torch.data.social import seeded_generator
    from repro_torch.device import synchronize
    from repro_torch.launch import serve_lm
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import attention, build_model, moe, transformer
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    served = serve_lm.serve(QWEN, batch=SERVE_BATCH, prompt_len=SERVE_PROMPT,
                            gen=SERVE_GEN, cache_len=SERVE_CACHE, smoke=False,
                            seed=0, device=DEVICE)
    toks = served["tokens"]
    cfg = _lm_config(QWEN)
    require(toks.shape == (SERVE_BATCH, 1 + SERVE_GEN) and
            int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
            f"lm {QWEN} serve: tokens {toks.shape} in "
            f"[{toks.min()}, {toks.max()}]")
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.empty_cache()
    # serve()'s model and prompts again, from its seeds
    model = build_model(cfg, DEVICE)
    params = model.init(seeded_generator(dev, 0, 0))
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=seeded_generator(dev, 0, 1),
                            device=dev, dtype=torch.int32)
    require(bool((prompts[:, 0].cpu().numpy() == toks[:, 0]).all()),
            f"lm {QWEN}: the prompts remade are not serve()'s")
    real = slice(0, cfg.vocab_size)
    with torch.no_grad():
        logits = model.apply(params, prompts, last_only=True)[0][:, -1,
                                                                 real]
    arg = steps_lib.make_prefill_step(model, last_only=True)(
        params, {"tokens": prompts})
    top2 = torch.topk(logits.float(), 2, dim=-1).values
    bound = QWEN_BF16_REL * float(logits.abs().max())
    clear = (top2[:, 0] - top2[:, 1] > bound).cpu().numpy()
    first = toks[:, 1]
    require(bool((arg.cpu().numpy() == logits.argmax(-1).cpu().numpy())
                 .all()), f"lm {QWEN}: prefill step argmax off apply's")
    require(bool((first[clear] == arg.cpu().numpy()[clear]).all()),
            f"lm {QWEN}: first generated {first} vs prefill argmax "
            f"{arg.tolist()} where clear {clear}")
    log(f"lm {QWEN} serve (full config, bf16, smoke=False) B={SERVE_BATCH} "
        f"prompt {SERVE_PROMPT} gen {SERVE_GEN} cache {SERVE_CACHE}: "
        f"{served['seconds']:.2f} s = "
        f"{(SERVE_PROMPT + SERVE_GEN - 1) / served['seconds']:.1f} decode "
        f"steps/s = {SERVE_BATCH * SERVE_GEN / served['seconds']:.1f} "
        f"generated tokens/s; first generated token == prefill argmax at "
        f"{int(clear.sum())} of {SERVE_BATCH} rows whose top-2 gap exceeds "
        f"{bound:.4g}; peak memory {serve_peak:.2f} GB | {card}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (1, PREFILL_T), generator=gen,
                           device=dev)
    with torch.no_grad():
        plain = model.apply(params, tokens, last_only=True)[0][0, -1, real]
        synchronize(dev)
        t0 = time.perf_counter()
        with attention.head_padding(PREFILL_PAD, "model"):
            padded = model.apply(params, tokens,
                                 last_only=True)[0][0, -1, real]
        synchronize(dev)
        pad_s = time.perf_counter() - t0
        with attention.sequence_parallel("model"), \
                attention.batch_parallel("model"), \
                transformer.sp_residual("model"), \
                moe.grouped_dispatch(1, "data"):
            placed = model.apply(params, tokens, last_only=True)[0][0, -1,
                                                                    real]
    synchronize(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        model.apply(params, tokens, last_only=True)
    synchronize(dev)
    plain_s = time.perf_counter() - t0
    args = {pad: steps_lib.make_prefill_step(model, last_only=True,
                                             head_pad=pad)(
        params, {"tokens": tokens}) for pad in (None, PREFILL_PAD)}
    d = float((padded.float() - plain.float()).abs().max())
    pbound = QWEN_BF16_REL * float(plain.abs().max())
    with attention.head_padding(PREFILL_PAD):
        heads = attention._padded_group(cfg, cfg.num_heads,
                                        cfg.kv_heads) * cfg.kv_heads
    log(f"lm {QWEN} prefill B=1 T={PREFILL_T}: head_pad={PREFILL_PAD} "
        f"({cfg.num_heads} heads -> {heads} on {cfg.kv_heads} kv groups) last "
        f"logits vs plain max |delta| {d:.4g} (bound {pbound:.4g}), argmax "
        f"{args[None].item()} / {args[PREFILL_PAD].item()}; "
        f"{plain_s * 1e3:.1f} ms plain, {pad_s * 1e3:.1f} ms padded; "
        f"sequence_parallel, batch_parallel, sp_residual and "
        f"grouped_dispatch(axis) on: bit for bit off "
        f"{bool(torch.equal(placed, plain))} | {card}")
    require(d <= pbound, f"lm {QWEN}: head-padded prefill off by {d}")
    require(bool(torch.equal(args[None], args[PREFILL_PAD])),
            f"lm {QWEN}: head-padded argmax {args}")
    require(bool(torch.equal(placed, plain)), f"lm {QWEN}: the placement "
            "context managers changed the logits")
    del params, model
    torch.cuda.empty_cache()
    return {"serve_s": served["seconds"], "serve_peak_gb": serve_peak,
            "clear_rows": int(clear.sum()), "pad_delta": d,
            "prefill_ms": plain_s * 1e3, "prefill_padded_ms": pad_s * 1e3}


def lm_train_serve_phase(card: str) -> dict:
    """Phase 21: the LM stack's train and serve paths (see 21a-c)."""
    return {"card_vs_cpu": lm_card_vs_cpu(card),
            "minicpm": lm_minicpm_phase(card), "serve": lm_serve_phase(card)}


# -- 22. the LM dry-run, its roofline, the gossip LM example -----------------

ROOF_STEPS = 5              # timed calls of each 22b step after a warm-up
EXAMPLE_ARCH, EXAMPLE_NODES, EXAMPLE_STEPS = "minicpm-2b", 4, 60


def lm_dryrun_start(tmp: str):
    """Phase 22a's process: ``python -m repro_torch.launch.dryrun --all``
    (meta tensors only, on the host's CPU), records into ``tmp``; it runs
    beside 22c, after 22b's timed steps."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--out", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(ROOT)), time.perf_counter()


def lm_dryrun_all(proc, t0: float, tmp: str, card: str) -> dict:
    """Phase 22a, its end: every architecture x input shape on the 16 x 16
    mesh ``ok``, or skipped where `steps.skip_reason` skips it; each ok
    record's collectives on the model axis unknown (None), never 0."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models.config import INPUT_SHAPES
    text, _ = proc.communicate(timeout=900)
    wall = time.perf_counter() - t0
    rc = proc.returncode
    recs = [json.loads(f.read_text()) for f in sorted(Path(tmp).iterdir())]
    status = {(r["arch"], r["shape"]): r["status"] for r in recs}
    want = {(a, sh): "skipped" if steps_lib.skip_reason(
        get_config(a), INPUT_SHAPES[sh]) else "ok"
        for a in ARCH_IDS for sh in INPUT_SHAPES}
    require(rc == 0 and status == want, f"lm dry-run --all: rc {rc}, "
            f"cells {sorted(k for k in want if status.get(k) != want[k])} "
            f"off; {text[-1500:]}")
    ok = [r for r in recs if r["status"] == "ok"]
    require(all(r["collectives"]["model_axis_bytes"] is None and
                r["memory_per_device"]["temp"] is None and
                r["hlo_flops"] > 0 and "counted_as" in r for r in ok),
            "lm dry-run --all: a record counts the model axis or misses "
            "its count")
    own = [line for line in text.splitlines() if line.startswith("[all]")]
    slowest = sorted(ok, key=lambda r: -r["compile_s"])[:3]
    log(f"lm dry-run --all (meta tensors, 16x16 mesh, gossip; its own "
        f"process, beside 22c): {len(ok)} ok, {len(recs) - len(ok)} "
        f"skipped as the reference skips, in {wall:.1f} s wall "
        f"({own[-1] if own else 'no summary line'}; slowest counts "
        f"{[(r['arch'], r['shape'], r['compile_s']) for r in slowest]}) "
        f"| {card}")
    return {"wall_s": wall, "ok": len(ok), "skipped": len(recs) - len(ok)}


def _roof_calls() -> list:
    """22b's two calls: (name, config, input shape, mesh shape)."""
    from repro_torch.models.config import ShapeConfig
    return [
        (f"{MINICPM} gossip step", _lm_config(MINICPM,
                                             num_layers=MINICPM_LAYERS),
         ShapeConfig("train_512", MINICPM_T, MINICPM_NODES * MINICPM_B,
                     "train"), (MINICPM_NODES, 1)),
        (f"{QWEN} prefill", _lm_config(QWEN),
         ShapeConfig("prefill_2k", PREFILL_T, 1, "prefill"), (1, 1))]


def lm_roofline(card: str, smi: str) -> dict:
    """Phase 22b: each call of `_roof_calls` counted through
    ``dryrun_one``'s path (`dryrun.lm_program`, `dryrun.count_lm_step`)
    once on a mesh of ``cuda:0`` (the step run) and once on a meta mesh
    (the loop shortcut: one node for all, representative layers); the two
    counts equal op by op. Then the card's time of the step (host clock
    around a synchronised call, after a warm-up; the median of ROOF_STEPS,
    and their spread) beside two bounds (`hlo_analysis.roofline_terms`,
    the whole step: the card runs every node), each over the counted
    flops: the roofline, whose memory term is the bytes the step needs
    however it is fused (`dryrun.needed_bytes`, from the shapes), and the
    eager-op budget, whose memory term is op_cost's count of the op
    sequence as it runs (every op's operands and results). Their shares
    (bound / time): the roofline share, and the eager-op share."""
    import torch
    from repro_torch.device import synchronize
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import make_mesh
    dev = torch.device(DEVICE)
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    out = {}
    try:
        for name, cfg, shape, mesh_shape in _roof_calls():
            size = mesh_shape[0] * mesh_shape[1]
            counts = {}
            for where in ("meta", DEVICE):
                mesh = make_mesh(mesh_shape, ("data", "model"),
                                 devices=[where] * size)
                program = dryrun.lm_program(cfg, shape, mesh)
                result, cost, count_s = dryrun.count_lm_step(program, mesh)
                if where == "meta":
                    need = dryrun.needed_bytes(program, result, cfg, shape)
                del result
                counts[where] = (cost, count_s)
            differ = _count_differences(counts[DEVICE][0], counts["meta"][0])
            require(not differ, f"lm roofline {name}: the card's count and "
                    f"the meta count differ at {differ[:6]}")
            cost = counts[DEVICE][0]
            fn, args = program["fn"], program["args"]
            times = []
            for i in range(ROOF_STEPS + 1):         # the first: warm-up
                synchronize(dev)
                t0 = time.perf_counter()
                result = fn(*args)
                synchronize(dev)
                if i:
                    times.append(time.perf_counter() - t0)
                del result
            del program, fn, args
            torch.cuda.empty_cache()
            step = statistics.median(times)
            bounds = {}
            for kind, nbytes in (("roofline", need),
                                 ("eager-op", cost.hbm_bytes)):
                terms = hlo_analysis.roofline_terms(cost.flops, nbytes, 0.0)
                bounds[kind] = (max(terms["t_compute_s"],
                                    terms["t_memory_s"]), terms)
            (roof, rterms), (eager, eterms) = bounds["roofline"], \
                bounds["eager-op"]
            top = sorted(cost.ops.items(), key=lambda kv: -kv[1]["bytes"])[:3]
            log(f"lm roofline {name} ({cfg.num_layers} layers, d"
                f"{cfg.d_model}, {cfg.dtype}; B={shape.global_batch} T="
                f"{shape.seq_len}, mesh {mesh_shape}): card count == meta "
                f"count op by op ({len(cost.ops)} ops; counted in "
                f"{counts[DEVICE][1]:.1f} s on the card, "
                f"{counts['meta'][1]:.1f} s on meta): {cost.flops:.6g} "
                f"flops (compute {rterms['t_compute_s'] * 1e3:.2f} ms at "
                f"{hlo_analysis.PEAK_FLOPS:.4g} FLOP/s); step median "
                f"{step * 1e3:.2f} ms of {[t * 1e3 for t in times]} "
                f"(spread {(max(times) - min(times)) * 1e3:.2f} ms); "
                f"roofline: {need:.6g} needed bytes (memory "
                f"{rterms['t_memory_s'] * 1e3:.2f} ms at "
                f"{hlo_analysis.HBM_BW:.4g} B/s), bound {roof * 1e3:.2f} ms "
                f"({rterms['dominant']}), roofline share {roof / step:.4f}; "
                f"eager-op budget: {cost.hbm_bytes:.6g} bytes (memory "
                f"{eterms['t_memory_s'] * 1e3:.2f} ms), bound "
                f"{eager * 1e3:.2f} ms ({eterms['dominant']}), eager-op "
                f"share {eager / step:.4f}; most bytes "
                f"{[(k, round(r['bytes'] / cost.hbm_bytes, 3)) for k, r in top]}"
                f" | {smi}")
            out[name] = {"flops": cost.flops, "bytes": cost.hbm_bytes,
                         "needed_bytes": need, "bound_ms": roof * 1e3,
                         "eager_bound_ms": eager * 1e3, "step_ms": step * 1e3,
                         "times_ms": [t * 1e3 for t in times],
                         "share": roof / step, "eager_share": eager / step,
                         "dominant": rterms["dominant"]}
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    return out


def lm_example_phase(card: str) -> dict:
    """Phase 22c: the gossip LM example's three runs
    (`repro_torch.figures.gossip_lm_training`) at its defaults (minicpm-2b
    reduced, 4 nodes, 60 steps; B 2 a node, T 128, lam 1e-5) on the card:
    finite losses; each run's ce start and end (means of the first and
    last five steps) and wall."""
    import contextlib
    import io
    from repro_torch.figures import gossip_lm_training as example
    out = {}
    for name, kw in example.runs().items():
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = example.run_one(EXAMPLE_ARCH, EXAMPLE_NODES, EXAMPLE_STEPS,
                                  device=DEVICE, **kw)
        wall = time.perf_counter() - t0
        ce = [h["ce"] for h in res["history"]]
        losses = [h["loss"] for h in res["history"]]
        require(len(ce) == EXAMPLE_STEPS and all(
            math.isfinite(v) for v in ce + losses),
            f"lm example {name}: {len(ce)} steps, losses finite "
            f"{all(math.isfinite(v) for v in ce + losses)}")
        start, end = statistics.mean(ce[:5]), statistics.mean(ce[-5:])
        log(f"lm example {name} ({EXAMPLE_ARCH} reduced, {EXAMPLE_NODES} "
            f"nodes, {EXAMPLE_STEPS} steps): ce start {start:.4f} end "
            f"{end:.4f} (improvement {start - end:+.4f}); {wall:.1f} s "
            f"= {EXAMPLE_STEPS / wall:.1f} steps/s | {card}")
        out[name] = {"ce_start": start, "ce_end": end, "wall_s": wall}
    return out


def lm_dryrun_phase(card: str, smi: str) -> dict:
    """Phase 22: the LM stack's first roofline shares (22b), then the LM
    dry-run (22a, in its own process) beside the gossip LM example (22c),
    so no host work of 22a's shares the clock of 22b's timed steps."""
    import tempfile
    roofline = lm_roofline(card, smi)
    with tempfile.TemporaryDirectory() as tmp:
        proc, t0 = lm_dryrun_start(tmp)
        try:
            example = lm_example_phase(card)
            dry = lm_dryrun_all(proc, t0, tmp, card)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"dryrun": dry, "roofline": roofline, "example": example}


# -- 23. the gossip step's fused update ---------------------------------------

GOSSIP_NODES = 4
# (alpha0, lam): the gossip cell's, and one whose primal is mostly zeros
GOSSIP_RULES = ((0.01, 1e-5), (0.01, 2.0))


def gossip_leaves() -> dict:
    """The gossip LM step's theta leaves a node, as (shape, gradient dtype):
    phase 21b's minicpm-2b (8 layers, each leaf kind stacked over them),
    read from the model built on ``meta``. Split into the embedding and the
    rest (the layer stacks and the final norm)."""
    import dataclasses
    from repro_torch.core import tree
    from repro_torch.models import build_model
    cfg = dataclasses.replace(_lm_config(MINICPM), num_layers=MINICPM_LAYERS)
    params = build_model(cfg, "meta").init(0)
    leaves = {k: (tuple(t.shape), t.dtype)
              for k, t in tree.flatten_with_path(params)}
    return {"embedding": {"embed/table": leaves.pop("embed/table")},
            "layers": leaves}


def _gossip_tree(leaves: dict, seed: int, dev):
    """A node-stacked theta (f32, ~N(0, 0.02^2)) and gradients in each
    leaf's dtype whose per-node norm is well above the clip bound 1, leaf
    ``k`` of shape (GOSSIP_NODES,) + its shape."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    theta, grads = {}, {}
    for k, (shape, dtype) in leaves.items():
        full = (GOSSIP_NODES,) + shape
        theta[k] = 0.02 * torch.randn(full, generator=g, device=dev)
        grads[k] = (1e-3 * torch.randn(full, generator=g,
                                       device=dev)).to(dtype)
    return theta, grads


def _eager_twin(gdp):
    """``gdp`` with its Laplace mechanism under a subclass that changes
    nothing: the dispatch hands it to the eager chain."""
    import dataclasses
    from repro_torch.api.mechanisms import LaplaceMechanism

    @dataclasses.dataclass(frozen=True)
    class SameLaplace(LaplaceMechanism):
        pass

    mech = gdp.mechanism
    return dataclasses.replace(gdp, mechanism=SameLaplace(**{
        f.name: getattr(mech, f.name) for f in dataclasses.fields(mech)
        if f.init}))


def _gossip_check(leaves: dict, what: str, card: str) -> int:
    """One update of a tree of ``leaves`` by the fused path and by the
    eager chain from one state and seed, bit for bit, at each of
    GOSSIP_RULES; returns the fused runs' kernel launches."""
    import torch
    import repro_torch.obs as obs
    from repro_torch.api import RunSpec
    from repro_torch.kernels import gossip_update as gu
    dev = torch.device(DEVICE)
    theta, grads = _gossip_tree(leaves, seed=len(leaves), dev=dev)
    launched = 0
    for alpha0, lam in GOSSIP_RULES:
        gdp = RunSpec(nodes=GOSSIP_NODES, mixer="ring", eps=1.0,
                      calibration="coordinate", clip_norm=1.0,
                      alpha0=alpha0, lam=lam).build_distributed()
        outs = {}
        for path, g in (("eager", _eager_twin(gdp)), ("fused", gdp)):
            state = g.init(theta, seed=5, device=dev)
            tel = obs.enable()
            before = gu.gossip_update.launches
            try:
                new, metrics = g.update(state, grads)
            finally:
                obs.disable()
            snap = tel.metrics.snapshot()
            nxt = torch.rand(8, generator=new.generator, device=dev)
            torch.cuda.synchronize()
            outs[path] = (new.theta, metrics, nxt, snap,
                          gu.gossip_update.launches - before)
            del state, new
        (et, em, en, es, el), (ft, fm, fn, fs, fl) = outs["eager"], outs[
            "fused"]
        require(es == {"gossip.eager_leaves": len(leaves)} and el == 0,
                f"gossip update ({what}): the eager run read {es}, {el} "
                "launches")
        require(fs == {"gossip.fused_leaves": len(leaves)}
                and fl == len(leaves),
                f"gossip update ({what}): the fused run read {fs}, {fl} "
                "launches")
        launched += fl
        for k in et:
            if not torch.equal(et[k], ft[k]):
                diff = (et[k] - ft[k]).abs()
                raise AssertionError(
                    f"gossip update ({what}, lam {lam}): leaf {k} differs "
                    f"from the eager chain at {int((diff > 0).sum())} of "
                    f"{diff.numel()} coordinates, max {float(diff.max()):.3g}")
        for key in ("theta_sparsity", "grad_norm_mean"):
            require(torch.equal(em[key], fm[key]),
                    f"gossip update ({what}, lam {lam}): {key} "
                    f"{float(em[key])!r} (eager) against "
                    f"{float(fm[key])!r} (fused)")
        require(torch.equal(en, fn), f"gossip update ({what}): the "
                "generator's next draw differs")
        log(f"gossip update ({what}: {len(leaves)} leaves of "
            f"{GOSSIP_NODES} nodes, alpha0 {alpha0}, lam {lam}): fused "
            f"equals the eager chain bit for bit; sparsity "
            f"{float(fm['theta_sparsity']):.6f}, {fl} launches | {card}")
        del outs, et, ft
    return launched


def _gossip_timing(leaves: dict, what: str, card: str) -> dict:
    """Time of the kernel over a tree's leaves (one call a leaf), beside
    its bound and the plain version's (the stages' own ops). By CUDA events
    over calls queued behind a sleeping kernel (`_queued_ms`): a profiler
    session here can come back with part of its device events missing
    (the ten leaves once read 3.8 ms against an 8.2 ms bound), and the
    card's gaps between these ms-long kernels are a few us."""
    import torch
    from repro_torch.api.mixers import RingRollMixer
    from repro_torch.kernels import gossip_update as gu
    from repro_torch.kernels.work import work
    dev = torch.device(DEVICE)
    theta, grads = _gossip_tree(leaves, seed=7, dev=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    us = {k: torch.rand(t.shape, generator=g, device=dev)
          for k, t in theta.items()}
    factor = torch.full((GOSSIP_NODES,), 0.5, device=dev)
    zeros = torch.zeros(1, dtype=torch.int64, device=dev)
    args = (0.02, 0.01, 1e-7, RingRollMixer(m=GOSSIP_NODES))

    def kern():
        for k in theta:
            gu.gossip_update(theta[k], us[k], grads[k], factor, *args, zeros)

    def plain():
        for k in theta:
            gu.gossip_update_plain(theta[k], us[k], grads[k], factor, *args)

    kern()
    plain()
    ms = _queued_ms(kern, reps=10, repeats=5)
    plain_ms = _queued_ms(plain, reps=2, repeats=3)
    nbytes = flops = 0
    for k, t in theta.items():
        b, f = work("gossip_update", GOSSIP_NODES,
                    t.numel() // GOSSIP_NODES,
                    grad_bytes=grads[k].element_size())
        nbytes, flops = nbytes + b, flops + f
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
    log(f"kernel gossip_update ({what}, {len(leaves)} leaves of "
        f"{GOSSIP_NODES} nodes): {ms:.4f} ms by CUDA events (median) | "
        f"{nbytes / 1e9:.3f} GB, bound {bound_ms:.4f} ms at 3.35 TB/s "
        f"(bytes), {100 * bound_ms / ms:.1f} % of it | plain version "
        f"{plain_ms:.4f} ms | {card}")
    return dict(name="gossip_update", route="cuda",
                source=SEED_SOURCES["gossip_update"],
                replaces=REPLACES["gossip_update"], what=what, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None)


def gossip_update_phase(card: str) -> dict:
    """Phase 23: the fused gossip update held to its eager chain on the
    gossip LM step's own leaves, then timed. Returns the kernels line's
    entry (``check_launches``: this phase's launches)."""
    import torch
    groups = gossip_leaves()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        launched = sum(_gossip_check(leaves, what, card)
                       for what, leaves in groups.items())
        torch.cuda.empty_cache()
        layers = _gossip_timing(groups["layers"], "layers", card)
        torch.cuda.empty_cache()
        entry = _gossip_timing(groups["embedding"], "embedding", card)
        torch.cuda.empty_cache()
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    entry["layers"] = {k: layers[k] for k in ("ms", "plain_ms", "bound_ms")}
    entry["check_launches"] = launched
    return entry


# -- 24. the tied unembedding's products ---------------------------------------

BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor cores (data sheet)
UNEMBED_D, UNEMBED_V = 2_304, 122_880      # minicpm-2b: d, padded vocab
# the LM cells' rows a product: AdamW's 8 x 512, a gossip node's 2 x 512
UNEMBED_M = {"allreduce_adamw": 4_096, "gossip_node": 1_024}


def _unembed_operands(M: int, dev, seed: int):
    """x (M, d) and table (V, d) bf16, g (M, V) a cross-entropy logit
    gradient, (softmax - onehot) / M, in f32."""
    import torch
    g0 = torch.Generator(device=dev)
    g0.manual_seed(seed)
    d, V = UNEMBED_D, UNEMBED_V
    x = torch.randn(M, d, generator=g0, device=dev).to(torch.bfloat16)
    table = (torch.randn(V, d, generator=g0, device=dev)
             / math.sqrt(d)).to(torch.bfloat16)
    g = torch.softmax(2.0 * torch.randn(M, V, generator=g0, device=dev),
                      dim=-1)
    labels = torch.randint(0, V, (M,), generator=g0, device=dev)
    g[torch.arange(M, device=dev), labels] -= 1.0
    return x, table, g.div_(M)


def _cancelling_operands(M: int, dev, seed: int):
    """x (M, d) and table (V, d) bf16 whose rows come in equal pairs, and
    two f32 gradients (M, V) whose entries come in pairs (1 + r, -1), r ~
    2^-12: ``g_x``'s along V (meeting table's equal rows: dx), ``g_t``'s
    along M (meeting x's: dtable). Each pair's high terms cancel exactly,
    so the products are the low terms'."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, V = UNEMBED_D, UNEMBED_V

    def pairs(rows, cols):
        rem = 2.0 ** -12 * torch.randn(rows, cols, generator=gen,
                                       device=dev)
        return torch.stack([1.0 + rem, -torch.ones_like(rem)],
                           dim=-1).reshape(rows, 2 * cols)

    x = torch.randn(M // 2, d, generator=gen, device=dev).to(
        torch.bfloat16).repeat_interleave(2, dim=0)
    table = (torch.randn(V // 2, d, generator=gen, device=dev)
             / math.sqrt(d)).to(torch.bfloat16).repeat_interleave(2, dim=0)
    return x, table, pairs(M, V // 2), pairs(V, M // 2).T.contiguous()


def _normwise(got, want) -> float:
    """max |got - want| over max |want|."""
    return float((got.double() - want).abs().max() / want.abs().max())


def unembed_gemm_phase(card: str) -> dict:
    """Phase 24: the tied unembedding's three products
    (`kernels.unembed_gemm`) at the LM cells' shapes: each held to a
    float64 product (its error no more than twice that of torch's f32
    product of the same operands, rounded as autograd rounds it), then
    timed by CUDA events over queued calls beside its bound (its bf16 MMA
    at 989 TFLOP/s or its bytes at 3.35 TB/s, the larger), the f32 work's
    bound at 67 TFLOP/s, its plain version (the f32 product and the cast
    that autograd runs) and ``library_ms`` (torch's f32 ``mm`` alone, which
    the port no longer calls there). Then dx and dtable of a cancelling
    gradient (`_cancelling_operands`): the same hold, which the kernel fed
    g's high terms alone (g cast to bf16) must fail. Returns the kernels
    line's entry."""
    import torch
    from repro_torch.kernels import unembed_gemm as ug
    from repro_torch.kernels.work import work
    dev = torch.device(DEVICE)
    bf16 = torch.bfloat16
    d, V = UNEMBED_D, UNEMBED_V
    entry = dict(name="unembed_gemm", route="cuda",
                 source=SEED_SOURCES["unembed_gemm"],
                 replaces=REPLACES["unembed_gemm"], shapes={})
    for cell, M in UNEMBED_M.items():
        x, table, g = _unembed_operands(M, dev, seed=M)
        xf, tf = x.float(), table.float()
        calls = {
            "logits": ((M, V, d), lambda: ug.logits(x, table),
                       lambda: ug.logits_plain(x, table),
                       lambda: torch.mm(xf, tf.t()),
                       lambda: x.double() @ table.double().t()),
            "grad_x": ((M, d, V), lambda: ug.grad_x(g, table),
                       lambda: ug.grad_x_plain(g, table).to(bf16),
                       lambda: torch.mm(g, tf),
                       lambda: g.double() @ table.double()),
            "grad_table": ((V, d, M), lambda: ug.grad_table(g, x),
                           lambda: ug.grad_table_plain(g, x).to(bf16),
                           lambda: torch.mm(g.t(), xf),
                           lambda: g.double().t() @ x.double())}
        rows = {}
        for op, ((m, n, k), kern, plain, lib, exact) in calls.items():
            want = exact()
            err = _normwise(kern(), want)
            err_lib = _normwise(plain(), want)
            del want
            require(err <= 2 * err_lib,
                    f"unembed_gemm {op} at M={M}: error {err:.3g} over "
                    f"twice torch's f32 product's {err_lib:.3g}")
            torch.cuda.empty_cache()
            ms = _queued_ms(kern, reps=5, repeats=3)
            plain_ms = _queued_ms(plain, reps=2, repeats=3)
            library_ms = _queued_ms(lib, reps=2, repeats=3)
            nbytes, flops = work(ug.OPS[op], m, n, k=k)
            t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
            f32_flops = 2 * m * n * k
            rows[op] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bf16_tflop=flops / 1e12, f32_tflop=f32_flops / 1e12,
                f32_bound_ms=f32_flops / FP32_FLOPS * 1e3,
                err=err, torch_f32_err=err_lib)
            log(f"kernel unembed_gemm {op} ({cell}: {m}x{n}, depth {k}): "
                f"{ms:.3f} ms by CUDA events (median) | {flops / 1e12:.3f} "
                f"TFLOP of bf16 MMA, bound {rows[op]['bound_ms']:.3f} ms at "
                f"989 TFLOP/s ({rows[op]['bound_by']}), "
                f"{100 * rows[op]['bound_ms'] / ms:.1f} % of it | the f32 "
                f"work {f32_flops / 1e12:.3f} TFLOP, "
                f"{rows[op]['f32_bound_ms']:.3f} ms at 67 TFLOP/s | plain "
                f"version {plain_ms:.3f} ms | library_ms (torch f32 mm) "
                f"{library_ms:.3f} ms | error {err:.3g} (torch f32 "
                f"{err_lib:.3g}) | {card}")
        total = {key: sum(r[key] for r in rows.values())
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        del x, table, g, xf, tf, calls
        torch.cuda.empty_cache()
        x, table, g_x, g_t = _cancelling_operands(M, dev, seed=M + 1)
        for op, kern, g_, b in (("grad_x", ug.grad_x, g_x, table),
                                ("grad_table", ug.grad_table, g_t, x)):
            want = (g_.double() @ b.double() if op == "grad_x"
                    else g_.double().t() @ b.double())
            err = _normwise(kern(g_, b), want)
            err_lib = _normwise(getattr(ug, op + "_plain")(g_, b).to(bf16),
                                want)
            err_hi = _normwise(kern(g_.to(bf16).float(), b), want)
            del want
            log(f"kernel unembed_gemm {op} ({cell}, M={M}), a gradient "
                f"cancelling to its low terms: error {err:.3g}, torch f32 "
                f"{err_lib:.3g}, g's high terms alone {err_hi:.3g} | {card}")
            require(err <= 2 * err_lib < err_hi,
                    f"unembed_gemm {op} at M={M}, cancelling gradient: "
                    f"error {err:.3g}, g's high terms alone {err_hi:.3g}, "
                    f"twice torch's f32 product's {2 * err_lib:.3g}: the "
                    f"hold must pass the kernel and fail the high terms")
            rows[op].update(cancel_err=err, cancel_torch_f32_err=err_lib,
                            cancel_high_terms_err=err_hi)
        del x, table, g_x, g_t
        log(f"unembed_gemm ({cell}, M={M}): the three products "
            f"{total['ms']:.3f} ms, bound {total['bound_ms']:.3f} ms | "
            f"plain {total['plain_ms']:.3f} ms | torch f32 mm "
            f"{total['library_ms']:.3f} ms | {card}")
        entry["shapes"][cell] = dict(rows, total=total)
        torch.cuda.empty_cache()
    a = entry["shapes"]["allreduce_adamw"]["total"]
    entry.update(ms=a["ms"], plain_ms=a["plain_ms"],
                 library_ms=a["library_ms"], bound_ms=a["bound_ms"],
                 bound_by="operations")
    return entry


PATHS = {"round_stats": "main, serve", "round_update": "main, serve",
         "dual_step": "hybrid (phase 6, complete, time_varying, faults)",
         "pdomd_update": "ops", "hinge_grad": "ops"}


def main() -> int:
    card, smi = card_check()
    import torch
    from repro_torch.configs.social_linear import CONFIG
    require((CONFIG.nodes, CONFIG.n, CONFIG.rounds)
            == (MAIN_M, MAIN_N, PAPER_T),
            "the kernels' shapes must be configs/social_linear.py's")
    build_phase()
    kernels = kernel_phase(card)
    batched = batch_kernel_phase(card)
    kernels.update(seed_kernel_phase(card))
    main_res, launches = main_path(card)
    idle_share(card)
    fused = agreement_phase(main_res, card)
    long_agreement_phase(main_res, card)
    launches["dual_step"] = hybrid_phase(fused, card)
    dist_launches = dist_phase(main_res, card)
    launches.update(ops_phase(card))
    topologies = topology_phase(card)
    stages = stages_phase(card)
    faults = faults_phase(main_res, card)
    batch = batch_phase(main_res, card)
    sweep13 = sweep_phase(card)
    serve = serve_phase(card)
    telemetry = telemetry_phase(card)
    runner = runner_phase(main_res, card)
    shard = shard_phase(main_res, fused, batch, card)
    figures = figures_phase(sweep13, card)
    ablations = ablations_phase(card)
    lm_phase(card)
    lm_minicpm = lm_train_serve_phase(card)["minicpm"]
    lm_gossip = lm_minicpm["gossip_eps_1.0"]
    lm_dryrun_phase(card, smi)
    gossip_entry = gossip_update_phase(card)
    gossip_entry["launches"] = lm_gossip["launches"]
    gossip_entry["path"] = (f"gossip LM step (phase 21b, {MINICPM_STEPS} "
                            "steps at eps 1)")
    hybrid = {"hybrid": launches["dual_step"],
              **{name: run["launches"]["dual_step"]
                 for name, run in topologies.items()
                 if run["path"] == "hybrid"},
              **{f"faults-{name}": n for name, n in faults.items()}}
    launches["dual_step"] = sum(hybrid.values())
    for name, entry in kernels.items():
        entry["launches"] = launches[name]
        entry["path"] = PATHS[name]
        if name in dist_launches and dist_launches[name]:
            entry["dist_launches"] = dist_launches[name]
    kernels["round_update"]["sparse_launches"] = launches[
        "round_update_sparse"]
    kernels["round_update"]["topology_launches"] = {
        name: {"path": run["path"],
               "launches": run["launches"]["round_update"],
               "sparse_launches": run["launches"]["round_update_sparse"]}
        for name, run in topologies.items() if run["path"] != "hybrid"}
    kernels["dual_step"]["launches_by_run"] = hybrid
    for name in ("round_stats", "round_update"):
        kernels[name]["batched"] = batched[name]
        kernels[name]["batch_launches"] = batch["launches"][name]
        # the serving trainer's rounds are the main path's too (phase 14)
        kernels[name]["main_launches"] = kernels[name]["launches"]
        kernels[name]["serve_launches"] = serve["launches"][name]
        kernels[name]["launches"] += serve["launches"][name]
        kernels[name]["obs_launches"] = telemetry["launches"][name]
        kernels[name]["runner_launches"] = {
            part: runner[part]["launches"][name]
            for part in ("custom", "cost", "clis")}
    kernels["round_update"]["batch_sparse_launches"] = batch["launches"][
        "round_update_sparse"]
    kernels["round_update"]["sparse_launches"] += serve["launches"][
        "round_update_sparse"]
    for name in ROUND_KERNELS:
        kernels[name]["figure_launches"] = {
            fig: run["launches"][name] for fig, run in figures.items()}
        kernels[name]["ablation_launches"] = {
            ab: run["launches"][name] for ab, run in ablations.items()}
    kernels["hinge_grad"]["slab_launches"] = launches["hinge_grad_slab"]
    for name, entry in shard["kernels"].items():
        entry["path"] = f"node-sharded, {entry['shards']} shards (phase 17)"
        kernels[name] = entry
    kernels["gossip_update"] = gossip_entry
    unembed_entry = unembed_gemm_phase(card)
    unembed_entry["launches"] = lm_gossip["unembed_launches"]
    unembed_entry["allreduce_launches"] = lm_minicpm["allreduce"][
        "unembed_launches"]
    unembed_entry["path"] = (f"tied unembedding of the LM steps (phase "
                             f"21b: {MINICPM_STEPS} gossip steps at eps 1 "
                             f"x {MINICPM_NODES} nodes, and "
                             f"{MINICPM_STEPS} all-reduce AdamW steps)")
    kernels["unembed_gemm"] = unembed_entry
    log("topologies (rounds/s, accuracy, regret[-1]): " + json.dumps(
        {name: [run["rounds_per_sec"], run["accuracy"], run["regret_last"]]
         for name, run in topologies.items()}))
    log("stage launches: " + json.dumps(stages))
    log(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
