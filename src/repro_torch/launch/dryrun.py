"""Dry-run: what a step costs, counted, with no horizon run.

Counterpart of `repro.launch.dryrun`, on the port:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b \
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        [--multi-pod] [--strategy gossip] [--opt flash,bigq]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --stream bursty \
        --engine dist --nodes 4 --dim 64 --chunk-rounds 16 --device cpu

The LM mode (``--arch/--shape`` or ``--all``) is the reference's
``dryrun_one``: every architecture x input shape on the production meshes
(16 x 16, or 2 x 16 x 16 with ``--multi-pod``), on shapes alone. The
reference lowers and compiles the step on ShapeDtypeStructs and reads the
HLO; the port builds the same state, parameters and batch as ``meta``
tensors (`launch.steps`, `launch.mesh`, `repro_torch.sharding`), runs the
step once on them under `launch.op_cost.count` (no device is touched), and
records, under the reference's keys:

  hlo_flops, hlo_bytes
            the counted step (`op_cost`'s eager rules: every op's operands
            and results, no fusion) over the mesh's devices. The gossip
            step's nodes do alike work, so one node's forward and backward
            is counted, weighted by the nodes; every fixed-trip loop (the
            layers, the RWKV-6 and RG-LRU time steps, the blockwise
            attention's chunks, micro-batches) by its representative
            iterations (`core.loops.loop`), as `hlo_cost` multiplies a while
            body by its trip count. The record's ``counted_as`` says so.
  collectives
            the strategy's own exchange, derived from the specs
            (`launch.hlo_analysis.collective_stats`); the model axis's
            collectives are ``None``, not 0.
  roofline  `hlo_analysis.roofline_terms` at the H100's peaks.
  memory_per_device
            ``arguments``, ``output`` and ``alias`` (the donated state or
            cache) exact from the specs: each leaf's shard bytes on the
            mesh; ``temp`` None (a meta count tracks no live memory).
  xla_cost_analysis_raw
            None (no XLA); ``compile_s`` is the counting wall time.

Records go to ``experiments/torch_dryrun/`` (never the reference's
``experiments/dryrun/``). ``--opt`` takes the reference's flags: those that
change the program change the count (last_only, padheads, flash,
batchpar, seqpar, moegroup, spres, bigq — the latter scoped, where the
reference sets a module global for the rest of the process), the
placement ones change the specs (ep, zerotheta, repattn).

``--stream`` (CUDA unless ``--device cpu``) counts the chunk program
`repro_torch.run` drives for a STREAMS scenario: ONE round of it on the
stream's first round (`repro_torch.obs.analyze_chunk`: torch ops by
`hlo_cost`'s rules, each kernel by its `kernels.work` numbers) times the
chunk's rounds, with the device's peak memory over the counted round and
the predicted chunk time on the calibrated roofline.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import tree
from repro_torch.launch import hlo_analysis, op_cost, steps
from repro_torch.launch.mesh import (gossip_axes, gossip_nodes,
                                     make_production_mesh)
from repro_torch.models import attention, build_model
from repro_torch.models.config import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.sharding import rules as shard_rules
from repro_torch.sharding.rules import P

__all__ = ["count_params", "active_param_count", "pick_microbatches",
           "lm_program", "count_lm_step", "argument_bytes", "needed_bytes",
           "dryrun_one",
           "dryrun_stream", "main", "OUT_DIR"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "torch_dryrun")
OPT_FLAGS = ("last_only", "padheads", "flash", "batchpar", "seqpar",
             "moegroup", "spres", "bigq", "ep", "zerotheta", "repattn")


def count_params(params) -> int:
    return sum(int(np.prod(t.shape)) for t in tree.leaves(params))


def active_param_count(cfg: ModelConfig, params) -> float:
    """N_active for MODEL_FLOPS = 6 N D: MoE counts only routed-active
    experts (the reference's path rule)."""
    total = count_params(params)
    if cfg.num_experts:
        expert = sum(int(np.prod(t.shape)) for path, t
                     in tree.flatten_with_path(params)
                     if "moe/" in path and ("gate" in path or "up" in path
                                            or "down" in path))
        return total - expert + expert * cfg.num_experts_per_tok / \
            cfg.num_experts
    return total


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Grad-accumulation factor so the per-chip remat carry stack (layers x
    per-node-microbatch x seq x d_model x 2B) stays under ~2 GB."""
    nodes = gossip_nodes(mesh)
    pnb = max(shape.global_batch // nodes, 1)
    if "pod" in mesh.axis_names:
        pnb = max(pnb // mesh.shape["data"], 1)
    layers_total = cfg.num_layers + cfg.encoder_layers
    carry = layers_total * pnb * shape.seq_len * cfg.d_model * 2
    m = 1
    while carry / m > 2e9 and m < pnb:
        m *= 2
    return m


def _map_specs(fn, specs, leaves_tree):
    """``fn(path, spec, leaf)`` over a spec tree and its leaves' tree."""
    flat = tree.flatten_with_path(leaves_tree)
    spec_leaves, spec = tree.flatten(specs)
    return tree.unflatten(spec, [fn(path, s, leaf) for (path, leaf), s
                                 in zip(flat, spec_leaves)])


def _zero_theta(theta_specs, theta, mesh):
    """zerotheta (multi-pod): also shard each theta leaf's first free
    divisible dim over "data" (each pod's node stored across its chips)."""
    data = mesh.shape["data"]

    def add_data(path, spec, leaf):
        dims = list(spec) + [None] * (leaf.dim() - len(spec))
        if "data" in dims:
            return spec
        for i in range(1, leaf.dim()):
            if dims[i] is None and leaf.shape[i] % data == 0 and \
                    leaf.shape[i] >= data:
                dims[i] = "data"
                return P(*dims)
        return spec
    return _map_specs(add_data, theta_specs, theta)


def _expert_parallel(specs, leaves_tree, gossip: bool):
    """ep: the MoE expert stacks' expert axis over "model"."""
    def ep(path, spec, leaf):
        if re.search(r"moe/(gate|up|down)$", path):
            lead = list(spec)[:1] if gossip else []
            return P(*(lead + ["model", None, None]))
        return spec
    return _map_specs(ep, specs, leaves_tree)


def _replicate_attention(specs, params):
    """repattn: attention weights replicated over the model axis."""
    return _map_specs(lambda path, spec, leaf: P() if re.search(
        r"(attn|cross)/w[qkvo]", path) else spec, specs, params)


def _realize(batch, vocab: int, device: torch.device, seed: int = 0):
    """A meta batch as tensors on ``device``: token ids drawn below
    ``vocab``, floats (frontend embeddings) zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def one(t):
        if t.dtype.is_floating_point:
            return torch.zeros(t.shape, dtype=t.dtype, device=device)
        return torch.randint(0, vocab, tuple(t.shape), generator=gen,
                             dtype=t.dtype, device=device)
    return tree.tree_map(one, batch)


def lm_program(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               strategy: str = "gossip", opt: str = "",
               recipe: steps.TrainRecipe | None = None, delay: int = 0,
               delay_dist: str | None = None, seed: int = 0) -> dict:
    """The step ``dryrun_one`` counts, built where the mesh's devices are:
    ``meta`` on the production meshes (shapes only), else the first
    device (a mesh that repeats one card, to count and time a step).

    Returns ``{"fn", "args", "arg_specs", "donated", "exchanged",
    "strategy", "mixer", "params", "contexts"}``: ``fn(*args)`` is the
    step, ``arg_specs`` the specs of ``args`` (leaf for leaf; non-tensor
    leaves are skipped), ``donated`` the index of the argument the
    reference donates (None for prefill), ``exchanged`` the (leaves,
    specs) `hlo_analysis.collective_stats` reads, ``params`` the model's
    parameters, ``contexts`` what the step runs under."""
    flags = {f for f in opt.split(",") if f}
    unknown = flags - set(OPT_FLAGS)
    if unknown:
        raise ValueError(f"unknown --opt flags {sorted(unknown)}; known: "
                         f"{', '.join(OPT_FLAGS)}")
    dev = mesh.devices.flat[0]
    model = build_model(cfg, dev)
    meta = dev.type == "meta"
    out = {"strategy": "serve", "mixer": None, "exchanged": (None, None),
           "donated": None}
    if shape.kind == "train":
        out["strategy"] = strategy
        if recipe is None:
            recipe = steps.TrainRecipe(
                strategy=strategy,
                microbatches=pick_microbatches(cfg, shape, mesh),
                delay=delay, delay_dist=delay_dist)
        batch, batch_specs = steps.train_batch_specs(cfg, shape, mesh,
                                                     strategy)
        if strategy == "gossip":
            nodes = gossip_nodes(mesh)
            gdp = steps.make_gossip_dp(nodes, recipe)
            fn = steps.make_gossip_train_step(
                model, gdp, recipe.microbatches,
                node_axis=gossip_axes(mesh)[0] if "batchpar" in flags
                else None,
                batchpar_attn="batchpar" in flags,
                head_pad=16 if "padheads" in flags else None,
                flash="flash" in flags)
            state = steps.make_gossip_init(model, gdp, nodes)(seed)
            theta = state.gossip.theta
            theta_specs = shard_rules.param_pspecs(
                theta, node_axes=gossip_axes(mesh), mesh=mesh)
            if "zerotheta" in flags and "pod" in mesh.axis_names:
                theta_specs = _zero_theta(theta_specs, theta, mesh)
            if "ep" in flags:
                theta_specs = _expert_parallel(theta_specs, theta, True)
            state_specs = steps.gossip_state_pspecs(state, theta_specs)
            mixer = gdp.mixer
            out["mixer"] = type(getattr(mixer, "inner", mixer)).__name__
            out["exchanged"] = (tree.leaves(theta), tree.leaves(theta_specs))
            out["delay"], out["delay_dist"] = gdp.delay, recipe.delay_dist
            params = tree.tree_map(lambda t: t[0], theta)
        else:
            fn, init = steps.make_allreduce_train_step(model, recipe)
            state = init(seed)
            params = state.params
            pspecs = shard_rules.param_pspecs(params, mesh=mesh)
            if "ep" in flags:
                pspecs = _expert_parallel(pspecs, params, False)
            mspecs = shard_rules.param_pspecs(state.opt["m"], mesh=mesh)
            state_specs = steps.AllreduceTrainState(
                params=pspecs, opt={"step": P(), "m": mspecs, "v": mspecs})
            out["exchanged"] = (tree.leaves(params), tree.leaves(pspecs))
        if not meta:
            batch = _realize(batch, cfg.vocab_size, dev, seed)
        out.update(fn=fn, args=(state, batch),
                   arg_specs=(state_specs, batch_specs), donated=0)
    else:
        params = model.init(seed)
        pspecs = shard_rules.param_pspecs(params, mesh=mesh)
        if shape.kind == "prefill":
            if "repattn" in flags:
                pspecs = _replicate_attention(pspecs, params)
            batch, batch_specs = steps.train_batch_specs(cfg, shape, mesh,
                                                         "allreduce")
            batch.pop("labels")
            batch_specs.pop("labels")
            if not meta:
                batch = _realize(batch, cfg.vocab_size, dev, seed)
            fn = steps.make_prefill_step(
                model, last_only="last_only" in flags,
                seqpar_axis="model" if "seqpar" in flags else None,
                moe_groups=16 if "moegroup" in flags else 1,
                moe_group_axis="data" if "moegroup" in flags else None,
                head_pad=16 if "padheads" in flags else None,
                sp_axis="model" if "spres" in flags else None)
            out.update(fn=fn, args=(params, batch),
                       arg_specs=(pspecs, batch_specs))
        else:
            cache = model.init_cache(shape.global_batch,
                                     steps.decode_cache_len(cfg, shape))
            baxes = steps.batch_axes_for_serve(mesh, shape.global_batch)
            cache_specs = shard_rules.cache_pspecs(cache, baxes or ("data",),
                                                   mesh=mesh)
            if not baxes:   # batch too small to shard: replicate it
                cache_specs = tree.tree_map(lambda s: P(*[
                    None if d in ("data", "pod") or isinstance(d, tuple)
                    else d for d in s]), cache_specs)
            (tok, pos), (tok_spec, pos_spec) = steps.serve_batch_specs(
                cfg, shape, mesh)
            if not meta:
                tok = _realize(tok, cfg.vocab_size, dev, seed)
                pos = torch.zeros(pos.shape, dtype=pos.dtype, device=dev)
            out.update(fn=steps.make_serve_step(model),
                       args=(params, cache, tok, pos),
                       arg_specs=(pspecs, cache_specs, tok_spec, pos_spec),
                       donated=1)
    out["params"] = params
    out["contexts"] = (attention.flash_query_chunk(1024),) if "bigq" in \
        flags else ()
    return out


def count_lm_step(program: dict, mesh) -> tuple:
    """``(outputs, OpCost, seconds)``: one call of ``program``'s step
    counted under ``with mesh:`` (on ``meta``, its loops shortened)."""
    t0 = time.perf_counter()
    with mesh, contextlib.ExitStack() as stack:
        for ctx in program["contexts"]:
            stack.enter_context(ctx)
        out, cost = op_cost.count(program["fn"], *program["args"])
    return out, cost, time.perf_counter() - t0


def _tensors_with_specs(values, specs) -> list:
    """(tensor, spec) pairs of a tree and its spec tree, the non-tensor
    leaves (a generator, a step count) skipped."""
    return [(t, s) for t, s in zip(tree.leaves(values), tree.leaves(specs))
            if isinstance(t, torch.Tensor)]


def _bytes_per_device(pairs, mesh) -> int:
    return sum(hlo_analysis.shard_bytes(tuple(t.shape), t.element_size(),
                                        s if isinstance(s, P) else P(), mesh)
               for t, s in pairs)


def argument_bytes(program: dict, mesh) -> list:
    """Per-device bytes of each argument of ``program``'s step, from its
    specs on ``mesh``."""
    return [_bytes_per_device(_tensors_with_specs(a, s), mesh) for a, s
            in zip(program["args"], program["arg_specs"])]


def _tensor_bytes(values) -> int:
    return sum(t.numel() * t.element_size() for t in tree.leaves(values)
               if isinstance(t, torch.Tensor))


def needed_bytes(program: dict, outputs, cfg: ModelConfig,
                 shape: ShapeConfig) -> int:
    """The HBM bytes one call of ``program``'s step needs however its ops
    are fused, from the shapes alone (the whole step, every device's):
    each argument read once and each output written once (``outputs``:
    the step's, meta will do); for a train step every node's gradient
    written once, and at each layer boundary of the residual stream
    (B x T x d_model in the model's dtype) the forward's activation and
    the backward's gradient each written once and read once, and the
    logits (B x T x vocab) written once and read once; for a prefill or
    decode step each layer boundary's activation written once and read
    once. This is the memory term of the step's roofline; op_cost's
    count is the eager op sequence's, which no fusion discounts."""
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    item = torch.empty((), dtype=cfg.tdtype).element_size()
    boundary = (cfg.num_layers + cfg.encoder_layers) * tokens * \
        cfg.d_model * item
    need = _tensor_bytes(program["args"]) + _tensor_bytes(outputs)
    if shape.kind != "train":
        return need + 2 * boundary
    grads = _tensor_bytes(program["exchanged"][0])
    return need + grads + 4 * boundary + \
        2 * tokens * cfg.vocab_size * item


def _memory(program: dict, outputs, mesh) -> dict:
    """Per-device bytes from the specs: the arguments, the outputs (the
    new state or cache on its argument's specs, the rest replicated), the
    donated argument; ``temp`` None: a meta count tracks no live memory."""
    args = argument_bytes(program, mesh)
    donated = program["donated"]
    first, rest = (outputs, ()) if donated is None else \
        ((outputs[0], outputs[1]) if donated == 0 else
         (outputs[1], outputs[0]))
    if donated is None:
        out_pairs = [(t, P()) for t in tree.leaves(first)
                     if isinstance(t, torch.Tensor)]
    else:
        out_pairs = _tensors_with_specs(first,
                                        program["arg_specs"][donated]) + \
            [(t, P()) for t in tree.leaves(rest)
             if isinstance(t, torch.Tensor)]
    return {
        "temp": None,
        "arguments": sum(args),
        "output": _bytes_per_device(out_pairs, mesh),
        "alias": 0 if donated is None else args[donated],
    }


def _model_flops(cfg, shape, n_active) -> float:
    if shape.kind == "decode":
        return hlo_analysis.model_flops(n_active, shape.global_batch) / 3.0
    mf = hlo_analysis.model_flops(n_active,
                                  shape.global_batch * shape.seq_len)
    return mf if shape.kind == "train" else mf / 3.0   # fwd only: 2ND


def _counted_as(program: dict, chips: int, shape: ShapeConfig) -> str:
    if program["strategy"] == "gossip":
        what = ("the global gossip train step: one node's forward and "
                "backward weighted by the nodes, then GossipDP.update over "
                "the node-stacked theta")
    elif program["strategy"] == "allreduce":
        what = "the global all-reduce train step (AdamW)"
    else:
        what = f"the global {shape.kind} step"
    return (f"{what}, counted on meta tensors by op_cost's eager rules "
            f"(every op's operands and results, no fusion; each fixed-trip "
            f"loop by weighted representative iterations), divided evenly "
            f"over the {chips} devices; replicated work not modelled")


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False,
               strategy: str = "gossip",
               recipe: steps.TrainRecipe | None = None, save: bool = True,
               verbose: bool = True, opt: str = "", delay: int = 0,
               delay_dist: str | None = None,
               out_dir: str | None = None) -> dict:
    """Count one step of ``arch`` at input shape ``shape_name`` on the
    production mesh, on shapes alone; see the module docstring. ``opt``:
    comma-separated perf-variant flags — results are saved under
    strategy+opt so baselines stay untouched. ``delay`` / ``delay_dist``
    install a history ring for WAN-stale gossip (ignored when an explicit
    recipe is passed). Records go to ``out_dir`` (default `OUT_DIR`)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    strategy_tag = strategy + ("+" + opt if opt else "")
    shape = INPUT_SHAPES[shape_name]
    base_cfg = get_config(arch)
    reason = steps.skip_reason(base_cfg, shape)
    if reason:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "strategy": strategy, "status": "skipped", "reason": reason}
        if save:
            _save(rec, out_dir)
        if verbose:
            print(f"[skip] {arch} x {shape_name}: {reason}")
        return rec
    cfg = steps.effective_config(base_cfg, shape)
    program = lm_program(cfg, shape, mesh, strategy=strategy, opt=opt,
                         recipe=recipe, delay=delay, delay_dist=delay_dist)
    outputs, cost, count_s = count_lm_step(program, mesh)
    chips = mesh.size
    flops, hbm_bytes = cost.flops / chips, cost.hbm_bytes / chips
    leaves, specs = program["exchanged"]
    coll = hlo_analysis.collective_stats(
        leaves, specs, mesh, strategy=program["strategy"],
        mixer=program["mixer"] or "RingRollMixer",
        delay=program.get("delay", 0), delay_dist=program.get("delay_dist"))
    terms = hlo_analysis.roofline_terms(flops, hbm_bytes, coll.total_bytes,
                                        chips=1)
    params = program["params"]
    n_active = active_param_count(cfg, params)
    mf = _model_flops(cfg, shape, n_active)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "strategy": strategy_tag, "status": "ok", "chips": chips,
        "compile_s": round(count_s, 3),
        "hlo_flops": flops, "hlo_bytes": hbm_bytes,
        "collectives": coll.summary(),
        "xla_cost_analysis_raw": None,
        "roofline": terms,
        "model_flops_6nd": mf,
        "useful_flops_ratio": (mf / cost.flops) if cost.flops else None,
        "n_params": count_params(params), "n_params_active": n_active,
        "memory_per_device": _memory(program, outputs, mesh),
        "counted_as": _counted_as(program, chips, shape),
    }
    if save:
        _save(rec, out_dir)
    if verbose:
        print(f"[ok] {arch} x {shape_name} @ {mesh_name}/{strategy}: "
              f"counted {count_s:.1f}s flops={flops:.3g} "
              f"bytes={hbm_bytes:.3g} coll={coll.total_bytes:.3g}B "
              f"(+ model axis: not derivable) "
              f"dominant={terms['dominant']} useful="
              f"{rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}")
    return rec


def dryrun_stream(stream: str, *, engine: str = "sim", nodes: int = 8,
                  dim: int = 256, chunk_rounds: int = 64,
                  stream_options: dict | None = None, save: bool = True,
                  verbose: bool = True, device: str = "cuda",
                  out_dir: str | None = None) -> dict:
    """Count the chunk program `repro_torch.run` drives for a STREAMS
    scenario (one round, times ``chunk_rounds``) and record its cost —
    proves a declared scenario runs on either engine before you pay for
    the run. The round body is the fused kernels' (``backend="cuda"``)."""
    from repro_torch.api import RunSpec
    from repro_torch.api.runner import _stream_chunk, make_chunk_fn
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.obs import analyze_chunk, calibrate

    dev = resolve_device(device)
    model = calibrate(device=dev)      # before the peak-memory window
    spec = RunSpec(nodes=nodes, dim=dim, horizon=chunk_rounds, eps=1.0,
                   alpha0=0.5, lam=0.01, stream=stream,
                   stream_options=stream_options or {}, backend="cuda")
    fn, state = make_chunk_fn(spec, engine, dev)
    xs, ys = _stream_chunk(spec.resolve_stream(device=dev), 0, 1, dev)
    before = None
    if dev.type == "cuda":
        synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        before = int(torch.cuda.memory_allocated(dev))
    t0 = time.perf_counter()
    cc = analyze_chunk(fn, state, xs, ys, model=model, rounds=chunk_rounds)
    synchronize(dev)
    count_s = time.perf_counter() - t0
    peak = (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else None)      # the process's, over the counted round
    rec = {
        "arch": f"stream-{stream}", "shape": f"chunk{chunk_rounds}",
        "mesh": "host", "strategy": engine, "status": "ok",
        "stream": stream, "engine": engine, "nodes": nodes, "dim": dim,
        "chunk_rounds": chunk_rounds, "compile_s": round(count_s, 1),
        "hlo_flops": cc.cost.flops, "hlo_bytes": cc.cost.hbm_bytes,
        "collectives": {"collective_bytes": cc.cost.collective_bytes},
        "device": str(dev),
        "memory_peak_bytes": peak,
        # what the counted round itself allocated above the state and data
        "memory_round_bytes": None if peak is None else peak - before,
        "predicted_chunk_s": cc.predicted_s,
        "model": cc.model.summary(),
    }
    if save:
        _save(rec, out_dir)
    if verbose:
        print(f"[ok] stream={stream} engine={engine} m={nodes} n={dim} "
              f"chunk={chunk_rounds}: counted {count_s:.1f}s "
              f"flops={cc.cost.flops:.3g} bytes={cc.cost.hbm_bytes:.3g}")
    return rec


def _save(rec: dict, out_dir: str | None = None) -> None:
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    fn = (f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__"
          f"{rec['strategy']}.json")
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(rec, f, indent=2)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="count an LM step on shapes alone (--arch/--shape, "
                    "--all), or a STREAMS scenario's chunk program "
                    "(--stream)")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="gossip",
                    choices=["gossip", "allreduce"])
    ap.add_argument("--opt", default="",
                    help="perf-variant flags, comma separated")
    ap.add_argument("--delay", type=int, default=0,
                    help="WAN gossip staleness (rounds); adds the history "
                         "ring to the counted GossipState")
    ap.add_argument("--delay-dist", default=None,
                    choices=["constant", "uniform", "geometric"])
    ap.add_argument("--stream", default=None,
                    help="repro_torch.api STREAMS name: count the "
                         "repro_torch.run chunk program instead of an arch")
    ap.add_argument("--stream-opt", action="append", default=[],
                    metavar="KEY=VALUE")
    ap.add_argument("--engine", default="sim", choices=["sim", "dist"])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--chunk-rounds", type=int, default=64)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where --stream's counted round runs (default: "
                         "the card); the LM mode touches no device")
    ap.add_argument("--out", default=None,
                    help=f"directory of the records (default {OUT_DIR})")
    return ap


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.stream:
        from repro_torch.launch.train import parse_stream_options
        dryrun_stream(args.stream, engine=args.engine, nodes=args.nodes,
                      dim=args.dim, chunk_rounds=args.chunk_rounds,
                      stream_options=parse_stream_options(args.stream_opt),
                      device=args.device, out_dir=args.out)
        return 0

    if args.all:
        runs = [(arch, shape) for arch in ARCH_IDS for shape in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        runs = [(args.arch, args.shape)]

    failures = 0
    t0 = time.perf_counter()
    for arch, shape in runs:
        try:
            dryrun_one(arch, shape, multi_pod=args.multi_pod,
                       strategy=args.strategy, opt=args.opt,
                       delay=args.delay, delay_dist=args.delay_dist,
                       out_dir=args.out)
        except Exception:
            failures += 1
            print(f"[FAIL] {arch} x {shape}:\n{traceback.format_exc()}")
            _save({"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if args.multi_pod else "16x16",
                   "strategy": args.strategy, "status": "failed",
                   "error": traceback.format_exc()[-2000:]}, args.out)
    if len(runs) > 1:
        print(f"[all] {len(runs)} cells, {failures} failed, in "
              f"{time.perf_counter() - t0:.1f} s")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
