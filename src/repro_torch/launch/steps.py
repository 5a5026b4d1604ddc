"""Step functions and input/shard-spec builders for training and serving.

Counterpart of `repro.launch.steps`, on the port: `launch/train.py`
(``--arch``) and `launch/serve_lm.py` execute these steps. The GossipDP
strategy is the paper's technique as a distribution strategy for a
transformer; 'allreduce' is the classic data-parallel baseline the paper
compares against (its "centralized" comparator).

The reference vmaps ``value_and_grad`` over the gossip node axis. The
port's gossip step loops over the nodes instead, each node's loss and
``torch.autograd.grad`` in turn, and writes node i's gradient into slot i
of a node-stacked buffer: one node's graph lives at a time, and the
blockwise attention's flash backward (an autograd Function) needs no vmap
rule. The primal is cast to the model's dtype for its float32 leaves only,
as the reference casts it; with ``microbatches`` > 1 the gradients are
accumulated in float32 and divided by the count.

The mesh arguments (``node_axis``, ``batchpar_attn``, the ``head_pad``
axis, the prefill step's ``seqpar_axis``, ``moe_group_axis`` and
``sp_axis``) place nothing: the port's one-process LM runs on one device,
and each axis is checked against the active mesh
(`repro_torch.sharding.rules.check_axis`). Head padding itself is real
(`repro_torch.models.attention.head_padding`).

The input "specs" are meta tensors: shape and dtype, no storage.

>>> spec = TrainRecipe(eps=0.5, topology="torus").to_runspec(16)
>>> spec.nodes, spec.mixer, spec.eps, spec.calibration
(16, 'torus', 0.5, 'coordinate')
>>> from repro_torch.models import INPUT_SHAPES
>>> from repro_torch.configs import get_config
>>> decode_cache_len(get_config("mixtral-8x7b"), INPUT_SHAPES["decode_32k"])
4096
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api import RunSpec
from repro_torch.core import tree
from repro_torch.core.gossip import GossipDP
from repro_torch.data.social import round_seed
from repro_torch.launch import mesh as mesh_lib
from repro_torch.core import loops
from repro_torch.models import attention, moe, transformer
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.obs import span
from repro_torch.optim import adamw, apply_updates, warmup_cosine
from repro_torch.sharding import rules as shard_rules
from repro_torch.sharding.rules import P, NamedSharding, check_axis

__all__ = ["TrainRecipe", "effective_config", "skip_reason",
           "decode_cache_len", "GossipTrainState", "make_gossip_dp",
           "make_gossip_train_step", "make_gossip_init",
           "gossip_state_pspecs", "AllreduceTrainState",
           "make_allreduce_train_step", "make_prefill_step",
           "make_serve_step", "train_batch_specs", "serve_batch_specs",
           "batch_axes_for_serve", "named"]

F32 = torch.float32


# ---------------------------------------------------------------------------
# strategy configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainRecipe:
    """Training-launch knobs; the gossip path materialises as a
    `repro_torch.api.RunSpec` (see :meth:`to_runspec`), so every
    registry-backed mixer / mechanism / local rule is reachable from the
    CLI."""

    strategy: str = "gossip"        # 'gossip' (the paper) | 'allreduce' (baseline)
    eps: float = 1.0                # DP budget per round (gossip only)
    L: float = 1.0                  # clip norm
    lam: float = 1e-4               # Lasso strength
    alpha0: float = 0.01
    topology: str = "ring"          # repro_torch.api MIXERS registry name
    lr: float = 3e-4                # allreduce baseline LR
    noise_self: bool = True
    microbatches: int = 1           # grad-accumulation chunks per round
    # Laplace calibration: 'coordinate' (2*alpha*L/eps per coordinate) is the
    # deployable default at transformer scale; the paper's exact Lemma-1
    # 'global' scale carries a sqrt(n) factor — selectable for the
    # paper-faithful linear workload.
    clip_style: str = "coordinate"
    mechanism: str = "laplace"      # repro_torch.api MECHANISMS registry name
    local_rule: str = "omd"         # repro_torch.api LOCAL_RULES registry name
    clipper: str = "l2"             # repro_torch.api CLIPPERS registry name
    # WAN staleness (rounds): delay > 0 gives the state a (delay+1)-deep
    # history ring; delay_dist ('constant'|'uniform'|'geometric') draws
    # per-edge delays <= delay from a seeded distribution instead of one
    # uniform lag.
    delay: int = 0
    delay_dist: str | None = None

    def to_runspec(self, nodes: int) -> RunSpec:
        return RunSpec(
            nodes=nodes,
            mixer=self.topology,
            mechanism=self.mechanism,
            local_rule=self.local_rule,
            clipper=self.clipper,
            eps=self.eps,
            clip_norm=self.L,
            noise_self=self.noise_self,
            calibration=self.clip_style,
            alpha0=self.alpha0,
            schedule="sqrt_t",
            lam=self.lam,
            delay=self.delay,
            delay_dist=self.delay_dist,
        )


def effective_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Shape-dependent tweaks: the long_500k sliding-window variant."""
    if shape.name == "long_500k" and cfg.window_500k and \
            cfg.sliding_window is None:
        return dataclasses.replace(cfg, sliding_window=cfg.window_500k)
    return cfg


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return ("full-attention arch without a windowed variant; 500k decode "
                "needs a sub-quadratic mechanism (DESIGN.md §Arch-applicability)")
    return None


def decode_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    if cfg.sliding_window is not None:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

def _loss_and_grads(loss_fn, params, batch):
    """(loss, metrics, gradients as a list in leaf order) of one loss;
    a leaf the loss does not reach gets a zero gradient, as in JAX."""
    leaves, spec = tree.flatten(params)
    live = [leaf.detach().requires_grad_(True) for leaf in leaves]
    with span("step.forward"):
        loss, metrics = loss_fn(tree.unflatten(spec, live), batch)
    with span("step.backward"):
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        # materialize_grads=True's zeros, but for the parameters of layers
        # a dry-run's representative layer stood for: what they stand in
        # for was counted, so they are free stand-ins too
        grads = [g if g is not None else
                 torch.empty_like(p) if loops.stands_in(p) else
                 torch.zeros_like(p) for g, p in zip(grads, live)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _per_node(loss_fn, w_model, batch, add):
    """Node by node: the loss on node i's params and batch, its gradient
    handed to ``add(i, grads)``. Returns ((n,) losses, {k: (n,)})."""
    leaves, spec = tree.flatten(w_model)
    losses, mets = [], []
    nodes = loops.loop(leaves[0].shape[0], leaves[0], independent=True)
    for i in nodes:
        loss, met, grads = _loss_and_grads(
            loss_fn, tree.unflatten(spec, [leaf[i] for leaf in leaves]),
            tree.tree_map(lambda b: b[i], batch))
        add(i, grads)
        del grads
        losses.append(loss)
        mets.append(met)
    losses, mets = nodes.full(losses), nodes.full(mets)
    return torch.stack(losses), {k: torch.stack([m[k] for m in mets])
                                 for k in mets[0]}


# ---------------------------------------------------------------------------
# train step builders
# ---------------------------------------------------------------------------

class GossipTrainState(NamedTuple):
    gossip: Any   # core.gossip.GossipState (theta = node-stacked params)


def make_gossip_dp(cfg_nodes: int, recipe: TrainRecipe) -> GossipDP:
    return recipe.to_runspec(cfg_nodes).build_distributed()


def make_gossip_train_step(model, gdp: GossipDP, microbatches: int = 1,
                           node_axis: str | None = None,
                           batchpar_attn: bool = False,
                           head_pad: int | None = None,
                           flash: bool = False):
    """Batch leaves carry a leading node axis; params/theta are node-stacked.

    ``microbatches`` > 1 grad-accumulates over chunks of the per-node batch
    (peak activation memory / microbatches; identical update in
    expectation). ``node_axis`` names the mesh axis of the node dim;
    ``batchpar_attn`` names "model" for attention's batch dim (both
    checked, not placed); ``head_pad`` pads attention heads to a multiple;
    ``flash`` routes blockwise attention through the flash backward.
    """
    cfg = model.cfg

    def node_grads(w_model, batch):
        """((n,) losses, {k: (n,)}, node-stacked gradients in leaf order)."""
        leaves = tree.leaves(w_model)
        if microbatches == 1:
            out = [torch.empty_like(leaf) for leaf in leaves]

            def add(i, grads):
                for o, g in zip(out, grads):
                    o[i].copy_(g)

            loss, metrics = _per_node(model.loss_fn, w_model, batch, add)
            return loss, metrics, out
        M = microbatches
        out = [torch.zeros(leaf.shape, dtype=F32, device=leaf.device)
               for leaf in leaves]

        def add(i, grads):
            for o, g in zip(out, grads):
                o[i] += g.to(F32)

        def to_mb(leaf):
            n, b = leaf.shape[:2]
            return leaf.reshape((n, M, b // M) + tuple(leaf.shape[2:]))

        mb_batch = tree.tree_map(to_mb, batch)
        losses, mets = [], []
        chunks = loops.loop(M, out[0], independent=True)
        for j in chunks:
            l_j, m_j = _per_node(model.loss_fn, w_model,
                                 tree.tree_map(lambda b: b[:, j], mb_batch),
                                 add)
            losses.append(l_j)
            mets.append(m_j)
        losses, mets = chunks.full(losses), chunks.full(mets)
        loss = torch.mean(torch.stack(losses), dim=0)
        metrics = {k: torch.mean(torch.stack([m[k] for m in mets]), dim=0)
                   for k in mets[0]}
        return loss, metrics, [o / M for o in out]

    def train_step(state: GossipTrainState, batch):
        check_axis(node_axis, "make_gossip_train_step(node_axis=)")
        with span("step.primal"):
            # node-stacked primal params (steps 6-7)
            w = gdp.primal(state.gossip)
            w_model = tree.tree_map(
                lambda a: a.to(cfg.tdtype) if a.dtype == F32 else a, w)
            del w
        spec = tree.flatten(w_model)[1]
        # the backward, and cfg.remat's recompute inside it, run under the
        # forward's attention contexts
        with attention.batch_parallel("model" if batchpar_attn else None), \
             attention.head_padding(head_pad, "model" if head_pad else None), \
             attention.flash_vjp("flash" if flash else False), \
             span("step.grad"):
            loss, metrics, out = node_grads(w_model, batch)
        del w_model
        grads = tree.unflatten(spec, out)
        del out
        with span("step.update"):
            new_gossip, gossip_metrics = gdp.update(state.gossip, grads)
        out = {
            "loss": torch.mean(loss),
            "ce": torch.mean(metrics["ce"]),
            "aux": torch.mean(metrics["aux"]),
            **gossip_metrics,
        }
        return GossipTrainState(gossip=new_gossip), out

    return train_step


def make_gossip_init(model, gdp: GossipDP, nodes: int):
    """``init(seed)``: the model's init, tiled over the nodes, as the
    engine's theta; the weights and the noise generator take independent
    seeds derived from ``seed``. Runs where the model lives."""
    def init(seed: int = 0) -> GossipTrainState:
        params = model.init(round_seed(seed, 0))
        node_params = shard_rules.with_node_axis(params, nodes)
        state = gdp.init(node_params, seed=round_seed(seed, 1),
                         device=tree.leaves(params)[0].device)
        del params, node_params
        # a float32 leaf may still be the broadcast view: make it its own
        theta = tree.tree_map(lambda t: t.contiguous(), state.theta)
        return GossipTrainState(gossip=state._replace(theta=theta))
    return init


def gossip_state_pspecs(state_struct: GossipTrainState,
                        theta_specs: Any) -> GossipTrainState:
    """PartitionSpecs for a GossipTrainState, given the theta leaf specs.

    The history ring (present when the mixer carries a delay) shards like
    theta with an extra unsharded leading ring axis, so the stale copies
    live on the same devices as the live ones.
    """
    gossip = state_struct.gossip
    hist_specs = None
    if gossip.history is not None:
        hist_specs = tree.tree_map(lambda s: P(*((None,) + tuple(s))),
                                   theta_specs)
    return GossipTrainState(gossip=type(gossip)(
        theta=theta_specs, t=P(), generator=P(), history=hist_specs))


class AllreduceTrainState(NamedTuple):
    params: Any
    opt: Any


def make_allreduce_train_step(model, recipe: TrainRecipe,
                              total_steps: int = 10_000):
    optimizer = adamw(warmup_cosine(recipe.lr, 200, total_steps))
    M = recipe.microbatches

    def train_step(state: AllreduceTrainState, batch):
        spec = tree.flatten(state.params)[1]
        with span("step.grad"):
            loss, metrics, grads = replica_grads(state.params, batch)
        with span("step.update"):
            updates, opt = optimizer.update(tree.unflatten(spec, grads),
                                            state.opt, state.params)
            params = apply_updates(state.params, updates)
        return AllreduceTrainState(params, opt), {"loss": loss, **metrics}

    def replica_grads(params, batch):
        """(loss, metrics, gradients in leaf order) of the replica's batch,
        accumulated over M microbatches."""
        if M == 1:
            return _loss_and_grads(model.loss_fn, params, batch)
        mb_batch = tree.tree_map(
            lambda leaf: leaf.reshape((M, leaf.shape[0] // M)
                                      + tuple(leaf.shape[1:])), batch)
        grads = [torch.zeros(p.shape, dtype=F32, device=p.device)
                 for p in tree.leaves(params)]
        losses, mets = [], []
        chunks = loops.loop(M, grads[0], independent=True)
        for j in chunks:
            l_j, m_j, g_j = _loss_and_grads(
                model.loss_fn, params,
                tree.tree_map(lambda b: b[j], mb_batch))
            for acc, g in zip(grads, g_j):
                acc += g.to(F32)
            losses.append(l_j)
            mets.append(m_j)
        losses, mets = chunks.full(losses), chunks.full(mets)
        grads = [g / M for g in grads]
        loss = torch.mean(torch.stack(losses))
        metrics = {k: torch.mean(torch.stack([m[k] for m in mets]))
                   for k in mets[0]}
        return loss, metrics, grads

    def init(seed: int = 0) -> AllreduceTrainState:
        params = model.init(seed)
        return AllreduceTrainState(params, optimizer.init(params))

    return train_step, init


# ---------------------------------------------------------------------------
# serve steps
# ---------------------------------------------------------------------------

def make_prefill_step(model, last_only: bool = False,
                      seqpar_axis: str | None = None,
                      moe_groups: int = 1, moe_group_axis: str | None = None,
                      head_pad: int | None = None, sp_axis: str | None = None):
    """The greedy next token after each prompt of ``batch["tokens"]``.

    last_only    — compute the logits of the last position only.
    seqpar_axis  — the reference's sequence-parallel blockwise attention
                   (checked, not placed).
    moe_groups   — grouped MoE dispatch (capacity C/G per group; changes
                   the drops), its group dim on ``moe_group_axis``.
    head_pad     — pad attention heads to a multiple (exact).
    sp_axis      — the reference's sequence-parallel residual stream.
    """
    def prefill_step(params, batch):
        with torch.no_grad(), attention.sequence_parallel(seqpar_axis), \
             moe.grouped_dispatch(moe_groups, moe_group_axis), \
             attention.head_padding(head_pad, "model" if head_pad else None), \
             transformer.sp_residual(sp_axis):
            logits, _ = model.apply(params, batch["tokens"],
                                    batch.get("frontend"),
                                    last_only=last_only)
        return torch.argmax(logits[:, -1], dim=-1)
    return prefill_step


def make_serve_step(model):
    def serve_step(params, cache, tokens, pos):
        with torch.no_grad():
            logits, cache = model.decode_step(params, cache, tokens, pos)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, cache
    return serve_step


# ---------------------------------------------------------------------------
# input specs (meta tensors — no allocation) + shardings
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      strategy: str) -> tuple[Any, Any]:
    """Returns (batch_structs, batch_pspecs)."""
    B, T = shape.global_batch, shape.seq_len
    if strategy == "gossip":
        nodes = mesh_lib.gossip_nodes(mesh)
        pnb = B // nodes
        lead_axes = mesh_lib.gossip_axes(mesh)
        inner = mesh_lib.data_axes_for_batch(mesh)
        lead = lead_axes[0] if len(lead_axes) == 1 else lead_axes
        bspec = P(lead, inner[0] if inner else None, None)
        shape3 = (nodes, pnb, T)
        fe_spec = P(lead, inner[0] if inner else None, None, None)
        fe_dims = (nodes, pnb)
    else:
        axes = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
        lead = axes if len(axes) > 1 else axes[0]
        bspec = P(lead, None)
        shape3 = (B, T)
        fe_spec = P(lead, None, None)
        fe_dims = (B,)

    batch = {
        "tokens": _sds(shape3, torch.int32),
        "labels": _sds(shape3, torch.int32),
    }
    specs = {"tokens": bspec, "labels": bspec}
    if cfg.frontend == "vision":
        batch["frontend"] = _sds(fe_dims + (cfg.frontend_tokens,
                                            cfg.d_model), cfg.tdtype)
        specs["frontend"] = fe_spec
    elif cfg.family == "encdec":
        batch["frontend"] = _sds(fe_dims + (max(T // 4, 8), cfg.d_model),
                                 cfg.tdtype)
        specs["frontend"] = fe_spec
    return batch, specs


def serve_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """Decode inputs: tokens (B, 1), pos (B,). Batch over all data axes;
    batch==1 (long_500k) replicates."""
    B = shape.global_batch
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    total = int(np.prod([mesh.shape[a] for a in axes]))
    lead = (tuple(axes) if len(axes) > 1 else axes[0]) if B >= total \
        else None
    tokens = _sds((B, 1), torch.int32)
    pos = _sds((B,), torch.int32)
    return (tokens, pos), (P(lead, None), P(lead))


def batch_axes_for_serve(mesh, B: int):
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    total = int(np.prod([mesh.shape[a] for a in axes]))
    if B >= total:
        return tuple(axes)
    return ()


def named(mesh, spec_tree):
    """Each PartitionSpec of ``spec_tree`` on ``mesh`` (a record)."""
    return tree.tree_map(lambda s: NamedSharding(mesh, s), spec_tree)
