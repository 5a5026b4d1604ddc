"""BACKENDS — how a RunSpec's round body executes.

Counterpart of `repro.api.backends`. `RunSpec.backend` selects the backend
by name and ``backend_options`` configure it; `runner.make_chunk_program`
dispatches through it, so streams, delay rings, checkpoints and both
engines ("sim" and "dist") work with either backend unchanged:

  "reference" — `core.algorithm1.Algorithm1.round` in torch ops: the
                correctness oracle.
  "cuda"      — the fused round of the reference's ``PallasBackend``, on
                the hand-written Hopper kernels of
                `repro_torch.kernels.round_fused`: prox + per-node stats in
                ``round_stats``, the clip folded into a per-node coefficient,
                noise-add + mix + dual step + crash freeze in
                ``round_update`` (from the graph's non-zeros when it has
                few per row — the ring, torus, hypercube and random
                graphs; else the dense A, as for a complete ``dense``
                mixer). Each row is added in the order the reference
                backend's mixer adds it — the ring's roll order, ascending
                columns for the others — and the dual step rounds as its
                torch ops do: the two backends' iterates part only where
                the kernel's per-node dot products (added in another
                order) move a margin across 1 or a sign.

Both backends share each engine's state (`SimState`, or `GossipState` with
``theta={"w": ...}``) and draw the noise the same way from the state's
generator, outside the kernels, so checkpoints interchange
and `correct`, `sparsity` and the eps ledger agree exactly at the tested
sizes; the iterates agree within the float32 contract (kernel reduction
order differs from torch's).

Modes of "cuda" (``backend_options={"mode": ...}``):

  fused  — mixing happens INSIDE ``round_update`` through the spec's fixed
           topology: its CSR form (`round_fused.sparse_mix`) when no row
           holds more than 16 non-zeros, else the dense (m, m) A; needs
           m <= ``max_fused_nodes``.
  hybrid — mixing stays in torch ops (``mixer.mix`` / ``mix_history``)
           between ``round_stats`` and ``dual_step``.
  auto   — fused when the mixer lowers to a fixed sparse graph and m fits,
           else hybrid: the complete, disconnected, alternating-ring,
           time-varying and per-edge-delay mixers have no fixed graph, and
           neither has a faulty one (`repro_torch.faults`: its weights
           change every round), so a fault scenario always runs hybrid.

Where the round has the same shape every round — the fused form at delay
0 with no fault schedule and the port's own mechanism, on the card — the
chunk programs replay it from a CUDA graph captured once a run
(`round_graph.RoundGraph`, built by `CudaBackend._round_program`): one
launch a round, bit for bit the eager loop. Every other path keeps the
eager loop.

Under a fault scenario with crash windows, the crash freeze runs in the
kernel (``dual_step``; ``round_update`` has the same epilogue) with the
round's liveness row from the schedule's device table — no host copy per
round.

Seed batches (`runner.run_batch`): each backend also builds a batch chunk
program over a `runner.BatchState`. The reference backend steps every
seed's round in seed order (the oracle). The cuda backend's round is
written for S seeds — one batched ``round_stats``, the per-node algebra
on (S, m) tensors (reductions seed by seed, in a one-seed run's order),
each seed's noise from its own generator, then one batched
``round_update`` (fused) or the torch-op mix seed by seed and one
``dual_step`` over the S*m rows (hybrid) — and a one-seed `run` takes it
as a batch of one, so a batch's seeds equal their runs bit for bit.

Node sharding (`shard_node.make_node_chunk_fn`): each backend's
``make_local_round_fn`` builds the round over every shard of a mesh row —
the reference backend in torch ops, seed by seed and shard by shard (the
oracle); the cuda backend with one ``round_stats`` and one ``dual_step``
launch a shard on its (S, block, n) rows and the mix in torch ops after
the halo copies (`shard_node.ShardedSparseMixer`).

>>> from repro_torch.api import BACKENDS
>>> BACKENDS.names()
('cuda', 'reference')
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.api.mixers import ring_read, ring_write
from repro_torch.api.registry import BACKENDS
from repro_torch.api.runner import (BatchState, batch_init, chunk_loop,
                                    reference_batch_chunk_program,
                                    reference_chunk_program,
                                    reference_round_program, seed_state,
                                    stack_states)
from repro_torch.kernels.round_fused import MAX_FUSED_NODES
from repro_torch.obs import span

__all__ = ["BACKENDS", "ReferenceBackend", "CudaBackend"]


@dataclasses.dataclass(frozen=True)
class ReferenceBackend:
    """Torch-op engine — the oracle the cuda backend is held to."""

    name: str = "reference"

    def make_chunk_program(self, spec, engine: str, device: torch.device):
        return reference_chunk_program(spec, engine, device)

    def make_batch_chunk_program(self, spec, engine: str,
                                 device: torch.device):
        return reference_batch_chunk_program(spec, engine, device)

    def make_local_round_fn(self, spec, engine: str, part, delay: int,
                            schedule=None, graph=None, *,
                            devices) -> Callable:
        from repro_torch.api import shard_node
        return shard_node.reference_local_round_fn(
            spec, engine, part, delay, schedule=schedule, graph=graph,
            devices=devices)


def _check_supported(spec) -> None:
    """The stages the fused round body hard-codes; everything else raises
    with the escape hatch named (backend='reference')."""
    from repro_torch.api.clippers import NoClipper, PerNodeL2Clipper
    from repro_torch.api.rules import OMDLassoRule

    rule = spec.resolve_local_rule()
    if not isinstance(rule, OMDLassoRule) or rule.prox_kind not in ("l1",
                                                                    "none"):
        raise ValueError(
            f"backend='cuda' fuses the paper's OMD + L1/identity prox "
            f"round body; got local_rule={type(rule).__name__}"
            f"{getattr(rule, 'prox_kind', '')!r} — use backend='reference'")
    clipper = spec.resolve_clipper()
    if not isinstance(clipper, (PerNodeL2Clipper, NoClipper)):
        raise ValueError(
            f"backend='cuda' folds clipping into a per-node coefficient, "
            f"which needs the per-node L2 clipper (or none); got "
            f"{type(clipper).__name__} — use backend='reference'")
    if spec.loss_and_grad is not None:
        raise ValueError(
            "backend='cuda' fuses the hinge loss/subgradient; a custom "
            "loss_and_grad needs backend='reference'")


def _dense_mix_form(mixer, device: torch.device):
    """(A, diag, delay, csr) mixing form for the fused mode, or None when
    the mixer has no fixed sparse lowering. ``csr`` is A's CSR form when
    the graph has few non-zeros per row (the sparse path), else None.
    A faulty mixer (`repro_torch.faults`) may subclass a fixed-form mixer,
    but its weights change every round: it has no fixed form."""
    if getattr(mixer, "schedule", None) is not None:
        return None
    from repro_torch.api.mixers import DelayedMixer
    from repro_torch.api.shard_node import mix_order, sparse_graph_and_delay
    from repro_torch.kernels.round_fused import MixCSR, sparse_mix
    try:
        graph, delay = sparse_graph_and_delay(mixer)
    except ValueError:
        return None
    A = torch.as_tensor(graph.to_dense(), dtype=torch.float32, device=device)
    diag = torch.as_tensor(graph.diag(), dtype=torch.float32, device=device)
    csr = sparse_mix(graph, device)
    if csr is not None and mix_order(mixer) == "ring":
        # the kernel adds each row as the reference backend's ring does
        inner = mixer.inner if isinstance(mixer, DelayedMixer) else mixer
        csr = MixCSR.ring_roll(inner.m, inner.self_weight, device)
    return A, diag, delay, csr


def _stack_seeds(outs: list) -> torch.Tensor:
    """Per-seed tensors on a leading seed axis (one seed: a view)."""
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


def _per_seed(fn: Callable, t) -> torch.Tensor:
    """``fn`` on each seed's slice of ``t``, stacked on a leading seed axis.
    A reduction on an (S, ...) tensor may take another order than on one
    seed's slice (torch picks its split from the output count), so the
    batch reduces seed by seed, exactly as a one-seed run does."""
    return _stack_seeds([fn(row) for row in t])


def _seed_rows(t: torch.Tensor) -> torch.Tensor:
    """An (S, m, ...) tensor as (S*m, ...) rows (no copy)."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


@dataclasses.dataclass(frozen=True)
class CudaBackend:
    """Fused-kernel execution of the round body (see module docstring).

    mode:            "auto" | "fused" | "hybrid" (auto fuses when possible).
    max_fused_nodes: dense-A cap for the fused mode; above it auto falls
                     back to hybrid and "fused" raises.
    """

    mode: str = "auto"
    max_fused_nodes: int = MAX_FUSED_NODES
    name: str = "cuda"

    def __post_init__(self):
        if self.mode not in ("auto", "fused", "hybrid"):
            raise ValueError(f"unknown cuda mode {self.mode!r}; expected "
                             "'auto', 'fused' or 'hybrid'")

    def make_chunk_program(self, spec, engine: str, device: torch.device):
        """One run: the batch chunk program on a batch of that one seed
        (views of its state: nothing is copied)."""
        init_fn = reference_round_program(spec, engine, device)[1]
        batch_fn = chunk_loop(*self._round_program(spec, engine, device))

        def chunk_fn(state, xs, ys):
            bstate, out = batch_fn(stack_states([state]), xs[:, None],
                                   ys[:, None])
            return seed_state(engine, bstate, 0), type(out)(
                *(f[:, 0] for f in out))

        chunk_fn.graphs = batch_fn.graphs
        return chunk_fn, init_fn

    def make_batch_chunk_program(self, spec, engine: str,
                                 device: torch.device):
        """A seed batch: the round of `_make_round_fn`, replayed from a
        CUDA graph where `_round_program` builds one (``chunk_fn.graphs``)."""
        init_fn = reference_round_program(spec, engine, device)[1]
        return (chunk_loop(*self._round_program(spec, engine, device)),
                batch_init(init_fn))

    def _make_round_fn(self, spec, engine: str,
                       device: torch.device) -> Callable:
        """The round of S seeds in step (`BatchState`; S = 1 for `run`):
        one ``round_stats`` and one ``round_update`` (or ``dual_step``)
        launch for all seeds, the per-node algebra on (S, m) tensors, and
        each seed's noise from its own generator, in seed order."""
        return self._round_program(spec, engine, device)[0]

    def _round_program(self, spec, engine: str, device: torch.device):
        """(round_fn, `round_graph.RoundGraph` or None): the eager round of
        `_make_round_fn`, and the same round body to capture where the
        round has one shape every round — the fused form (a fixed
        topology, a CSR or dense A), delay 0, no fault schedule and the
        port's own noise mechanism — on the card. The node-sharded round
        (`make_local_round_fn`) and every other path run eagerly."""
        from repro_torch.api import round_graph
        from repro_torch.api.clippers import (PerNodeL2Clipper, clip_factor,
                                              per_node_norms)
        from repro_torch.core.algorithm1 import RoundOutput
        from repro_torch.core.prox import zero_fraction
        from repro_torch.kernels import round_fused as rf

        _check_supported(spec)
        m, n = spec.nodes, spec.dim
        if n is None:
            raise ValueError("RunSpec.dim is required by backend='cuda'")
        mech = spec.resolve_mechanism()
        rule = spec.resolve_local_rule()
        clip = spec.resolve_clipper()
        omd = spec.omd_config()
        mixer = spec.resolve_mixer()
        prox_l1 = rule.prox_kind == "l1"
        clip_norm = clip.max_norm if isinstance(clip, PerNodeL2Clipper) \
            else None

        dense = None
        if self.mode != "hybrid":
            dense = _dense_mix_form(mixer, device)
            if dense is not None and m > self.max_fused_nodes:
                dense = None
            if dense is None and self.mode == "fused":
                raise ValueError(
                    f"backend='cuda' mode='fused' needs a fixed topology "
                    f"with nodes <= {self.max_fused_nodes} (got mixer="
                    f"{type(mixer).__name__}, m={m}); use mode='hybrid' or "
                    f"'auto'")
        if dense is not None:
            A, diag_v, delay, csr = dense
        else:
            delay = int(getattr(mixer, "delay", 0))
        schedule = getattr(mixer, "schedule", None)
        if schedule is None or not schedule.has_crashes:
            schedule = None
        alive = torch.ones(m, dtype=torch.float32, device=device)

        def stats_and_coeff(theta, x, y, lam_t, counter):
            dot, _, nnz, wbdot, _ = rf.round_stats(
                theta, x, lam_t, m, prox_l1=prox_l1, counter=counter)
            margin = y * dot
            loss = torch.clamp_min(1.0 - margin, 0.0)
            correct = (torch.sign(dot) == y).to(torch.float32)
            active = (margin < 1.0).to(torch.float32)
            coeff = -(active * y)
            if clip_norm is not None:
                # the hinge gradient -active*y*x is rank-1 per node, so its
                # norm is active * ||x||: the clip is a per-node factor.
                # ||x|| is summed as the reference backend's clipper sums
                # ||grad|| (the kernel's xsq adds in another order, and an
                # ulp in the factor moves theta)
                coeff = coeff * clip_factor(
                    active * _per_seed(per_node_norms, x), clip_norm)
            wb_loss = _per_seed(torch.mean,
                                torch.clamp_min(1.0 - y * wbdot, 0.0))
            # zero COUNT first (exact), then one f32 division — bit-equal
            # to the reference's mean of indicators
            sparsity = zero_fraction(m * n - nnz.sum(dim=1), m * n)
            return coeff, loss, correct, wb_loss, sparsity

        sim = engine == "sim"
        write_ring = lambda hist, t, v: ring_write(  # noqa: E731
            hist.transpose(0, 1), t, v)    # slot t % depth of every seed

        def round_fn(state, batch):
            with span("round"):
                return body(state, batch)

        def core(theta, hist, t, x, y, lam_t, alpha_t, noise,
                 counter=None):
            """Round t of S seeds: (theta_next, RoundOutput). lam_t and
            alpha_t are numbers, or device scalars in a captured round;
            ``noise()`` is the round's (S, m, n) noise."""
            S = theta.shape[0]
            with span("round.stats"):
                coeff, loss, correct, wb_loss, sparsity = stats_and_coeff(
                    theta, x, y, lam_t, counter)
            live = (alive if schedule is None
                    else schedule.alive_f32(t, device)).expand(S, m)
            with span("round.noise"):
                delta = noise()
            with span("round.mix"):
                theta_next = mix(t, theta, hist, delta, x, coeff, live,
                                 alpha_t, S)
            return theta_next, RoundOutput(loss=loss, w_bar_loss=wb_loss,
                                           sparsity=sparsity, correct=correct)

        def body(state, batch):
            x, y = batch                   # (S, m, n), (S, m)
            theta, hist = state.theta, state.history
            if not sim:
                theta = theta["w"]
                hist = None if hist is None else hist["w"]
            ctx = omd.step_context(state.t + 1)

            def noise():
                # each seed's noise draw from its own generator, outside
                # the kernels, in seed order
                scale = mech.scale(ctx.alpha_t, n)
                return _per_seed(lambda g: mech.sample(g, (m, n), scale),
                                 state.generators)

            theta_next, out = core(theta, hist, state.t, x, y, ctx.lam_t,
                                   ctx.alpha_t, noise)
            if not sim:
                theta_next = {"w": theta_next}
                hist = None if hist is None else {"w": hist}
            return BatchState(theta=theta_next, t=state.t + 1,
                              generators=state.generators,
                              history=hist), out

        def mix(t, theta, hist, delta, x, coeff, live, alpha_t, S):
            """round_update, or the torch-op mix and one dual_step, with
            the delay ring written on the way."""
            if dense is not None:
                if delay:
                    tilde = theta + delta
                    write_ring(hist, t, tilde)
                    recv, use_recv = ring_read(hist.transpose(0, 1), t,
                                               delay, tilde), 1
                else:
                    recv, use_recv = theta, 0
                return rf.round_update(
                    A, theta, delta, x, recv.contiguous(), coeff, diag_v,
                    live.contiguous(), alpha_t, use_recv,
                    mech.noise_self, csr=csr)[0]
            tilde = theta + delta
            # the torch-op mix seed by seed
            if delay:
                write_ring(hist, t, tilde)
                mixed = _stack_seeds([
                    mixer.mix_history(theta[i], tilde[i], hist[i],
                                      mech.noise_self, t)
                    for i in range(S)])
            else:
                mixed = _stack_seeds([
                    mixer.mix(theta[i], tilde[i], mech.noise_self, t)
                    for i in range(S)])
            # the dual step is row-wise: one launch over the S*m rows
            return rf.dual_step(
                _seed_rows(mixed.contiguous()), _seed_rows(x),
                _seed_rows(theta), coeff.reshape(-1),
                live.reshape(-1), alpha_t).view(S, m, n)

        graph = None
        if (dense is not None and delay == 0 and schedule is None
                and round_graph.graphable_mechanism(mech)
                and round_graph._card(device)):
            graph = round_graph.RoundGraph(
                lambda theta, x, y, lam_t, alpha_t, noise, counter: core(
                    theta, None, 0, x, y, lam_t, alpha_t, noise, counter),
                lambda gens, scale: _per_seed(
                    lambda g: scale * mech.unit(g, (m, n)), gens),
                engine=engine, omd=omd, mech=mech, m=m, n=n, device=device)
        return round_fn, graph

    # -- node-sharded round (hybrid: the halo exchange stays in torch ops) --

    def make_local_round_fn(self, spec, engine: str, part, delay: int,
                            schedule=None, graph=None, *,
                            devices) -> Callable:
        """The round over every shard of a mesh row (see
        `shard_node.reference_local_round_fn` for its state and outputs),
        S seeds in step: per shard one ``round_stats`` launch on its (S,
        block, n) rows (w_bar over the global m) and one ``dual_step``
        after the sharded mix, the per-node algebra as torch ops with each
        seed's reductions in a one-seed run's order, the clip's norms from
        the round's unsplit features on the row's first device (as the
        unsharded round sums them); the noise is drawn once a round per
        seed, as (m, n), zero-padded and sliced."""
        from repro_torch.api.clippers import (PerNodeL2Clipper, clip_factor,
                                              per_node_norms)
        from repro_torch.api.shard_node import (Blocks, _alive_blocks,
                                                _masks, _mix_seed,
                                                _noise_blocks, _pack,
                                                _pad_rows, _psum,
                                                _sharded_mixer, _unpack)
        from repro_torch.core.algorithm1 import RoundOutput
        from repro_torch.core.prox import zero_fraction
        from repro_torch.kernels import round_fused as rf

        _check_supported(spec)
        m, n = part.m, spec.dim
        if n is None:
            raise ValueError("RunSpec.dim is required by backend='cuda'")
        devices = tuple(torch.device(d) for d in devices)
        dev0 = devices[0]
        mech = spec.resolve_mechanism()
        rule = spec.resolve_local_rule()
        clip = spec.resolve_clipper()
        omd = spec.omd_config()
        prox_l1 = rule.prox_kind == "l1"
        clip_norm = clip.max_norm if isinstance(clip, PerNodeL2Clipper) \
            else None
        smixer = _sharded_mixer(part, delay, schedule, graph, devices)
        masks = _masks(part, devices)
        imasks = [mk.to(torch.int32) for mk in masks]
        ones = [torch.ones(part.block, dtype=torch.float32, device=dev)
                for dev in devices]

        def shard_stats(theta, x, y, norms, ctx):
            dot, _, nnz, _, wsum = rf.round_stats(theta, x, ctx.lam_t, m,
                                                  prox_l1=prox_l1)
            margin = y * dot
            loss = torch.clamp_min(1.0 - margin, 0.0)
            correct = (torch.sign(dot) == y).to(torch.float32)
            active = (margin < 1.0).to(torch.float32)
            coeff = -(active * y)
            if clip_norm is not None:
                coeff = coeff * clip_factor(active * norms, clip_norm)
            return coeff, loss, correct, wsum, nnz

        def round_fn(state, batch):
            # Blocks of (S, block, n) and (S, block); the unsplit (S, m, n)
            xb, yb, x_global = batch
            theta, hist = _unpack(engine, state)
            t, S = state.t, len(state.generators)
            ctx = omd.step_context(t + 1)
            # ||x|| of every node from the unsplit features, as the
            # unsharded round sums it: a card's row sum takes another
            # order at another row count, and an ulp moves theta
            norms = _pad_rows(_per_seed(per_node_norms, x_global),
                              part.m_pad - m, 1)
            stats = [shard_stats(th, x, y, norms[:, d * part.block:
                                                 (d + 1) * part.block]
                                 .to(x.device), ctx)
                     for d, (th, x, y) in enumerate(zip(
                         theta.parts, xb.parts, yb.parts))]
            coeff, loss, correct, wsum, nnz = zip(*stats)
            # the metrics: per-shard partials, added in shard order
            w_bar = _psum(wsum, dev0) / m                      # (S, n)
            wb_loss = _psum([_per_seed(torch.sum, torch.clamp_min(
                1.0 - y * _per_seed(lambda a: torch.sum(a, dim=-1),
                                    w_bar.to(x.device)[:, None, :] * x),
                0.0) * mk) for x, y, mk in zip(xb.parts, yb.parts, masks)],
                dev0) / m
            zeros = _psum([((n - nz) * mk).sum(dim=1)
                           for nz, mk in zip(nnz, imasks)], dev0)
            sparsity = zero_fraction(zeros, m * n)

            deltas = _noise_blocks(mech, state.generators, m, n,
                                   mech.scale(ctx.alpha_t, n), part, devices)
            tilde = theta + Blocks(deltas)
            mixed = Blocks.stack([
                _mix_seed(smixer, theta[i], tilde[i],
                          None if hist is None else hist[i],
                          mech.noise_self, t) for i in range(S)])
            alive = _alive_blocks(schedule, t, part, devices) or ones
            nxt = Blocks(
                rf.dual_step(_seed_rows(md.contiguous()), _seed_rows(x),
                             _seed_rows(th), c.reshape(-1),
                             a.expand(S, -1).reshape(-1),
                             ctx.alpha_t).view(th.shape)
                for md, x, th, c, a in zip(mixed.parts, xb.parts,
                                           theta.parts, coeff, alive))
            out = RoundOutput(loss=Blocks(loss), w_bar_loss=wb_loss,
                              sparsity=sparsity, correct=Blocks(correct))
            return _pack(engine, state, nxt, hist), out

        return round_fn


@BACKENDS.register("reference")
def _reference() -> ReferenceBackend:
    """Torch-op engine (the correctness oracle)."""
    return ReferenceBackend()


@BACKENDS.register("cuda")
def _cuda(mode: str = "auto",
          max_fused_nodes: int = MAX_FUSED_NODES) -> CudaBackend:
    """Fused round body on the hand-written Hopper kernels."""
    return CudaBackend(mode=mode, max_fused_nodes=max_fused_nodes)
