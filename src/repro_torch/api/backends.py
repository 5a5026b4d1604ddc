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
cuda backend also builds the same round body to replay from a CUDA graph
captured once a run (`round_graph.RoundGraph`): one launch a round, bit
for bit the eager loop. Every other path keeps the eager loop.

Under a fault scenario with crash windows, the crash freeze runs in the
kernel (``dual_step``; ``round_update`` has the same epilogue) with the
round's liveness row from the schedule's device table — no host copy per
round.

A backend builds rounds and nothing else, and `program` makes the chunk
programs from them. ``make_round_program`` gives the round of S seeds in
step over a `program.BatchState` (and the `RoundGraph` above, or None):
the reference round seed by seed (the oracle), or the cuda round written
for S seeds — one batched ``round_stats``, the per-node algebra on (S, m)
tensors reduced seed by seed in a one-seed run's order, each seed's noise
from its own generator, one batched ``round_update`` (fused) or the
torch-op mix seed by seed and one ``dual_step`` over the S*m rows
(hybrid). A one-seed `run` is a batch of one, so a batch's seeds equal
their runs bit for bit. ``make_local_round_fn`` is the node-sharded round
of `shard_node` (`reference_local_round_fn`, `cuda_local_round_fn`).

>>> from repro_torch.api import BACKENDS
>>> BACKENDS.names()
('cuda', 'reference')
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.api import shard_node
from repro_torch.api.mixers import ring_read, ring_write
from repro_torch.api.program import (fused_stages, hinge_coeff, pack,
                                     per_seed, per_seed_round,
                                     reference_round_program, seed_rows,
                                     stack_seeds, unpack)
from repro_torch.api.registry import BACKENDS
from repro_torch.kernels.round_fused import MAX_FUSED_NODES
from repro_torch.obs import span

__all__ = ["BACKENDS", "ReferenceBackend", "CudaBackend"]


@dataclasses.dataclass(frozen=True)
class ReferenceBackend:
    """Torch-op engine — the oracle the cuda backend is held to."""

    name: str = "reference"
    make_local_round_fn = staticmethod(shard_node.reference_local_round_fn)

    def make_round_program(self, spec, engine: str, device: torch.device):
        """(round_fn, None): the reference round stepped seed by seed."""
        round_fn = reference_round_program(spec, engine, device)[0]
        return per_seed_round(round_fn, engine), None


def _dense_mix_form(mixer, device: torch.device):
    """(A, diag, delay, csr) mixing form for the fused mode, or None when
    the mixer has no fixed sparse lowering. ``csr`` is A's CSR form when
    the graph has few non-zeros per row (the sparse path), else None.
    A faulty mixer (`repro_torch.faults`) may subclass a fixed-form mixer,
    but its weights change every round: it has no fixed form."""
    if getattr(mixer, "schedule", None) is not None:
        return None
    from repro_torch.api.mixers import DelayedMixer
    from repro_torch.kernels.round_fused import MixCSR, sparse_mix
    try:
        graph, delay = shard_node.sparse_graph_and_delay(mixer)
    except ValueError:
        return None
    A = torch.as_tensor(graph.to_dense(), dtype=torch.float32, device=device)
    diag = torch.as_tensor(graph.diag(), dtype=torch.float32, device=device)
    csr = sparse_mix(graph, device)
    if csr is not None and shard_node.mix_order(mixer) == "ring":
        # the kernel adds each row as the reference backend's ring does
        inner = mixer.inner if isinstance(mixer, DelayedMixer) else mixer
        csr = MixCSR.ring_roll(inner.m, inner.self_weight, device)
    return A, diag, delay, csr


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
    make_local_round_fn = staticmethod(shard_node.cuda_local_round_fn)

    def __post_init__(self):
        if self.mode not in ("auto", "fused", "hybrid"):
            raise ValueError(f"unknown cuda mode {self.mode!r}; expected "
                             "'auto', 'fused' or 'hybrid'")

    def make_round_program(self, spec, engine: str, device: torch.device):
        """(round_fn, `round_graph.RoundGraph` or None): the round of S
        seeds (see the module docstring), and the same round body to
        capture where the round has one shape every round: the fused form
        (a fixed topology, a CSR or dense A), delay 0, no fault schedule
        and the port's own noise mechanism, on the card."""
        from repro_torch.api import round_graph
        from repro_torch.api.clippers import per_node_norms
        from repro_torch.core.algorithm1 import RoundOutput
        from repro_torch.core.prox import zero_fraction
        from repro_torch.kernels import round_fused as rf

        mech, omd, prox_l1, clip_norm = fused_stages(spec)
        m, n = spec.nodes, spec.dim
        mixer = spec.resolve_mixer()

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

        def stats(theta, x, y, lam_t, counter):
            dot, _, nnz, wbdot, _ = rf.round_stats(
                theta, x, lam_t, m, prox_l1=prox_l1, counter=counter)
            coeff, loss, correct = hinge_coeff(
                dot, y, clip_norm, lambda: per_seed(per_node_norms, x))
            wb_loss = per_seed(torch.mean,
                               torch.clamp_min(1.0 - y * wbdot, 0.0))
            # zero COUNT first (exact), then one f32 division — bit-equal
            # to the reference's mean of indicators
            sparsity = zero_fraction(m * n - nnz.sum(dim=1), m * n)
            return coeff, loss, correct, wb_loss, sparsity

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
                coeff, loss, correct, wb_loss, sparsity = stats(
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
            theta, hist = unpack(engine, state)
            ctx = omd.step_context(state.t + 1)

            def noise():
                # each seed's noise draw from its own generator, outside
                # the kernels, in seed order
                scale = mech.scale(ctx.alpha_t, n)
                return per_seed(lambda g: mech.sample(g, (m, n), scale),
                                state.generators)

            theta_next, out = core(theta, hist, state.t, x, y, ctx.lam_t,
                                   ctx.alpha_t, noise)
            return pack(engine, state, theta_next, hist), out

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
                mixed = stack_seeds([
                    mixer.mix_history(theta[i], tilde[i], hist[i],
                                      mech.noise_self, t)
                    for i in range(S)])
            else:
                mixed = stack_seeds([
                    mixer.mix(theta[i], tilde[i], mech.noise_self, t)
                    for i in range(S)])
            # the dual step is row-wise: one launch over the S*m rows
            return rf.dual_step(
                seed_rows(mixed.contiguous()), seed_rows(x),
                seed_rows(theta), coeff.reshape(-1),
                live.reshape(-1), alpha_t).view(S, m, n)

        graph = None
        if (dense is not None and delay == 0 and schedule is None
                and round_graph.capturable(mech, device)):
            graph = round_graph.RoundGraph(
                lambda theta, x, y, lam_t, alpha_t, noise, counter: core(
                    theta, None, 0, x, y, lam_t, alpha_t, noise, counter),
                lambda gens, scale: per_seed(
                    lambda g: scale * mech.unit(g, (m, n)), gens),
                engine=engine, omd=omd, mech=mech, m=m, n=n, device=device)
        return round_fn, graph


@BACKENDS.register("reference")
def _reference() -> ReferenceBackend:
    """Torch-op engine (the correctness oracle)."""
    return ReferenceBackend()


@BACKENDS.register("cuda")
def _cuda(mode: str = "auto",
          max_fused_nodes: int = MAX_FUSED_NODES) -> CudaBackend:
    """Fused round body on the hand-written Hopper kernels."""
    return CudaBackend(mode=mode, max_fused_nodes=max_fused_nodes)
