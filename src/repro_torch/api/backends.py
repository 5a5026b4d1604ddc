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
                few per row, as the ring does; else the dense A).

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
           else hybrid.

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
from repro_torch.api.runner import chunk_loop, reference_chunk_program

__all__ = ["BACKENDS", "ReferenceBackend", "CudaBackend"]


@dataclasses.dataclass(frozen=True)
class ReferenceBackend:
    """Torch-op engine — the oracle the cuda backend is held to."""

    name: str = "reference"

    def make_chunk_program(self, spec, engine: str, device: torch.device):
        return reference_chunk_program(spec, engine, device)


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
    the graph has few non-zeros per row (the sparse path), else None."""
    from repro_torch.api.shard_node import sparse_graph_and_delay
    from repro_torch.kernels.round_fused import sparse_mix
    try:
        graph, delay = sparse_graph_and_delay(mixer)
    except ValueError:
        return None
    A = torch.as_tensor(graph.to_dense(), dtype=torch.float32, device=device)
    diag = torch.as_tensor(graph.diag(), dtype=torch.float32, device=device)
    return A, diag, delay, sparse_mix(graph, device)


@dataclasses.dataclass(frozen=True)
class CudaBackend:
    """Fused-kernel execution of the round body (see module docstring).

    mode:            "auto" | "fused" | "hybrid" (auto fuses when possible).
    max_fused_nodes: dense-A cap for the fused mode; above it auto falls
                     back to hybrid and "fused" raises.
    """

    mode: str = "auto"
    max_fused_nodes: int = 1024
    name: str = "cuda"

    def __post_init__(self):
        if self.mode not in ("auto", "fused", "hybrid"):
            raise ValueError(f"unknown cuda mode {self.mode!r}; expected "
                             "'auto', 'fused' or 'hybrid'")

    def make_chunk_program(self, spec, engine: str, device: torch.device):
        init_fn = reference_chunk_program(spec, engine, device)[1]
        return chunk_loop(self._make_round_fn(spec, engine, device)), init_fn

    def _make_round_fn(self, spec, engine: str,
                       device: torch.device) -> Callable:
        from repro_torch.api.clippers import PerNodeL2Clipper, clip_factor
        from repro_torch.core.algorithm1 import RoundOutput, SimState
        from repro_torch.core.gossip import GossipState
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
        alive = torch.ones(m, dtype=torch.float32, device=device)

        def stats_and_coeff(theta, x, y, ctx):
            dot, xsq, nnz, wbdot, _ = rf.round_stats(
                theta, x, ctx.lam_t, m, prox_l1=prox_l1)
            margin = y * dot
            loss = torch.clamp_min(1.0 - margin, 0.0)
            correct = (torch.sign(dot) == y).to(torch.float32)
            active = (margin < 1.0).to(torch.float32)
            coeff = -(active * y)
            if clip_norm is not None:
                # the hinge gradient -active*y*x is rank-1 per node, so its
                # norm is active * ||x||: the clip is a per-node factor
                coeff = coeff * clip_factor(active * torch.sqrt(xsq),
                                            clip_norm)
            wb_loss = torch.mean(torch.clamp_min(1.0 - y * wbdot, 0.0))
            # zero COUNT first (exact), then one f32 division — bit-equal
            # to the reference's mean of indicators
            sparsity = zero_fraction(m * n - nnz.sum(), m * n)
            return coeff, loss, correct, wb_loss, sparsity

        sim = engine == "sim"

        def round_fn(state, batch):
            x, y = batch
            theta, hist = state.theta, state.history
            if not sim:
                theta = theta["w"]
                hist = None if hist is None else hist["w"]
            ctx = omd.step_context(state.t + 1)
            coeff, loss, correct, wb_loss, sparsity = stats_and_coeff(
                theta, x, y, ctx)

            # the engine's noise draw, outside the kernels
            scale = mech.scale(ctx.alpha_t, n)
            delta = mech.sample(state.generator, (m, n), scale)

            if dense is not None:
                if delay:
                    tilde = theta + delta
                    hist = ring_write(hist, state.t, tilde)
                    recv, use_recv = ring_read(hist, state.t, delay,
                                               tilde), 1
                else:
                    recv, use_recv = theta, 0
                theta_next, _ = rf.round_update(
                    A, theta, delta, x, recv.contiguous(), coeff, diag_v,
                    alive, ctx.alpha_t, use_recv, mech.noise_self, csr=csr)
            else:
                tilde = theta + delta
                if delay:
                    hist = ring_write(hist, state.t, tilde)
                    mixed = mixer.mix_history(theta, tilde, hist,
                                              mech.noise_self, state.t)
                else:
                    mixed = mixer.mix(theta, tilde, mech.noise_self, state.t)
                theta_next = rf.dual_step(mixed.contiguous(), x, theta,
                                          coeff, alive, ctx.alpha_t)

            out = RoundOutput(loss=loss, w_bar_loss=wb_loss,
                              sparsity=sparsity, correct=correct)
            if sim:
                return SimState(theta=theta_next, t=state.t + 1,
                                generator=state.generator, history=hist), out
            return GossipState(
                theta={"w": theta_next}, t=state.t + 1,
                generator=state.generator,
                history=None if hist is None else {"w": hist}), out

        return round_fn


@BACKENDS.register("reference")
def _reference() -> ReferenceBackend:
    """Torch-op engine (the correctness oracle)."""
    return ReferenceBackend()


@BACKENDS.register("cuda")
def _cuda(mode: str = "auto", max_fused_nodes: int = 1024) -> CudaBackend:
    """Fused round body on the hand-written Hopper kernels."""
    return CudaBackend(mode=mode, max_fused_nodes=max_fused_nodes)
