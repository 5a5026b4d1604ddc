"""Faulty mixers — lift a registered mixer onto an unreliable fabric.

Counterpart of `repro.faults.mixers`. `wrap_mixer(mixer, schedule)`
returns a mixer that applies the schedule's per-round link drops,
partitions, crash masks and straggler lags while keeping the mixing matrix
ROW-stochastic every round. Renormalization is *self-healing*: each
off-diagonal edge keeps ``w * keep(t)`` and the dropped mass
``w * (1 - keep(t))`` folds onto the destination row's self-loop — a node
that hears from fewer neighbours leans on its own state, no division
anywhere.

Zero rates are bit-identical to the clean mixer: the keep mask is then
exactly 1.0, so every effective weight is ``w * 1.0`` and every healed term
``+ 0.0``, and the faulty sparse mixer adds its rows in the clean
`SparseMixer`'s order (slot by slot, ascending source, ``torch.addcmul``).

Symmetry: link drops are drawn per undirected LINK (`link_table`), so a
symmetric input graph keeps ``A_eff[i, j] == A_eff[j, i]`` off the
diagonal every round. Column stochasticity is given up under faults.

A faulty mixer's per-round keeps and liveness come from the schedule's
device tables (`FaultSchedule.keep`, `alive_f32`), so a round on a card
copies nothing from the host. `FaultyShardedSparseMixer` is the node-sharded
path's (`repro_torch.api.shard_node`): every shard uses the round's one
link draw and heals, weighs and adds its rows as `FaultySparseMixer` does
the same rows.

>>> import torch
>>> from repro_torch.api.mixers import MIXERS
>>> from repro_torch.faults import FaultSpec, wrap_mixer
>>> clean = MIXERS.build("sparse", m=4, topology="ring")
>>> fm = wrap_mixer(MIXERS.build("sparse", m=4, topology="ring"),
...                 FaultSpec().compile(m=4))
>>> x = torch.arange(8.0).reshape(4, 2)
>>> bool((fm.apply(x, 0) == clean.apply(x, 0)).all())   # zero-rate contract
True
>>> sched = FaultSpec(link_rate=0.9, seed=3).compile(m=4)
>>> A = wrap_mixer(MIXERS.build("sparse", m=4, topology="ring"),
...                sched).apply(torch.eye(4), 5)
>>> bool(torch.allclose(A.sum(dim=1), torch.ones(4)))   # row-stochastic
True
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.mixers import (AlternatingRingMixer, CompleteMixer,
                                    DelayedMixer, DenseMatrixMixer,
                                    DisconnectedMixer,
                                    HeterogeneousDelayMixer, MixerBase,
                                    RingRollMixer, SparseMixer, _bcast, _on,
                                    ring_read)
from repro_torch.api.shard_node import (Blocks, NodePartition,
                                        ShardedSparseMixer)
from repro_torch.core.graph import complete_matrix, ring_edges
from repro_torch.faults.schedule import (FaultSchedule, edge_link_idx,
                                         link_table)

__all__ = ["FaultySparseMixer", "FaultyDenseMixer",
           "FaultyShardedSparseMixer", "wrap_mixer"]


def _windows_on(t: int, partitions) -> list[int]:
    """Indices of the partition windows open at round ``t``."""
    return [k for k, (start, end, _) in enumerate(partitions)
            if start <= t < end]


class _FaultyMixer(MixerBase):
    """What both faulty mixers share: the schedule, the straggler delay
    classes, and the noise-placement algebra of `MixerBase` with a healed
    diagonal computed on the mixing tensors' device.

    A subclass provides ``_weights(t, device) -> (weights, healed)``, the
    round's effective weights in its own form and the (m,) healed diagonal
    mass, ``_base_diag(t, device)``, ``_product(weights, x)``, the mix
    of ``x`` with such weights, and ``_delivered(t, device)``, the round's
    surviving and total off-diagonal weight.
    """

    def _setup(self, m: int, schedule: FaultSchedule, delay: int,
               name: str) -> None:
        if int(m) != int(schedule.m):
            raise ValueError(f"mixer has m={m} nodes but the fault "
                             f"schedule was compiled for m={schedule.m}")
        self.schedule = schedule
        self.m = int(m)
        self.base_delay = int(delay)
        self.delay = int(delay) + schedule.max_extra
        self.name = f"faulty[{name}]"

    def _set_classes(self, lags: list[int], masks: list[np.ndarray]) -> None:
        self._class_lags = tuple(lags)
        self._class_masks = tuple(torch.as_tensor(k.astype(np.float32))
                                  for k in masks)

    def apply(self, x, t):
        return self._product(self._weights(t, x.device)[0], x)

    def diag(self, t, device: str | torch.device = "cpu"):
        """(m,) effective self-weights of round ``t`` on ``device``."""
        return self._base_diag(t, device) + self._weights(t, device)[1]

    def mix(self, clean, tilde, noise_self, t):
        mixed = self.apply(tilde, t)
        if not noise_self:
            mixed = mixed - _bcast(self.diag(t, tilde.device),
                                   tilde) * (tilde - clean)
        return mixed

    def mix_delayed(self, clean, tilde, recv, noise_self, t):
        d = _bcast(self.diag(t, recv.device), recv)
        self_term = tilde if noise_self else clean
        return self.apply(recv, t) - d * recv + d * self_term

    def mix_history(self, clean, tilde, hist, noise_self, t):
        # without stragglers every neighbour shares one lag — MixerBase's
        # ring-read algebra applies verbatim (and bit-identically)
        if not self._class_lags:
            return super().mix_history(clean, tilde, hist, noise_self, t)
        if hist is None:
            raise ValueError(
                f"{type(self).__name__} declares delay={self.delay} but no "
                "history ring was provided (engine state missing .history)")
        dev = tilde.device
        weights, healed = self._weights(t, dev)
        self_term = tilde if noise_self else clean
        out = _bcast(self._base_diag(t, dev) + healed, tilde) * self_term
        for lag, cls in zip(self._class_lags,
                            _on(self, "_class_masks", dev)):
            recv = ring_read(hist, t, self.base_delay + lag, tilde)
            out = out + self._product(weights * cls, recv).to(tilde.dtype)
        return out

    def connectivity(self, rounds: int,
                     device: str | torch.device = "cpu") -> np.ndarray:
        """(rounds,) float32 fraction of off-diagonal weight delivered per
        round (1.0 = the clean graph; a partition window shows as a dip),
        computed on ``device`` round by round from the keeps the mix
        uses."""
        dev = torch.device(device)
        fracs = []
        for t in range(int(rounds)):
            surv, total = self._delivered(t, dev)
            # the reference's surv / total: XLA multiplies by the f32
            # reciprocal of the constant total
            fracs.append(torch.where(total > 0,
                                     surv * torch.reciprocal(total), 1.0))
        return (torch.stack(fracs).cpu().numpy() if fracs
                else np.zeros((0,), np.float32))


class FaultySparseMixer(_FaultyMixer):
    """SparseMixer under a FaultSchedule: per-round edge keeps + healing.

    Requires a stored self-loop on every node — that is where the dropped
    off-diagonal mass heals to (all standard topologies store one).
    """

    def __init__(self, inner: SparseMixer, schedule: FaultSchedule,
                 delay: int = 0):
        self._setup(inner.graph.m, schedule, delay, inner.name)
        self.inner = inner
        dst, src, w = inner._sorted
        loops = dst == src
        if np.unique(dst[loops]).size != self.m:
            raise ValueError(
                f"fault injection needs a self-loop on every node (dropped "
                f"edge mass heals onto the diagonal) but topology "
                f"{inner.name!r} stores only {np.unique(dst[loops]).size} "
                f"of {self.m}")
        uniq, self.num_links = link_table(dst, src, self.m)
        idx, _ = edge_link_idx(uniq, dst, src, self.m)
        self._link_idx = torch.as_tensor(idx.astype(np.int64))
        self._src = torch.as_tensor(src)
        self._is_loop = torch.as_tensor(loops)
        self._loop_f = torch.as_tensor(loops.astype(np.float32))
        self._w = torch.as_tensor(w)
        self._dst = torch.as_tensor(dst)
        self._cross = tuple(
            torch.as_tensor((((dst < cut) != (src < cut)) & ~loops)
                            .astype(np.float32))
            for _, _, cut in schedule.partitions)
        # straggler delay classes: edges grouped by their SOURCE node's lag
        extra = schedule.extra
        lags = (sorted({int(v) for v in extra[src[~loops]]})
                if schedule.max_extra else [])
        self._set_classes(lags, [(extra[src] == lag) & ~loops
                                 for lag in lags])

    def _edge_keep(self, t: int, dev: torch.device) -> torch.Tensor:
        """(E,) keep in [0, 1] per stored edge; self-loops are always 1."""
        sched = self.schedule
        keep = sched.keep(t, self.num_links, dev)[_on(self, "_link_idx",
                                                      dev)]
        if sched.has_crashes:
            # a crashed SOURCE sends nothing; the destination row heals
            keep = keep * sched.alive_f32(t, dev)[_on(self, "_src", dev)]
        cross = _on(self, "_cross", dev)
        for k in _windows_on(t, sched.partitions):
            keep = keep * (1.0 - cross[k])
        return torch.where(_on(self, "_is_loop", dev), 1.0, keep)

    def _weights(self, t, dev):
        """(effective edge weights, healed diagonal mass) for round t: the
        healed mass of row i sums its dropped weights in ascending source
        order, slot by slot."""
        dev = torch.device(dev)
        w = _on(self, "_w", dev)
        keep = self._edge_keep(t, dev)
        dropped = w * (1.0 - keep)
        healed = torch.zeros(self.m, dtype=torch.float32, device=dev)
        for rows, edges in zip(_on(self.inner, "_rows", dev),
                               _on(self.inner, "_slot_edges", dev)):
            if rows.numel() == self.m:
                healed = healed + dropped[edges]
            else:
                healed[rows] = healed[rows] + dropped[edges]
        w_eff = w * keep + _on(self, "_loop_f", dev) * healed[
            _on(self, "_dst", dev)]
        return w_eff, healed

    def _base_diag(self, t, dev):
        return _on(self.inner, "_diag", torch.device(dev))

    def _product(self, w_eff, x):
        edges = _on(self.inner, "_slot_edges", x.device)
        return self.inner.slot_sum(tuple(w_eff[e] for e in edges), x)

    def _delivered(self, t, dev):
        """(surviving, total) off-diagonal weight of round t."""
        off = _on(self, "_w", dev) * (1.0 - _on(self, "_loop_f", dev))
        return torch.sum(off * self._edge_keep(t, dev)), torch.sum(off)


class FaultyDenseMixer(_FaultyMixer):
    """DenseMatrixMixer under a FaultSchedule (time-varying stacks too).

    Same healing algebra as the sparse form, in dense coordinates:
    ``A_eff = A * K(t) + diag(rowsum(A * (1 - K(t))))`` with K == 1 on the
    diagonal, so rows stay stochastic and zero rates are bit-identical.
    """

    def __init__(self, inner: DenseMatrixMixer, schedule: FaultSchedule,
                 delay: int = 0):
        self._setup(inner.m, schedule, delay, inner.name)
        self.inner = inner
        m = self.m
        support = (inner.stack.numpy() > 0).any(axis=0)
        np.fill_diagonal(support, False)
        dst, src = np.nonzero(support)
        uniq, self.num_links = link_table(dst, src, m)
        idx, _ = edge_link_idx(uniq, dst, src, m)
        L = np.zeros((m, m), np.int64)
        L[dst, src] = idx
        self._link_idx = torch.as_tensor(L)
        self._has_link = torch.as_tensor(support)
        self._eye = torch.eye(m, dtype=torch.float32)
        offdiag = ~np.eye(m, dtype=bool)
        self._offdiag = torch.as_tensor(offdiag)
        self._off_f = torch.as_tensor(offdiag.astype(np.float32))
        node = np.arange(m)
        self._cross = tuple(
            torch.as_tensor((((node[:, None] < cut) != (node[None, :] < cut))
                             & offdiag).astype(np.float32))
            for _, _, cut in schedule.partitions)
        extra = schedule.extra
        lags = sorted({int(v) for v in extra}) if schedule.max_extra else []
        self._set_classes(lags, [(extra[None, :] == lag) & offdiag
                                 for lag in lags])

    def _keep_mat(self, t: int, dev: torch.device) -> torch.Tensor:
        """(m, m) keep matrix; diagonal and non-edges are exactly 1."""
        sched = self.schedule
        keep = torch.where(
            _on(self, "_has_link", dev),
            sched.keep(t, self.num_links, dev)[_on(self, "_link_idx", dev)],
            1.0)
        if sched.has_crashes:
            alive = sched.alive_f32(t, dev)
            keep = keep * torch.where(_on(self, "_offdiag", dev),
                                      alive[None, :], 1.0)
        cross = _on(self, "_cross", dev)
        for k in _windows_on(t, sched.partitions):
            keep = keep * (1.0 - cross[k])
        return keep

    def _weights(self, t, dev):
        dev = torch.device(dev)
        A = self.inner.matrix(t, dev)
        keep = self._keep_mat(t, dev)
        healed = torch.sum(A * (1.0 - keep), dim=1)
        return A * keep + healed[:, None] * _on(self, "_eye", dev), healed

    def _base_diag(self, t, dev):
        return self.inner.diag(t).to(dev)

    def _product(self, A_eff, x):
        return torch.tensordot(A_eff, x.to(A_eff.dtype),
                               dims=1).to(x.dtype)

    def _delivered(self, t, dev):
        off = self.inner.matrix(t, dev) * _on(self, "_off_f", dev)
        return torch.sum(off * self._keep_mat(t, dev)), torch.sum(off)


class FaultyShardedSparseMixer(ShardedSparseMixer):
    """ShardedSparseMixer under a FaultSchedule — the ("node",) mesh path.

    The round's link keeps are drawn once (`FaultSchedule.keep` on the
    row's first device) and every shard reads them: the link table is
    built from the global graph, so a shard's edge maps to the link id its
    unsharded copy uses. Each shard then computes its rows' healed
    diagonal mass and effective weights and adds its rows exactly as
    `FaultySparseMixer` adds the same rows (ascending source, slot by
    slot), after the base class's halo copies. Self-loops keep 1, and the
    healed mass folds onto real self-loops only; the partition's
    zero-weight filler entries are not edges here at all. Stragglers need
    the per-class delay rings and are refused.
    """

    def __init__(self, part: NodePartition, graph,
                 schedule: FaultSchedule, delay: int = 0, devices=None):
        super().__init__(part, delay=delay, devices=devices)
        if schedule.max_extra:
            raise ValueError(
                "stragglers are not supported on the node-sharded path — "
                "drop straggler_* from the FaultSpec or run unsharded")
        self.schedule = schedule
        m, block = int(graph.m), part.block
        uniq, self.num_links = link_table(graph.dst, graph.src, m)
        per_shard = []
        for d, (e, dev) in enumerate(zip(self._edges, self.devices)):
            dst_g = d * block + e.dst
            idx, valid = edge_link_idx(uniq, dst_g, e.src_g, m)
            loops = dst_g == e.src_g
            on = lambda a: torch.as_tensor(a).to(dev)  # noqa: E731
            per_shard.append(dict(
                link_idx=on(idx.astype(np.int64)), forced=on(loops | ~valid),
                loop_f=on(loops.astype(np.float32)), src=on(e.src_g),
                dst=on(e.dst), w=on(e.weight),
                cross=tuple(on((((dst_g < cut) != (e.src_g < cut)) & ~loops)
                               .astype(np.float32))
                            for _, _, cut in schedule.partitions)))
        self._fault = tuple(per_shard)

    def _keeps(self, t: int) -> list:
        """Each shard's (E_d,) keep per stored edge; self-loops are 1."""
        sched, dev0 = self.schedule, self.devices[0]
        links = sched.keep(t, self.num_links, dev0)
        alive = sched.alive_f32(t, dev0) if sched.has_crashes else None
        windows = _windows_on(t, sched.partitions)
        keeps = []
        for f, dev in zip(self._fault, self.devices):
            keep = links.to(dev)[f["link_idx"]]
            if alive is not None:
                # a crashed SOURCE sends nothing; the destination row heals
                keep = keep * alive.to(dev)[f["src"]]
            for k in windows:
                keep = keep * (1.0 - f["cross"][k])
            keeps.append(torch.where(f["forced"], 1.0, keep))
        return keeps

    def _weights(self, t: int) -> list:
        """Per shard (effective edge weights, (block,) healed mass): the
        healed mass of a row sums its dropped weights slot by slot."""
        out = []
        for d, (f, keep) in enumerate(zip(self._fault, self._keeps(t))):
            dropped = f["w"] * (1.0 - keep)
            healed = torch.zeros(self.part.block, dtype=torch.float32,
                                 device=keep.device)
            for rows, _, edges, _ in self._slots[d]:
                if rows.numel() == self.part.block:
                    healed = healed + dropped[edges]
                else:
                    healed[rows] = healed[rows] + dropped[edges]
            out.append((f["w"] * keep + f["loop_f"] * healed[f["dst"]],
                        healed))
        return out

    def apply(self, x: Blocks, t) -> Blocks:
        bufs = self._exchange(x)
        return Blocks(
            self._slot_sum(d, [w_eff[s[2]] for s in self._slots[d]], buf)
            for d, ((w_eff, _), buf) in enumerate(zip(self._weights(t),
                                                      bufs)))

    def diag(self, t) -> Blocks:
        return Blocks(base + healed for base, (_, healed) in
                      zip(self._diag_blocks.parts, self._weights(t)))


def wrap_mixer(mixer, schedule: FaultSchedule):
    """Lift a resolved mixer onto the faulty fabric described by
    ``schedule``.

    Sparse-form mixers (SparseMixer, RingRollMixer via its exact
    `ring_edges` form) become `FaultySparseMixer`; dense-form mixers
    (DenseMatrixMixer stacks, CompleteMixer, AlternatingRingMixer) become
    `FaultyDenseMixer`. A `DelayedMixer` wrapper contributes its uniform
    delay as the base staleness. The zero-rate bit-identity contract holds
    within each family (a lowered ring is compared against the same
    lowered ring, which is what `RunSpec.resolve_mixer` produces on both
    sides).
    """
    base_delay = int(getattr(mixer, "delay", 0))
    inner = mixer.inner if isinstance(mixer, DelayedMixer) else mixer
    if isinstance(inner, HeterogeneousDelayMixer):
        raise ValueError(
            "faults do not compose with per-edge heterogeneous delays — "
            "model slow links as FaultSpec stragglers instead")
    if isinstance(inner, DisconnectedMixer):
        raise ValueError(
            "the disconnected topology has no links to fault — nothing "
            "to inject")
    if isinstance(inner, RingRollMixer):
        inner = SparseMixer(graph=ring_edges(inner.m,
                                             self_weight=inner.self_weight),
                            name="ring")
    if isinstance(inner, SparseMixer):
        return FaultySparseMixer(inner=inner, schedule=schedule,
                                 delay=base_delay)
    if isinstance(inner, CompleteMixer):
        inner = DenseMatrixMixer(stack=complete_matrix(inner.m)[None],
                                 name="complete")
    if isinstance(inner, AlternatingRingMixer):
        eye = np.eye(inner.m, dtype=np.float32)
        inner = DenseMatrixMixer(
            stack=np.stack([0.5 * eye + 0.5 * np.roll(eye, 1, axis=0),
                            0.5 * eye + 0.5 * np.roll(eye, -1, axis=0)]),
            name="ring_alternating")
    if isinstance(inner, DenseMatrixMixer):
        return FaultyDenseMixer(inner=inner, schedule=schedule,
                                delay=base_delay)
    raise ValueError(
        f"cannot inject faults into {type(inner).__name__}: no sparse or "
        "dense fixed form (use mixer='sparse'/'dense' or ring/complete/"
        "ring_alternating)")
