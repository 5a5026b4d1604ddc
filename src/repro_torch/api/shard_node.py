"""Node-axis sharding — run the gossip round with theta split across devices.

Counterpart of `repro.api.shard_node`. The node axis — the paper's m data
centres — is split over the ("node",) axis of a `repro_torch.launch.mesh.Mesh`:

* the topology comes in as a `repro_torch.core.graph.SparseGraph` (edge
  list, O(edges) memory): `sparse_graph_and_delay` lowers a `SparseMixer`,
  the ring and fixed single-matrix dense stacks to one;
* `partition_graph` splits the m rows into D contiguous blocks of
  ``block = ceil(m / D)`` rows (rows m..m_pad-1 are padding: no edges, zero
  mask) and groups each destination block's edges by **shard offset**
  ``(src_shard - dst_shard) % D``;
* `ShardedSparseMixer` mixes a `Blocks` (one tensor per shard, each on its
  shard's device): for every used offset o != 0 it copies the block of
  shard (d + o) % D into a buffer on shard d's device (the halo exchange;
  offset 0 is local), then adds each row's weighted sources slot by slot
  with ``torch.addcmul`` in the order the unsharded mix adds them
  (`mix_order`: ascending global source for a `SparseMixer`, the ring's
  roll order — self, i-1, i+1 — for a `RingRollMixer`), no atomics, so
  the sharded run equals the unsharded one bit for bit in its state, a
  rerun too, and sim == dist;
* `make_node_chunk_fn` wraps the round loop of a chunk so that
  `repro_torch.run(exec=ExecConfig(node_devices=D))` and `run_batch`'s
  ("seed", "node") grid drive it like any other chunk program. State and
  data cross the wrapper GLOBAL and unpadded, so checkpoints restore under
  any device count.

One process drives every shard (the reference's single-controller model):
a round computes each shard's block on its device, and the metrics' sums
("psums") add the D per-shard partials in shard order 0..D-1 on the mesh's
first device. The per-round noise is the dense engines' draw: the full
(m, n) sample from the run's generator, zero-padded to m_pad rows, each
shard taking its block — so a sharded run differs from the unsharded one
only by the reduction order of w_bar's column sums and the metric sums
(``w_bar_loss``), and on the cuda backend of ``round_stats``' per-node dot
(the loss), which its kernel adds in an order set by the shard's row
count; theta, ``correct`` and the integer-valued ``sparsity`` stay bit for
bit unless a margin lies within an ulp of 0 or 1.

>>> from repro_torch.api import RunSpec
>>> from repro_torch.launch.mesh import make_mesh
>>> spec = RunSpec(nodes=6, dim=4, horizon=4, eps=1.0, alpha0=0.5,
...                lam=0.01, stream="drift", mixer="sparse",
...                mixer_options={"topology": "ring"})
>>> mesh = make_mesh((2,), ("node",), device="cpu")
>>> chunk_fn, init_fn = make_node_chunk_fn(spec, "sim", mesh)
>>> state = init_fn(spec.seed)
>>> xs, ys = spec.resolve_stream(device="cpu").chunk(0, 4)
>>> state, outs = chunk_fn(state, xs, ys)
>>> tuple(outs.loss.shape), tuple(state.theta.shape)
((4, 6), (6, 4))
>>> graph, delay = sparse_graph_and_delay(RunSpec(nodes=8, mixer="hypercube"
...                                               ).resolve_mixer())
>>> graph.edges, delay
(32, 0)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.api.mixers import (DelayedMixer, DenseMatrixMixer,
                                    MixerBase, RingRollMixer, SparseMixer,
                                    ring_write)
from repro_torch.core import tree
from repro_torch.core.graph import SparseGraph, ring_edges

__all__ = ["sparse_graph_and_delay", "mix_order", "NodePartition",
           "partition_graph", "Blocks", "ShardedSparseMixer",
           "make_node_chunk_fn", "resolve_node_mesh",
           "reference_local_round_fn"]


def sparse_graph_and_delay(mixer) -> tuple[Any, int]:
    """(SparseGraph, delay) behind a resolved mixer, for sharding (and for
    the fused backend's ``round_update``, which mixes with its CSR form).

    Accepts `SparseMixer` (native), `RingRollMixer` (exact `ring_edges`
    form) and fixed single-matrix `DenseMatrixMixer` stacks (converted via
    `SparseGraph.from_dense`), optionally wrapped in `DelayedMixer`.
    Time-varying schedules, per-edge heterogeneous delays, the complete and
    the no-communication mixers have no fixed sparse form and raise
    ValueError.
    """
    delay = int(getattr(mixer, "delay", 0))
    inner = mixer.inner if isinstance(mixer, DelayedMixer) else mixer
    if isinstance(inner, SparseMixer):
        return inner.graph, delay
    if isinstance(inner, RingRollMixer):
        return ring_edges(inner.m, self_weight=inner.self_weight), delay
    if isinstance(inner, DenseMatrixMixer):
        if inner.stack.shape[0] != 1:
            raise ValueError(
                f"mixer {inner.name!r} is a time-varying dense schedule "
                f"({inner.stack.shape[0]} matrices); a fixed sparse form "
                "needs one fixed topology — use mixer='sparse' or a "
                "single-matrix stack")
        return SparseGraph.from_dense(inner.stack[0].numpy(),
                                      name=inner.name), delay
    raise ValueError(
        f"{type(inner).__name__} cannot be node-sharded: no fixed sparse "
        "form (use mixer='sparse' with a ring/torus/... topology)")


def mix_order(mixer) -> str:
    """The order in which the unsharded mix adds each row's terms:
    ``"ring"`` (self, then node i-1, then node i+1 — `RingRollMixer`'s
    torch ops and `MixCSR.ring_roll`, m >= 3) or ``"ascending"`` (global
    source order — `SparseMixer`, a dense stack's CSR form, a faulty
    mixer). A sharded mix that adds in the same order rounds as the
    unsharded one on every row, the ring's wrap-around rows 0 and m-1
    included."""
    inner = mixer.inner if isinstance(mixer, DelayedMixer) else mixer
    if isinstance(inner, RingRollMixer) and inner.m >= 3:
        return "ring"
    return "ascending"


@dataclasses.dataclass(frozen=True)
class NodePartition:
    """Edges of a SparseGraph regrouped for a D-way contiguous row split.

    ``offsets`` holds one entry per used shard offset o = (src_shard -
    dst_shard) % D, in ascending o: (o, dst_local (D, E_o), src_local (D,
    E_o), weight (D, E_o)) — row d of each array is destination shard d's
    edges whose sources live on shard (d + o) % D, zero-padded to the
    widest shard (a weight-0 entry adds nothing). ``diag_blocks`` is the
    (D, block) self-weight table; padding rows m..m_pad-1 carry no edges
    and weight 0. ``order`` is the order in which each row's edges add
    (`mix_order` of the unsharded mixer).
    """

    m: int
    devices: int
    block: int           # rows per shard = ceil(m / devices)
    m_pad: int           # block * devices
    offsets: tuple       # ((o, dst_local, src_local, weight), ...)
    diag_blocks: Any     # (D, block) float32
    order: str = "ascending"   # "ascending" | "ring"


def partition_graph(graph, devices: int,
                    order: str = "ascending") -> NodePartition:
    """Split a SparseGraph's edges by destination shard and source offset;
    each row's edges add in ``order`` (`mix_order`)."""
    D = int(devices)
    if D < 1:
        raise ValueError(f"partition_graph needs devices >= 1, got {D}")
    if order not in ("ascending", "ring"):
        raise ValueError(f"unknown mix order {order!r}; expected 'ring' or "
                         "'ascending'")
    m = int(graph.m)
    block = -(-m // D)
    m_pad = block * D
    dst = np.asarray(graph.dst, np.int64)
    src = np.asarray(graph.src, np.int64)
    weight = np.asarray(graph.weight, np.float32)
    dst_shard = dst // block
    offs = (src // block - dst_shard) % D
    offsets = []
    for o in sorted(set(int(v) for v in offs)):
        per_dev = [np.flatnonzero((offs == o) & (dst_shard == d))
                   for d in range(D)]
        width = max(len(ix) for ix in per_dev)
        dl = np.zeros((D, width), np.int32)
        sl = np.zeros((D, width), np.int32)
        ww = np.zeros((D, width), np.float32)
        for d, ix in enumerate(per_dev):
            k = len(ix)
            dl[d, :k] = dst[ix] - d * block
            sl[d, :k] = src[ix] % block
            ww[d, :k] = weight[ix]
        offsets.append((o, dl, sl, ww))
    diag = np.zeros((m_pad,), np.float32)
    diag[:m] = np.asarray(graph.diag(), np.float32)
    return NodePartition(m=m, devices=D, block=block, m_pad=m_pad,
                         offsets=tuple(offsets),
                         diag_blocks=diag.reshape(D, block), order=order)


class Blocks:
    """A node-axis tensor as its D per-shard blocks, each on its shard's
    device. Arithmetic between Blocks, indexing and item assignment act
    shard by shard, so `MixerBase`'s noise-placement algebra and the
    history ring (`ring_write`, `ring_read`) run on it unchanged; ``shape``
    is a block's. ``device`` is None: a per-shard vector moved "to" it (as
    ``_bcast`` does) stays where its shards are."""

    __slots__ = ("parts",)
    device = None

    def __init__(self, parts):
        self.parts = tuple(parts)

    def _zip(self, other: "Blocks", fn) -> "Blocks":
        return Blocks(fn(a, b) for a, b in zip(self.parts, other.parts))

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._zip(other, lambda a, b: a * b)

    def __getitem__(self, idx) -> "Blocks":
        return Blocks(a[idx] for a in self.parts)

    def __setitem__(self, idx, value: "Blocks") -> None:
        for a, v in zip(self.parts, value.parts):
            a[idx] = v

    @property
    def shape(self) -> torch.Size:
        return self.parts[0].shape

    def dim(self) -> int:
        return self.parts[0].dim()

    def to(self, device) -> "Blocks":
        if device is not None:
            raise TypeError("Blocks stay on their shards' devices")
        return self

    def reshape(self, *shape) -> "Blocks":
        return Blocks(a.reshape(*shape) for a in self.parts)

    @staticmethod
    def stack(seeds: list) -> "Blocks":
        """Per-seed Blocks on a leading seed axis of each shard (one seed:
        a view)."""
        if len(seeds) == 1:
            return seeds[0][None]
        return Blocks(torch.stack(ps) for ps in zip(*(b.parts
                                                      for b in seeds)))


@dataclasses.dataclass(frozen=True)
class _ShardEdges:
    """One destination shard's edges by local row, each row's in the
    partition's ``order``, grouped into slots (slot k: the k-th edge of
    every row that has one). ``pos`` indexes the shard's halo
    buffer (offset index * block + source row in its block)."""

    dst: np.ndarray          # (E,) local destination row
    src_g: np.ndarray        # (E,) global source node
    pos: np.ndarray          # (E,) row of the halo buffer
    weight: np.ndarray       # (E,) float32
    slots: tuple             # per slot: (local rows, indices into the edges)


def _shard_edges(part: NodePartition, d: int) -> _ShardEdges:
    D, block, m = part.devices, part.block, part.m
    cols = [[], [], [], []]
    for k, (o, dl, sl, ww) in enumerate(part.offsets):
        real = ww[d] != 0.0          # the zero-filled entries add nothing
        cols[0].append(dl[d][real].astype(np.int64))
        src = sl[d][real].astype(np.int64)
        cols[1].append(((d + o) % D) * block + src)
        cols[2].append(k * block + src)
        cols[3].append(ww[d][real])
    dst, src_g, pos, w = (np.concatenate(c) for c in cols)
    if part.order == "ring":
        # rank in the roll order: self 0, node i-1 1, node i+1 2
        rel = (src_g - (d * block + dst)) % m
        key = np.select([rel == 0, rel == m - 1], [0, 1], 2)
    else:
        key = src_g
    perm = np.lexsort((key, dst))
    deg = np.bincount(dst[perm], minlength=block)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int64)
    rows = [np.flatnonzero(deg > k) for k in range(int(deg.max(initial=0)))]
    return _ShardEdges(dst=dst[perm], src_g=src_g[perm], pos=pos[perm],
                       weight=w[perm].astype(np.float32),
                       slots=tuple((r, start[r] + k)
                                   for k, r in enumerate(rows)))


class ShardedSparseMixer(MixerBase):
    """SparseMixer split over the shards of a ("node",) mesh row.

    ``apply`` takes and returns `Blocks`. Each used offset o != 0 costs one
    copy of a whole neighbour block into shard d's halo buffer (counted in
    ``ShardedSparseMixer.halo_copies``; a peer copy when the two shards'
    devices differ, a copy on the card when they repeat it — never a
    view); offset 0 is copied from the shard's own block. Each row then
    adds its weighted sources slot by slot (``torch.addcmul``) in the
    partition's order (`mix_order` of the unsharded mixer: ascending global
    source, or the ring's roll order). ``mix``, ``mix_delayed`` and
    ``mix_history`` are `MixerBase`'s, so noise placement and delay
    handling match the unsharded mixers.
    """

    halo_copies = 0

    def __init__(self, part: NodePartition, delay: int = 0, devices=None):
        self.part = part
        self.m = part.m
        self.delay = int(delay)
        D = part.devices
        self.devices = tuple(torch.device(d) for d in
                             (devices if devices is not None
                              else ("cpu",) * D))
        if len(self.devices) != D:
            raise ValueError(f"{D} shards but {len(self.devices)} devices")
        self._used = tuple(o for o, *_ in part.offsets)
        self._edges = tuple(_shard_edges(part, d) for d in range(D))
        # per shard, per slot: (rows, halo rows, edge indices, weights)
        self._slots = tuple(
            tuple(tuple(torch.as_tensor(a).to(dev) for a in
                        (rows, e.pos[edges], edges, e.weight[edges]))
                  for rows, edges in e.slots)
            for e, dev in zip(self._edges, self.devices))
        self._diag_blocks = Blocks(
            torch.as_tensor(part.diag_blocks[d]).to(dev)
            for d, dev in enumerate(self.devices))

    @classmethod
    def reset_halo_copies(cls) -> None:
        ShardedSparseMixer.halo_copies = 0

    def _exchange(self, x: Blocks) -> list:
        """Each shard's halo buffer: the blocks of its used offsets, in
        ascending offset, on its device."""
        D, block = self.part.devices, self.part.block
        if self._used == (0,):
            return list(x.parts)
        bufs = []
        for d, dev in enumerate(self.devices):
            own = x.parts[d]
            buf = torch.empty((len(self._used) * block,) + own.shape[1:],
                              dtype=own.dtype, device=dev)
            for k, o in enumerate(self._used):
                buf[k * block:(k + 1) * block].copy_(x.parts[(d + o) % D])
                if o:
                    ShardedSparseMixer.halo_copies += 1
            bufs.append(buf)
        return bufs

    def _slot_sum(self, d: int, weights, buf: torch.Tensor) -> torch.Tensor:
        """Shard d's rows: ``sum_j A[i, j] x[j]`` over its edges with slot
        weights ``weights``, added slot by slot from 0."""
        block = self.part.block
        flat = buf.to(torch.float32).reshape(buf.shape[0], -1)
        out = torch.zeros((block, flat.shape[1]), dtype=torch.float32,
                          device=flat.device)
        for (rows, pos, _, _), w in zip(self._slots[d], weights):
            if rows.numel() == block:      # every row has a k-th edge
                out = torch.addcmul(out, w[:, None], flat[pos])
            else:
                out[rows] = torch.addcmul(out[rows], w[:, None], flat[pos])
        return out.reshape((block,) + tuple(buf.shape[1:])).to(buf.dtype)

    def apply(self, x: Blocks, t) -> Blocks:
        return Blocks(self._slot_sum(d, [s[3] for s in self._slots[d]], buf)
                      for d, buf in enumerate(self._exchange(x)))

    def diag(self, t) -> Blocks:
        return self._diag_blocks


# -- the node-sharded chunk program ------------------------------------------

def _pad_rows(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """``x`` with ``pad`` zero rows appended along ``axis``."""
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _split(x: torch.Tensor, part: NodePartition, axis: int,
           devices) -> Blocks:
    """A global node-axis tensor as zero-padded, contiguous per-shard
    blocks, each on its shard's device."""
    xp = _pad_rows(x, part.m_pad - part.m, axis)
    return Blocks(xp.narrow(axis, d * part.block, part.block).contiguous()
                  .to(dev) for d, dev in enumerate(devices))


def _merge(b: Blocks, m: int, axis: int, dev: torch.device) -> torch.Tensor:
    """The global, unpadded tensor of per-shard blocks, on ``dev``."""
    return torch.cat([p.to(dev) for p in b.parts], dim=axis).narrow(
        axis, 0, m).contiguous()


def _psum(partials, dev: torch.device) -> torch.Tensor:
    """Per-shard partials summed in shard order on ``dev``."""
    acc = partials[0].to(dev)
    for p in partials[1:]:
        acc = acc + p.to(dev)
    return acc


def _masks(part: NodePartition, devices) -> list:
    """Each shard's (block,) float mask: 1 on real rows, 0 on padding."""
    gidx = np.arange(part.m_pad).reshape(part.devices, part.block)
    return [torch.as_tensor((gidx[d] < part.m).astype(np.float32)).to(dev)
            for d, dev in enumerate(devices)]


def _alive_blocks(schedule, t: int, part: NodePartition, devices):
    """The round's (block,) liveness per shard (pad rows 0), or None when
    the schedule crashes nobody."""
    if schedule is None or not schedule.has_crashes:
        return None
    alive = _pad_rows(schedule.alive_f32(t, devices[0]), part.m_pad - part.m,
                      0)
    return [alive[d * part.block:(d + 1) * part.block].to(dev)
            for d, dev in enumerate(devices)]


def _noise_blocks(mech, generators, m: int, n: int, scale,
                  part: NodePartition, devices) -> list:
    """Each seed's (m, n) draw from its generator — the dense engines'
    draw — zero-padded to m_pad rows, as per-shard (S, block, n) slices."""
    from repro_torch.api.backends import _per_seed
    delta = _pad_rows(_per_seed(lambda g: mech.sample(g, (m, n), scale),
                                generators), part.m_pad - m, 1)
    return [delta[:, d * part.block:(d + 1) * part.block].to(dev)
            for d, dev in enumerate(devices)]


def _sharded_mixer(part: NodePartition, delay: int, schedule, graph,
                   devices) -> ShardedSparseMixer:
    if schedule is not None:
        from repro_torch.faults.mixers import FaultyShardedSparseMixer
        return FaultyShardedSparseMixer(part, graph, schedule, delay=delay,
                                        devices=devices)
    return ShardedSparseMixer(part, delay=delay, devices=devices)


def _unpack(engine: str, state):
    """(theta, history) Blocks of a sharded engine state."""
    if engine == "sim":
        return state.theta, state.history
    return state.theta["w"], (None if state.history is None
                              else state.history["w"])


def _pack(engine: str, state, theta, hist):
    if engine != "sim":
        theta = {"w": theta}
        hist = None if hist is None else {"w": hist}
    return state._replace(theta=theta, t=state.t + 1, history=hist)


def _mix_seed(smixer, theta: Blocks, tilde: Blocks, hist, noise_self: bool,
              t: int) -> Blocks:
    """One seed's mix (its ring written first when the mixer is delayed)."""
    if smixer.delay:
        ring_write(hist, t, tilde)
        return smixer.mix_history(theta, tilde, hist, noise_self, t)
    return smixer.mix(theta, tilde, noise_self, t)


def reference_local_round_fn(spec, engine: str, part: NodePartition,
                             delay: int, schedule=None, graph=None, *,
                             devices=None) -> Callable:
    """One gossip round over every shard of a mesh row, in torch ops — the
    reference backend (`make_node_chunk_fn` dispatches here, or to the cuda
    backend's variant, via ``spec.resolve_backend()``).

    The round takes a `runner.BatchState` whose theta (and history ring)
    are `Blocks` of (S, block, n) — S seeds in step — and (x, y, x_global):
    Blocks of (S, block, n) and (S, block), and the round's unsplit (S, m,
    n) features on the row's first device; it returns the next state and a
    RoundOutput whose ``loss`` and ``correct`` are (S, block) Blocks and
    ``w_bar_loss`` and ``sparsity`` (S,) tensors on the row's first
    device. It mirrors `Algorithm1.round` term for term, seed by seed and
    shard by shard (the oracle); the only cross-shard traffic is the
    mixer's halo copies and the three metric sums. ``schedule`` (a
    `repro_torch.faults.FaultSchedule`, with the global ``graph``) swaps
    the mixer for `FaultyShardedSparseMixer` and freezes crashed rows.
    """
    from repro_torch.core.algorithm1 import RoundOutput, hinge_loss_and_grad
    from repro_torch.core.prox import zero_fraction

    m, n = part.m, spec.dim
    devices = tuple(torch.device(d) for d in devices)
    dev0 = devices[0]
    mech = spec.resolve_mechanism()
    rule = spec.resolve_local_rule()
    clipper = spec.resolve_clipper()
    omd = spec.omd_config()
    loss_and_grad = spec.loss_and_grad or hinge_loss_and_grad
    smixer = _sharded_mixer(part, delay, schedule, graph, devices)
    masks = _masks(part, devices)

    def round_fn(state, batch):
        xb, yb, _ = batch
        theta, hist = _unpack(engine, state)
        t = state.t
        ctx = omd.step_context(t + 1)
        alive = _alive_blocks(schedule, t, part, devices)
        deltas = _noise_blocks(mech, state.generators, m, n,
                               mech.scale(ctx.alpha_t, n), part, devices)
        nxt, losses, corrects, wb_losses, sparsities = [], [], [], [], []
        for i in range(len(state.generators)):
            th, x, y = theta[i], xb[i], yb[i]
            w = [rule.primal(p, ctx) for p in th.parts]
            grads, loss, correct = [], [], []
            for wd, xd, yd in zip(w, x.parts, y.parts):
                ld, gd = loss_and_grad(wd, xd, yd)
                correct.append((torch.sign(torch.sum(wd * xd, dim=1)) == yd)
                               .to(torch.float32))
                loss.append(ld)
                grads.append(clipper.clip(gd)[0])
            tilde = th + Blocks(dl[i] for dl in deltas)
            mixed = _mix_seed(smixer, th, tilde,
                              None if hist is None else hist[i],
                              mech.noise_self, t)
            step = [rule.dual_step(md, gd, ctx)
                    for md, gd in zip(mixed.parts, grads)]
            if alive is not None:
                # crashed rows of each block freeze; pad rows stay zero
                step = [torch.where(a[:, None] > 0.0, s, p)
                        for a, s, p in zip(alive, step, th.parts)]
            nxt.append(Blocks(step))
            # the metrics: masked partial sums, added in shard order
            w_bar = _psum([torch.sum(wd * md[:, None], dim=0)
                           for wd, md in zip(w, masks)], dev0) / m
            wb = _psum([torch.sum(torch.clamp_min(
                1.0 - yd * torch.sum(w_bar.to(xd.device)[None, :] * xd,
                                     dim=-1), 0.0) * md)
                for xd, yd, md in zip(x.parts, y.parts, masks)], dev0) / m
            zeros = _psum([torch.sum((torch.abs(wd) <= 0.0).to(torch.float32)
                                     * md[:, None])
                           for wd, md in zip(w, masks)], dev0)
            losses.append(Blocks(loss))
            corrects.append(Blocks(correct))
            wb_losses.append(wb)
            sparsities.append(zero_fraction(zeros, m * n))
        out = RoundOutput(loss=Blocks.stack(losses),
                          w_bar_loss=torch.stack(wb_losses),
                          sparsity=torch.stack(sparsities),
                          correct=Blocks.stack(corrects))
        return _pack(engine, state, Blocks.stack(nxt), hist), out

    return round_fn


def resolve_node_mesh(node_devices, mesh, *, device: str = "cuda"):
    """The mesh carrying the "node" axis, or None for the unsharded path.

    A prebuilt ``mesh`` must carry a "node" axis; ``node_devices`` goes
    through `launch.mesh.node_mesh` on devices of type ``device`` (None /
    0 / 1 -> None, "auto" -> every visible device).
    """
    if mesh is not None:
        if "node" not in mesh.axis_names:
            raise ValueError(
                f"node sharding needs a mesh with a 'node' axis, got axes "
                f"{tuple(mesh.axis_names)}")
        return mesh
    if node_devices is None:
        return None
    from repro_torch.launch.mesh import node_mesh
    return node_mesh(node_devices, device=device)


def _row_program(round_fn: Callable, part: NodePartition, engine: str,
                 devices: tuple) -> Callable:
    """chunk_fn(BatchState, xs (C, S, m, n), ys (C, S, m)) of one mesh row:
    global, unpadded state and data in and out; the padding, the split
    into shards and the round loop inside."""
    from repro_torch.core.algorithm1 import RoundOutput

    m, dev0 = part.m, devices[0]
    split = lambda a, axis: _split(a, part, axis, devices)  # noqa: E731

    def chunk_fn(state, xs, ys):
        st = state._replace(
            theta=tree.tree_map(lambda a: split(a, 1), state.theta),
            history=tree.tree_map(lambda a: split(a, 2), state.history))
        xb, yb = split(xs, 2), split(ys, 2)
        outs = []
        for k in range(xs.shape[0]):
            st, out = round_fn(st, (xb[k], yb[k], xs[k]))
            outs.append(out)
        fields = []
        for f in zip(*outs):
            if isinstance(f[0], Blocks):
                per = Blocks(torch.stack(ps) for ps in
                             zip(*(b.parts for b in f)))
                fields.append(_merge(per, m, 2, dev0))
            else:
                fields.append(torch.stack(f))
        state = st._replace(
            theta=tree.tree_map(lambda b: _merge(b, m, 1, dev0), st.theta),
            history=tree.tree_map(lambda b: _merge(b, m, 2, dev0),
                                  st.history))
        return state, RoundOutput(*fields)

    return chunk_fn


def make_node_chunk_fn(spec, engine: str, mesh,
                       batched: bool = False) -> tuple[Callable, Callable]:
    """Node-sharded (chunk_fn, init_fn) — drop-in for `make_chunk_program`.

    chunk_fn consumes and returns GLOBAL, unpadded state and data on the
    mesh's first device: the node padding (m -> m_pad = ceil(m/D)*D), the
    split over the mesh's "node" axis and the round loop live inside, so
    `run`'s checkpoint, resume and metrics logic — and checkpoints across
    device counts — need no changes. With ``batched=True`` the state is a
    `runner.BatchState` of S seeds (xs (C, S, m, n)), the mesh a ("seed",
    "node") grid: each seed row of the grid runs its share of the seeds
    (padded to a multiple of the rows) on its node shards, and init_fn
    takes a list of seeds.
    """
    from repro_torch.api.runner import (batch_init, reference_round_program,
                                        seed_rows_program, seed_state,
                                        stack_states)
    from repro_torch.core.algorithm1 import RoundOutput

    if engine not in ("sim", "dist"):
        raise ValueError(f"unknown engine {engine!r}; expected 'sim' or 'dist'")
    if "node" not in getattr(mesh, "axis_names", ()):
        raise ValueError(
            f"make_node_chunk_fn needs a mesh with a 'node' axis, got "
            f"{tuple(getattr(mesh, 'axis_names', ()))}")
    if batched and "seed" not in mesh.axis_names:
        raise ValueError("batched node sharding needs a ('seed','node') mesh")
    D = int(mesh.shape["node"])

    mixer = spec.resolve_mixer()
    schedule = getattr(mixer, "schedule", None)
    if schedule is not None:
        # repro_torch.faults: the spec resolved to a faulty mixer — shard
        # its INNER edge list and rebuild the fault masks per shard
        from repro_torch.faults.mixers import FaultySparseMixer
        if not isinstance(mixer, FaultySparseMixer):
            raise ValueError(
                f"node sharding under faults needs the sparse edge-list path "
                f"(mixer='sparse' or a ring), got {type(mixer).__name__}")
        if schedule.max_extra:
            raise ValueError(
                "stragglers are not supported under node sharding — "
                "per-class delay rings do not shard; drop "
                "straggler_rate/stragglers or run unsharded")
        graph, delay = mixer.inner.graph, mixer.base_delay
    else:
        graph, delay = sparse_graph_and_delay(mixer)
    if int(graph.m) != int(spec.nodes):
        raise ValueError(f"graph has m={graph.m} nodes but RunSpec.nodes="
                         f"{spec.nodes}")
    part = partition_graph(graph, D, order=mix_order(mixer))
    backend = spec.resolve_backend()
    rows = mesh.rows("node") if batched else mesh.rows("node")[:1]
    programs = [_row_program(backend.make_local_round_fn(
        spec, engine, part, delay, schedule=schedule, graph=graph,
        devices=row), part, engine, row) for row in rows]

    # init states are built by the UNSHARDED reference program: global,
    # unpadded — the same state a plain run initializes, so checkpoints
    # interchange across backends and device counts
    dev0 = rows[0][0]
    init_fn = reference_round_program(spec, engine, dev0)[1]
    if batched:
        return (seed_rows_program(programs, [row[0] for row in rows], dev0),
                batch_init(init_fn))
    program = programs[0]

    def chunk_fn(state, xs, ys):
        bstate, outs = program(stack_states([state]), xs[:, None],
                               ys[:, None])
        return seed_state(engine, bstate, 0), RoundOutput(
            *(f[:, 0] for f in outs))

    return chunk_fn, init_fn
