"""Predicted-vs-measured chunk cost: the predict-then-measure loop.

Counterpart of `repro.obs.cost`. `repro_torch.launch.op_cost.count` counts
the flops and memory bytes of one eager call (torch ops by `hlo_cost`'s
rules, each kernel by its `kernels.work` numbers). This module closes the
loop: a roofline :class:`CostModel` turns that count into a PREDICTED
chunk time, the runner's chunk spans supply the MEASURED one, and their
ratio is recorded with the run (``metrics["obs"]["cost"]`` and the
``chunk_cost`` run event).

The model is ``max(flops / peak_flops, bytes / peak_bandwidth)`` — the
two-term roofline. Peaks are CALIBRATED once per device with the
reference's two probes (a 512^2 matmul for the flop ceiling, a saxpy of
512^2 * 16 floats for the bandwidth ceiling, best of 5; on a card timed by
CUDA events), so predictions track the device the run is on; pass an
explicit :class:`CostModel` to pin them. A probe's flops and bytes are
counted as a run's are (`op_cost.count`): XLA fuses the reference's saxpy
``2x + 1`` into one pass over x, but eagerly it is two kernels that each
read and write the vector, and a peak taken over the fused pass's bytes
would read half the rate the counted bytes move at. The port's chunk is a loop of
eager launches, so an error ratio far below 1 is the host's share of a
chunk: the gap between what the bytes need and what the loop takes.

>>> import torch
>>> model = CostModel(peak_flops=1e12, peak_bandwidth=1e11)
>>> cc = analyze_chunk(lambda x: x @ x + 1.0, torch.ones(64, 64),
...                    model=model)
>>> cc.cost.flops >= 2 * 64 * 64 * 64
True
>>> cc.predicted_s > 0
True
>>> cc.record(cc.predicted_s * 2)      # "measured" twice the prediction
>>> round(cc.summary()["error_ratio"], 3)
0.5
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = ["CostModel", "ChunkCost", "analyze_chunk", "calibrate"]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Two-term roofline: seconds = max(flops/peak, bytes/bandwidth)."""

    peak_flops: float          # FLOP/s the device sustains on a hot matmul
    peak_bandwidth: float      # bytes/s on a streaming elementwise op

    def predict_seconds(self, cost) -> float:
        """Predicted time of one execution of a counted program (``cost``
        is a `repro_torch.launch.op_cost.OpCost`)."""
        return max(cost.flops / self.peak_flops,
                   cost.hbm_bytes / self.peak_bandwidth)

    def summary(self) -> dict:
        return {"peak_flops": self.peak_flops,
                "peak_bandwidth": self.peak_bandwidth}


_CALIBRATED: dict = {}


# ~0.5 ms of GPU clock cycles: long enough for the host to queue a probe
# call behind it, so its events time the card's work, not the launches
_QUEUE_CYCLES = 1_000_000


def _best_seconds(fn, repeats: int, dev) -> float:
    """The fastest of ``repeats`` calls of ``fn`` (after one untimed call):
    on a card, CUDA events around each call queued behind a device sleep
    (a host clock, or events recorded as the host launches, would read the
    launches of a ~5 us matmul); the host clock on the CPU."""
    import torch
    fn()
    best = float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_QUEUE_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            secs = time.perf_counter() - t0
        best = min(best, secs)
    return max(best, 1e-9)


def calibrate(size: int = 512, repeats: int = 5,
              device="cuda") -> CostModel:
    """Measure ``device``'s achievable peaks with two probes (cached per
    device; CUDA unless the caller passes ``device="cpu"``).

    The probes run on throwaway tensors and draw no random numbers, so
    calibrating inside a seeded run cannot perturb it. Each probe's rate is
    its counted work (`op_cost.count`) over its best time."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.launch import op_cost
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)                  # one calibration a physical device
    if key in _CALIBRATED:
        return _CALIBRATED[key]
    with (torch.cuda.device(dev) if dev.type == "cuda"
          else contextlib.nullcontext()):
        a = torch.ones((size, size), dtype=torch.float32, device=dev)
        v = torch.ones((size * size * 16,), dtype=torch.float32, device=dev)
        matmul, saxpy = (lambda: a @ a), (lambda: 2.0 * v + 1.0)
        flops = op_cost.count(matmul)[1].flops          # 2 * size^3
        nbytes = op_cost.count(saxpy)[1].hbm_bytes      # two f32 passes
        model = CostModel(
            peak_flops=flops / _best_seconds(matmul, repeats, dev),
            peak_bandwidth=nbytes / _best_seconds(saxpy, repeats, dev))
    _CALIBRATED[key] = model
    return model


@dataclasses.dataclass
class ChunkCost:
    """One chunk program's predicted cost + its measured executions.

    The runner calls :meth:`record` with every chunk span's duration;
    :meth:`summary` is what lands in ``RunResult.metrics['obs']['cost']``
    and the ``chunk_cost`` run event.
    """

    cost: object                     # repro_torch.launch.op_cost.OpCost
    model: CostModel
    predicted_s: float
    measured: list = dataclasses.field(default_factory=list)

    def record(self, seconds: float) -> None:
        self.measured.append(float(seconds))

    def summary(self) -> dict:
        mean = (sum(self.measured) / len(self.measured)
                if self.measured else None)
        return {
            "flops": self.cost.flops,
            "hbm_bytes": self.cost.hbm_bytes,
            "collective_bytes": self.cost.collective_bytes,
            "predicted_s": self.predicted_s,
            "measured_mean_s": mean,
            "measured_chunks": len(self.measured),
            # >1: the program ran FASTER than the model says it could;
            # <1: overheads (launches, host work) the model omits
            "error_ratio": (self.predicted_s / mean
                            if mean and mean > 0 else None),
            "model": self.model.summary(),
        }


def _device_of(args) -> str:
    """The device of the first tensor among ``args`` (the CPU if none)."""
    import torch
    from torch.utils._pytree import tree_leaves
    for leaf in tree_leaves(list(args)):
        if isinstance(leaf, torch.Tensor):
            return str(leaf.device)
    return "cpu"


def analyze_chunk(fn, *args, model: CostModel | None = None,
                  rounds: int = 1) -> ChunkCost:
    """Count one call ``fn(*args)`` (`op_cost.count`), multiply the count
    by ``rounds`` — the trip count of a chunk whose one round ``fn`` is,
    as the reference's HLO roll-up multiplies a scan body — and predict
    the chunk's time. ``fn`` runs once: pass it copies of anything it
    changes. Without ``model`` the peaks of the device ``args`` live on
    are calibrated."""
    from repro_torch.launch import op_cost

    _, cost = op_cost.count(fn, *args)
    cost = cost.scaled(rounds)
    model = model or calibrate(device=_device_of(args))
    return ChunkCost(cost=cost, model=model,
                     predicted_s=model.predict_seconds(cost))
