"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

`round_fused` carries the fused round body of ``backend="cuda"``
(``round_stats``, ``round_update``, ``dual_step``, re-exported here as
`repro.kernels` exports them); `ops` wraps the seed kernels
(``pdomd_update``, ``hinge_grad``) for parameter pytrees; `ref` names the
plain versions as the reference names its oracles. Every kernel is built
from ``src/repro_torch/csrc/`` at first use (`build`).

``MAX_FUSED_NODES`` is the port's own bound: the cuda backend's default
``max_fused_nodes``, past which ``mode="auto"`` takes the hybrid path. The
reference's ``LANE``, ``SUBLANE`` and ``DEFAULT_BLOCK_COLS`` are TPU tiling
constants (its Pallas grid's vector lanes, sublanes and column block);
the CUDA kernels tile on their own terms, so they are not carried.
"""
from repro_torch.kernels.round_fused import (MAX_FUSED_NODES, dual_step,
                                             round_stats, round_update)

__all__ = ["round_stats", "round_update", "dual_step", "MAX_FUSED_NODES"]
