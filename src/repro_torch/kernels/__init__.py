"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

`round_fused` carries the fused round body of ``backend="cuda"``
(``round_stats``, ``round_update``, ``dual_step``); `ops` wraps the seed
kernels (``pdomd_update``, ``hinge_grad``) for parameter pytrees; `ref`
names the plain versions as the reference names its oracles. Every kernel
is built from ``src/repro_torch/csrc/`` at first use (`build`).
"""
