"""repro_torch.figures — the paper's Figs. 2-5 and the two ablations on the
port.

Counterpart of ``benchmarks/common.py``, ``benchmarks/fig2..fig5``,
``benchmarks/ablation_sparse_methods.py``, ``benchmarks/ablation_delay.py``
and ``examples/private_social_training.py``: each module keeps the reference's
axes, ``run(...)`` signature (plus ``device`` and ``store``), JSON rows,
file name and derived check, and its result dict adds the `SweepResult`
under ``"sweep"``. A figure runs on ``backend="cuda"`` — the hand-written
kernels on a card, their plain versions on the CPU (the sparse-methods
ablation's truncated gradient and RDA on ``"reference"``) — through
`repro_torch.sweep` into the port's own store (``common.STORE``).

    python -m repro_torch.figures --smoke --device cpu   # seconds, CPU
    python -m repro_torch.figures --paper                # §V scale, card
"""
from repro_torch.figures import (ablation_delay, ablation_sparse_methods,
                                 fig2_privacy, fig3_topology, fig4_sparsity,
                                 fig5_nodes)
from repro_torch.figures.common import (FIGURES, SEEDS, STORE, Scale,
                                        figure_sweep, make_spec)

__all__ = ["SEEDS", "STORE", "FIGURES", "Scale", "make_spec",
           "figure_sweep", "fig2_privacy", "fig3_topology", "fig4_sparsity",
           "fig5_nodes", "ablation_sparse_methods", "ablation_delay"]
