"""repro_torch.launch — command-line entry points of the port.

Counterpart of `repro.launch`: ``python -m repro_torch.launch.train
--stream`` runs the paper's linear workload on a STREAMS scenario
(`TrainRecipe` of `launch.steps`), ``python -m repro_torch.launch.dryrun
--stream`` counts its chunk program without running the horizon
(`launch.op_cost`, the counterpart of `repro.launch.hlo_cost`), ``python -m
repro_torch.launch.sweep`` runs a sweep (`repro_torch.sweep`), ``python -m
repro_torch.launch.serve`` serves predictions while the ring learns
(`repro_torch.serve`), and ``python -m repro_torch.launch.obs report``
renders a run-event stream (`repro_torch.obs`); `launch.mesh` builds the
device meshes that shard a run's node or seed axis, and the LM stack's
production meshes (``meta`` positions: counted, not run). The LM stack:
``python -m repro_torch.launch.train --arch`` trains an architecture with
the gossip or all-reduce step of `launch.steps`, and ``python -m
repro_torch.launch.serve_lm`` decodes greedily; ``python -m
repro_torch.launch.dryrun --arch/--shape`` or ``--all`` counts its steps on
``meta`` tensors at the production meshes, and `launch.hlo_analysis` gives
the counts their H100 roofline terms and the strategies' exchanged bytes.
"""
