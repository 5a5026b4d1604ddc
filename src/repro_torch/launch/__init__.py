"""repro_torch.launch — command-line entry points of the port.

Counterpart of `repro.launch`: ``python -m repro_torch.launch.sweep`` runs
a sweep (`repro_torch.sweep`), ``python -m repro_torch.launch.serve``
serves predictions while the ring learns (`repro_torch.serve`), and
``python -m repro_torch.launch.obs report`` renders a run-event stream
(`repro_torch.obs`).
"""
