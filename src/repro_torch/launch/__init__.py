"""repro_torch.launch — command-line entry points of the port.

Counterpart of `repro.launch`; ``python -m repro_torch.launch.sweep`` runs
a sweep (`repro_torch.sweep`) from the command line.
"""
