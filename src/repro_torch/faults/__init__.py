"""repro_torch.faults — fault injection and graceful degradation for gossip
over unreliable data-center networks.

Counterpart of `repro.faults`. A declarative :class:`FaultSpec`
(registry-backed, carried on ``RunSpec.faults``) compiles into a seeded
:class:`FaultSchedule` of per-round link drops, transient partitions, node
crash windows and stragglers; :func:`wrap_mixer` lifts a registered mixer
(sparse, dense, delayed) onto that schedule with per-round self-healing
renormalization, so both engines and both backends run under faults.
Crashed nodes freeze their local update, spend no eps (`PrivacyAccountant`
participation masks), drop out of mixing and rejoin from their last state.
A FaultSpec with every rate at zero is bit-identical to a fault-free run.
`FaultyShardedSparseMixer` runs the same faults on the node-sharded path
(`repro_torch.api.shard_node`).

>>> from repro_torch.faults import FAULTS, FaultSpec
>>> FAULTS.names()
('crash', 'dcn', 'links', 'none', 'partition')
>>> FAULTS.build("links", {"link_rate": 0.0}).is_zero
True
>>> FaultSpec(partitions=((4, 8, 2),)).compile(m=4).partitions
((4, 8, 2),)
"""
from repro_torch.faults.metrics import degradation, rounds_to_recover
from repro_torch.faults.mixers import (FaultyDenseMixer,
                                       FaultyShardedSparseMixer,
                                       FaultySparseMixer, wrap_mixer)
from repro_torch.faults.schedule import (FaultSchedule, edge_link_idx,
                                         link_table)
from repro_torch.faults.spec import FAULTS, FaultSpec

__all__ = [
    "FAULTS",
    "FaultSpec",
    "FaultSchedule",
    "FaultySparseMixer",
    "FaultyDenseMixer",
    "FaultyShardedSparseMixer",
    "wrap_mixer",
    "degradation",
    "rounds_to_recover",
    "link_table",
    "edge_link_idx",
]

