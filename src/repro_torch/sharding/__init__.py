"""repro_torch.sharding — parameter, batch and cache placement rules
(counterpart of `repro.sharding`)."""
from repro_torch.sharding.rules import (
    param_pspecs, batch_pspec, cache_pspecs, with_node_axis, NODE_AXES,
    MODEL_AXIS,
)

__all__ = ["param_pspecs", "batch_pspec", "cache_pspecs", "with_node_axis",
           "NODE_AXES", "MODEL_AXIS"]
