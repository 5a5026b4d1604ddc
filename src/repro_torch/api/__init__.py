"""repro_torch.api — the round-pipeline stages, RunSpec and run.

Counterpart of `repro.api`: Algorithm 1 (clip -> Laplace-noise ->
gossip-mix -> local sparse update -> L1 prox) decomposed into registry-backed
stages — Mixer, Mechanism, LocalRule, Clipper, Stream — shared by both
engines (the dense simulator and the distributed `GossipDP`), and a
BACKENDS registry that says how the round body executes ("reference" torch
ops or the fused "cuda" kernels).

>>> from repro_torch.api import MIXERS, MECHANISMS, LOCAL_RULES, CLIPPERS
>>> MIXERS.names(), MECHANISMS.names(), LOCAL_RULES.names(), CLIPPERS.names()
(('ring',), ('laplace', 'none'), ('omd',), ('l2', 'none'))
"""
from repro_torch.api.registry import (BACKENDS, CLIPPERS, LOCAL_RULES,
                                      MECHANISMS, MIXERS, STREAMS, Registry,
                                      UnknownEntryError)
from repro_torch.api.mixers import (DelayedMixer, Mixer, MixerBase,
                                    RingRollMixer, ring_read, ring_write)
from repro_torch.api.mechanisms import LaplaceMechanism, Mechanism, NoNoise
from repro_torch.api.rules import LocalRule, OMDLassoRule, StepContext
from repro_torch.api.clippers import (Clipper, NoClipper, PerNodeL2Clipper,
                                      per_node_norms)
from repro_torch.api.streams import SocialStream, Stream
from repro_torch.api.spec import RunSpec
from repro_torch.api.exec_config import ExecConfig
from repro_torch.api.runner import RunResult, make_chunk_program, run
# importing repro_torch.api.backends registers the BACKENDS entries
from repro_torch.api.backends import CudaBackend, ReferenceBackend
from repro_torch.core.gossip import (GossipDP, GossipState, gossip_mix_tree,
                                     per_node_clip)
from repro_torch.kernels import ops

__all__ = [
    "Registry", "UnknownEntryError", "MIXERS", "MECHANISMS", "LOCAL_RULES",
    "CLIPPERS", "STREAMS", "BACKENDS",
    "Mixer", "MixerBase", "RingRollMixer", "DelayedMixer", "ring_read",
    "ring_write",
    "Mechanism", "LaplaceMechanism", "NoNoise",
    "LocalRule", "StepContext", "OMDLassoRule",
    "Clipper", "PerNodeL2Clipper", "NoClipper", "per_node_norms",
    "Stream", "SocialStream",
    "RunSpec", "ExecConfig", "RunResult", "run", "make_chunk_program",
    "ReferenceBackend", "CudaBackend",
    "GossipDP", "GossipState", "gossip_mix_tree", "per_node_clip", "ops",
]
