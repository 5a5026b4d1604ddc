"""repro_torch.api — the round-pipeline stages, RunSpec and run.

Counterpart of `repro.api`: Algorithm 1 (clip -> Laplace-noise ->
gossip-mix -> local sparse update -> L1 prox) decomposed into registry-backed
stages — Mixer, Mechanism, LocalRule, Clipper, Stream — shared by both
engines (the dense simulator and the distributed `GossipDP`), and a
BACKENDS registry that says how the round body executes ("reference" torch
ops or the fused "cuda" kernels), and the FAULTS registry of fault
scenarios (`repro_torch.faults`). `run` drives one seed, `run_batch` S
seeds of one configuration in step (`seed_vectorizable` says when they can
share one chunk program).

>>> from repro_torch.api import MIXERS, MECHANISMS, LOCAL_RULES, CLIPPERS
>>> MIXERS.names()    # doctest: +NORMALIZE_WHITESPACE
('complete', 'delayed', 'dense', 'disconnected', 'het_delayed', 'hypercube',
 'random', 'ring', 'ring_alternating', 'sparse', 'time_varying', 'torus')
>>> MECHANISMS.names(), LOCAL_RULES.names(), CLIPPERS.names()
... # doctest: +NORMALIZE_WHITESPACE
(('gaussian', 'laplace', 'none'), ('omd', 'rda', 'tg', 'truncated_gradient'),
 ('l2', 'none', 'value'))
>>> from repro_torch.api import STREAMS
>>> STREAMS.names()
('bursty', 'drift', 'heterogeneous', 'social_sparse')
"""
from repro_torch.api.registry import (BACKENDS, CLIPPERS, LOCAL_RULES,
                                      MECHANISMS, MIXERS, STREAMS, Registry,
                                      UnknownEntryError)
from repro_torch.api.mixers import (AlternatingRingMixer, CompleteMixer,
                                    DelayedMixer, DenseMatrixMixer,
                                    DisconnectedMixer,
                                    HeterogeneousDelayMixer, Mixer,
                                    MixerBase, RingRollMixer, SparseMixer,
                                    ring_read, ring_write,
                                    sample_edge_delays)
from repro_torch.api.mechanisms import (GaussianMechanism, LaplaceMechanism,
                                        Mechanism, NoNoise)
from repro_torch.api.rules import (LocalRule, OMDLassoRule, RDARule,
                                   StepContext, TruncatedGradientRule)
from repro_torch.api.clippers import (Clipper, NoClipper, PerNodeL2Clipper,
                                      ValueClipper, per_node_norms)
from repro_torch.api.streams import (BurstyStream, DriftStream,
                                     HeterogeneousStream, SocialStream,
                                     Stream)
from repro_torch.api.spec import RunSpec
from repro_torch.api.exec_config import ExecConfig
from repro_torch.api.runner import (RunResult, make_chunk_program, run,
                                   run_batch, seed_vectorizable)
# importing repro_torch.api.backends registers the BACKENDS entries
from repro_torch.api.backends import CudaBackend, ReferenceBackend
from repro_torch.core.gossip import (GossipDP, GossipState, gossip_mix_tree,
                                     per_node_clip)
from repro_torch.kernels import ops
from repro_torch.faults import (FAULTS, FaultSpec, degradation,
                                rounds_to_recover, wrap_mixer)

__all__ = [
    "Registry", "UnknownEntryError", "MIXERS", "MECHANISMS", "LOCAL_RULES",
    "CLIPPERS", "STREAMS", "BACKENDS",
    "Mixer", "MixerBase", "DenseMatrixMixer", "SparseMixer", "RingRollMixer",
    "CompleteMixer", "DisconnectedMixer", "AlternatingRingMixer",
    "DelayedMixer", "HeterogeneousDelayMixer", "ring_read", "ring_write",
    "sample_edge_delays",
    "Mechanism", "LaplaceMechanism", "GaussianMechanism", "NoNoise",
    "LocalRule", "StepContext", "OMDLassoRule", "TruncatedGradientRule",
    "RDARule",
    "Clipper", "PerNodeL2Clipper", "ValueClipper", "NoClipper",
    "per_node_norms",
    "Stream", "SocialStream", "DriftStream", "HeterogeneousStream",
    "BurstyStream",
    "RunSpec", "ExecConfig", "RunResult", "run", "run_batch",
    "seed_vectorizable", "make_chunk_program",
    "ReferenceBackend", "CudaBackend",
    "GossipDP", "GossipState", "gossip_mix_tree", "per_node_clip", "ops",
    "FAULTS", "FaultSpec", "wrap_mixer", "degradation", "rounds_to_recover",
]
