"""repro_torch.core — the paper's contribution (private distributed online
learning) on torch tensors; counterpart of `repro.core`.

Modules:
  graph      — communication topologies + doubly-stochastic mixing matrices
  privacy    — Laplace mechanism, Lemma-1 sensitivity, clipping, accountant
  prox       — L1 / group / elastic-net proximal operators (Lasso step)
  omd        — online mirror descent local optimizer
  algorithm1 — the m-node simulator of the paper's Algorithm 1
  gossip     — the distributed GossipDP strategy
  regret     — Definition-3 regret measurement + Theorem-2 bound
  tree       — pytrees of tensors in JAX's leaf order

Both engines are thin compositions over the `repro_torch.api` protocol
layer; build them declaratively with `repro_torch.api.RunSpec`.
"""
import importlib

from repro_torch.core.graph import GossipGraph
from repro_torch.core.omd import OMDConfig, OnlineMirrorDescent
from repro_torch.core.privacy import PrivacyConfig, PrivacyAccountant

# The engines compose `repro_torch.api` stages, and `api.mixers` imports
# `core.graph` — so they load on first use, not with the package.
_ENGINES = {"GossipDP": "gossip", "GossipState": "gossip",
            "Algorithm1": "algorithm1"}

__all__ = [
    "GossipGraph",
    "OMDConfig",
    "OnlineMirrorDescent",
    "PrivacyConfig",
    "PrivacyAccountant",
    "GossipDP",
    "GossipState",
    "Algorithm1",
]


def __getattr__(name: str):
    if name in _ENGINES:
        module = importlib.import_module(f"repro_torch.core.{_ENGINES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")
