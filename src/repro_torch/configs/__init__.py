"""repro_torch.configs — the registry of `repro.configs`.

One module per assigned architecture (``ARCH_IDS``), each the reference's
exact published numbers as a `repro_torch.models.ModelConfig`;
``get_config(id).reduced()`` gives the CPU smoke-test variant of the same
family. The paper's own workload, `social_linear` (``PAPER_WORKLOAD``), is
the linear model the figures run.

>>> get_config(PAPER_WORKLOAD).nodes
64
>>> get_config("qwen2-7b").d_model
3584
"""
from __future__ import annotations

import importlib

__all__ = ["ARCH_IDS", "PAPER_WORKLOAD", "get_config", "all_configs"]

ARCH_IDS = [
    "rwkv6-3b",
    "recurrentgemma-2b",
    "mixtral-8x7b",
    "qwen2-vl-2b",
    "llama4-scout-17b-a16e",
    "qwen2-7b",
    "minicpm-2b",
    "seamless-m4t-medium",
    "internlm2-20b",
    "qwen3-32b",
]

# the paper's own workload (not a transformer): configs.social_linear
PAPER_WORKLOAD = "social-linear"


def get_config(arch_id: str):
    """The config of ``arch_id``: a `ModelConfig` for an LM architecture,
    `social_linear.CONFIG` for the paper's workload."""
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def all_configs() -> dict:
    """Every assigned architecture's config, by id."""
    return {a: get_config(a) for a in ARCH_IDS}
