"""repro_torch.configs — the registry of `repro.configs`.

The paper's own workload, `social_linear` (``PAPER_WORKLOAD``), is ported.
The assigned LM architectures (``ARCH_IDS``) are the LM stack, ROADMAP
queue 1 item 5: their ids are listed as the reference lists them, and
``get_config`` of one raises naming that item.

>>> get_config(PAPER_WORKLOAD).nodes
64
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
    """The config of ``arch_id``: `social_linear.CONFIG` for the paper's
    workload; an LM architecture raises NotImplementedError."""
    if arch_id in ARCH_IDS:
        raise NotImplementedError(
            f"the LM architecture {arch_id!r} is not ported yet (ROADMAP "
            "queue 1 item 5); the port runs the paper's workload, "
            f"{PAPER_WORKLOAD!r}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_')}")
    return mod.CONFIG


def all_configs() -> dict:
    """Every assigned architecture's config — the LM stack, so this raises
    NotImplementedError naming ROADMAP queue 1 item 5."""
    return {a: get_config(a) for a in ARCH_IDS}
