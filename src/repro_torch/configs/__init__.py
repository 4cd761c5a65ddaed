"""Architecture registry of the port: ``--arch <id>`` → ModelConfig.

The same ids as the reference's ``repro.configs``, all ten ported
(``attn``, ``moe``, ``mla_dense``, ``mla_moe``, ``rwkv6`` and ``mamba2``
blocks with zamba2's shared attention block, M-RoPE and patch
embeddings, musicgen-medium's codebooks).  Each architecture has its own
module with ``config()`` (the published hyper-parameters) and
``smoke_config()`` (a reduced same-family variant for CPU tests).
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = (
    "rwkv6-1.6b",
    "mistral-nemo-12b",
    "nemotron-4-15b",
    "zamba2-1.2b",
    "mixtral-8x7b",
    "yi-6b",
    "qwen2-vl-7b",
    "musicgen-medium",
    "h2o-danube-3-4b",
    "deepseek-v2-236b",
)


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = arch_id.replace("-", "_").replace(".", "p")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str, **overrides) -> ModelConfig:
    cfg = _module(arch_id).config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(arch_id: str, **overrides) -> ModelConfig:
    cfg = _module(arch_id).smoke_config()
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
