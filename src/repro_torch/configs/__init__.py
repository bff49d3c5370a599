"""Architecture registry of the port: ``--arch <id>`` resolution.

Each module exports CONFIG (the published dimensions) and SMOKE (a reduced
same-family config for CPU tests), field for field the JAX package's.
`ARCHS` lists every selectable id: the ten LM archs and the paper's own
SNN controller.
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen2-72b", "internlm2-20b", "qwen3-4b", "qwen1.5-32b",
         "zamba2-7b", "deepseek-moe-16b", "grok-1-314b", "musicgen-medium",
         "pixtral-12b", "mamba2-1.3b", "firefly-snn"]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _load(arch: str):
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")


def get_config(arch: str):
    return _load(arch).CONFIG


def get_smoke(arch: str):
    return _load(arch).SMOKE
