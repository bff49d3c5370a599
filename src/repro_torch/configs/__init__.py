"""Architecture registry of the port: ``--arch <id>`` resolution.

Each module exports CONFIG (the published dimensions) and SMOKE (a reduced
same-family config for CPU tests).  Only the archs whose layout the port
carries resolve; the JAX package's other archs raise and point at
ROADMAP.md, where their port is queued.
"""
from __future__ import annotations

import importlib

ARCHS = ["qwen3-4b", "mamba2-1.3b", "zamba2-7b", "deepseek-moe-16b",
         "grok-1-314b", "firefly-snn"]
# the JAX package's other LM archs, in ROADMAP order
PENDING = ["qwen2-72b", "internlm2-20b", "qwen1.5-32b", "musicgen-medium",
           "pixtral-12b"]

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def _load(arch: str):
    if arch in PENDING:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (ROADMAP.md, "
            f"Queue 1 item 9); ported: {ARCHS}")
    if arch not in _MOD:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MOD[arch]}")


def get_config(arch: str):
    return _load(arch).CONFIG


def get_smoke(arch: str):
    return _load(arch).SMOKE
