"""The per-arch training launch setup: microbatches, activation sharding
and the optimizer's moment and accumulator dtypes, the JAX package's table
(which it sized against 16 GiB chips).  On one card ``act_shard`` is a
no-op the config carries.

The dry-run's abstract inputs of the JAX package (its ``ShapeDtypeStruct``
stand-ins with shardings) wait for ROADMAP Queue 1 item 10 (launch
analysis).
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

TRAIN_SETUP: dict[str, dict] = {
    "qwen2-72b":        dict(microbatches=2, act_shard="sp"),
    "qwen1.5-32b":      dict(microbatches=2, act_shard="sp"),
    "internlm2-20b":    dict(microbatches=2, act_shard="sp"),
    "grok-1-314b":      dict(microbatches=1, act_shard="sp",
                             moment_dtype="bfloat16",
                             accum_dtype="bfloat16"),
    "pixtral-12b":      dict(microbatches=2, act_shard="sp"),
    "qwen3-4b":         dict(microbatches=2),
    "deepseek-moe-16b": dict(microbatches=2),
    "musicgen-medium":  dict(microbatches=2),
    "zamba2-7b":        dict(microbatches=4),
    "mamba2-1.3b":      dict(microbatches=2),
}


def train_setup(arch: str) -> dict:
    return dict(TRAIN_SETUP.get(arch, {}))


def apply_setup(cfg: ModelConfig, setup: dict) -> ModelConfig:
    """Fold launch-level overrides that live on the ModelConfig."""
    if "act_shard" in setup:
        cfg = cfg.with_(act_shard=setup["act_shard"])
    return cfg
