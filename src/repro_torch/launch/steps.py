"""Step builders: the prefill and decode programs of the serving driver.

Each closes over a `ModelConfig` and resolves it through
`models.factory.build`:

    prefill(params, inputs)             -> (last_logits (B,V), cache)
    decode_step(params, cache, tokens)  -> (logits (B,V), cache)

PyTorch runs eagerly, so these are plain closures where the JAX package
hands them to ``jax.jit``.
"""
from __future__ import annotations

from repro_torch.models import factory
from repro_torch.models.config import ModelConfig


def make_prefill(cfg: ModelConfig, max_len: int):
    model = factory.build(cfg)

    def prefill(params, inputs):
        return model.prefill(params, inputs, max_len)
    return prefill


def make_decode_step(cfg: ModelConfig):
    model = factory.build(cfg)

    def decode(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return decode
