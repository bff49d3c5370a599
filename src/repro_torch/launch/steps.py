"""Step builders: the prefill and decode programs of the serving driver.

Each closes over a `ModelConfig` and resolves it through
`models.factory.build`:

    prefill(params, inputs)             -> (last_logits (B,V), cache)
    decode_step(params, cache, tokens)  -> (logits (B,V), cache)

and `n_active_params` counts the parameters a token touches.

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


def n_active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token: all of them for a dense model, the
    top-k of the routed experts for MoE; the input embedding gather (not
    a matmul) excluded, as the JAX package counts them."""
    total = factory.build(cfg).n_params()
    embed = cfg.vocab * cfg.d_model
    if cfg.moe is None:
        return total - embed
    m = cfg.moe
    expert_params = 3 * cfg.d_model * m.d_expert      # gate/up/down per expert
    n_moe_layers = cfg.n_layers - m.first_dense
    inactive = n_moe_layers * (m.num_experts - m.top_k) * expert_params
    return total - embed - inactive
