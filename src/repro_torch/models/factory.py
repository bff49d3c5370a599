"""Config-driven model factory: one surface over the LM stack.

`build(arch_or_cfg)` turns a `ModelConfig` into a `Model` whose entry
points (`init` / `forward` / `prefill` / `decode_step` / `init_cache`) are
what `launch/steps.py` and `launch/serve.py` consume; callers never import
`models.transformer` directly.  The serving-pool plumbing of the JAX
package's factory waits for the port of ``serving.lm.LMScheduler``.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

_LAYOUTS = ("dense", "moe", "ssm", "hybrid")


def _validate(cfg: ModelConfig) -> None:
    if not isinstance(cfg, ModelConfig):
        raise TypeError(
            f"factory.build needs a ModelConfig (an LM backbone); got "
            f"{type(cfg).__name__}.  The 'firefly-snn' arch is the paper's "
            "SNN controller (core.snn.SNNConfig), not an LM.")
    if cfg.layout not in _LAYOUTS:
        raise ValueError(f"unknown layout {cfg.layout!r}; expected one of "
                         f"{_LAYOUTS}")
    T.segments(cfg)               # raises for the layouts not ported yet
    if cfg.plastic_adapter and cfg.adapter_neurons < 1:
        raise ValueError(f"{cfg.name}: plastic_adapter needs "
                         f"adapter_neurons >= 1")


class Model:
    """A `ModelConfig` bound to every entry point the stack consumes; each
    method forwards to `models.transformer`."""

    def __init__(self, cfg: ModelConfig):
        _validate(cfg)
        self.cfg = cfg

    def init(self, generator: torch.Generator):
        """Random parameters on the generator's device."""
        return T.init(self.cfg, generator)

    def n_params(self) -> int:
        return T.n_params(self.cfg)

    def forward(self, params, inputs, **kw):
        return T.forward(params, inputs, self.cfg, **kw)

    def prefill(self, params, inputs, max_len: int):
        return T.prefill(params, inputs, self.cfg, max_len)

    def decode_step(self, params, cache, tokens):
        return T.decode_step(params, cache, tokens, self.cfg)

    def init_cache(self, batch: int, max_len: int, device=None):
        return T.init_cache(self.cfg, batch, max_len, device)


def build(arch_or_cfg: Union[str, ModelConfig], smoke: bool = False,
          **overrides) -> Model:
    """Resolve an arch id (or pass a ModelConfig through), apply
    `ModelConfig.with_` overrides, validate, and bind."""
    if isinstance(arch_or_cfg, str):
        cfg = get_smoke(arch_or_cfg) if smoke else get_config(arch_or_cfg)
    else:
        cfg = arch_or_cfg
    if not isinstance(cfg, ModelConfig):
        _validate(cfg)                    # the informative TypeError
    if overrides:
        cfg = cfg.with_(**overrides)
    return Model(cfg)
