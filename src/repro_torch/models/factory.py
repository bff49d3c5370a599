"""Config-driven model factory: one surface over the LM stack.

`build(arch_or_cfg)` turns a `ModelConfig` into a `Model` whose entry
points (`init` / `forward` / `loss_fn` / `prefill` / `decode_step` /
`decode_rollout` / the cache plans) are what `launch/steps.py`,
`launch/serve.py` and `serving.lm.LMScheduler` consume; callers never import
`models.transformer` directly.

The factory also owns the serving pool's plumbing (`serving.scheduler`):
which axis of each decode-cache leaf carries the slot rows (`cache_axes`,
found structurally, so that a zsuper's stacked inner caches get axis 2
without a table), a pooled cache with per-slot sequence indices
(`pool_cache`), and the B = 1 prefill -> session row conversion
(`session_from_prefill`) that makes admitting a freshly prefilled stream
one slot copy.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.configs import get_config, get_smoke
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.layers import ParamDesc, leaves, map_plan

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
    if cfg.plastic_adapter and cfg.adapter_neurons < 1:
        raise ValueError(f"{cfg.name}: plastic_adapter needs "
                         f"adapter_neurons >= 1")


def _infer_axes(cfg: ModelConfig, max_len: int):
    """Per-leaf slot axis of the pooled decode cache, found structurally:
    the one axis whose extent follows the batch between two plans (so a
    zsuper's stacked inner SSM caches come out at axis 2)."""
    a = T.cache_plan(cfg, 2, max_len, per_slot_index=True)
    b = T.cache_plan(cfg, 3, max_len, per_slot_index=True)
    flat_b = iter(leaves(b))

    def one(da: ParamDesc):
        db = next(flat_b)
        diff = [i for i, (x, y) in enumerate(zip(da.shape, db.shape))
                if x != y]
        if len(diff) != 1:
            raise ValueError(
                f"cannot infer the slot axis of cache leaf {da.shape} vs "
                f"{db.shape}: expected exactly one batch-tracking axis, "
                f"found {diff}")
        return diff[0]

    return map_plan(one, a)


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

    def loss_fn(self, params, batch):
        return T.loss_fn(params, batch, self.cfg)

    def prefill(self, params, inputs, max_len: int):
        return T.prefill(params, inputs, self.cfg, max_len)

    def decode_step(self, params, cache, tokens, active=None):
        return T.decode_step(params, cache, tokens, self.cfg, active=active)

    def decode_rollout(self, params, cache, tokens, active=None):
        return T.decode_rollout(params, cache, tokens, self.cfg,
                                active=active)

    def cache_plan(self, batch: int, max_len: int,
                   per_slot_index: bool = False):
        return T.cache_plan(self.cfg, batch, max_len, per_slot_index)

    def init_cache(self, batch: int, max_len: int, device=None,
                   per_slot_index: bool = False):
        return T.init_cache(self.cfg, batch, max_len, device, per_slot_index)

    # ---- serving-pool plumbing (the SessionPool contract) -----------------

    def pool_cache(self, slots: int, max_len: int, device=None):
        """Zeroed pooled decode cache: per-slot ``(B,)`` sequence indices,
        one session row per slot in every leaf."""
        return T.init_cache(self.cfg, slots, max_len, device,
                            per_slot_index=True)

    def cache_axes(self, max_len: int):
        """The slot-axes tree of `pool_cache` (see `serving.scheduler`)."""
        return _infer_axes(self.cfg, max_len)

    def session_from_prefill(self, cache1):
        """A B = 1 prefill cache as one session row (the tree a
        `SessionPool` copies into a slot and a `SessionStore` persists):
        each leaf's slot axis dropped (views), the prefill's scalar index
        passed through as the session's position."""
        axes = _ckpt.flatten(self.cache_axes(1))[1]
        paths, leaves = _ckpt.flatten(cache1)
        out = []
        for path, leaf, ax in zip(paths, leaves, axes):
            if leaf.ndim == 0:                  # the scalar prefill index
                out.append(leaf)
            elif leaf.ndim > ax and leaf.shape[ax] == 1:
                out.append(leaf.squeeze(ax))
            else:
                raise ValueError(
                    f"session_from_prefill needs a batch = 1 cache; leaf "
                    f"{path} has shape {tuple(leaf.shape)} with slot axis "
                    f"{ax}")
        return _ckpt.unflatten(cache1, out)

    def session_template(self, max_len: int):
        """One session's cache as tensors on ``meta`` (shapes and dtypes,
        no storage): the `SessionStore` validation template of this pool
        layout."""
        plan = T.cache_plan(self.cfg, 1, max_len, per_slot_index=True)
        axes = iter(_ckpt.flatten(self.cache_axes(max_len))[1])

        def one(d: ParamDesc):
            ax = next(axes)
            shape = d.shape[:ax] + d.shape[ax + 1:]
            return torch.empty(shape, dtype=torch_dtype(d.dtype),
                               device="meta")
        return map_plan(one, plan)


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
