"""Model configuration of the LM stack (the fields of ``repro``'s
`ModelConfig` that describe a model; backend selectors are gone: the
backend follows the tensors.  ``act_shard`` stays, a no-op on one card),
and the input shapes assigned to the LM fleet (`SHAPES`).

`ModelConfig` keeps the JAX package's names and defaults, so the same
config describes the same model in both packages; ``dtype`` stays a string
and `ModelConfig.adtype` turns it into a torch dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int32": torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    """A dtype name as the JAX package writes it -> the torch dtype."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    n_shared: int = 0             # always-on shared experts (deepseek-moe)
    first_dense: int = 0          # leading dense layers
    first_dense_ff: int = 0       # their FFN width
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 128              # S — state dimension per head
    head_dim: int = 64            # P — channels per head
    expand: int = 2               # d_inner = expand * d_model
    n_groups: int = 1             # B/C projection groups
    conv_width: int = 4           # short causal conv
    chunk: int = 256              # SSD chunk length
    attn_every: int = 0           # hybrid: shared attn block every N blocks

    def n_heads(self, d_model: int) -> int:
        return (self.expand * d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                  # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    layout: str = "dense"         # dense | moe | ssm | hybrid
    input_mode: str = "tokens"    # tokens | embeddings (stub frontend)
    sub_quadratic: bool = False   # eligible for long_500k
    # plastic adapter (the paper's technique as an LM serving feature)
    plastic_adapter: bool = False
    adapter_neurons: int = 512
    adapter_quant: bool = False   # fixed-point adapter: int8 W_fast with
                                  # per-slot scales, int32 membranes/traces
    kv_quant: bool = False        # int8 KV cache, float32 scale planes
    dtype: str = "bfloat16"       # activations/params storage
    remat: bool = True            # training: recompute each block in the
                                  # backward (`transformer.loss_fn`)
    # residual-stream activation sharding between blocks ("dp" | "sp");
    # kept so the configs and `launch.specs.TRAIN_SETUP` read as the JAX
    # package's, a no-op on one card
    act_shard: str = "dp"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else \
            self.d_model // max(self.n_heads, 1)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes assigned to the LM fleet (one set shared by all ten archs).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool,
                                                                    str]:
    """long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("skipped: pure full-attention arch — 524k dense-"
                       "attention KV decode is the quadratic regime the "
                       "shape spec excludes")
    return True, ""
