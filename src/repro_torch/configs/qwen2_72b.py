"""qwen2-72b [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; GQA, QKV bias.  The same dimensions as the JAX package's
config, field for field.  ~145 GB in bf16: more than one card holds, so
the port runs it at smoke scale."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    layout="dense",
)

SMOKE = ModelConfig(
    name="qwen2-72b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512,
    qkv_bias=True, rope_theta=1_000_000.0,
    layout="dense",
    remat=False,
)
