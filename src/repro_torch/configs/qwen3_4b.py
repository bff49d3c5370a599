"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936; qk_norm, GQA, head_dim=128 (decoupled from d_model/H).
The same dimensions as the JAX package's config, field for field."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=9728, vocab=151936, head_dim=128,
    qk_norm=True, rope_theta=1_000_000.0,
    layout="dense",
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=64,       # head_dim != d_model/H, as in full
    qk_norm=True, rope_theta=1_000_000.0,
    layout="dense",
    remat=False,
)
