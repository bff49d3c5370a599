"""qwen1.5-32b [dense] — 64L d_model=5120 40H (MHA: kv=40) d_ff=27392
vocab=152064; QKV bias.  The same dimensions as the JAX package's config,
field for field: 40 KV heads of 128, so its bf16 cache is 1.31 MB a token
and its int8 cache (``kv_quant``) 0.68 MB."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    layout="dense",
)

SMOKE = ModelConfig(
    name="qwen1.5-32b-smoke",
    n_layers=2, d_model=120, n_heads=5, n_kv_heads=5,   # odd head count, as in full
    d_ff=256, vocab=512,
    qkv_bias=True, rope_theta=1_000_000.0,
    layout="dense",
    remat=False,
)
