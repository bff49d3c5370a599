"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens.  The same dimensions as the
JAX package's config, field for field.

Backbone only: the EnCodec frontend is a stub, so prefill takes frame
embeddings (``input_mode="embeddings"``, (B, S, d_model)); decode feeds
tokens through the embedding table, as in the JAX package."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab=2048,
    layout="dense", input_mode="embeddings",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=6,
    d_ff=192, vocab=128,
    layout="dense", input_mode="embeddings",
    remat=False,
)
