"""pixtral-12b [vlm] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072; pixtral-ViT frontend + mistral-nemo decoder.  The same
dimensions as the JAX package's config, field for field.

Backbone only: the ViT patch encoder is a stub, so prefill takes patch or
text embeddings (``input_mode="embeddings"``, (B, S, d_model)); decode
feeds tokens through the embedding table, as in the JAX package."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=131072, head_dim=128,
    rope_theta=1_000_000.0,
    layout="dense", input_mode="embeddings",
)

SMOKE = ModelConfig(
    name="pixtral-12b-smoke",
    n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
    d_ff=256, vocab=512, head_dim=32,
    layout="dense", input_mode="embeddings",
    remat=False,
)
