"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072; 8 experts top-2.  [hf:xai-org/grok-1]
The same dimensions as the JAX package's config, field for field; at full
width it does not fit one card (316.5 B parameters), so the port serves it
at SMOKE scale and checks the full plan without allocating it."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    layout="moe",
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768, n_shared=0,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="grok-1-314b-smoke",
    n_layers=2, d_model=96, n_heads=6, n_kv_heads=1,
    d_ff=192, vocab=512,
    layout="moe",
    moe=MoEConfig(num_experts=4, top_k=2, d_expert=192, n_shared=0,
                  capacity_factor=1.25),
    remat=False,
)
