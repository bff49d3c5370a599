"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (kv=16) d_ff=1408 (expert
width) vocab=102400; 2 shared + 64 routed top-6, fine-grained; first layer
dense (d_ff=10944).  [arXiv:2401.06066; hf]
The same dimensions as the JAX package's config, field for field."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    rope_theta=10_000.0,
    layout="moe",
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  first_dense=1, first_dense_ff=10944,
                  capacity_factor=1.25),
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=96, vocab=512,
    layout="moe",
    moe=MoEConfig(num_experts=8, top_k=2, d_expert=96, n_shared=2,
                  first_dense=1, first_dense_ff=192,
                  capacity_factor=1.25),
    remat=False,
)
