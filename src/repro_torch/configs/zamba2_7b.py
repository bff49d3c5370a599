"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64; Mamba2 backbone + SHARED attention block.  [arXiv:2411.15242]

Mapped to the `hybrid` layout: 81 layers = 9 super-blocks x (1 shared
attention+MLP block + 8 Mamba2 blocks).  The attention/MLP parameters are
shared across super-blocks (stored once at top level), as Zamba2's global
block is; ssm_state=64, mamba head_dim=64, attention heads 3584 / 32 = 112
wide.  The same dimensions as the JAX package's config, field for field."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    layout="hybrid", sub_quadratic=True,
    ssm=SSMConfig(state=64, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=256, attn_every=9),
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512,
    layout="hybrid", sub_quadratic=True,
    ssm=SSMConfig(state=16, head_dim=16, expand=2, n_groups=1,
                  conv_width=4, chunk=16, attn_every=3),
    remat=False,
)
