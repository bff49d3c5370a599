"""mamba2-1.3b [ssm] — 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060]
The same dimensions as the JAX package's config, field for field (its
untied head too: the published model ties its embeddings, ROADMAP.md
Queue 3)."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    layout="ssm", sub_quadratic=True,
    ssm=SSMConfig(state=128, head_dim=64, expand=2, n_groups=1,
                  conv_width=4, chunk=256),
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=509,          # odd vocab, as in full (50280 % 16 != 0)
    layout="ssm", sub_quadratic=True,
    ssm=SSMConfig(state=16, head_dim=16, expand=2, n_groups=1,
                  conv_width=4, chunk=16),
    remat=False,
)
