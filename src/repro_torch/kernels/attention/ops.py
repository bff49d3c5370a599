"""Public entry of the attention kernel: ``attention(q, k, v, causal=,
scale=, kv_len=)``, q (B,Sq,H,D) and k/v (B,Skv,HKV,D) -> (B,Sq,H,D) in q's
dtype.  The backend follows the tensors' device: a CUDA tensor launches
``csrc/flash_attention.cu``, a CPU tensor takes its plain version (see
`kernel.flash_attention`, whose launch counter this shares)."""
from repro_torch.kernels.attention.kernel import flash_attention as attention

__all__ = ["attention"]
