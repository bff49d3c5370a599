"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

  plasticity — fused dual-engine steps (fleet and shared weights, float32
               and fixed point) and the time-fused rollout window
  lif        — psum-stationary product + LIF + trace (Forward Engine)
  attention  — causal GQA flash attention (LM prefill)
  ssd        — the Mamba2 chunked SSD scan (LM prefill) and its decode step
"""
from repro_torch.kernels.lif import lif_forward

__all__ = ["lif_forward"]
