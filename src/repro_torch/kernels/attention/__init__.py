from repro_torch.kernels.attention.ops import attention

__all__ = ["attention"]
