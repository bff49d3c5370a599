from repro_torch.kernels.lif.ops import lif_forward

__all__ = ["lif_forward"]
