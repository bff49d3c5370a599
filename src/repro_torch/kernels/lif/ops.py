"""Public entry of the Forward Engine kernel (the backend follows the
tensors' device; see `kernel.lif_forward`)."""
from repro_torch.kernels.lif.kernel import lif_forward

__all__ = ["lif_forward"]
