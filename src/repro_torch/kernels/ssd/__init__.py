from repro_torch.kernels.ssd.ops import ssd, ssd_decode_step

__all__ = ["ssd", "ssd_decode_step"]
