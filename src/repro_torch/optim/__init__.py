"""Optimizer-side utilities of the port: the int8 compression that
`snn.quantize_state` uses to move a float session onto the weight grid."""
from repro_torch.optim.compression import compress_int8, decompress_int8

__all__ = ["compress_int8", "decompress_int8"]
