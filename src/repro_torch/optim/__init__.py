"""Optimizers of the port.

  adamw / sgd      — init/update pairs over trees of tensors, in place
  schedules        — warmup-cosine, linear warmup, constant
  clip_by_global_norm / global_norm
  compression      — the int8 compression that `snn.quantize_state` uses
                     to move a float session onto the weight grid
"""
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.optimizers import (OptState, adamw,
                                          clip_by_global_norm, global_norm,
                                          sgd)
from repro_torch.optim.schedules import constant, linear_warmup, \
    warmup_cosine

__all__ = ["OptState", "adamw", "sgd", "clip_by_global_norm", "global_norm",
           "constant", "linear_warmup", "warmup_cosine",
           "compress_int8", "decompress_int8"]
