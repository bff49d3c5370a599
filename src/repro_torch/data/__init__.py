"""Deterministic data of the port (nothing is downloaded).

  mnist — procedural 28x28 digits + Poisson-rate spike encoding (the
          Table II stand-in; accuracy not comparable, the protocol is)
"""
from repro_torch.data.mnist import (draw_jitter, mnist_batch, render,
                                    render_digit, spike_encode,
                                    spikes_from_uniform)

__all__ = ["draw_jitter", "mnist_batch", "render", "render_digit",
           "spike_encode", "spikes_from_uniform"]
