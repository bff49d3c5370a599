"""Deterministic data of the port (nothing is downloaded).

  tokens — procedural LM token pipeline: seeded, restartable (a batch is a
           pure function of seed, step and shard), per-host sharded
  mnist  — procedural 28x28 digits + Poisson-rate spike encoding (the
           Table II stand-in; accuracy not comparable, the protocol is)
"""
from repro_torch.data.mnist import (draw_jitter, mnist_batch, render,
                                    render_digit, spike_encode,
                                    spikes_from_uniform)
from repro_torch.data.tokens import (TokenPipelineConfig, batch_at_step,
                                     host_batch)

__all__ = ["TokenPipelineConfig", "batch_at_step", "host_batch",
           "draw_jitter", "mnist_batch", "render", "render_digit",
           "spike_encode", "spikes_from_uniform"]
