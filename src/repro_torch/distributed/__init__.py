"""Fault tolerance of the port's training loop (one card: no mesh).

  ft — NaN/inf sentinel with rollback to the last good checkpoint (the
       poisoned batch skipped), straggler monitor, resume from the latest
       checkpoint, counters in an `obs.MetricsRegistry`
"""
from repro_torch.distributed import ft
from repro_torch.distributed.ft import (FaultTolerantRunner,
                                        StragglerMonitor, loss_is_bad)

__all__ = ["ft", "FaultTolerantRunner", "StragglerMonitor", "loss_is_bad"]
