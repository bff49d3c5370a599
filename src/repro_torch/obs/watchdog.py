"""Recompile watchdog: "nothing new after warm-up" as a runtime monitor.

The JAX package's watchdog listens for XLA compiles.  The port compiles
nothing at serve time, so it watches the two events that take their place:

  * **a new static signature of a pool entry point** — a session pool
    dispatching an entry point with operand shapes, dtypes, device or flags
    it has not seen (`serving.scheduler.SessionPool._dispatch`; named
    ``"<Class>.<entry point>"``, e.g. ``"FleetScheduler.pool_rollout"``);
  * **a kernel library loaded for the first time** in this process
    (`kernels._build.library`; named ``"library:<source>"``).

After warm-up either one means a shape drifted, a flag leaked into a
signature or a new entry point was hit, and the watchdog reports it with
the offending name while it is armed.  It is a process-wide singleton
(`obs.watchdog.watchdog`), silent until `install()`, and `install()` is
idempotent.

Usage:

    watchdog.install()
    ... warm-up: admit sessions, run one step per entry point ...
    with watchdog.armed():
        serve()                     # any new signature -> warning + counter
    assert watchdog.violations == 0, watchdog.violation_signatures
"""
from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from typing import List, Optional

from repro_torch.kernels import _build


class RecompileWatchdog:
    """Singleton compile monitor: count compiles, flag them while armed."""

    def __init__(self):
        self._installed = False
        self._armed = 0                 # re-entrant arm depth
        self._lock = threading.Lock()
        self.compiles = 0               # all compiles since install
        self.violations = 0             # compiles observed while armed
        self.violation_signatures: List[str] = []
        self.last_signature: Optional[str] = None
        self._registry = None
        self._log = logging.getLogger("repro_torch.obs.watchdog")

    # ---- installation ----------------------------------------------------

    def install(self, registry=None) -> "RecompileWatchdog":
        """Start listening.  Idempotent; an optional metrics registry gets
        `compiles_total` / `recompiles_after_warmup_total` counters."""
        if registry is not None:
            self._registry = registry
        self._installed = True
        if self.notify not in _build.load_listeners:
            _build.load_listeners.append(self.notify)
        return self

    # ---- arming ----------------------------------------------------------

    def arm(self) -> None:
        """Enter the no-recompile regime (re-entrant)."""
        with self._lock:
            self._armed += 1

    def disarm(self) -> None:
        with self._lock:
            self._armed = max(0, self._armed - 1)

    @property
    def is_armed(self) -> bool:
        return self._armed > 0

    @contextmanager
    def armed(self):
        """Context manager: compiles inside the block are violations."""
        self.arm()
        try:
            yield self
        finally:
            self.disarm()

    def reset(self) -> None:
        """Clear counts (keeps installation and arm depth)."""
        with self._lock:
            self.compiles = 0
            self.violations = 0
            self.violation_signatures = []
            self.last_signature = None

    # ---- the listener ----------------------------------------------------

    def notify(self, name: str) -> None:
        """One compile event named `name` (a new pool signature or a first
        library load); ignored until `install()`."""
        if not self._installed:
            return
        with self._lock:
            self.compiles += 1
            self.last_signature = name
            armed = self._armed > 0
            if armed:
                self.violations += 1
                self.violation_signatures.append(name)
        if self._registry is not None:
            self._registry.counter(
                "compiles_total", "backend compiles since install").inc()
        if armed:
            if self._registry is not None:
                self._registry.counter(
                    "recompiles_after_warmup_total",
                    "compiles observed while the watchdog was armed").inc()
            self._log.warning(
                "recompile after warmup: %r (violation #%d) — a shape or "
                "static argument drifted", name, self.violations)


# Process-wide singleton (the hooks in the scheduler and the kernel loader
# report to this instance).
watchdog = RecompileWatchdog()
