"""Observability: in-band fleet telemetry, host metrics, recompile watchdog,
and the session-health subsystem.

  * `obs.telemetry` — DEVICE-side per-slot fleet telemetry (spike rate,
    mean |dw|, membrane saturation, occupancy) computed inside the fused
    dual-engine kernels as extra reduced outputs (a ``telemetry=`` variant
    of `engine.layer_step` / `engine.rollout` and the scheduler).
  * `obs.metrics`   — HOST-side counters/gauges/histograms with
    Prometheus-text and JSON snapshot exporters; the serving stack
    (SessionStore, SessionPool) records admit/evict/checkout latencies,
    warm-cache hits and occupancy into per-component registries.
  * `obs.watchdog`  — the RECOMPILE WATCHDOG: after warm-up, a new static
    signature of a pool entry point or a newly loaded kernel library is
    reported by name while armed.
  * `obs.recorder`  — the device-side FLIGHT RECORDER: a ``(B, W, C)``
    ring of per-slot channels written by the schedulers' ``record=``
    variants (one fused launch on the card, ``csrc/recorder.cu``), the
    lockstep serve loop's `AdapterFlightRecorder`, and the incident dump
    exporter.
  * `obs.health`    — streaming anomaly detectors over the channels (EWMA
    z-score, absolute bound, stuck-at, dead-session) with per-detector
    hysteresis and latched flags; the schedulers' `remediate()` turns the
    verdict into quarantine -> `SessionStore` rollback -> re-admit.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, REGISTRY, phase,
                                     serve_metrics)
from repro_torch.obs.telemetry import (SAT_FRACTION, FleetTelemetry,
                                       adapter_telemetry,
                                       record_fleet_telemetry,
                                       sat_threshold, sat_threshold_q)
from repro_torch.obs.health import (CHANNELS, DETECTORS, HealthConfig,
                                    HealthState, health_update, init_health)
from repro_torch.obs.watchdog import RecompileWatchdog, watchdog
from repro_torch.obs.recorder import (AdapterFlightRecorder, RecorderState,
                                      adapter_weight_norm, dump_incident,
                                      init_recorder, network_weight_norm,
                                      record_step, recorder_update,
                                      reset_slot, unroll_ring)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY", "phase",
    "serve_metrics", "SAT_FRACTION", "FleetTelemetry", "adapter_telemetry",
    "record_fleet_telemetry", "sat_threshold", "sat_threshold_q",
    "RecompileWatchdog", "watchdog",
    "CHANNELS", "DETECTORS", "HealthConfig", "HealthState", "health_update",
    "init_health",
    "AdapterFlightRecorder", "RecorderState", "adapter_weight_norm",
    "dump_incident", "init_recorder",
    "network_weight_norm", "record_step", "recorder_update", "reset_slot",
    "unroll_ring",
]
