"""Observability: in-band fleet telemetry and host metrics.

  * `obs.telemetry` — DEVICE-side per-slot fleet telemetry (spike rate,
    mean |dw|, membrane saturation, occupancy) computed inside the fused
    dual-engine kernels as extra reduced outputs (a ``telemetry=`` variant
    of `engine.layer_step` / `engine.rollout` and the scheduler).
  * `obs.metrics`   — HOST-side counters/gauges/histograms with
    Prometheus-text and JSON snapshot exporters; the serving stack
    (SessionStore, SessionPool) records admit/evict/checkout latencies,
    warm-cache hits and occupancy into per-component registries.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, REGISTRY, phase,
                                     serve_metrics)
from repro_torch.obs.telemetry import (SAT_FRACTION, FleetTelemetry,
                                       record_fleet_telemetry,
                                       sat_threshold, sat_threshold_q)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY", "phase",
    "serve_metrics", "SAT_FRACTION", "FleetTelemetry",
    "record_fleet_telemetry", "sat_threshold", "sat_threshold_q",
]
