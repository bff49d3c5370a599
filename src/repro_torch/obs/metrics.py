"""Host-side metrics: counters/gauges/histograms + Prometheus/JSON export.

A deliberately small, dependency-free registry (the container bakes no
prometheus_client) with the exposition semantics monitoring stacks expect:

  * `Counter`   — monotonically increasing total (``_total`` suffix by
    convention): admissions, evictions, warm-cache hits, restores.
  * `Gauge`     — point-in-time value: pool occupancy, tokens/s, the fleet
    telemetry means.
  * `Histogram` — cumulative le-buckets + sum/count (Prometheus histogram
    exposition) plus a bounded reservoir of raw observations so the
    benchmarks can report true p50s: admit/evict/checkout/restore/decode
    latencies.

Every serving component owns a `MetricsRegistry` (SessionStore, each
SessionPool) rather than mutating a process-global singleton, so two pools
in one process never alias counters; `REGISTRY` exists as the default for
one-off scripts.  Exporters: `prometheus_text()` (text exposition format)
and `snapshot()` (JSON-able dict).  Metric names, bucket edges and both
export formats are those of the JAX package's ``obs.metrics``: a schema.

`phase(name)` annotates a host-side serving phase (admit, swap-in/out, pool
step) with `torch.profiler.record_function`, so a `torch.profiler` trace
attributes time to scheduling events.

`serve_metrics(registry, port)` exposes a registry over stdlib
`http.server` for scraping: every metric holds its own lock across its full
export, so a scrape racing the serving thread always sees a consistent
(count, sum, buckets) triple.
"""
from __future__ import annotations

import json
import math
import threading
import time
from contextlib import contextmanager
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, Optional

# Default le-buckets: 100 us .. ~100 s in half-decade steps — spans warm
# admissions (sub-ms), disk restores (ms..tens of ms), and decode windows.
DEFAULT_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1,
                   1.0, 3.0, 10.0, 30.0, 100.0)
_RESERVOIR = 4096      # raw observations kept per histogram (for percentiles)


class Counter:
    """Monotonic counter (increase-only)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: cannot decrease "
                             f"(inc({amount}))")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Point-in-time value (set/add)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Cumulative-bucket histogram + bounded raw reservoir for percentiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._raw: list = []
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            i = 0
            while i < len(self.buckets) and value > self.buckets[i]:
                i += 1
            self._counts[i] += 1
            self._sum += value
            self._count += 1
            if len(self._raw) < _RESERVOIR:
                self._raw.append(value)

    @contextmanager
    def time(self):
        """Observe the wall-clock duration of the with-block (seconds)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def _export(self) -> tuple:
        """One consistent (counts, sum, count, raw) copy under the lock —
        the only way readers see this histogram, so a scrape racing
        `observe` never mixes a new count with an old sum."""
        with self._lock:
            return list(self._counts), self._sum, self._count, \
                list(self._raw)

    @staticmethod
    def _pct(raw: list, p: float) -> float:
        if not raw:
            return 0.0
        s = sorted(raw)
        k = min(len(s) - 1, max(0, int(math.ceil(p / 100.0 * len(s))) - 1))
        return s[k]

    @property
    def count(self) -> int:
        return self._export()[2]

    @property
    def sum(self) -> float:
        return self._export()[1]

    @property
    def mean(self) -> float:
        _, tot, n, _ = self._export()
        return tot / n if n else 0.0

    def percentile(self, p: float) -> float:
        """p in [0, 100] from the raw reservoir (exact while it fits)."""
        return self._pct(self._export()[3], p)

    def snapshot(self) -> dict:
        counts, tot, n, raw = self._export()
        cum, out = 0, {}
        for le, c in zip(self.buckets, counts):
            cum += c
            out[f"{le:g}"] = cum
        return {"type": self.kind, "count": n, "sum": tot,
                "mean": tot / n if n else 0.0, "p50": self._pct(raw, 50),
                "p99": self._pct(raw, 99), "buckets": out}


class MetricsRegistry:
    """Get-or-create registry of named metrics with stable export schema."""

    def __init__(self, namespace: str = ""):
        self.namespace = namespace
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def timer(self, name: str, help: str = ""):
        """Context manager timing the with-block into histogram `name`."""
        return self.histogram(name, help).time()

    # ---- export ----------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able {metric name -> typed snapshot} (stable schema)."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.snapshot() for m in metrics}

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (histograms as le-buckets)."""
        with self._lock:
            metrics = list(self._metrics.values())
        lines = []
        for m in sorted(metrics, key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                counts, tot, n, _ = m._export()
                cum = 0
                for le, c in zip(m.buckets, counts):
                    cum += c
                    lines.append(f'{m.name}_bucket{{le="{le:g}"}} {cum}')
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {n}')
                lines.append(f"{m.name}_sum {tot:g}")
                lines.append(f"{m.name}_count {n}")
            else:
                lines.append(f"{m.name} {m.value:g}")
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()     # default registry for one-off scripts


@contextmanager
def phase(name: str, histogram: Optional[Histogram] = None):
    """Annotate a serving phase for profilers (+ optional latency record).

    Wraps the block in `torch.profiler.record_function(name)`, so a
    `torch.profiler` trace names the scheduling events (admit, swap-in/out,
    pool step, decode window) on its timeline; if a `Histogram` is given
    the block's wall-clock duration is observed into it.
    """
    from torch.profiler import record_function
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        if histogram is not None:
            histogram.observe(time.perf_counter() - t0)


# ---- scrape endpoint --------------------------------------------------------


def serve_metrics(registry: MetricsRegistry, port: int = 0,
                  host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """Expose `registry` over HTTP on a daemon thread; returns the server.

    ``GET /metrics`` (or ``/``) serves `prometheus_text()`; ``GET
    /metrics.json`` serves the JSON `snapshot()`.  ``port=0`` binds an
    ephemeral port — read it back from ``server.server_address[1]``.  The
    thread is a daemon and never blocks shutdown; call ``server.shutdown()``
    for a deterministic stop (tests do).
    """

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):                          # noqa: N802 (stdlib API)
            path = self.path.split("?", 1)[0]
            if path in ("/", "/metrics"):
                body = registry.prometheus_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps(registry.snapshot(), sort_keys=True,
                                  indent=1).encode()
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):              # silence per-request spam
            pass

    server = ThreadingHTTPServer((host, int(port)), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="metrics-http", daemon=True)
    thread.start()
    return server
