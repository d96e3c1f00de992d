"""Fabric observability: causal ticket tracing + unified metrics.

Two halves, both zero-cost when unused:

  * :mod:`repro.obs.trace` — :class:`Tracer`, a virtual-clock-friendly
    span recorder for the full ticket lifecycle (enqueue → shard-route →
    lease → wire transfer → client execute → submit → barrier fold),
    exporting Chrome trace-event JSON that Perfetto / ``chrome://tracing``
    loads directly.  Every instrumented constructor takes ``tracer=None``
    and every call site is guarded by a single ``is not None`` check —
    the disabled path costs one attribute test.
  * :mod:`repro.obs.metrics` — :class:`MetricsRegistry` with labelled
    counters/gauges/histograms under the linted ``subsystem.noun_unit``
    naming convention, and :mod:`repro.obs.collect` collectors that
    absorb the fabric's legacy telemetry into it at snapshot time.

On top of them sits the **fleet telemetry plane** (PR 10):

  * :mod:`repro.obs.fleet` — :class:`FleetAggregator`, the server-side
    sink for remote clients' ``telemetry`` wire batches: per-client
    metric series under a ``client=`` label, span buffers remapped to
    server time via heartbeat-echo clock-skew estimation, and a merged
    one-timeline Perfetto export.
  * :mod:`repro.obs.slo` — declarative :class:`Slo` thresholds over a
    registry, evaluated per round by :class:`SloMonitor` (breaches emit
    ``slo.breach`` instants and gate CI in ``benchmarks/run.py``).
  * The :class:`Tracer` flight recorder — ring-buffer mode plus
    :meth:`Tracer.dump_on` triggers that write a bounded Perfetto file
    the moment a failure instant (stall, eviction, busy storm) fires.

See ``docs/ARCHITECTURE.md`` §Observability for the span taxonomy,
fleet-plane topology, and metric catalog.
"""
from repro_torch.obs.collect import (collect_edge, collect_fabric,
                               collect_federation, collect_fleet,
                               collect_origin, collect_queue,
                               collect_transport)
from repro_torch.obs.fleet import ClockSkew, FleetAggregator
from repro_torch.obs.metrics import (METRIC_NAME_RE, UNITS, Counter, Gauge,
                               Histogram, MetricsRegistry,
                               valid_metric_name)
from repro_torch.obs.slo import DEFAULT_ROUND_SLOS, Slo, SloMonitor
from repro_torch.obs.trace import Tracer, render_chrome_trace

__all__ = [
    "ClockSkew", "Counter", "DEFAULT_ROUND_SLOS", "FleetAggregator",
    "Gauge", "Histogram", "METRIC_NAME_RE", "MetricsRegistry", "Slo",
    "SloMonitor", "Tracer", "UNITS", "collect_edge", "collect_fabric",
    "collect_federation", "collect_fleet", "collect_origin",
    "collect_queue", "collect_transport", "render_chrome_trace",
    "valid_metric_name",
]
