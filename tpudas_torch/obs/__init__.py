"""tpudas_torch.obs — run introspection for the port's streaming stack.

The port's counterpart of :mod:`tpudas.obs`:

- :mod:`tpudas_torch.obs.registry` — process-wide metrics registry
  (counters / gauges / histograms with labels) with Prometheus text
  exposition, byte-equal to the JAX package's;
- :mod:`tpudas_torch.obs.trace` — ``span("name", **attrs)`` nested
  timed spans into a bounded ring buffer, span sinks, JSONL export via
  ``log_event``;
- :mod:`tpudas_torch.obs.health` — atomic ``health.json`` +
  ``metrics.prom`` snapshots the realtime runner drops beside the
  stream carry (``TPUDAS_HEALTH=1``);
- :mod:`tpudas_torch.obs.flight` — the crash-surviving flight recorder
  under ``.flight/`` (``TPUDAS_FLIGHT=0`` disables);
- :mod:`tpudas_torch.obs.phases` — the round-phase timeline
  (``tpudas_stream_round_phase_seconds{phase}``);
- :mod:`tpudas_torch.obs.collect` — the fleet rollup with per-stream
  freshness SLO status (``tpudas_torch.tools.obs_report``).

Kill switch: ``TPUDAS_OBS=0``.  Not ported yet: the device telemetry
(``tpudas.obs.devprof``).
"""

from tpudas_torch.obs.collect import (
    SLOPolicy,
    cluster_snapshot,
    fleet_rollup,
    slo_status,
)
from tpudas_torch.obs.flight import FlightRecorder, read_flight
from tpudas_torch.obs.health import (
    HEALTH_FILENAME,
    HEALTH_SCHEMA_VERSION,
    PROM_FILENAME,
    read_health,
    write_health,
    write_prom,
)
from tpudas_torch.obs.phases import PHASES, RoundPhases
from tpudas_torch.obs.registry import (
    MetricsRegistry,
    get_registry,
    headline,
    use_registry,
)
from tpudas_torch.obs.trace import clear_spans, get_spans, span

__all__ = [
    "MetricsRegistry",
    "get_registry",
    "use_registry",
    "headline",
    "span",
    "get_spans",
    "clear_spans",
    "write_health",
    "read_health",
    "write_prom",
    "FlightRecorder",
    "read_flight",
    "PHASES",
    "RoundPhases",
    "SLOPolicy",
    "slo_status",
    "fleet_rollup",
    "cluster_snapshot",
    "HEALTH_FILENAME",
    "PROM_FILENAME",
    "HEALTH_SCHEMA_VERSION",
]
