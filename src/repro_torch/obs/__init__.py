"""Observability plane: structured lifecycle tracing, SLO-violation
attribution, a live Prometheus-style metrics registry, and program
spans on the profiler's clock (docs/observability.md).

Everything here is zero-dependency and OFF by default: a replica / fleet
with no recorder attached takes the exact code paths it took before this
package existed (the golden-trace inertness guarantee in
tests/test_obs.py), and an attached recorder only *reads* decision
outputs — it can never alter a scheduling decision.
"""
from repro_torch.obs.attribution import (CAUSES, Attribution, attribute,
                                         render_attribution_table)
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry)
from repro_torch.obs import spans
from repro_torch.obs.scrape import scrape_fleet, scrape_replica
from repro_torch.obs.spans import span
from repro_torch.obs.trace import (EVENT_SCHEMA, TraceRecorder,
                                   install_tracer, validate_events)

__all__ = [
    "TraceRecorder", "EVENT_SCHEMA", "validate_events", "install_tracer",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "Attribution", "attribute", "render_attribution_table", "CAUSES",
    "scrape_fleet", "scrape_replica", "span", "spans",
]
