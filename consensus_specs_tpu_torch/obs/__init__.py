"""Observability for the port (copies of the JAX package's jax-free obs
modules; no torch at module level):

  obs.metrics    process-wide registry: counters, gauges, fixed-bucket
                 histograms with p50/p99 readout (`REGISTRY`).
  obs.trace      span tracer (`span("merkle.device")`), disabled unless a
                 Tracer is installed.
  obs.flight     always-on flight recorder: a bounded event ring dumped as
                 canonical JSON on incident triggers (breaker open,
                 self-check), written to disk only where OBS_FLIGHT_DIR
                 points.
  obs.export     canonical JSON snapshot + Prometheus text, one value set.

The JAX package's compile counter (obs/recompile.py) has no counterpart:
the port's pins count kernel launches (`kernels/build.LAUNCHES`).
"""
from .metrics import REGISTRY, MetricsRegistry, DEFAULT_BUCKETS, series_key
from .trace import NULL_SPAN, Tracer, annotate, current_tracer, span
from .flight import FlightRecorder, current_recorder
from .export import (
    canonical_json,
    json_snapshot,
    prometheus_text,
    prometheus_value_set,
    snapshot_dict,
    snapshot_value_set,
    validate_snapshot_text,
    write_snapshot,
)

__all__ = [
    "REGISTRY",
    "MetricsRegistry",
    "DEFAULT_BUCKETS",
    "series_key",
    "NULL_SPAN",
    "Tracer",
    "annotate",
    "current_tracer",
    "span",
    "FlightRecorder",
    "current_recorder",
    "canonical_json",
    "json_snapshot",
    "prometheus_text",
    "prometheus_value_set",
    "snapshot_dict",
    "snapshot_value_set",
    "validate_snapshot_text",
    "write_snapshot",
]
