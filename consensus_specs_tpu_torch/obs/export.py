"""Exporters: canonical JSON snapshot and Prometheus text exposition (the
port's copy of the JAX package's obs/export.py).

Canonical means byte-identical across two dumps of equal registry state:
sorted keys, fixed separators, no timestamps — if a consumer wants a
timestamp it goes in the caller-supplied `meta` block, never injected here.
Artifact diffs rely on this.

The two formats expose ONE value set. `snapshot_value_set` derives
{series: float} from the JSON snapshot; `prometheus_value_set` parses the
same out of the text exposition — the tests hold them equal so the
exporters cannot drift apart.
"""
from __future__ import annotations

import json
from typing import Optional

from .metrics import REGISTRY, MetricsRegistry

SNAPSHOT_VERSION = 1


# --- JSON --------------------------------------------------------------------


def snapshot_dict(registry: MetricsRegistry = REGISTRY,
                  meta: Optional[dict] = None) -> dict:
    snap = registry.snapshot()
    if meta:
        snap["meta"] = dict(meta)
    return snap


def canonical_json(obj: dict) -> str:
    """THE canonical serialization (sorted keys, fixed separators, trailing
    newline). Anything claiming to be an obs snapshot must round-trip
    through this byte-identically."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False) + "\n"


def json_snapshot(registry: MetricsRegistry = REGISTRY,
                  meta: Optional[dict] = None) -> str:
    return canonical_json(snapshot_dict(registry, meta))


def write_snapshot(path, registry: MetricsRegistry = REGISTRY,
                   meta: Optional[dict] = None) -> str:
    text = json_snapshot(registry, meta)
    with open(path, "w") as f:
        f.write(text)
    return text


def validate_snapshot_text(text: str):
    """(ok, reason) for an on-disk snapshot: parseable, right version,
    canonical (re-serializing reproduces the exact bytes)."""
    try:
        obj = json.loads(text)
    except ValueError as e:
        return False, f"not JSON: {e}"
    if not isinstance(obj, dict):
        return False, "snapshot is not an object"
    if obj.get("version") != SNAPSHOT_VERSION:
        return False, f"version {obj.get('version')!r} != {SNAPSHOT_VERSION}"
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(obj.get(section), dict):
            return False, f"missing section {section!r}"
    if canonical_json(obj) != text:
        return False, "not canonical (re-serialization differs)"
    return True, "ok"


# --- Prometheus text exposition ----------------------------------------------


def _split_series(key: str):
    """`name{a="b"}` -> ("name", 'a="b"'); bare `name` -> ("name", "")."""
    if key.endswith("}") and "{" in key:
        name, _, inner = key.partition("{")
        return name, inner[:-1]
    return key, ""


def _with_label(inner: str, extra: str) -> str:
    return f"{inner},{extra}" if inner else extra


def _fmt(v) -> str:
    """Value formatting shared by exporter and value-set derivation; floats
    via repr so float(text) round-trips exactly."""
    if isinstance(v, bool):
        return repr(int(v))
    if isinstance(v, int):
        return repr(v)
    return repr(float(v))


def _fmt_le(edge) -> str:
    return "+Inf" if edge == "+Inf" else repr(float(edge))


def prometheus_text(snapshot: dict) -> str:
    """Text exposition of a snapshot dict (counters, gauges, histogram
    bucket/sum/count; derived p50/p99/min/max stay JSON-only — Prometheus
    computes quantiles server-side from the buckets)."""
    lines = []
    typed: set[str] = set()

    def head(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for key, v in snapshot.get("counters", {}).items():
        name, inner = _split_series(key)
        head(name, "counter")
        lines.append(f"{key} {_fmt(v)}")
    for key, v in snapshot.get("gauges", {}).items():
        name, inner = _split_series(key)
        head(name, "gauge")
        lines.append(f"{key} {_fmt(v)}")
    for key, h in snapshot.get("histograms", {}).items():
        name, inner = _split_series(key)
        head(name, "histogram")
        for le, n in h["buckets"]:
            labels = _with_label(inner, f'le="{_fmt_le(le)}"')
            lines.append(f"{name}_bucket{{{labels}}} {_fmt(n)}")
        suffix = f"{{{inner}}}" if inner else ""
        lines.append(f"{name}_sum{suffix} {_fmt(h['sum'])}")
        lines.append(f"{name}_count{suffix} {_fmt(h['count'])}")
    return "\n".join(lines) + "\n"


def snapshot_value_set(snapshot: dict) -> dict:
    """{series: float} — the ground truth both exporters must agree on."""
    out: dict[str, float] = {}
    for key, v in snapshot.get("counters", {}).items():
        out[key] = float(v)
    for key, v in snapshot.get("gauges", {}).items():
        out[key] = float(v)
    for key, h in snapshot.get("histograms", {}).items():
        name, inner = _split_series(key)
        for le, n in h["buckets"]:
            labels = _with_label(inner, f'le="{_fmt_le(le)}"')
            out[f"{name}_bucket{{{labels}}}"] = float(n)
        suffix = f"{{{inner}}}" if inner else ""
        out[f"{name}_sum{suffix}"] = float(h["sum"])
        out[f"{name}_count{suffix}"] = float(h["count"])
    return out


def prometheus_value_set(text: str) -> dict:
    """Parse a text exposition back into {series: float}."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        out[series] = float(value)
    return out
