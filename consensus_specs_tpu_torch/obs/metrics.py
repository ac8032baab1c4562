"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms
(the port's copy of the JAX package's obs/metrics.py).

One registry (`REGISTRY`) for the whole process, mirroring how Prometheus
client libraries model it: every hot-path seam increments named instruments
here, and the exporters (obs/export.py) read one coherent snapshot instead
of scraping module-global dicts (`LAST_FLUSH`), dataclasses (`NodeStats`)
and ad-hoc event lists (the breaker log) that cannot see each other.

Design constraints, in priority order:

  1. CHEAP — an increment is a dict lookup plus an int add under a lock the
     hot paths never contend (tier-1 is single-threaded; the gossip rx
     threads touch disjoint label sets). Instrument handles are stable
     objects, so call sites may cache them and skip even the lookup.
  2. no torch at module level: `obs/` is consumed by robustness/ and
     sched/, which the host-only callers import.
  3. CANONICAL — `snapshot()` returns a plain dict whose keys are the
     Prometheus series identities (`name{k="v"}`, labels sorted), so two
     snapshots of equal registry state serialize byte-identically and the
     JSON and Prometheus exporters agree on the value set by construction.

Histograms use FIXED buckets (log-spaced seconds by default): quantile
readout (p50/p99) is bucket interpolation, never a sample sort, so memory
per histogram is O(buckets) no matter how long the soak runs — the same
reason the breaker event log is now a bounded ring.
"""
from __future__ import annotations

import threading
from bisect import bisect_left

# Log-spaced latency buckets (seconds): 1us .. 60s. Device dispatches sit in
# the 1ms-1s decades, host epilogues in 10us-10ms, pairing flushes can reach
# tens of seconds on the cpu-debug lane — one shared ladder keeps every
# span/seam comparable in the exported snapshot.
DEFAULT_BUCKETS = (
    1e-6, 1e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\"", "\\\"").replace("\n", "\\n")


def series_key(name: str, labels: dict | None = None) -> str:
    """Prometheus series identity: `name` or `name{k="v",...}`, labels
    sorted by key — THE canonical key for snapshots and exporters."""
    if not labels:
        return name
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in sorted(labels.items()))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic integer counter."""

    __slots__ = ("key", "_value", "_lock")

    def __init__(self, key: str, lock: threading.Lock):
        self.key = key
        self._value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _reset(self) -> None:
        self._value = 0


class Gauge:
    """Last-write-wins numeric gauge."""

    __slots__ = ("key", "_value", "_lock")

    def __init__(self, key: str, lock: threading.Lock):
        self.key = key
        self._value = 0.0
        self._lock = lock

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def add(self, v) -> None:
        with self._lock:
            self._value += v

    @property
    def value(self):
        return self._value

    def _reset(self) -> None:
        self._value = 0.0


class Histogram:
    """Fixed-bucket histogram with sum/count/min/max and quantile readout.

    Buckets are upper-bound edges (non-cumulative counts internally; the
    snapshot exports CUMULATIVE counts plus the +Inf bucket, matching the
    Prometheus text format so the two exporters share one value set)."""

    __slots__ = ("key", "buckets", "_counts", "_sum", "_count", "_min",
                 "_max", "_exemplars", "_lock")

    def __init__(self, key: str, lock: threading.Lock,
                 buckets: tuple = DEFAULT_BUCKETS):
        self.key = key
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(self.buckets), "bucket edges must ascend"
        self._counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._exemplars: dict[int, str] = {}  # bucket ix -> last trace id
        self._lock = lock

    def observe(self, v: float, exemplar: str | None = None) -> None:
        """Record one observation. `exemplar` (optional) is a trace id
        retained per bucket — LAST writer wins — so a fat p99 bucket links
        to a replayable trace. Exemplars surface in the JSON snapshot
        only, never in the Prometheus text, and a histogram that never
        receives one snapshots byte-identically to the pre-exemplar
        format."""
        v = float(v)
        ix = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[ix] += 1
            self._sum += v
            self._count += 1
            if self._min is None or v < self._min:
                self._min = v
            if self._max is None or v > self._max:
                self._max = v
            if exemplar is not None:
                self._exemplars[ix] = str(exemplar)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile in [0, 1]; 0.0 when empty. Values in
        the +Inf bucket resolve to the observed max (the honest upper bound
        a fixed ladder can give)."""
        if self._count == 0:
            return 0.0
        rank = q * self._count
        cum = 0
        for ix, c in enumerate(self._counts):
            prev_cum = cum
            cum += c
            if cum >= rank and c > 0:
                if ix >= len(self.buckets):  # +Inf bucket
                    return float(self._max)
                lo = self.buckets[ix - 1] if ix else 0.0
                hi = self.buckets[ix]
                frac = (rank - prev_cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return float(self._max)

    def p50(self) -> float:
        return self.quantile(0.50)

    def p99(self) -> float:
        return self.quantile(0.99)

    def cumulative_buckets(self) -> list:
        """[(le, cumulative_count)] including ("+Inf", count)."""
        out = []
        cum = 0
        for edge, c in zip(self.buckets, self._counts):
            cum += c
            out.append((edge, cum))
        out.append(("+Inf", self._count))
        return out

    def exemplars(self) -> dict:
        """{bucket le label: trace id} for buckets holding an exemplar
        (the +Inf bucket labels as "+Inf"); empty when none recorded."""
        out = {}
        for ix, trace_id in self._exemplars.items():
            le = ("+Inf" if ix >= len(self.buckets)
                  else repr(float(self.buckets[ix])))
            out[le] = trace_id
        return out

    def _reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = None
        self._max = None
        self._exemplars = {}


class MetricsRegistry:
    """Homogeneous home for every instrument; instrument identity is the
    canonical series key, so asking twice returns the same object (call
    sites may cache handles — the hot paths do)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        key = series_key(name, labels)
        c = self._counters.get(key)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(key, Counter(key, self._lock))
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = series_key(name, labels)
        g = self._gauges.get(key)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(key, Gauge(key, self._lock))
        return g

    def histogram(self, name: str, buckets: tuple = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        key = series_key(name, labels)
        h = self._histograms.get(key)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    key, Histogram(key, self._lock, buckets))
        return h

    def counter_value(self, name: str, **labels) -> int:
        """Read-only: 0 when the series was never created (reads must not
        materialize series, or snapshots would differ run to run)."""
        with self._lock:
            c = self._counters.get(series_key(name, labels))
        return c.value if c is not None else 0

    def gauge_value(self, name: str, **labels):
        with self._lock:
            g = self._gauges.get(series_key(name, labels))
        return g.value if g is not None else 0.0

    def counters_matching(self, name: str) -> dict[str, int]:
        """{series key: value} for every series of `name` (any label set).

        The lock is not optional here: iterating `_counters` while the
        flush worker registers a new series raises `RuntimeError: dict
        changed size during iteration`."""
        prefix = name + "{"
        with self._lock:
            items = sorted(self._counters.items())
        return {k: c.value for k, c in items
                if k == name or k.startswith(prefix)}

    def reset(self) -> None:
        """Zero every instrument IN PLACE: cached handles stay wired, so a
        test may reset between phases without re-plumbing call sites."""
        with self._lock:
            for c in self._counters.values():
                c._reset()
            for g in self._gauges.values():
                g._reset()
            for h in self._histograms.values():
                h._reset()

    def clear(self) -> None:
        """Drop every series entirely (fresh-process equivalence; snapshot
        of a cleared registry is empty). Cached handles become orphans —
        only test teardown should use this."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> dict:
        """Canonical plain-dict state: sorted series keys, cumulative
        histogram buckets, derived p50/p99 included for human consumers.
        Two calls against equal registry state return equal dicts, and
        json.dumps(..., sort_keys=True) of them is byte-identical."""
        with self._lock:
            counters = {k: c._value for k, c in sorted(self._counters.items())}
            gauges = {k: g._value for k, g in sorted(self._gauges.items())}
            hists = {}
            for k, h in sorted(self._histograms.items()):
                hists[k] = {
                    "buckets": [[le if le == "+Inf" else float(le), int(n)]
                                for le, n in h.cumulative_buckets()],
                    "count": h._count,
                    "sum": h._sum,
                    "min": h._min,
                    "max": h._max,
                    "p50": h.quantile(0.50),
                    "p99": h.quantile(0.99),
                }
                # exemplars are JSON-snapshot-only (the Prometheus text and
                # both exporter value sets never see them) and the key is
                # OMITTED when none were recorded, so exemplar-free
                # registries snapshot byte-identically to the v1 format
                if h._exemplars:
                    hists[k]["exemplars"] = h.exemplars()
        return {
            "version": 1,
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }


# The process-wide registry: every instrumented seam records here unless a
# caller explicitly threads its own registry (tests isolating a phase).
REGISTRY = MetricsRegistry()
