"""Metrics registry: counters / gauges / histograms with labels, one
namespace for every signal the stack emits.

The registry is deliberately small and dependency-free: metric families
are created idempotently (``registry.counter(name, ...)`` returns the
existing family on repeat calls, kind-checked), each family holds one
series per label-value tuple, and two exports cover the consumers we
have — ``snapshot()`` (plain dict, lands in the BENCH_*.json files and
``--metrics-json``) and ``to_prometheus()`` (text exposition for
scraping / eyeballing).

Semantics note: serving sources (engine dispatch counters, the
device-resident metrics block, pool/prefix counters) keep their own
cumulative accounting and MIRROR it into the registry at flush
boundaries via ``Counter.set`` — so a registry counter tracks its
source, including ``Engine.reset_counters()`` zeroing between a warmup
and a timed pass.  ``inc`` is for sources whose only accounting IS the
registry (e.g. the tracer's span counts).
"""
from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["MetricsRegistry", "Counter", "Gauge", "Histogram",
           "DEFAULT_LATENCY_BUCKETS"]

# log-spaced seconds, sized for host-side serving latencies (sub-ms
# dispatch spans up to multi-second requests); +Inf is implicit
DEFAULT_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _label_key(label_names: Sequence[str], labels: Dict) -> Tuple:
    extra = set(labels) - set(label_names)
    assert not extra, f"unknown labels {sorted(extra)} (have {label_names})"
    return tuple(str(labels.get(n, "")) for n in label_names)


class _Family:
    """One named metric family; holds a series per label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._series: Dict[Tuple, object] = {}

    def _get(self, labels: Dict):
        key = _label_key(self.label_names, labels)
        if key not in self._series:
            self._series[key] = self._new_series()
        return self._series[key]

    def series(self) -> Iterable[Tuple[Dict, object]]:
        for key, val in sorted(self._series.items()):
            yield dict(zip(self.label_names, key)), val

    def clear(self) -> None:
        """Drop every series (an owner's reset boundary — e.g. the
        tracer zeroes its latency histograms between timed passes)."""
        self._series = {}


class Counter(_Family):
    """Monotone-by-convention count.  ``set`` mirrors an externally
    accumulated cumulative value (see module docstring)."""

    kind = "counter"

    def _new_series(self):
        return 0.0

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _label_key(self.label_names, labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        self._series[key] = float(value)

    def get(self, **labels) -> float:
        return self._series.get(_label_key(self.label_names, labels), 0.0)


class Gauge(_Family):
    kind = "gauge"

    def _new_series(self):
        return 0.0

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        self._series[key] = float(value)

    def get(self, **labels) -> float:
        return self._series.get(_label_key(self.label_names, labels), 0.0)


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "vmin", "vmax")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)      # +1 = +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.vmin = math.inf
        self.vmax = -math.inf


class Histogram(_Family):
    """Fixed upper-edge buckets (Prometheus-style cumulative on export;
    stored per-bucket).  ``quantile`` interpolates within the winning
    bucket — good enough for p50/p99 reporting, exact at the edges."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help, label_names)
        assert list(buckets) == sorted(buckets) and len(buckets) >= 1
        self.buckets = tuple(float(b) for b in buckets)

    def _new_series(self):
        return _HistSeries(len(self.buckets))

    def observe(self, value: float, **labels) -> None:
        s: _HistSeries = self._get(labels)
        value = float(value)
        i = 0
        while i < len(self.buckets) and value > self.buckets[i]:
            i += 1
        s.counts[i] += 1
        s.sum += value
        s.count += 1
        s.vmin = min(s.vmin, value)
        s.vmax = max(s.vmax, value)

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Bucket-interpolated quantile in [0, 1]; None when empty."""
        s = self._series.get(_label_key(self.label_names, labels))
        if s is None or s.count == 0:
            return None
        rank = q * s.count
        cum = 0
        for i, c in enumerate(s.counts):
            if c == 0:
                continue
            lo = 0.0 if i == 0 else self.buckets[i - 1]
            hi = s.vmax if i == len(self.buckets) else self.buckets[i]
            if cum + c >= rank:
                frac = (rank - cum) / c
                # clamp interpolation to the observed range: buckets know
                # only edges, vmin/vmax know the actual extremes
                return min(max(lo + frac * (hi - lo), s.vmin), s.vmax)
            cum += c
        return s.vmax

    def summary(self, **labels) -> Dict:
        s = self._series.get(_label_key(self.label_names, labels))
        if s is None or s.count == 0:
            return {"count": 0}
        return {"count": s.count, "sum": round(s.sum, 6),
                "mean": round(s.sum / s.count, 6),
                "min": round(s.vmin, 6), "max": round(s.vmax, 6),
                "p50": round(self.quantile(0.50, **labels), 6),
                "p90": round(self.quantile(0.90, **labels), 6),
                "p99": round(self.quantile(0.99, **labels), 6)}


class MetricsRegistry:
    def __init__(self):
        self._families: Dict[str, _Family] = {}

    def _register(self, cls, name: str, help: str, labels: Sequence[str],
                  **kw) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            assert isinstance(fam, cls), \
                f"{name} already registered as {fam.kind}"
            return fam
        fam = cls(name, help, labels, **kw)
        self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram, name, help, labels,
                              buckets=buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    # -- exports -----------------------------------------------------------
    def snapshot(self) -> Dict:
        """Plain-dict export (JSON-safe): {name: {type, help, values}}.
        Histogram values carry bucket counts + the summary stats."""
        out: Dict = {}
        for name, fam in sorted(self._families.items()):
            rows: List[Dict] = []
            for labels, val in fam.series():
                row: Dict = {"labels": labels}
                if fam.kind == "histogram":
                    row["buckets"] = {
                        **{str(b): c for b, c in zip(fam.buckets,
                                                     val.counts)},
                        "+Inf": val.counts[-1]}
                    row.update(fam.summary(**labels))
                else:
                    row["value"] = val
                rows.append(row)
            out[name] = {"type": fam.kind, "help": fam.help,
                         "values": rows}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counters get no _total suffix
        appended — name them *_total at creation)."""
        def esc(v) -> str:
            # label VALUES escape backslash, double-quote and newline
            # (exposition format) — model/config names with odd
            # characters would otherwise break the scrape
            return (str(v).replace("\\", r"\\").replace('"', r"\"")
                    .replace("\n", r"\n"))

        def fmt_labels(d: Dict) -> str:
            if not d:
                return ""
            body = ",".join(f'{k}="{esc(v)}"' for k, v in d.items())
            return "{" + body + "}"

        lines: List[str] = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for labels, val in fam.series():
                if fam.kind == "histogram":
                    cum = 0
                    for b, c in zip(fam.buckets, val.counts):
                        cum += c
                        lb = dict(labels, le=repr(float(b)))
                        lines.append(f"{name}_bucket{fmt_labels(lb)} {cum}")
                    cum += val.counts[-1]
                    lb = dict(labels, le="+Inf")
                    lines.append(f"{name}_bucket{fmt_labels(lb)} {cum}")
                    lines.append(f"{name}_sum{fmt_labels(labels)} "
                                 f"{val.sum}")
                    lines.append(f"{name}_count{fmt_labels(labels)} "
                                 f"{val.count}")
                else:
                    v = val
                    v = int(v) if float(v).is_integer() else v
                    lines.append(f"{name}{fmt_labels(labels)} {v}")
        return "\n".join(lines) + "\n"

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
