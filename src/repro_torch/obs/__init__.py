"""repro_torch.obs — unified observability for the serving stack
(``repro.obs``).

One :class:`Observability` bundle carries the three pieces:

- ``registry`` — :class:`~repro_torch.obs.registry.MetricsRegistry`
  (counters / gauges / histograms with labels; JSON snapshot +
  Prometheus text exposition).
- ``tracer`` — :class:`~repro_torch.obs.tracer.Tracer` (per-request and
  per-dispatch spans, TTFT / inter-token latency histograms, Chrome
  trace / Perfetto export).  ``None`` when tracing is disabled.
- ``device_metrics`` flag — when True the engine keeps a packed int32
  :class:`~repro_torch.obs.device.DeviceMetricsSpec` block on the
  device, adds to it in every dispatch and reads it only at flushes.
"""
from __future__ import annotations

from repro_torch.obs.device import SCALE, DeviceMetricsSpec
from repro_torch.obs.quality import (DriftDetector, EwmaDetector,
                                     PageHinkleyDetector,
                                     inject_coefficient_drift)
from repro_torch.obs.registry import (DEFAULT_LATENCY_BUCKETS, Counter,
                                      Gauge, Histogram, MetricsRegistry)
from repro_torch.obs.server import MetricsServer
from repro_torch.obs.tracer import Tracer, validate_chrome_trace

__all__ = ["Observability", "MetricsRegistry", "Counter", "Gauge",
           "Histogram", "Tracer", "DeviceMetricsSpec", "SCALE",
           "DEFAULT_LATENCY_BUCKETS", "validate_chrome_trace",
           "DriftDetector", "EwmaDetector", "PageHinkleyDetector",
           "inject_coefficient_drift", "MetricsServer"]


class Observability:
    """Bundle handed to :class:`repro_torch.serving.engine.Engine` tying
    registry + tracer + device-metrics toggle together.  Several engines
    may share one bundle: series are told apart by their labels
    (layout, group, shard).  ``annotations`` wraps each dispatch in a
    ``torch.profiler`` range (the JAX package's ``jax_annotations``)."""

    def __init__(self, registry: MetricsRegistry = None, *,
                 device_metrics: bool = True, tracing: bool = True,
                 annotations: bool = False):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.device_metrics = device_metrics
        self.annotations = annotations
        self.tracer = Tracer(self.registry, annotations=annotations) \
            if tracing else None

    def snapshot(self) -> dict:
        out = {"metrics": self.registry.snapshot()}
        if self.tracer is not None:
            out["tracing"] = self.tracer.summary()
        return out

    def write_metrics_json(self, path: str) -> None:
        import json
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    def write_trace(self, path: str) -> None:
        assert self.tracer is not None, "tracing disabled"
        self.tracer.write_chrome_trace(path)
