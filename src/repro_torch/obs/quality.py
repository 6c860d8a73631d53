"""Predictor-quality observability: drift detection over shadow-oracle
scores, the trigger signal for an online recalibration loop
(``repro.obs.quality``).

The serving engine samples 1-in-N dispatches through a "shadow" twin of
its active MoR execution plans (``MoRExecutionPlan.as_shadow``): the
sampled dispatch ALSO runs the dense-oracle forward, scoring the
predictor's tile decisions against the dense truth, and the exact
per-(layer, expert) false-skip / false-keep counts accumulate in the
device metrics block's quality lanes (``obs.device.QUALITY_FIELDS``) —
zero extra host syncs, drained once per flush like everything else.

This module is the HOST side: :class:`DriftDetector` consumes the
drained cumulative counters flush-over-flush, turns them into
per-series false-skip rates, and runs a pluggable change detector per
(group, layer[, expert]) series — EWMA-vs-threshold by default (an
absolute misprediction budget: the paper's accuracy cliff lives at a
few percent of incorrectly-predicted zeros, Fig. 12), or Page-Hinkley
for relative mean-shift detection.  The engine mirrors the rates into
``repro_mor_false_skip_rate`` / ``repro_mor_drift`` gauges, fires
tracer drift events into the Perfetto timeline, and surfaces the state
in ``report()["quality"]``.

``inject_coefficient_drift`` is the test/benchmark knob: it perturbs
ONE layer's fitted-line intercept in a calibrated MoR tree (the
predictor goes wrong; the model's dense truth is untouched), which is
exactly the degradation signature the detector exists to catch.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["DriftDetector", "EwmaDetector", "PageHinkleyDetector",
           "inject_coefficient_drift"]


class EwmaDetector:
    """Exponentially-weighted moving average vs an ABSOLUTE threshold.

    ``update(rate)`` folds one per-flush false-skip rate in and returns
    True while the smoothed rate sits above ``threshold``.  The EWMA
    (not the raw sample) is compared so a single noisy flush on a tiny
    shadow sample cannot flap the flag."""

    def __init__(self, threshold: float, alpha: float = 0.5):
        assert 0.0 < alpha <= 1.0
        self.threshold = float(threshold)
        self.alpha = float(alpha)
        self.ewma: Optional[float] = None

    def update(self, rate: float) -> bool:
        self.ewma = (rate if self.ewma is None
                     else self.alpha * rate + (1 - self.alpha) * self.ewma)
        return self.ewma > self.threshold

    @property
    def value(self) -> float:
        return 0.0 if self.ewma is None else self.ewma


class PageHinkleyDetector:
    """Page-Hinkley mean-shift test: fires when the cumulative positive
    deviation from the running mean exceeds ``threshold`` (lambda).
    Detects RELATIVE degradation from whatever baseline the series
    establishes, where the EWMA detector needs an absolute budget."""

    def __init__(self, threshold: float, delta: float = 0.005):
        self.threshold = float(threshold)
        self.delta = float(delta)
        self.n = 0
        self.mean = 0.0
        self.cum = 0.0
        self.cum_min = 0.0

    def update(self, rate: float) -> bool:
        self.n += 1
        self.mean += (rate - self.mean) / self.n
        self.cum += rate - self.mean - self.delta
        self.cum_min = min(self.cum_min, self.cum)
        return (self.cum - self.cum_min) > self.threshold

    @property
    def value(self) -> float:
        return self.cum - self.cum_min


_DETECTORS = {"ewma": EwmaDetector, "page-hinkley": PageHinkleyDetector}


class DriftDetector:
    """Per-(group, layer[, expert]) drift detection over the drained
    shadow-score counters.

    ``update(device_metrics)`` takes the engine's host-side
    ``DeviceMetricsSpec.read`` output (CUMULATIVE counters), diffs it
    against the previous flush, feeds each series' per-flush false-skip
    rate into its detector instance, and returns the NEWLY-drifted
    series as event dicts ``{"group", "layer", "expert", "rate"}``
    (``expert`` is None for (L,)-shaped groups) — the engine turns
    those into tracer timeline events.  Series with fewer than
    ``min_tiles`` truly-live tiles since the last flush are skipped
    (nothing to score).  ``rebase()`` forgets the cumulative snapshot
    (the engine calls it from ``reset_counters`` when the device block
    re-inits) without losing detector state."""

    def __init__(self, threshold: float = 0.25, detector: str = "ewma",
                 min_tiles: int = 1, **det_kw):
        assert detector in _DETECTORS, \
            f"unknown drift detector {detector!r} (have {sorted(_DETECTORS)})"
        self.threshold = float(threshold)
        self.detector = detector
        self.min_tiles = int(min_tiles)
        self._det_kw = det_kw
        self._dets: Dict = {}            # (group, idx) -> detector
        self._drifted: Dict = {}         # (group, idx) -> bool
        self._rates: Dict = {}           # (group, idx) -> last rate
        self._last: Dict = {}            # group -> (false_skip, truth_live)
        self.n_updates = 0

    def _series(self, key):
        det = self._dets.get(key)
        if det is None:
            det = self._dets[key] = _DETECTORS[self.detector](
                self.threshold, **self._det_kw)
        return det

    def update(self, device_metrics: Dict) -> List[Dict]:
        events: List[Dict] = []
        self.n_updates += 1
        for g, d in device_metrics.get("groups", {}).items():
            fs = np.asarray(d["false_skip"], np.int64)
            tl = np.asarray(d["truth_live"], np.int64)
            pfs, ptl = self._last.get(g, (np.zeros_like(fs),
                                          np.zeros_like(tl)))
            dfs, dtl = fs - pfs, tl - ptl
            self._last[g] = (fs, tl)
            for idx in np.ndindex(fs.shape):
                if dtl[idx] < self.min_tiles:
                    continue                  # no shadow sample to score
                rate = float(dfs[idx]) / float(dtl[idx])
                key = (g, idx)
                self._rates[key] = rate
                was = self._drifted.get(key, False)
                now = self._series(key).update(rate)
                self._drifted[key] = now
                if now and not was:
                    events.append({
                        "group": g, "layer": int(idx[0]),
                        "expert": int(idx[1]) if len(idx) > 1 else None,
                        "rate": rate})
        return events

    def rebase(self) -> None:
        """Forget the cumulative-counter snapshot (the source counters
        were zeroed, e.g. ``Engine.reset_counters``); detector state —
        EWMA / Page-Hinkley accumulators and raised flags — survives."""
        self._last = {}

    def reset(self) -> None:
        """Full reset: snapshot AND every per-series detector."""
        self._last = {}
        self._dets = {}
        self._drifted = {}
        self._rates = {}
        self.n_updates = 0

    # -- introspection -----------------------------------------------------
    def state(self) -> Dict[str, Dict]:
        """{group: {"rate": smoothed array, "last_rate": array,
        "drifted": bool array}} shaped like the source counters."""
        out: Dict[str, Dict] = {}
        for g, (fs, _tl) in self._last.items():
            rate = np.zeros(fs.shape, np.float64)
            last = np.zeros(fs.shape, np.float64)
            drifted = np.zeros(fs.shape, bool)
            for idx in np.ndindex(fs.shape):
                det = self._dets.get((g, idx))
                if det is not None:
                    rate[idx] = det.value
                last[idx] = self._rates.get((g, idx), 0.0)
                drifted[idx] = self._drifted.get((g, idx), False)
            out[g] = {"rate": rate, "last_rate": last, "drifted": drifted}
        return out

    def drifted_series(self) -> List[Dict]:
        """Every series whose flag is currently raised."""
        out = []
        for (g, idx), flag in sorted(self._drifted.items()):
            if flag:
                out.append({"group": g, "layer": int(idx[0]),
                            "expert": int(idx[1]) if len(idx) > 1 else None,
                            "rate": self._rates.get((g, idx), 0.0)})
        return out

    def summary(self) -> Dict:
        st = self.state()
        return {
            "detector": self.detector,
            "threshold": self.threshold,
            "n_updates": self.n_updates,
            "n_series": len(self._dets),
            "n_drifted": sum(1 for v in self._drifted.values() if v),
            "drifted": self.drifted_series(),
            "false_skip_rate": {
                g: np.round(d["rate"], 6).tolist()
                for g, d in st.items()},
        }


def inject_coefficient_drift(raw_mor: Dict, group: str, layer: int, *,
                             shift: Optional[float] = None) -> Dict:
    """Return a copy of a RAW calibrated MoR tree ({group: stacked
    MoRLayer}) with ONE layer's predictor wrecked, while the model's
    dense truth is untouched — the degradation signature of stale
    calibration coefficients, which is what the drift detector exists
    to catch.  Both calibration artifacts the hybrid predictor rests on
    go stale together:

    - the fitted-line intercept ``b`` is shifted hard negative, so the
      binary rookie estimates every pre-activation below zero (``b``
      feeds only ``estimate_preact``; the real pre-activations never
      see it);
    - the proxy assignments are cleared (``proxy_slot = -1``), so the
      proxy rookie abstains instead of vetoing the binary rookie's
      skips (``hybrid_predict`` skips only when BOTH rookies say zero
      — a live proxy column would rescue every neuron it covers and
      mask the broken line).

    The layer is force-enabled so calibration's own accuracy gate
    cannot hide the injection.  ``shift`` defaults to a value large
    enough to dominate any realistically-calibrated line.
    ``raw_mor[group]`` may be an expert group ({"experts": (L, E)-
    stacked MoRLayer}); then every expert of the layer is wrecked.
    Tensors are cloned, never edited in place."""
    import torch
    entry = raw_mor[group]
    experts = isinstance(entry, dict) and "experts" in entry
    stack = entry["experts"] if experts else entry
    b = stack["b"].float()
    if shift is None:
        shift = 10.0 * (float(b[layer].abs().mean())
                        + float(stack["m"][layer].float().abs().mean())
                        + 1.0)
    new = dict(stack)
    new["b"] = b.clone()
    new["b"][layer] -= float(shift)
    new["proxy_slot"] = stack["proxy_slot"].clone()
    new["proxy_slot"][layer] = -1
    new["enable"] = stack["enable"].to(torch.bool).clone()
    new["enable"][layer] = True
    out = dict(raw_mor)
    out[group] = {"experts": new} if experts else new
    return out
