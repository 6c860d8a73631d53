"""Serving telemetry: per-layer tile-liveness histograms and the
liveness-quantile capacity calibration (``repro.serving.telemetry``).

Every engine dispatch returns ``aux`` whose ``*mor_stats`` entries hold
per-layer (L-stacked) realised skip statistics: ``mor_stats`` for a
dense model, ``dense_mor_stats`` and the (L, E)-shaped per-(layer,
expert) ``moe_mor_stats`` for a moe model.  The telemetry bins each
row's live-tile fraction into a fixed histogram (an (L, E) group as L*E
rows); ``calibrate_capacity`` reads a quantile of that distribution per
row and hands the budgets back in the group's shape.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig

# aux keys that carry per-layer MoR stats, in the order groups appear
STAT_KEYS = ("mor_stats", "dense_mor_stats", "moe_mor_stats")


def mor_group_map(cfg: ModelConfig) -> Dict[str, str]:
    """aux stat-group key -> mor-tree layer-group key."""
    if cfg.family == "hybrid":
        return {"mor_stats": "shared"}
    if cfg.family == "moe":
        return {"dense_mor_stats": "dense_layers",
                "moe_mor_stats": "moe_layers"}
    return {"mor_stats": "layers"}


class ServingTelemetry:
    """Host-side accumulator over chunk-step aux dicts (already moved to
    host numpy by the engine's flush)."""

    def __init__(self, n_bins: int = 32):
        self.n_bins = n_bins
        self.hist: Dict[str, np.ndarray] = {}
        self.sums: Dict[str, Dict[str, np.ndarray]] = {}
        self.shapes: Dict[str, tuple] = {}
        self.n_updates = 0
        self.prefix: Optional[Dict] = None

    def update(self, aux: Dict) -> None:
        seen = False
        for key in STAT_KEYS:
            stats = aux.get(key)
            if not stats:
                continue
            seen = True
            live = np.asarray(stats["frac_tiles_live"], np.float64)
            self.shapes.setdefault(key, live.shape)
            live = live.reshape(-1)
            L = live.shape[0]
            if key not in self.hist:
                self.hist[key] = np.zeros((L, self.n_bins), np.int64)
                self.sums[key] = {
                    "frac_computed": np.zeros(L),
                    "frac_tiles_live": np.zeros(L),
                    "frac_tiles_computed": np.zeros(L),
                    "frac_mispredicted_zero": np.zeros(L),
                }
            bins = np.clip((live * self.n_bins).astype(np.int64), 0,
                           self.n_bins - 1)
            self.hist[key][np.arange(L), bins] += 1
            for name, acc in self.sums[key].items():
                if name in stats:
                    acc += np.asarray(stats[name], np.float64).reshape(-1)
        if seen:
            self.n_updates += 1

    def liveness_quantile(self, q: float) -> Dict[str, np.ndarray]:
        """Per layer, the smallest bin upper edge whose cumulative mass
        reaches ``q``."""
        out = {}
        for key, h in self.hist.items():
            cdf = np.cumsum(h, axis=1) / np.maximum(h.sum(1, keepdims=True),
                                                    1)
            idx = np.argmax(cdf >= q, axis=1)
            out[key] = ((idx + 1) / self.n_bins).reshape(
                self.shapes.get(key, idx.shape))
        return out

    def update_prefix(self, counters: Dict) -> None:
        """Record the latest prefix-cache counters (cumulative values:
        the engine recomputes them from the pool at each flush)."""
        self.prefix = dict(counters)

    def summary(self) -> Dict:
        out: Dict = {"n_dispatches": self.n_updates}
        if self.prefix is not None:
            out["prefix_cache"] = dict(self.prefix)
        for key, sums in self.sums.items():
            n = max(self.n_updates, 1)
            shape = self.shapes.get(key)
            out[key] = {name: (acc / n).reshape(shape if shape
                                                else acc.shape).tolist()
                        for name, acc in sums.items()}
        return out


def export_telemetry(registry, tel: ServingTelemetry, *, layout: str,
                     capacities: Optional[Dict] = None) -> None:
    """Mirror a ``ServingTelemetry`` summary (and optionally the
    calibrated per-layer capacities) into an obs
    ``MetricsRegistry``.

    Every series carries a ``layout`` label and is written with
    idempotent ``set``: re-exporting the same layout overwrites its own
    series, and engines of two layouts sharing one registry keep apart
    series, keyed by ``(layout, group, layer, expert)``."""
    g_frac = registry.gauge(
        "repro_telemetry_frac",
        "mean realised MoR fractions per layer (serving dispatches)",
        ("layout", "group", "stat", "layer", "expert"))
    g_disp = registry.gauge(
        "repro_telemetry_dispatches",
        "dispatches accumulated into the telemetry histograms",
        ("layout",))
    g_disp.set(tel.n_updates, layout=layout)

    def cells(arr, shape):
        a = np.asarray(arr, np.float64).reshape(shape)
        if a.ndim == 0:
            # scalar capacity spec (serve --capacity): one all-layers cell
            yield "", "", float(a)
        elif a.ndim == 1:
            for li in range(a.shape[0]):
                yield li, "", float(a[li])
        else:
            for li in range(a.shape[0]):
                for e in range(a.shape[1]):
                    yield li, e, float(a[li, e])

    n = max(tel.n_updates, 1)
    for key, sums in tel.sums.items():
        shape = tel.shapes.get(key)
        for name, acc in sums.items():
            for li, e, v in cells(acc / n, shape):
                g_frac.set(v, layout=layout, group=key, stat=name,
                           layer=li, expert=e)
    if capacities:
        g_cap = registry.gauge(
            "repro_telemetry_capacity",
            "calibrated per-layer gather_matmul capacity fraction",
            ("layout", "group", "layer", "expert"))
        for key, arr in capacities.items():
            a = np.asarray(arr)
            for li, e, v in cells(a, a.shape):
                g_cap.set(v, layout=layout, group=key, layer=li,
                          expert=e)


def calibrate_capacity(tel: ServingTelemetry, *, quantile: float = 0.95,
                       floor: float = 0.05,
                       headroom: float = 0.0) -> Dict[str, np.ndarray]:
    """Per layer, provision the gather_matmul capacity at the
    ``quantile`` of the observed live-tile fraction (+ headroom), floored
    so a layer is never starved.  -> {stat group -> fractions}."""
    if tel.n_updates == 0:
        raise ValueError("calibrate_capacity needs serving telemetry")
    return {key: np.clip(q + headroom, floor, 1.0)
            for key, q in tel.liveness_quantile(quantile).items()}
