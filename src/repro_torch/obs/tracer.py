"""Span-based request tracer for the serving engine
(``repro.obs.tracer``).

The engine's hot loop is host-synchronous per dispatch (one
``step()`` = one compiled-step launch), so the tracer records spans
from the host dispatch timeline: for each request admit → prefill
chunks → decode emits → finish, and for the engine a span per
dispatch.  TTFT is measured submit → end of the dispatch that emitted
the request's first token; inter-token latency is the gap between the
ends of consecutive emitting dispatches.  Both are host-timeline
approximations (a dispatch emits tokens for many slots at once), which
is exactly the granularity the scheduler can act on.

Export is Chrome-trace JSON (``{"traceEvents": [...]}`` with "ph":"X"
complete events) — loadable in Perfetto / chrome://tracing.  Span
events per request live on a per-slot track so concurrent requests
stack visually the way they share slots physically.

Optionally (``annotations=True``) each dispatch is wrapped in a
``torch.profiler.record_function("repro.dispatch.<kind>")`` range so
the spans line up with the card's kernels in a ``torch.profiler``
trace; off by default to keep the overhead budget.  The tracer reads
the host clock only (``time.perf_counter``): no span waits for the
device.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Tracer", "validate_chrome_trace"]

# inter-token latencies at reduced dims are sub-ms; extend the default
# latency buckets downward for ITL
ITL_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
               0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5)
TTFT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


@dataclass
class _Req:
    rid: int
    t_submit: float
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_last_emit: Optional[float] = None
    t_finish: Optional[float] = None
    slot: Optional[int] = None
    n_tokens: int = 0


@dataclass
class _Event:
    name: str
    ts: float            # seconds, perf_counter timebase
    dur: float
    pid: str
    tid: object
    args: Dict = field(default_factory=dict)


class Tracer:
    """Collects dispatch + request spans; drains into registry
    histograms and a Chrome-trace event list."""

    def __init__(self, registry=None, annotations: bool = False,
                 max_events: int = 100_000):
        self.registry = registry
        self.annotations = annotations
        self.max_events = max_events
        self.reset()
        if registry is not None:
            self._h_ttft = registry.histogram(
                "repro_serving_ttft_seconds",
                "time from submit to first emitted token",
                buckets=TTFT_BUCKETS)
            self._h_itl = registry.histogram(
                "repro_serving_itl_seconds",
                "inter-token latency between emitting dispatches",
                buckets=ITL_BUCKETS)
            self._h_queue = registry.histogram(
                "repro_serving_queue_wait_seconds",
                "time from submit to slot admission",
                buckets=TTFT_BUCKETS)
            self._h_dispatch = registry.histogram(
                "repro_serving_dispatch_seconds",
                "wall time of one engine dispatch", ("kind",),
                buckets=ITL_BUCKETS)
        else:
            self._h_ttft = self._h_itl = None
            self._h_queue = self._h_dispatch = None

    def reset(self) -> None:
        self._reqs: Dict[int, _Req] = {}
        self._events: List[_Event] = []
        self._n_dispatch = 0
        self._n_preempt = 0
        self._n_restore = 0
        self._n_drift = 0
        self._dropped = 0
        # the tracer owns its latency histograms: a reset boundary (the
        # engine's reset_counters between timed passes) zeroes them too,
        # so exported quantiles describe the LAST pass, not the compile-
        # heavy warmup
        for h in (getattr(self, "_h_ttft", None),
                  getattr(self, "_h_itl", None),
                  getattr(self, "_h_queue", None),
                  getattr(self, "_h_dispatch", None)):
            if h is not None:
                h.clear()

    # -- hooks the engine calls -------------------------------------------
    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def on_submit(self, rid: int, t: Optional[float] = None) -> None:
        self._reqs[rid] = _Req(rid, self.now() if t is None else t)

    def annotation(self, kind: str):
        """Context manager wrapping a dispatch; a ``torch.profiler``
        range when enabled, else a no-op."""
        if self.annotations:
            import torch
            return torch.profiler.record_function(f"repro.dispatch.{kind}")
        import contextlib
        return contextlib.nullcontext()

    def on_dispatch(self, kind: str, t0: float, t1: float, *,
                    admitted: Sequence[Tuple[int, int]] = (),
                    prefilling: Sequence[Tuple[int, int, int, int]] = (),
                    emits: Sequence[Tuple[int, int]] = (),
                    emit_counts: Optional[Sequence[int]] = None,
                    finished: Sequence[int] = (),
                    queue_depth: int = 0,
                    n_active: int = 0) -> None:
        """One engine step.  admitted: (slot, rid) pairs newly placed;
        prefilling: (slot, rid, offset, take) chunks consumed this
        dispatch; emits: (slot, rid) that produced a token; finished:
        rids that completed.  Speculative verify dispatches emit UP TO
        k+1 tokens per slot at once — ``emit_counts`` (aligned with
        ``emits``) carries the per-slot count so request token totals
        stay exact; TTFT/ITL remain per-emitting-dispatch timestamps
        (an accepted run reaches the host as one batch, so the
        per-round gap IS its inter-token cadence).  Any ``kind`` string
        flows through to the span name and the dispatch histogram
        label — the speculative round uses draft/verify/replay."""
        i = self._n_dispatch
        self._n_dispatch += 1
        n_emits = (sum(emit_counts) if emit_counts is not None
                   else len(emits))
        self._emit(_Event(f"dispatch/{kind}", t0, t1 - t0, "engine",
                          "dispatch",
                          {"i": i, "kind": kind,
                           "queue_depth": queue_depth,
                           "n_active": n_active,
                           "n_emits": n_emits}))
        if self._h_dispatch is not None:
            self._h_dispatch.observe(t1 - t0, kind=kind)

        for slot, rid in admitted:
            r = self._reqs.get(rid)
            if r is None:        # request submitted before tracer reset
                r = self._reqs[rid] = _Req(rid, t0)
            r.t_admit = t0
            r.slot = slot
            self._emit(_Event(f"queued rid={rid}", r.t_submit,
                              t0 - r.t_submit, "requests", f"rid {rid}",
                              {"rid": rid}))
            if self._h_queue is not None:
                self._h_queue.observe(t0 - r.t_submit)

        for item in prefilling:
            slot, rid, off, take = item
            self._emit(_Event(f"prefill rid={rid} [{off}:{off + take}]",
                              t0, t1 - t0, "slots", f"slot {slot}",
                              {"rid": rid, "offset": off, "take": take}))

        for j, (slot, rid) in enumerate(emits):
            n_tok = emit_counts[j] if emit_counts is not None else 1
            r = self._reqs.get(rid)
            self._emit(_Event(f"decode rid={rid}", t0, t1 - t0, "slots",
                              f"slot {slot}",
                              {"rid": rid, "n_tokens": n_tok}))
            if r is None:
                continue
            r.n_tokens += n_tok
            if r.t_first_token is None:
                r.t_first_token = t1
                if self._h_ttft is not None:
                    self._h_ttft.observe(t1 - r.t_submit)
            elif r.t_last_emit is not None and self._h_itl is not None:
                self._h_itl.observe(t1 - r.t_last_emit)
            r.t_last_emit = t1

        for rid in finished:
            r = self._reqs.get(rid)
            if r is None:
                continue
            r.t_finish = t1
            self._emit(_Event(f"request rid={rid}", r.t_submit,
                              t1 - r.t_submit, "requests", f"rid {rid}",
                              {"rid": rid, "n_tokens": r.n_tokens,
                               "ttft_s": None if r.t_first_token is None
                               else round(r.t_first_token - r.t_submit,
                                          6)}))

    def on_preempt(self, rid: int, slot: int,
                   t: Optional[float] = None) -> None:
        """Request ``rid`` was spilled out of ``slot`` (pages moved to
        host; it re-enters the waiting queue at its exact progress)."""
        t = self.now() if t is None else t
        self._n_preempt += 1
        self._emit(_Event(f"preempt rid={rid}", t, 0.0, "requests",
                          f"rid {rid}", {"rid": rid, "slot": slot}))

    def on_restore(self, rid: int, slot: int,
                   t: Optional[float] = None) -> None:
        """Spilled request ``rid`` re-admitted into ``slot``."""
        t = self.now() if t is None else t
        self._n_restore += 1
        self._emit(_Event(f"restore rid={rid}", t, 0.0, "requests",
                          f"rid {rid}", {"rid": rid, "slot": slot}))

    def on_drift(self, group: str, layer: int, expert: Optional[int],
                 rate: float, t: Optional[float] = None) -> None:
        """Predictor drift flagged on one (group, layer[, expert])
        series — an instant marker on its own "quality" track so the
        degradation onset lines up against the dispatch timeline."""
        t = self.now() if t is None else t
        self._n_drift += 1
        where = f"{group}/L{layer}" + ("" if expert is None
                                       else f"/E{expert}")
        self._emit(_Event(f"drift {where}", t, 0.0, "quality", group,
                          {"group": group, "layer": layer,
                           "expert": expert,
                           "false_skip_rate": round(rate, 6)}))

    def _emit(self, ev: _Event) -> None:
        if len(self._events) >= self.max_events:
            self._dropped += 1
            return
        self._events.append(ev)

    # -- introspection / export -------------------------------------------
    @property
    def n_dispatches(self) -> int:
        return self._n_dispatch

    def request_spans(self) -> Dict[int, Dict]:
        out = {}
        for rid, r in sorted(self._reqs.items()):
            out[rid] = {
                "t_submit": r.t_submit, "t_admit": r.t_admit,
                "t_first_token": r.t_first_token,
                "t_finish": r.t_finish, "slot": r.slot,
                "n_tokens": r.n_tokens,
                "ttft_s": None if r.t_first_token is None
                else r.t_first_token - r.t_submit}
        return out

    def summary(self) -> Dict:
        out: Dict = {"n_dispatches": self._n_dispatch,
                     "n_requests": len(self._reqs),
                     "n_preemptions": self._n_preempt,
                     "n_restores": self._n_restore,
                     "n_drift_events": self._n_drift,
                     "events_dropped": self._dropped}
        if self._h_ttft is not None:
            out["ttft"] = self._h_ttft.summary()
            out["itl"] = self._h_itl.summary()
            out["queue_wait"] = self._h_queue.summary()
        return out

    def to_chrome_trace(self) -> Dict:
        """Chrome trace event format; ts/dur in microseconds."""
        pids = sorted({ev.pid for ev in self._events})
        pid_ids = {p: i + 1 for i, p in enumerate(pids)}
        tid_ids: Dict[Tuple[str, object], int] = {}
        events: List[Dict] = []
        for pid, pi in pid_ids.items():
            events.append({"ph": "M", "name": "process_name", "pid": pi,
                           "tid": 0, "args": {"name": pid}})
        for ev in self._events:
            key = (ev.pid, ev.tid)
            if key not in tid_ids:
                tid_ids[key] = len([k for k in tid_ids
                                    if k[0] == ev.pid]) + 1
                events.append({"ph": "M", "name": "thread_name",
                               "pid": pid_ids[ev.pid],
                               "tid": tid_ids[key],
                               "args": {"name": str(ev.tid)}})
            events.append({"ph": "X", "name": ev.name,
                           "ts": round(ev.ts * 1e6, 3),
                           "dur": round(max(ev.dur, 0.0) * 1e6, 3),
                           "pid": pid_ids[ev.pid], "tid": tid_ids[key],
                           "args": ev.args})
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "metadata": {"tool": "repro_torch.obs.tracer"}}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


def validate_chrome_trace(obj) -> List[str]:
    """Schema check for the exported trace; returns a list of problems
    (empty == valid).  Shared by tests and the CI smoke job."""
    problems: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["missing top-level traceEvents"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M", "B", "E", "i"):
            problems.append(f"event {i}: bad ph {ph!r}")
            continue
        if "name" not in ev or "pid" not in ev:
            problems.append(f"event {i}: missing name/pid")
        if ph == "X":
            ts, dur = ev.get("ts"), ev.get("dur")
            if not isinstance(ts, (int, float)):
                problems.append(f"event {i}: bad ts {ts!r}")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: bad dur {dur!r}")
    return problems
