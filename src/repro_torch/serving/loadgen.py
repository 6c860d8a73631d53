"""Open-loop load generation for SLO benchmarks (a copy of
``repro.serving.loadgen``; host numpy and ``time.perf_counter`` only).

Closed-loop driving (``Engine.run`` on a fixed trace) measures
throughput but can never measure TAIL latency under load: the driver
only submits as fast as the engine serves, so the queue never builds.
An OPEN-loop generator submits on a wall-clock arrival schedule that
does not care how busy the engine is — overload shows up as queue
depth, and queue depth shows up as p99 TTFT, which is exactly the
signal admission policies and page-spill preemption exist to shape.

``poisson_trace`` is fully seeded: the same (rate, seed, shape params)
produce byte-identical arrival times, prompts and priorities, so policy
A vs policy B comparisons (and CI reruns) see the SAME offered load.
``run_open_loop`` replays a trace against a live engine in real time:
arrivals whose time has come are submitted (rejections recorded, never
fatal — that is what ``RequestRejected`` is for), the engine steps
whenever it has work, and the driver sleeps only when idle ahead of the
next arrival.  Per-request latencies come out of the engine's tracer
(``Tracer.request_spans``), which shares the ``perf_counter`` timebase
with the arrival clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.serving.scheduler import RequestRejected

__all__ = ["Arrival", "OpenLoopResult", "poisson_trace", "run_open_loop",
           "latency_stats"]


@dataclass
class Arrival:
    """One scheduled request: submit at ``t`` (seconds from the run's
    start), with a priority class for policies that use one."""
    t: float
    prompt: np.ndarray
    max_new_tokens: int
    priority: int = 0


@dataclass
class OpenLoopResult:
    """What one open-loop replay observed (token values stay in
    ``engine.results``): rid -> arrival index for joining engine spans
    back to the trace, plus the rejection log."""
    submitted: Dict[int, int] = field(default_factory=dict)
    rejected: List[Tuple[int, str]] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def n_submitted(self) -> int:
        return len(self.submitted)


def poisson_trace(rate: float, duration_s: float, vocab_size: int,
                  seed: int = 0, prompt_len: Tuple[int, int] = (8, 48),
                  max_new: Tuple[int, int] = (4, 16),
                  hi_pri_frac: float = 0.0, hi_pri: int = 5,
                  oversize_frac: float = 0.0,
                  max_len: int = 0) -> List[Arrival]:
    """Seeded Poisson arrivals at ``rate`` req/s for ``duration_s``
    seconds, with prompt/generation lengths uniform over the given
    inclusive ranges and a ``hi_pri_frac`` fraction of requests tagged
    ``hi_pri``.  ``oversize_frac`` > 0 injects unservable requests
    (prompt past ``max_len``) to exercise the rejection path under
    load."""
    if rate <= 0 or duration_s <= 0:
        raise ValueError(f"rate {rate} and duration_s {duration_s} must be "
                         f"> 0")
    rng = np.random.default_rng(seed)
    out: List[Arrival] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration_s:
            break
        p_lo, p_hi = prompt_len
        n_p = int(rng.integers(p_lo, p_hi + 1))
        n_g = int(rng.integers(max_new[0], max_new[1] + 1))
        if oversize_frac > 0 and rng.random() < oversize_frac:
            if max_len <= 0:
                raise ValueError("oversize_frac needs max_len")
            n_p = max_len          # prompt + gen + 1 always > max_len
        prompt = rng.integers(1, vocab_size,
                              size=max(n_p, 1)).astype(np.int32)
        pri = hi_pri if (hi_pri_frac > 0
                         and rng.random() < hi_pri_frac) else 0
        out.append(Arrival(t, prompt, n_g, pri))
    return out


def run_open_loop(engine, arrivals: List[Arrival], *,
                  time_scale: float = 1.0,
                  idle_sleep_cap: float = 0.002) -> OpenLoopResult:
    """Replay ``arrivals`` against ``engine`` in real time: submit every
    arrival whose (scaled) time has passed, step the engine whenever it
    has work, sleep only when idle before the next arrival, then drain.
    Rejections (oversize injections, etc.) are recorded and the run
    continues — a load generator that dies on one bad request measures
    nothing."""
    res = OpenLoopResult()
    t0 = time.perf_counter()
    i, n = 0, len(arrivals)
    while i < n or engine.scheduler.has_work:
        now = (time.perf_counter() - t0) / time_scale
        while i < n and arrivals[i].t <= now:
            a = arrivals[i]
            try:
                rid = engine.submit(a.prompt, a.max_new_tokens,
                                    priority=a.priority)
                res.submitted[rid] = i
            except RequestRejected as e:
                res.rejected.append((i, e.reason))
            i += 1
        if engine.scheduler.has_work:
            engine.step()
        elif i < n:
            wait = arrivals[i].t * time_scale - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(min(wait, idle_sleep_cap))
    engine.drain()
    res.wall_s = time.perf_counter() - t0
    return res


def latency_stats(spans: Dict[int, Dict], submitted: Dict[int, int],
                  arrivals: List[Arrival],
                  quantiles: Tuple[float, ...] = (0.5, 0.99)
                  ) -> Dict[str, Dict[str, float]]:
    """Per-priority-class TTFT quantiles from ``Tracer.request_spans``
    joined back to the trace (plus the all-requests row under "all")."""
    by_class: Dict[str, List[float]] = {"all": []}
    for rid, idx in submitted.items():
        sp = spans.get(rid)
        if sp is None or sp.get("ttft_s") is None:
            continue
        by_class["all"].append(sp["ttft_s"])
        key = f"pri{arrivals[idx].priority}"
        by_class.setdefault(key, []).append(sp["ttft_s"])
    out: Dict[str, Dict[str, float]] = {}
    for key, vals in by_class.items():
        if not vals:
            continue
        out[key] = {"n": len(vals)}
        for q in quantiles:
            out[key][f"p{int(q * 100)}"] = float(
                np.percentile(vals, q * 100))
    return out
