"""Straggler monitoring (``repro.distributed.fault_tolerance``, its
policy layer): ``StragglerMonitor`` ingests per-step wall times (one per
host), compares each host's last step with the median, and recommends
an action when one host's time exceeds the threshold for ``patience``
consecutive steps: shift part of its micro-batch share to the others
(rebalance), then mark it for eviction.  The training loop feeds it one
host's times.  ``ElasticPlan`` (the mesh and batch plan after a resize)
is ROADMAP queue A 7 of the port.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Tuple


@dataclass
class StragglerConfig:
    window: int = 20            # rolling window of step times
    ratio_threshold: float = 1.5  # pmax/p50 that flags a straggler
    patience: int = 5           # consecutive flagged steps before action
    rebalance_step: float = 0.25  # fraction of microbatch to shift away


@dataclass
class StragglerMonitor:
    n_hosts: int
    cfg: StragglerConfig = field(default_factory=StragglerConfig)
    _times: Dict[int, Deque[float]] = field(default_factory=dict)
    _flagged: Dict[int, int] = field(default_factory=dict)
    microbatch_share: Dict[int, float] = field(default_factory=dict)

    def __post_init__(self):
        for h in range(self.n_hosts):
            self._times[h] = collections.deque(maxlen=self.cfg.window)
            self._flagged[h] = 0
            self.microbatch_share[h] = 1.0 / self.n_hosts

    def record_step(self, step_times: Dict[int, float]) -> List[Tuple[str, int]]:
        """Feed one step's per-host times; returns recommended actions:
        [("rebalance", host)] or [("evict", host)]."""
        actions: List[Tuple[str, int]] = []
        for h, t in step_times.items():
            self._times[h].append(t)
        med = sorted(t[-1] for t in self._times.values() if t)[
            len(self._times) // 2]
        for h in range(self.n_hosts):
            if not self._times[h]:
                continue
            ratio = self._times[h][-1] / max(med, 1e-9)
            if ratio > self.cfg.ratio_threshold:
                self._flagged[h] += 1
            else:
                self._flagged[h] = 0
            if self._flagged[h] == self.cfg.patience:
                actions.append(("rebalance", h))
                self._shift_share(h)
            elif self._flagged[h] >= 2 * self.cfg.patience:
                actions.append(("evict", h))
        return actions

    def _shift_share(self, straggler: int) -> None:
        """Move a slice of the straggler's microbatch share to the others."""
        delta = self.microbatch_share[straggler] * self.cfg.rebalance_step
        self.microbatch_share[straggler] -= delta
        others = [h for h in range(self.n_hosts) if h != straggler]
        for h in others:
            self.microbatch_share[h] += delta / len(others)
