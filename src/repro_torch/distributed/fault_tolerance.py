"""Straggler monitoring (``repro.distributed.fault_tolerance``, its
policy layer): ``StragglerMonitor`` ingests per-step wall times (one per
host), compares each host's last step with the median, and recommends
an action when one host's time exceeds the threshold for ``patience``
consecutive steps: shift part of its micro-batch share to the others
(rebalance), then mark it for eviction.  The training loop feeds it one
host's times.  ``ElasticPlan`` computes the new mesh and batch split
after a node-count change; the restore then goes through
``CheckpointManager.restore`` with the new mesh's specs (a
mesh-agnostic payload).
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


@dataclass(frozen=True)
class ElasticPlan:
    """Mesh + batch plan after an elastic resize."""
    n_devices: int
    mesh_shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    global_batch: int

    @staticmethod
    def plan(n_devices: int, model_parallel: int, global_batch: int,
             multi_pod_size: int = 0) -> "ElasticPlan":
        """Keep TP fixed (model weights' shard layout is the expensive
        thing to reshuffle); absorb node loss in the data axis.  Batch is
        kept divisible by the new dp size by rounding down."""
        if n_devices % model_parallel != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by TP={model_parallel}")
        dp = n_devices // model_parallel
        if multi_pod_size and dp % multi_pod_size == 0:
            shape = (multi_pod_size, dp // multi_pod_size, model_parallel)
            names = ("pod", "data", "model")
        else:
            shape = (dp, model_parallel)
            names = ("data", "model")
        gb = (global_batch // dp) * dp
        return ElasticPlan(n_devices, shape, names, max(gb, dp))
