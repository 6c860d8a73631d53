"""Admission policy for the serving scheduler (a copy of the FCFS part
of ``repro.serving.policy``; host bookkeeping only).

A ``Policy`` reorders the waiting queue and caps how many prompt tokens
a mixed dispatch may consume (``prefill_budget`` > 0; 0 = unlimited).
"""
from __future__ import annotations

from typing import List

__all__ = ["Policy", "FCFSPolicy"]


class Policy:
    """Base policy: arrival order, no preemption."""

    name = "fcfs"

    def __init__(self, prefill_budget: int = 0):
        if prefill_budget < 0:
            raise ValueError(f"prefill_budget {prefill_budget} < 0")
        self.prefill_budget = int(prefill_budget)

    def order(self, waiting: List) -> None:
        pass                                 # arrival order (stable)


class FCFSPolicy(Policy):
    name = "fcfs"

