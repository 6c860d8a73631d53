"""Admission and preemption policies for the serving scheduler (a copy
of ``repro.serving.policy``; host bookkeeping only).

A ``Policy`` reorders the waiting queue, caps how many prompt tokens a
mixed dispatch may consume (``prefill_budget`` > 0; 0 = unlimited) and
picks preemption victims.  It reads priorities, offsets and generated
counts, never a token value, so it plugs in without touching the
dispatch.  Three built-ins:

  * ``FCFSPolicy``: arrival order, never preempts.
  * ``PriorityPolicy``: higher ``Request.priority`` admits first, and a
    waiting request may preempt a running slot of strictly lower
    priority (the engine spills the victim's pages to the host and
    requeues it at its exact progress: no token is lost).
  * ``ShortestPrefillPolicy`` (``sjf``): shortest remaining prefill
    first; preempted resumes (no prefill left) sort to the front.

All three share ``spill_victim``, the engine's choice when the paged
pool runs out of pages: lowest priority first, then the most remaining
work, then the latest arrival.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["Policy", "FCFSPolicy", "PriorityPolicy",
           "ShortestPrefillPolicy", "get_policy"]


def _remaining(slot_or_entry) -> int:
    """Tokens of work left: unconsumed prompt + ungenerated tokens."""
    req = slot_or_entry.req
    return (max(0, len(req.prompt) - slot_or_entry.offset)
            + max(0, req.max_new_tokens - slot_or_entry.n_generated))


def _lowest(slots: Sequence, cand: List[int]) -> Optional[int]:
    """The candidate of lowest priority, then most remaining work, then
    latest arrival."""
    if not cand:
        return None
    return max(cand, key=lambda s: (-slots[s].req.priority,
                                    _remaining(slots[s]), slots[s].seq))


class Policy:
    """Base policy: arrival order, no voluntary preemption, and the
    shared pool-pressure victim.  Hooks: ``order(waiting)`` sorts the
    waiting queue in place (stable); ``select_victim(slots, entry)`` is
    the running slot to preempt so that ``entry`` is admitted, or None;
    ``spill_victim(slots, exclude)`` the running slot to spill when the
    paged pool is exhausted, or None."""

    name = "fcfs"

    def __init__(self, prefill_budget: int = 0):
        if prefill_budget < 0:
            raise ValueError(f"prefill_budget {prefill_budget} < 0")
        self.prefill_budget = int(prefill_budget)

    def order(self, waiting: List) -> None:
        pass                                 # arrival order (stable)

    def select_victim(self, slots: Sequence, entry) -> Optional[int]:
        return None

    def spill_victim(self, slots: Sequence,
                     exclude: Sequence[int] = ()) -> Optional[int]:
        skip = set(exclude)
        return _lowest(slots, [s for s, sl in enumerate(slots)
                               if sl.req is not None and s not in skip])


class FCFSPolicy(Policy):
    name = "fcfs"


class PriorityPolicy(Policy):
    """Strict priority classes: the waiting queue sorts by descending
    priority (arrival order within a class), and a waiting request
    preempts the lowest-priority running slot whose priority is strictly
    below its own; equal priorities never preempt each other."""

    name = "priority"

    def order(self, waiting: List) -> None:
        waiting.sort(key=lambda e: (-e.req.priority, e.seq))

    def select_victim(self, slots: Sequence, entry) -> Optional[int]:
        return _lowest(slots, [s for s, sl in enumerate(slots)
                               if sl.req is not None
                               and sl.req.priority < entry.req.priority])


class ShortestPrefillPolicy(Policy):
    """Shortest remaining prefill first; a preempted resume has none left
    and gets its slot back before new long prompts."""

    name = "sjf"

    def order(self, waiting: List) -> None:
        waiting.sort(key=lambda e: (max(0, len(e.req.prompt) - e.offset),
                                    e.seq))


_POLICIES = {p.name: p for p in (FCFSPolicy, PriorityPolicy,
                                 ShortestPrefillPolicy)}


def get_policy(name: str, prefill_budget: int = 0) -> Policy:
    if name not in _POLICIES:
        raise ValueError(f"unknown policy {name!r} (have "
                         f"{sorted(_POLICIES)})")
    return _POLICIES[name](prefill_budget=prefill_budget)
