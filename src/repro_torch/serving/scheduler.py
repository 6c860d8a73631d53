"""Continuous-batching scheduler (a copy of ``repro.serving.scheduler``
without preemption and speculation; host numpy only).

Requests share a fixed pool of ``n_slots`` cache slots.  Prompts are
consumed in fixed-size chunks; a dispatch is MIXED — every prefilling
slot contributes its next chunk while every decoding slot contributes
its one pending token in the same (B, C) batch.  When all remaining work
is decode, dispatches shrink to (B, 1).  Finished sequences are evicted
immediately and their slot is recycled.  The scheduler never sees token
VALUES (count-based), so the engine keeps tokens on the device.  A
placement hook at admission lets the paged engine start a request's
prefill past its prefix-cache hit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.serving.policy import FCFSPolicy, Policy

FREE, PREFILL, DECODE = "free", "prefill", "decode"


class RequestRejected(ValueError):
    """A request the engine can never serve, raised at submit time."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (P,) int32 token ids
    max_new_tokens: int = 16
    priority: int = 0


@dataclass
class PendingEntry:
    req: Request
    offset: int = 0
    n_generated: int = 0
    seq: int = 0                        # arrival order (stable ties)


@dataclass
class _Slot:
    state: str = FREE
    req: Optional[Request] = None
    offset: int = 0                     # prompt tokens already prefilled
    n_generated: int = 0                # tokens emitted so far
    seq: int = 0


class Scheduler:
    def __init__(self, n_slots: int, chunk: int,
                 policy: Optional[Policy] = None):
        if n_slots < 1 or chunk < 1:
            raise ValueError(f"n_slots {n_slots} and chunk {chunk} must "
                             f"be >= 1")
        self.n_slots = n_slots
        self.chunk = chunk
        self.policy = policy or FCFSPolicy()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.waiting: List[PendingEntry] = []
        self._seq = 0
        # set by ``admit`` when the placement hook deferred (pool
        # exhausted)
        self.deferred = False
        # prefix-cache accounting: admission-time hits shrink a
        # request's remaining prefill
        self.chunks_skipped = 0
        self.tokens_skipped = 0
        self.dispatch_kinds = {"mixed": 0, "decode": 0}

    def add(self, req: Request) -> None:
        self.waiting.append(PendingEntry(req, seq=self._seq))
        self._seq += 1

    def admit(self, place=None) -> List[int]:
        """Move waiting requests (policy order) into free slots; returns
        the admitted slot indices.

        ``place(slot, entry) -> offset`` is the engine's placement hook:
        the paged engine binds it to ``PagedPool.admit``, so a
        prefix-cache hit starts the prefill past the hit (whole chunks
        whose pages fully hit are never dispatched).  Returning ``None``
        defers admission: the entry stays at the head of the queue,
        ``self.deferred`` is set, and admission stops."""
        self.policy.order(self.waiting)
        newly: List[int] = []
        self.deferred = False
        for s, slot in enumerate(self.slots):
            if not self.waiting:
                break
            if slot.state is not FREE:
                continue
            entry = self.waiting[0]
            off = entry.offset if place is None else place(s, entry)
            if off is None:
                self.deferred = True
                break
            off = int(off)
            self.waiting.pop(0)
            P = len(entry.req.prompt)
            assert 0 <= off < P
            self.slots[s] = _Slot(state=PREFILL, req=entry.req, offset=off,
                                  n_generated=entry.n_generated,
                                  seq=entry.seq)
            if off:
                cold = -(-P // self.chunk)
                warm = -(-(P - off) // self.chunk)
                self.chunks_skipped += cold - warm
                self.tokens_skipped += off
            newly.append(s)
        return newly

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(s.state is not FREE
                                         for s in self.slots)

    def peek_kind(self) -> Optional[str]:
        if any(s.state is PREFILL for s in self.slots):
            return "mixed"
        if any(s.state is DECODE for s in self.slots):
            return "decode"
        return None

    def build_batch(self, kind: str
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               List[Tuple[int, int]],
                               List[Tuple[int, int]],
                               List[Tuple[int, int, int]]]:
        """-> (tokens (B, C), n_valid (B,), use_pending (B,), emits,
        finishing, prefilling).

        ``tokens`` carries each prefilling slot's next prompt chunk;
        slots flagged in ``use_pending`` feed their device-resident last
        sampled token instead.  ``emits`` lists the (slot, rid) pairs
        that emit a generated token from THIS dispatch.  ``finishing``
        lists the (slot, offset) pairs whose prompt completes this
        dispatch; ``prefilling`` every (slot, offset, take) consuming
        prompt tokens (the paged engine's pre-wrap publish hook).  A
        positive ``prefill_budget`` caps the prompt tokens of a mixed
        dispatch; the first prefilling slot always gets at least one
        token."""
        C = self.chunk if kind == "mixed" else 1
        budget = self.policy.prefill_budget
        left = budget if (kind == "mixed" and budget > 0) else None
        tokens = np.zeros((self.n_slots, C), np.int32)
        n_valid = np.zeros((self.n_slots,), np.int32)
        use_pending = np.zeros((self.n_slots,), bool)
        emits: List[Tuple[int, int]] = []
        finishing: List[Tuple[int, int]] = []
        prefilling: List[Tuple[int, int, int]] = []
        for s, slot in enumerate(self.slots):
            if slot.state is PREFILL:
                take = min(C, len(slot.req.prompt) - slot.offset)
                if left is not None:
                    take = min(take, left if prefilling else max(left, 1))
                    if take <= 0:
                        continue
                    left -= take
                tokens[s, :take] = slot.req.prompt[slot.offset:
                                                   slot.offset + take]
                n_valid[s] = take
                prefilling.append((s, slot.offset, take))
                if slot.offset + take >= len(slot.req.prompt):
                    emits.append((s, slot.req.rid))
                    finishing.append((s, slot.offset))
            elif slot.state is DECODE:
                use_pending[s] = True
                n_valid[s] = 1
                emits.append((s, slot.req.rid))
        return tokens, n_valid, use_pending, emits, finishing, prefilling

    def feed(self, n_valid: np.ndarray
             ) -> Tuple[List[Tuple[int, Request]],
                        List[Tuple[int, Request]]]:
        """Advance slot states after a dispatch (count-based).  Returns
        ``(finished, entering_decode)`` as (slot, request) pairs:
        finished requests' slots are freed; slots entering decode just
        completed their prompt (the paged engine publishes their prompt
        pages into the prefix trie, AFTER the dispatch that wrote
        them)."""
        finished = []
        entering = []
        for s, slot in enumerate(self.slots):
            nv = int(n_valid[s])
            if nv == 0:
                continue
            if slot.state is PREFILL:
                slot.offset += nv
                if slot.offset >= len(slot.req.prompt):
                    slot.state = DECODE
                    slot.n_generated = 1
                    entering.append((s, slot.req))
            elif slot.state is DECODE:
                slot.n_generated += 1
            if slot.state is DECODE and \
                    slot.n_generated >= slot.req.max_new_tokens:
                finished.append((s, slot.req))
                self.slots[s] = _Slot()
        return finished, entering
