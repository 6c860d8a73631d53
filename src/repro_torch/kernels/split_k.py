"""The split-K planner of the MoR matmuls (``csrc/mma_tile.cuh``).

A block of those kernels owns a 64-row x 128-column output tile.  Where
the grid has fewer live blocks than the card has SMs (a decode dispatch:
a few dozen kept column tiles), the contraction is split over a thread
block cluster of ``split`` blocks (at most 8, the portable cluster
size), each summing ``kb_per`` whole 128-wide k blocks: as many blocks
a cluster as still fit one wave of one block an SM.  The partials meet
in a fixed order, so a given shape always gives the same bits.  Pure
Python on host ints: the plan never waits for the device.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

BM, BN, KB = 64, 128, 128
MAX_SPLIT = 8


def plan(E: int, M: int, K: int, N: int, *, sms: int,
         capacity: Optional[int] = None) -> Tuple[int, int]:
    """-> (split, kb_per).  The grid has E x ceil(M/64) x ceil(N/128)
    blocks, of which at most E x ``capacity`` compute when a budget of
    ``capacity`` tiles an expert bounds them.  ``split``: as many blocks
    a cluster as still fit those live blocks into one wave of ``sms``
    (at least 1, at most 8 and the k blocks), so split = 1 whenever the
    grid already fills the card; ``kb_per`` k blocks a rank, and the
    split recounted so that no rank is empty."""
    per_expert = -(-M // BM) * -(-N // BN)
    live = E * (per_expert if capacity is None
                else min(per_expert, capacity))
    return split_over(live, K, sms=sms)


def split_over(live: int, K: int, *, sms: int) -> Tuple[int, int]:
    """-> (split, kb_per) for ``live`` output tiles over a contraction
    of K: as many blocks a cluster as still fit one wave of ``sms`` (at
    least 1, at most 8 and the 128-wide k blocks), ``kb_per`` k blocks a
    rank, and the split recounted so that no rank is empty.  Shared by
    every kernel that splits K over a cluster (``plan`` here,
    ``binary_dot.plan``)."""
    nkb = max(1, -(-K // KB))
    split = max(1, min(MAX_SPLIT, nkb, sms // max(1, live)))
    kb_per = -(-nkb // split)
    return -(-nkb // kb_per), kb_per


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of a CUDA device (read once a device)."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
