"""Timing on the card: a function's device time by CUDA events, and its
host time to enqueue.  Both need a CUDA device and raise without one:
neither falls back to the host clock for a device time."""
from __future__ import annotations

import time
from typing import Callable

import torch

# the device spin in ``device_ms``, about 0.5 ms at the H100's clocks:
# longer than the host takes to enqueue one call of a kernel wrapper
SPIN_CYCLES = 1_000_000


def _require_cuda(device) -> None:
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device timing needs a CUDA device, got "
                           f"{device} (CUDA available: "
                           f"{torch.cuda.is_available()})")


def device_ms(fn: Callable, flush: torch.Tensor, iters: int = 10) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, each timed by its
    own CUDA event pair with the L2 cache flushed before it (``flush``:
    a CUDA buffer larger than L2, zeroed).  A spin of SPIN_CYCLES on the
    stream between the flush and the start event lets the host enqueue
    all of ``fn``'s launches before the device reaches them, so the pair
    times the device's work and not the host's enqueue (``host_ms``
    times that).  Three untimed calls warm up first."""
    _require_cuda(flush.device)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def host_ms(fn: Callable, iters: int = 50) -> float:
    """Mean host ms to enqueue one call of ``fn`` (its Python and its
    launches, without waiting for the device), after three warm-up
    calls."""
    _require_cuda("cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e3
