"""The page shards' flash merge (``repro.distributed.collectives``
``flash_merge``): ONE collective per attention layer.

Each rank holds partial flash statistics over its locally resident kv
pages: running max ``m`` (...), denominator ``l`` (...) and the
unnormalised accumulator ``acc`` (..., Dv), all float32.  The ranks
exchange them packed into one (..., Dv + 2) float32 buffer, by one
``all_reduce(SUM)`` of a (world, ..., Dv + 2) zero buffer in which rank r
fills slot r, summed as bytes: adding zeros is exact, so every rank
receives every rank's statistics bit for bit, on gloo (CPU or CUDA
tensors) and NCCL alike, and then combines them locally in rank order
(``merge_stacked``):

    m* = max_i m_i;  w_i = exp(m_i - m*);
    o = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30)

A rank with no resident page for a row (m_i = -1e30, l_i = 0) weighs
nothing against a real score.  ``counts`` tallies the collectives this
module and ``decode_attention`` issue, by name, so that a run can show
exactly one merge per attention layer per dispatch; ``nbytes`` their
buffers' bytes by kind ("all-reduce"), which ``launch.roofline.
collective_wire_bytes`` turns into wire bytes.  The overlapped
all-gather / reduce-scatter matmuls of tensor parallelism are ROADMAP
queue A 7 of the port.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

# collectives run since the last reset, by name; their buffers' bytes,
# by kind
counts: Dict[str, int] = {}
nbytes: Dict[str, int] = {}


def reset_counts() -> None:
    counts.clear()
    nbytes.clear()


def _count(name: str, kind: str, x: torch.Tensor) -> None:
    counts[name] = counts.get(name, 0) + 1
    nbytes[kind] = nbytes.get(kind, 0) + x.numel() * x.element_size()


def sum_disjoint(x: torch.Tensor, group, name: str) -> torch.Tensor:
    """``all_reduce(SUM)`` IN PLACE of a tensor whose non-zero entries
    on each rank are zero on every other rank, summed as bytes (viewed as
    uint8): x + 0 = x with no carry, so every dtype travels bit for bit
    on any backend.  -> x."""
    dist.all_reduce(x.view(torch.uint8), op=dist.ReduceOp.SUM,
                    group=group.pg)
    _count(name, "all-reduce", x)
    return x


def all_ranks(x: torch.Tensor, group, name: str) -> torch.Tensor:
    """-> (world, *x.shape): every rank's ``x``, by one collective over
    a zero buffer in which this rank fills its own slot."""
    buf = torch.zeros((group.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[group.rank] = x
    return sum_disjoint(buf, group, name)


def merge_stacked(m: torch.Tensor, l: torch.Tensor,
                  acc: torch.Tensor) -> torch.Tensor:
    """The local combine of P ranks' statistics stacked on a leading
    axis, in rank order: m, l (P, ...), acc (P, ..., Dv) -> the
    normalised output (..., Dv) in float32."""
    m, l, acc = m.float(), l.float(), acc.float()
    w = torch.exp(m - m.amax(0))
    den = (w * l).sum(0)
    return (w[..., None] * acc).sum(0) / torch.clamp(den, min=1e-30)[
        ..., None]


def flash_merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                group) -> torch.Tensor:
    """Exact softmax merge of the ranks' partial statistics with ONE
    collective: m, l (...), acc (..., Dv) -> (..., Dv) float32, the same
    bits on every rank."""
    packed = torch.cat([m.float()[..., None], l.float()[..., None],
                        acc.float()], -1)
    allp = all_ranks(packed, group, "flash_merge")
    return merge_stacked(allp[..., 0], allp[..., 1], allp[..., 2:])
