"""The page-sharded serving layout's glue (``repro.serving.mesh``).

``Engine(layout="paged-sharded", group=...)`` runs on every rank of a
``launch.mesh.PageGroup``.  There is no ``shard_map``: each rank runs the
engine's whole step, with the host half (scheduler, allocators, prefix
cache, tables) replicated, and only the page pools split, one page range
a rank (``kv_pool.PagedPool(n_shards=, shard=)``).  The engine runs its
step body inside ``decode_attention.page_shard_context`` over the
rank's local cache, so the
models' one paged branch writes its pages and runs the distributed flash
decode (``distributed.decode_attention``): one merge collective per
attention layer per dispatch and, for recurrent state, one gather per
state leaf.  Parameters, activations and the MoR plans are replicated
and must be the same bits on every rank: ``check_replicated`` asserts it
at start-up, ``broadcast`` hands rank 0's calibrated tree to the others,
and ``check_tokens`` holds the ranks' greedy tokens equal at every
flush (ranks that disagreed would drive diverging schedulers).  The
page-sharded shadow step is ROADMAP queue A 7 of the port.
"""
from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import all_ranks

__all__ = ["check_replicated", "broadcast", "check_tokens"]


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for k in sorted(tree.__dataclass_fields__)
                for t in _leaves(getattr(tree, k))]
    return []


def check_replicated(tree, group, what: str) -> None:
    """Assert that every rank holds the same ``tree``: a checksum of
    each tensor leaf (float64 sums of the values and of their squares),
    exchanged by one collective, must be equal on all ranks."""
    leaves = _leaves(tree)
    dev = leaves[0].device if leaves else group.device
    rows = [torch.zeros(2, dtype=torch.float64, device=dev)]
    for t in leaves:
        row = rows[0].new_zeros(2)
        # float64 copies of 2^24 values at a time: a full-width weight
        # stack would not fit twice more
        for part in t.detach().reshape(-1).split(1 << 24):
            x = part.double()
            row += torch.stack([x.sum(), x.square().sum()])
        rows.append(row)
    allr = all_ranks(torch.stack(rows), group, "check_replicated")
    bad = [r for r in range(group.size) if not torch.equal(allr[r], allr[0])]
    if bad:
        raise RuntimeError(f"{what} differ between ranks 0 and {bad}: the "
                           f"page-sharded layout replicates them")


def broadcast(obj: Any, group, src: int = 0, device=None) -> Any:
    """``obj`` from rank ``src`` on every rank (its tensors go as CPU
    copies and come back on ``device``, by default the rank's)."""
    box = [_to(obj, "cpu") if group.rank == src else None]
    dist.broadcast_object_list(box, src=src, group=group.pg)
    return _to(box[0], group.device if device is None else device)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        import dataclasses
        return dataclasses.replace(tree, **{
            k: _to(getattr(tree, k), device)
            for k, f in tree.__dataclass_fields__.items() if f.init})
    return tree


def check_tokens(tokens: torch.Tensor, group, first: int) -> None:
    """Raise unless every rank sampled the same tokens: ``tokens`` (n,
    n_slots) int32 of the engine's logged dispatches ``first``, ``first``
    + 1, ... (those that emit a token); names the first where a rank
    differs."""
    allr = all_ranks(tokens, group, "check_tokens").cpu()
    for r in range(1, group.size):
        diff = (allr[r] != allr[0]).any(-1).nonzero()
        if len(diff):
            d = int(diff[0])
            raise RuntimeError(
                f"page-sharded ranks 0 and {r} sampled different tokens at "
                f"logged dispatch {first + d}: {allr[0][d].tolist()} against "
                f"{allr[r][d].tolist()}")
