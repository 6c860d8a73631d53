"""Distributed flash decode over the page-sharded paged pool
(``repro.distributed.decode_attention``).

Under ``Engine(layout="paged-sharded")`` every rank holds one page shard
of every pool leaf:

  * block and state tables stay replicated and hold GLOBAL page ids;
    rank r holds the ids [r n_local, (r + 1) n_local) of every pool
    leaf, at local index id - r n_local, plus the trailing scratch page
    the writes send dropped rows to (so ``n_local`` is the leaf's page
    count less one);
  * writes map global ids to local ones and send pages another rank
    owns to the scratch page (``pool_set``; torch has no ``mode="drop"``
    scatter);
  * the attends run the paged kernels' shard-window, partial form over
    the resident pages (foreign pages are skipped like the null page)
    and merge the ranks' statistics with ONE collective per attention
    layer (``collectives.flash_merge``);
  * recurrent state pools shard the same way with a single-owner
    gather: the one rank that holds a slot's state row contributes it,
    the others zeros, and one ``all_reduce`` per state leaf per dispatch
    replicates it (``state_take``); only the owner writes it back
    (``state_put``).

Every helper degrades to the single-device paged behaviour when no
page-shard context is active, so the models keep exactly one paged
branch.  The context is the rank's ``launch.mesh.PageGroup``, entered
around the engine's step (``serving.mesh``).  The reference's
pool-direct CPU fallback (``pool_positions``, ``gqa_pool_flash``,
``mla_pool_flash``) is not on the port's path: the port always attends
through the kernels' wrappers.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.distributed.collectives import flash_merge, sum_disjoint
from repro_torch.kernels.paged_attention import (gqa_paged_flash,
                                                 mla_paged_flash)

_TLS = threading.local()


@contextlib.contextmanager
def page_shard_context(group):
    """Activate the page-shard context (a ``PageGroup``) for the engine
    step that runs inside it."""
    prev = getattr(_TLS, "group", None)
    _TLS.group = group
    try:
        yield
    finally:
        _TLS.group = prev


def shard_info():
    """-> the active ``PageGroup``, or None outside a sharded step."""
    return getattr(_TLS, "group", None)


def _local_base(n_local: int, group) -> int:
    """First global page id resident on this rank."""
    return group.rank * n_local


def _local(ids: torch.Tensor, n_local: int, group):
    """-> (local index, resident) of global page ids on this rank."""
    loc = ids - _local_base(n_local, group)
    return loc, (loc >= 0) & (loc < n_local)


# ==========================================================================
# pool access through the (replicated) block tables
# ==========================================================================

def pool_set(pool: torch.Tensor, pidx: torch.Tensor, off: torch.Tensor,
             val: torch.Tensor, valid: torch.Tensor) -> None:
    """Write ``val`` into a page pool IN PLACE at (page ``pidx``, row
    ``off``): ``pool`` (n_local + 1, page, ...) whose last page is the
    scratch page, ``pidx`` / ``off`` / ``valid`` (B, C) global page ids,
    in-page offsets and validity.  Invalid tokens, and under a
    page-shard context pages another rank holds, go to the scratch page,
    which no table holds, so every real page stays bit-identical (their
    owner makes the same write with the roles reversed)."""
    n_local = pool.shape[0] - 1
    group = shard_info()
    if group is None:
        tgt = torch.where(valid, pidx, n_local)
    else:
        loc, ok = _local(pidx, n_local, group)
        tgt = torch.where(valid & ok, loc, n_local)
    pool[tgt, off] = val


# ==========================================================================
# distributed flash decode: partial (m, l, acc) + one-collective merge
# ==========================================================================

def gqa_paged_attend(q, kpool, vpool, ppool, block_table, qpos, *,
                     window: int = 0) -> torch.Tensor:
    """Sharded GQA paged attention: ``gqa_paged_flash``'s partial form
    over this rank's resident pages, merged across ranks with ONE
    collective.  q (B, C, H, D); pools (n_local + 1, page, hkv, ·);
    block_table (B, W) global ids; qpos (B, C).  -> (B, C, H, Dv) in q's
    dtype: the exact softmax over every rank's pages."""
    group = shard_info()
    assert group is not None, "gqa_paged_attend needs a page-shard context"
    B, C, H, _ = q.shape
    n_local = kpool.shape[0] - 1
    m, l, acc = gqa_paged_flash(q, kpool, vpool, ppool, block_table, qpos,
                                window=window,
                                lo=_local_base(n_local, group),
                                n_local=n_local, partial=True)
    o = flash_merge(m, l, acc, group)                # (B, hkv, G, C, Dv)
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, -1).to(q.dtype)


def mla_paged_attend(q_lat, q_pe, ck_pool, cpe_pool, cp_pool, block_table,
                     qpos, *, scale: float) -> torch.Tensor:
    """Sharded absorbed-MLA paged attention: ``mla_paged_flash``'s
    partial form over the resident latent pages, merged with ONE
    collective.  -> o_lat (B, C, h, kr) in q_lat's dtype (the caller
    absorbs W_uv)."""
    group = shard_info()
    assert group is not None, "mla_paged_attend needs a page-shard context"
    n_local = ck_pool.shape[0] - 1
    m, l, acc = mla_paged_flash(q_lat, q_pe, ck_pool, cpe_pool, cp_pool,
                                block_table, qpos, scale=scale,
                                lo=_local_base(n_local, group),
                                n_local=n_local, partial=True)
    o = flash_merge(m, l, acc, group)                # (B, h, C, kr)
    return o.permute(0, 2, 1, 3).to(q_lat.dtype)


# ==========================================================================
# recurrent-state pools: single-owner gather / owner-local scatter
# ==========================================================================

def state_take(pool: torch.Tensor, table) -> torch.Tensor:
    """Each slot's state rows through the (B,) state table: pool (L,
    n_spages, ...) -> (L, B, ...), for every layer at once (``table``
    None: the slotted layout's rows, the pool itself).  Sharded, the
    pool is (L, n_local + 1, ...) with a trailing scratch page: exactly
    one rank holds each row, it contributes the row, the others zeros,
    and ONE collective per leaf per dispatch replicates the result."""
    if table is None:
        return pool
    group = shard_info()
    if group is None:
        return pool[:, table]
    loc, ok = _local(table, pool.shape[1] - 1, group)
    g = pool[:, torch.where(ok, loc, 0)]
    mask = ok.reshape((1, -1) + (1,) * (g.ndim - 2))
    g = torch.where(mask, g, torch.zeros((), dtype=g.dtype,
                                         device=g.device))
    return sum_disjoint(g.contiguous(), group, "state_take")


def state_put(leaf: torch.Tensor, table, new: torch.Tensor) -> None:
    """Write one layer's new state rows back IN PLACE through the state
    table (``leaf`` is the layer's (n_spages, ...) pool; ``table`` None:
    the slotted rows themselves).  Sharded, only the owning rank writes:
    the others send the row to their scratch page."""
    new = new.to(leaf.dtype)
    if table is None:
        leaf.copy_(new)
        return
    group = shard_info()
    if group is None:
        leaf[table] = new
        return
    n_local = leaf.shape[0] - 1
    loc, ok = _local(table, n_local, group)
    leaf[torch.where(ok, loc, n_local)] = new
