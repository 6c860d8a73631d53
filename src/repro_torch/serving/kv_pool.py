"""Serving cache layouts (``repro.serving.kv_pool``): the contiguous slot
pool and the paged pool (fixed-size pages + block tables + refcounts +
copy-on-write + prefix caching), for attention kv and recurrent state.

**Slot pool** (``init`` / ``reset_slots``): every slot owns a contiguous
row of every cache leaf: the model's ``cache_init`` tree at batch
``n_slots``, with the page/slot dim at axis 1 of every stacked leaf and
a top-level ``pos`` (n_slots,) next position per slot.  A transformer's
is {"pos", "layers": {"k", "v": (L, n_slots, Lr, hkv, hd), "pos": (L,
n_slots, Lr) int32 position tags, -1 = empty}} (an MLA model holds its
latent rows {"c_kv", "k_pe", "pos"} over the full ``max_len`` instead;
all L layers of a moe model form one stack, where JAX keeps one per
layer group); an RWKV model's holds state leaves only ({"tm_shift",
"wkv", "cm_shift"}), a hybrid's both ({"mamba", "tail"} state and the
shared attention's ring "shared_attn").  The tree walkers
(``map_kv_nodes``, ``map_state_leaves``) tell the two kinds apart.

**Paged pool** (``PagedPool``): the engine's default layout.  A kv
node's leaves become page pools: a slot's logical ring row ``r`` lives
at ``(block_table[slot, r // page], r % page)``, page 0 is the reserved
null page (position tags -1, never written).  A state leaf becomes an
(L, n_state_pages, ...) pool indexed by a one-entry-per-slot
``state_table``: the same indirection with one block, which is what
lets prefix-cache state snapshots live in the same pool as the live
slots.  The host half (``BlockAllocator``, ``PrefixCache``) is numpy;
``PagedPool`` turns its decisions into ONE packed int32 vector per
dirty dispatch that ``apply_cache_ops`` applies to the device cache in
place.  With ``n_shards > 1`` the pool is page-sharded over ranks (the
``paged-sharded`` layout): the host half is replicated and
ownership-aware, and each rank builds and edits only its own page range.

Preemption (``spill`` / ``restore``, one device) moves a slot's
exclusively owned pages and its recurrent state to the host and keeps
its shared pages by reference (``SpillRecord``); a speculative round
(``spec_fork`` ... ``spec_abort``) is a block-table operation plus, for
a model with state, one backup copy of the state page (``SpecFork``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.serving.prefix_cache import PrefixCache

class PoolExhausted(RuntimeError):
    """A paged pool ran out of pages (after prefix-cache eviction)."""


def ring_cfg(cfg: ModelConfig, chunk: int) -> ModelConfig:
    """Config used ONLY for cache allocation: window + chunk ring slack
    (a hybrid's shared attention window too)."""
    if cfg.sliding_window:
        cfg = cfg.replace(sliding_window=cfg.sliding_window + chunk)
    if cfg.family == "hybrid" and cfg.shared_attn_window:
        cfg = cfg.replace(shared_attn_window=cfg.shared_attn_window + chunk)
    return cfg


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the device: a
    pinned staging copy and an asynchronous transfer on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


# ==========================================================================
# tree walkers
# ==========================================================================

_TABLE_KEYS = ("pos", "block_table", "state_table")


def _is_kv_node(node) -> bool:
    return isinstance(node, dict) and (
        ("k" in node and "pos" in node) or "c_kv" in node)


def map_kv_nodes(tree, fn):
    """Apply ``fn`` to every token-indexed cache node (attention ring /
    MLA latent dicts), leaving everything else untouched."""
    if _is_kv_node(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_kv_nodes(v, fn) for k, v in tree.items()}
    return tree


def map_state_leaves(tree, fn):
    """Apply ``fn`` to every recurrent-state leaf (any tensor leaf NOT
    inside a token-indexed node)."""
    if _is_kv_node(tree):
        return tree
    if isinstance(tree, dict):
        return {k: map_state_leaves(v, fn) for k, v in tree.items()}
    return fn(tree)


def _cache_nodes(cache: Dict):
    """The cache's subtrees, without the top-level tables."""
    return [v for k, v in cache.items() if k not in _TABLE_KEYS]


# ==========================================================================
# slot-pool layout (contiguous per-slot rows)
# ==========================================================================

def _upgrade(node, n_slots: int, device):
    """Give every attention ring per-slot position tags (``cache_init``
    shares one (L, Lr) tag row across the batch)."""
    if not isinstance(node, dict):
        return node
    if "k" in node and "pos" in node:
        out = dict(node)
        lead, Lr = node["pos"].shape[:-1], node["pos"].shape[-1]
        out["pos"] = torch.full(tuple(lead) + (n_slots, Lr), -1,
                                dtype=torch.int32, device=device)
        return out
    if "c_kv" in node:                 # MLA: per-slot tags already
        return node
    return {k: _upgrade(v, n_slots, device) for k, v in node.items()}


def init(cfg: ModelConfig, n_slots: int, max_len: int, chunk: int = 0,
         dtype=None, device="cuda") -> Dict:
    """Allocate the slot-pool cache for ``n_slots`` sequences of up to
    ``max_len`` positions."""
    chunk = chunk or cfg.serve_chunk
    api = get_model(cfg)
    cache = api.cache_init(ring_cfg(cfg, chunk), n_slots, max_len,
                           dtype or cfg.tdtype, device)
    out = {k: _upgrade(v, n_slots, device) for k, v in cache.items()
           if k != "pos"}
    out["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=device)
    return out


def reset_slots(cache: Dict, slots: torch.Tensor) -> Dict:
    """Recycle cache slots IN PLACE: zero state / -1 kv tags / 0 position
    for every slot where ``slots`` (n_slots,) bool is True."""
    def walk(node):
        for key, a in node.items():
            if isinstance(a, dict):
                walk(a)
            else:
                m = slots.reshape((1, -1) + (1,) * (a.ndim - 2))
                a.masked_fill_(m, -1 if key == "pos" else 0)

    walk({k: v for k, v in cache.items() if k != "pos"})
    cache["pos"].masked_fill_(slots, 0)
    return cache


# ==========================================================================
# paged layout: applying the packed edits
# ==========================================================================

def apply_cache_ops(cache: Dict, ops: torch.Tensor, n_reset: int,
                    n_copy: int, n_st_reset: int = 0,
                    n_st_copy: int = 0) -> None:
    """Apply one packed vector of host-planned pool edits to the device
    cache IN PLACE: the ``pos``, ``block_table`` and ``state_table``
    uploads, page-tag resets (-1) for freshly allocated kv pages and
    page copies (copy-on-write) on every kv node's pools (K, V or the
    MLA latent rows, and the tags), then zeroing of freshly allocated
    state pages and state page copies (prefix-cache snapshots and their
    restores) on every state leaf.

    ``ops`` (int32, on the cache's device) is laid out by
    ``PagedPool.drain`` (a page-sharded pool's rank gets its own row,
    page ids local to its range): pos (n_slots) | block_table (n_slots *
    n_blocks, where the model has kv) | state_table (n_slots, where it
    has state) | kv reset page ids (n_reset) | kv copy sources (n_copy)
    | destinations (n_copy) | state reset page ids (n_st_reset) | state
    copy sources (n_st_copy) | destinations (n_st_copy).  JAX pads the
    copies out of bounds to static widths for ``jit``; eager torch
    passes exactly the real ones, so nothing is dropped here.  State
    copies run one after another, in queue order: a restore may read a
    snapshot taken earlier in the same batch."""
    S = cache["pos"].shape[0]
    i = 0

    def take(n):
        nonlocal i
        out = ops[i:i + n]
        i += n
        return out

    cache["pos"].copy_(take(S))
    if "block_table" in cache:
        bt = cache["block_table"]
        bt.copy_(take(bt.numel()).view(bt.shape))
    if "state_table" in cache:
        cache["state_table"].copy_(take(S))
    reset, src, dst = take(n_reset), take(n_copy), take(n_copy)
    st_reset, st_src, st_dst = take(n_st_reset), take(n_st_copy), \
        take(n_st_copy)

    def kv(node):
        if n_reset:
            node["pos"][:, reset] = -1
        if n_copy:
            for a in node.values():
                a[:, dst] = a[:, src]
        return node

    def st(a):
        if n_st_reset:
            a[:, st_reset] = 0
        for j in range(n_st_copy):
            # one-element index slices: no host read of the page ids
            a[:, st_dst[j:j + 1]] = a[:, st_src[j:j + 1]]
        return a

    for node in _cache_nodes(cache):
        map_kv_nodes(node, kv)
        map_state_leaves(node, st)


def ops_counts(cache: Dict, ops: torch.Tensor, n_reset: int, n_copy: int,
               n_st_reset: int = 0, n_st_copy: int = 0) -> Dict:
    """Count the page edits a packed ops vector performs (the same walk
    as ``apply_cache_ops``) as four int32 device scalars for the obs
    metrics block, read off the vector on the device: no host value
    enters.  A page-sharded rank's vector holds its own pages' edits, so
    its counts are shard-local."""
    S = cache["pos"].shape[0]
    i = S + (cache["block_table"].numel() if "block_table" in cache else 0)
    i += S if "state_table" in cache else 0
    out = {}
    for name, n_res, n_cp in (("kv", n_reset, n_copy),
                              ("state", n_st_reset, n_st_copy)):
        reset, dst = ops[i:i + n_res], ops[i + n_res + n_cp:
                                           i + n_res + 2 * n_cp]
        out[f"{name}_page_resets"] = (reset >= 0).sum(dtype=torch.int32)
        out[f"{name}_page_copies"] = (dst >= 0).sum(dtype=torch.int32)
        i += n_res + 2 * n_cp
    return out


def shadow_view(cache: Dict, group=None) -> Dict:
    """The cache a shadow twin dispatch runs on, leaving ``cache`` as it
    was: ``pos`` and the recurrent state the dispatch rewrites are
    copies (on the paged layout only the rows under the slots' state
    table, gathered into a pool of n_slots pages behind an identity
    table), while the kv pools and the block table are shared.  Sharing
    the kv pools is safe because the primary dispatch, run right after
    on the same tables and ``n_valid``, writes exactly the same (page,
    row) entries, and each layer writes its rows before it attends.

    ``group``: the rank's page group of the page-sharded layout, whose
    state pools hold its page shard and a scratch page.  Each rank's
    view pool then holds n_slots pages and a scratch page: at slot b's
    page the rows this rank owns (zeros where another rank does),
    behind a table naming slot b's owner (owner x n_slots + b), so that
    the twin's ``state_take`` gathers the same rows with the same one
    collective a leaf as the primary step and its ``state_put`` writes
    into the view; no collective builds it."""
    table = cache.get("state_table")
    if table is not None and group is not None:
        return _sharded_shadow_view(cache, table, group)
    out = {}
    for k, v in cache.items():
        if k in _TABLE_KEYS:
            continue
        out[k] = map_state_leaves(
            v, (lambda a: a.clone()) if table is None
            else (lambda a: a[:, table.long()]))
    out["pos"] = cache["pos"].clone()
    if "block_table" in cache:
        out["block_table"] = cache["block_table"]
    if table is not None:
        out["state_table"] = torch.arange(table.shape[0], dtype=table.dtype,
                                          device=table.device)
    return out


def _sharded_shadow_view(cache: Dict, table: torch.Tensor, group) -> Dict:
    """``shadow_view`` of a page-sharded rank's cache (see there)."""
    B = table.shape[0]
    t = table.long()

    def view(a):
        n_local = a.shape[1] - 1
        loc = t - group.rank * n_local
        ok = (loc >= 0) & (loc < n_local)
        rows = a[:, torch.where(ok, loc, 0)]
        mask = ok.reshape((1, -1) + (1,) * (rows.ndim - 2))
        rows = torch.where(mask, rows, torch.zeros((), dtype=a.dtype,
                                                   device=a.device))
        return torch.cat([rows, torch.zeros_like(rows[:, :1])], 1)

    out = {k: map_state_leaves(v, view) for k, v in cache.items()
           if k not in _TABLE_KEYS}
    leaves = []
    for v in _cache_nodes(cache):
        map_state_leaves(v, lambda a: leaves.append(a) or a)
    owner = torch.div(t, leaves[0].shape[1] - 1, rounding_mode="floor")
    out["state_table"] = (owner * B + torch.arange(
        B, device=t.device)).to(table.dtype)
    out["pos"] = cache["pos"].clone()
    if "block_table" in cache:
        out["block_table"] = cache["block_table"]
    return out


def _scan_structure(cache: Dict) -> Tuple[bool, bool, int]:
    """-> (has_kv, has_state, kv ring length in rows) of a
    ``cache_init`` tree."""
    has_kv, has_state, ring = False, False, 0

    def kv(node):
        nonlocal has_kv, ring
        has_kv = True
        rows = (node["k"].shape[-3] if "k" in node
                else node["c_kv"].shape[-2])
        ring = max(ring, rows)
        return node

    def st(leaf):
        nonlocal has_state
        has_state = True
        return leaf

    for node in _cache_nodes(cache):
        map_kv_nodes(node, kv)
        map_state_leaves(node, st)
    return has_kv, has_state, ring


# ==========================================================================
# BlockAllocator: host-side page accounting
# ==========================================================================

class BlockAllocator:
    """Free lists + refcounts + per-slot block tables for one page pool
    (``repro.serving.kv_pool.BlockAllocator``).

    Page ids are ints in ``[1, n_pages)``; id 0 is the reserved null
    page and is never allocated.  A page's refcount equals the number of
    holders: block-table entries pointing at it plus external retains
    (prefix-cache entries, pending-copy pins).  ``ref == 1`` with a
    single table entry means the slot owns the page exclusively and may
    write it in place; ``write_plan`` enforces that, allocating fresh
    pages for null entries and copy-on-writing shared ones.

    With ``n_shards > 1`` the id space is partitioned into ``n_shards``
    contiguous ranges of ``pages_per_shard`` (shard s holds ids [s pps,
    (s + 1) pps)) and the allocator is ownership-aware: a page stays on
    the shard that holds it for its whole life, fresh pages round-robin
    the shards most-free-first, and a copy-on-write destination goes on
    its source's shard (``alloc(prefer=)``), so every page copy is
    shard-local."""

    def __init__(self, n_pages: int, n_slots: int, n_blocks: int,
                 n_shards: int = 1):
        assert n_pages >= 2 and n_slots >= 1 and n_blocks >= 1
        assert n_shards >= 1 and n_pages % n_shards == 0, \
            "the page count must divide evenly over the shards"
        self.n_pages = n_pages
        self.n_shards = n_shards
        self.pages_per_shard = pps = n_pages // n_shards
        self.table = np.zeros((n_slots, n_blocks), np.int32)
        self.ref = np.zeros((n_pages,), np.int64)
        self.ref[0] = 1                          # null page, pinned
        # per-shard LIFO free lists (shard 0's without the null page)
        self._free: List[List[int]] = [
            list(range((s + 1) * pps - 1, max(1, s * pps) - 1, -1))
            for s in range(n_shards)]
        self._rr = 0                             # round-robin tiebreak
        # occupancy per shard, current and high-water
        self.in_use = np.zeros((n_shards,), np.int64)
        self.hiwater = np.zeros((n_shards,), np.int64)
        # cumulative alloc/free event counts
        self.events = {"alloc": 0, "free": 0}

    @property
    def free(self) -> List[int]:
        """The free page ids: on one shard the free list itself, else
        every shard's, flattened."""
        if self.n_shards == 1:
            return self._free[0]
        return [p for fl in self._free for p in fl]

    def shard_of(self, page: int) -> int:
        return page // self.pages_per_shard

    # -- primitive ops -----------------------------------------------------
    def alloc(self, prefer: Optional[int] = None) -> Optional[int]:
        """Allocate a page: on shard ``prefer`` (a copy's destination on
        its source's shard), else on the shard with the most free pages,
        ties broken round-robin."""
        if prefer is None:
            prefer = min(range(self.n_shards),
                         key=lambda i: (-len(self._free[i]),
                                        (i - self._rr) % self.n_shards))
            if self._free[prefer]:
                self._rr = (prefer + 1) % self.n_shards
        if not self._free[prefer]:
            return None
        p = self._free[prefer].pop()
        assert self.ref[p] == 0, "free list held a referenced page"
        self.ref[p] = 1
        sh = self.shard_of(p)
        self.in_use[sh] += 1
        self.hiwater[sh] = max(self.hiwater[sh], self.in_use[sh])
        self.events["alloc"] += 1
        return p

    def retain(self, page: int) -> None:
        assert page != 0 and self.ref[page] > 0, "retain of unowned page"
        self.ref[page] += 1

    def unalloc(self, page: int) -> None:
        """Return a just-allocated (sole-ref) page to the free list."""
        assert self.ref[page] == 1, "unalloc of a shared page"
        self.ref[page] = 0
        self._free[self.shard_of(page)].append(page)
        self.in_use[self.shard_of(page)] -= 1
        self.events["free"] += 1

    def drop(self, page: int) -> bool:
        """Drop one reference; returns True if the page was freed."""
        assert page != 0 and self.ref[page] > 0, "drop of unowned page"
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self._free[self.shard_of(page)].append(page)
            self.in_use[self.shard_of(page)] -= 1
            self.events["free"] += 1
            return True
        return False

    # -- table ops ---------------------------------------------------------
    def share(self, slot: int, block: int, page: int) -> None:
        """Point a (null) block-table entry at an existing page."""
        assert self.table[slot, block] == 0, "share over an owned block"
        self.retain(page)
        self.table[slot, block] = page

    def write_plan(self, slot: int, blocks: Sequence[int], alloc=None,
                   on_copy=None) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Make every listed block exclusively owned by ``slot`` before a
        dispatch writes it.  Returns ``(fresh, copies)``: ``fresh`` pages
        were allocated for null entries (their position tags must be
        reset), ``copies`` are (src, dst) copy-on-write pairs (dst is a
        fresh page; src keeps its remaining holders and is NEVER
        written).  ``on_copy(src, dst)`` fires the moment a pair is
        created, BEFORE any later block's alloc, so the caller can pin
        src against eviction by that very alloc.  A sharded pool
        allocates a copy's destination on its source's shard."""
        alloc = alloc or self.alloc
        fresh: List[int] = []
        copies: List[Tuple[int, int]] = []
        for b in blocks:
            cur = int(self.table[slot, b])
            if cur != 0 and self.ref[cur] == 1:
                continue                          # already exclusive
            new = alloc(prefer=self.shard_of(cur)
                        if cur != 0 and self.n_shards > 1 else None)
            if new is None:
                raise PoolExhausted("paged KV pool exhausted")
            if cur == 0:
                fresh.append(new)
            else:
                copies.append((cur, new))
                if on_copy is not None:
                    on_copy(cur, new)
                self.drop(cur)                    # ref > 1: never frees
            self.table[slot, b] = new
        return fresh, copies

    def release_slot(self, slot: int) -> List[int]:
        """Drop the slot's references; returns the pages actually freed."""
        freed = []
        for b in np.nonzero(self.table[slot])[0]:
            p = int(self.table[slot, b])
            if self.drop(p):
                freed.append(p)
        self.table[slot, :] = 0
        return freed

    def check(self, external_refs: Optional[Dict[int, int]] = None) -> None:
        """No page leaked, no page double-owned: every non-null page is
        either on the free list (ref 0) or referenced, with its refcount
        equal to its holder count (table occurrences + external refs)."""
        free = set(self.free)
        assert len(free) == len(self.free), "free list has duplicates"
        assert 0 not in free and self.ref[0] == 1
        counts = np.bincount(self.table.reshape(-1),
                             minlength=self.n_pages).astype(np.int64)
        counts[0] = 1
        for p, n in (external_refs or {}).items():
            counts[p] += n
        for p in range(1, self.n_pages):
            if p in free:
                assert self.ref[p] == 0, f"page {p} free but referenced"
                assert counts[p] == 0, f"page {p} free but held"
            else:
                assert self.ref[p] == counts[p], \
                    f"page {p}: ref {self.ref[p]} != holders {counts[p]}"
        for s, fl in enumerate(self._free):
            assert all(self.shard_of(p) == s for p in fl), \
                f"shard {s} free list holds a foreign page"
        owned = np.bincount([self.shard_of(p)
                             for p in np.nonzero(self.ref[1:])[0] + 1],
                            minlength=self.n_shards)
        assert np.array_equal(owned, self.in_use), \
            f"per-shard in_use {self.in_use} != owned {owned}"


# ==========================================================================
# spill records and speculation forks (host side)
# ==========================================================================

# the kv-node leaf order shared by the spill gather and the restore
# scatter (k and v share shape and dtype: only a fixed walk order keeps
# the flat host lists aligned)
_KV_KEYS = ("k", "v", "c_kv", "k_pe", "pos")


@dataclass
class SpecFork:
    """Restore point of one slot's speculative round: the committed
    position, the block-table row at fork time (rollback drops the
    blocks the round allocated fresh) and, for a model with state, the
    backup state page holding the state at the fork (draft and verify
    dispatches advance the live page in place).  KV pages need no
    backup: stale rows past the committed position carry tags above any
    later query's position and mask themselves."""
    slot: int
    pos: int
    kv_row: Optional[np.ndarray] = None
    st_backup: int = 0


@dataclass
class SpillRecord:
    """Host image of a preempted slot, enough for ``restore`` to resume
    the request in any slot: its position, its last sampled token (the
    engine splices it back into its pending vector), the contents of its
    exclusively owned kv pages and of its state page (CPU tensors, in
    ``_KV_KEYS`` walk order), and the (block, page) pairs of its SHARED
    pages, kept by reference instead of copied."""
    rid: int = -1
    pos: int = 0
    last_token: int = 0
    kv_kept: List[Tuple[int, int]] = field(default_factory=list)
    kv_blocks: List[int] = field(default_factory=list)
    kv_host: List[torch.Tensor] = field(default_factory=list)
    st_host: List[torch.Tensor] = field(default_factory=list)
    nbytes: int = 0


# ==========================================================================
# PagedPool: device pool + prefix caching on top of the allocator
# ==========================================================================

class PagedPool:
    """The paged serving cache: builds the device cache, owns the host
    allocators (kv pages, state pages) and the prefix cache, and turns
    host-side decisions into ONE packed int32 vector per dirty dispatch
    (``drain``), uploaded and applied in place by ``flush``; a clean
    dispatch uploads nothing.

    Device layout (``build``): the model's ``cache_init`` tree with every
    kv node's leaves as page pools, (L, n_pages + 1, page, ...) ("k",
    "v" (..., hkv, hd) or an MLA model's latent "c_kv" / "k_pe", and the
    int32 position tags "pos" (L, n_pages + 1, page)), every state leaf
    as an (L, n_state_pages, ...) pool, and the top-level "pos"
    (n_slots,), "block_table" (n_slots, n_blocks) where the model has kv
    and "state_table" (n_slots,) where it has state; updated in place.
    JAX keeps per-layer tuples of pool leaves only so that XLA can alias
    each scatter to its donated buffer; eager torch writes in place
    anyway.  The trailing kv page ``n_pages`` is a scratch page that no
    table ever holds: the attention write sends the tokens it drops
    there (torch has no ``mode="drop"`` scatter), so every real page
    stays bit-identical.  State pages need none on one device: every
    slot owns its state page, and an idle slot's chunk step writes its
    state back unchanged.

    Page-sharded (``n_shards > 1``, this rank's ``shard``): the page
    counts round up to a multiple of ``n_shards``, the host half (both
    allocators, the prefix cache, the tables) is replicated on every
    rank and ownership-aware (``BlockAllocator``), and ``build`` gives
    this rank only its range of every pool leaf, ``pages_per_shard``
    pages at local index id - shard pps, plus a trailing scratch page
    (the state pools too: a rank that does not own a slot's state row
    writes it there).  ``drain`` emits this rank's row of the edits:
    its resets and copies, in local ids; a copy that crosses shards is
    an allocator bug and raises."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 chunk: int = 0, page: int = 0, dtype=None,
                 spare_pages: Optional[int] = None,
                 snap_slots: Optional[int] = None,
                 prefix_cache: bool = True, n_shards: int = 1,
                 shard: int = 0, device="cuda"):
        assert n_shards >= 1 and 0 <= shard < n_shards
        self.n_shards, self.shard = n_shards, shard
        chunk = chunk or cfg.serve_chunk
        page = page or cfg.serve_page
        assert page >= 1
        self.cfg, self.n_slots, self.max_len = cfg, n_slots, max_len
        self.chunk, self.page = chunk, page
        self.dtype = dtype or cfg.tdtype
        self.device = torch.device(device)
        # the cache's structure, on the meta device: nothing allocated
        self._proto = get_model(cfg).cache_init(
            ring_cfg(cfg, chunk), 1, max_len, self.dtype, "meta")
        self.has_kv, self.has_state, rows = _scan_structure(self._proto)
        # ring length rounded up to a page multiple: position p maps to
        # ring row p % ring, block r // page, offset r % page
        self.n_blocks = max(1, -(-rows // page)) if self.has_kv else 0
        self.ring = self.n_blocks * page
        if self.has_kv:
            spare = (n_slots * self.n_blocks if spare_pages is None
                     else spare_pages)
            n_pages = 1 + n_slots * self.n_blocks + spare
            self.n_pages = n_pages + (-n_pages) % n_shards
            self.kv = BlockAllocator(self.n_pages, n_slots, self.n_blocks,
                                     n_shards)
        else:
            self.n_pages, self.kv = 0, None
        if self.has_state:
            n_snap = (n_slots if (snap_slots is None and prefix_cache)
                      else (snap_slots or 0))
            # one live page per slot + one spare per slot (admission
            # cycles to a fresh page before the old one is dropped) +
            # the snapshot budget; page 0 reserved as null for symmetry
            n_spages = 1 + 2 * n_slots + n_snap
            self.n_spages = n_spages + (-n_spages) % n_shards
            self.st = BlockAllocator(self.n_spages, n_slots, 1, n_shards)
            for s in range(n_slots):
                self.st.table[s, 0] = self.st.alloc()
        else:
            self.n_spages, self.st = 0, None
        self.prefix = PrefixCache(page) if prefix_cache else None
        self.pos = np.zeros((n_slots,), np.int64)
        self.counters = {
            "prefix_queries": 0, "prefix_hits": 0, "tokens_reused": 0,
            "pages_shared": 0, "pages_published": 0, "pages_cowed": 0,
            "pages_evicted": 0, "snapshots": 0, "snap_restores": 0,
        }
        # pending device edits, applied by the next flush
        self._kv_reset: set = set()
        self._kv_copies: List[Tuple[int, int]] = []
        self._st_reset: set = set()
        self._st_copies: List[Tuple[int, int]] = []
        self._dirty = False
        # pages kept alive BY REFERENCE for spilled requests ({page: n})
        self._spill_kv: Dict[int, int] = {}
        self.spill_events = {"spills": 0, "restores": 0,
                             "spilled_bytes": 0}

    # -- device cache ------------------------------------------------------
    def local_pages(self) -> Tuple[int, int]:
        """-> (kv, state) pages of this rank's pool leaves: its range and
        the scratch page (the kv pool's scratch page also on one
        device)."""
        kv = self.n_pages // self.n_shards + 1
        st = self.n_spages if self.n_shards == 1 else \
            self.n_spages // self.n_shards + 1
        return kv, st

    def build(self) -> Dict:
        """Allocate the paged device cache (this rank's range of it, when
        sharded): pools zeroed, position tags -1, block tables null,
        state table at each slot's page."""
        dev, page = self.device, self.page
        n_kv, n_st = self.local_pages()

        def kv(node):
            out = {}
            for key, a in node.items():
                lead = a.shape[:1]               # the layer stack
                if key == "pos":
                    out[key] = torch.full(tuple(lead) + (n_kv, page), -1,
                                          dtype=torch.int32, device=dev)
                else:                            # (L, 1, rows, *feat)
                    out[key] = torch.zeros(
                        tuple(lead) + (n_kv, page) + tuple(a.shape[3:]),
                        dtype=a.dtype, device=dev)
            return out

        def st(a):
            return torch.zeros(a.shape[:1] + (n_st,) + a.shape[2:],
                               dtype=a.dtype, device=dev)

        cache: Dict = {}
        for k, v in self._proto.items():
            if k in _TABLE_KEYS:
                continue
            cache[k] = map_state_leaves(map_kv_nodes(v, kv), st)
        cache["pos"] = torch.zeros((self.n_slots,), dtype=torch.int32,
                                   device=dev)
        if self.has_kv:
            cache["block_table"] = torch.zeros(
                (self.n_slots, self.n_blocks), dtype=torch.int32,
                device=dev)
        if self.has_state:
            cache["state_table"] = upload(
                self.st.table[:, 0].astype(np.int32), dev)
        return cache

    def drain(self) -> Optional[Tuple[np.ndarray, int, int, int, int]]:
        """-> (ops, n_reset, n_copy, n_st_reset, n_st_copy): the pending
        edits as ONE packed int32 vector in the layout
        ``apply_cache_ops`` reads, or None when clean.  Emitting a copy
        releases its source's pin.  Sharded, the vector is this rank's
        row: the replicated tables, then the resets and copies of the
        pages its shard holds, in local ids (every rank drains the same
        host state, each keeping its own row)."""
        if not self._dirty:
            return None
        parts = [self.pos.astype(np.int32)]
        if self.has_kv:
            parts.append(self.kv.table.reshape(-1))
        if self.has_state:
            parts.append(self.st.table[:, 0])
        counts = []
        for alloc, reset, copies in ((self.kv, self._kv_reset,
                                      self._kv_copies),
                                     (self.st, self._st_reset,
                                      self._st_copies)):
            if alloc is None:
                parts.append(np.zeros((0,), np.int32))
                counts += [0, 0]
                continue
            base = self.shard * alloc.pages_per_shard
            mine = lambda p: alloc.shard_of(p) == self.shard
            for s, d in copies:
                if alloc.shard_of(s) != alloc.shard_of(d):
                    raise RuntimeError(
                        f"page copy {s} -> {d} crosses shards (an "
                        f"allocator ownership bug)")
            ids = sorted(p - base for p in reset if mine(p))
            src = [s - base for s, _ in copies if mine(s)]
            dst = [d - base for s, d in copies if mine(s)]
            for s, _ in copies:
                alloc.drop(s)            # release the pending-src pin
            reset.clear()
            copies.clear()
            parts.append(np.asarray(ids + src + dst, np.int32))
            counts += [len(ids), len(src)]
        self._dirty = False
        return (np.concatenate([p.astype(np.int32) for p in parts]),
                *counts)

    def flush(self, cache: Dict):
        """Apply all pending edits to ``cache`` now: one pinned,
        non-blocking host -> device transfer of the packed vector, then
        ``apply_cache_ops`` on the same stream.  -> (the device vector,
        its four counts) for ``ops_counts``, or None when clean (a
        no-op)."""
        drained = self.drain()
        if drained is None:
            return None
        ops, *counts = drained
        ops = upload(ops, self.device)
        apply_cache_ops(cache, ops, *counts)
        return ops, counts

    # pending page copies: the src is PINNED (one extra ref) from queueing
    # until ``drain`` emits the pair, so no interleaved eviction/free can
    # recycle it and reset it ahead of the copy
    def _push_kv_copy(self, src: int, dst: int) -> None:
        self.kv.retain(src)
        self._kv_copies.append((src, dst))
        self._kv_reset.add(dst)
        self._dirty = True

    def _push_st_copy(self, src: int, dst: int) -> None:
        self.st.retain(src)
        self._st_copies.append((src, dst))
        self._dirty = True

    def _on(self, alloc: BlockAllocator, page: int,
            prefer: Optional[int]) -> bool:
        return prefer is None or alloc.shard_of(page) == prefer

    def _kv_alloc(self, prefer: Optional[int] = None,
                  reset: bool = True) -> Optional[int]:
        """Allocate a kv page (on shard ``prefer`` when given), evicting
        LRU prefix-cache entries whose page actually frees (an entry
        still shared into a live slot reclaims nothing: keep it for
        future hits), then state snapshots holding such pages, on that
        shard.  ``reset=False`` (a restore, whose content is uploaded
        from the host) drops any reset still queued on the id instead of
        queueing one."""
        p = self.kv.alloc(prefer)
        while p is None and self.prefix is not None:
            pg = self.prefix.evict_lru_page(
                lambda q: self.kv.ref[q] == 1 and self._on(self.kv, q,
                                                           prefer))
            if pg is not None:
                self.kv.drop(pg)
                self.counters["pages_evicted"] += 1
            else:
                e = self.prefix.evict_lru_snap(
                    lambda s: any(self.kv.ref[q] == 1 and
                                  self._on(self.kv, q, prefer)
                                  for q in s.kv_pages))
                if e is None:
                    break
                self._drop_snap(e)
            p = self.kv.alloc(prefer)
        if p is not None:
            if reset:
                self._kv_reset.add(p)
            else:
                self._kv_reset.discard(p)
            self._dirty = True
        return p

    def _st_alloc(self, prefer: Optional[int] = None,
                  reset: bool = True) -> Optional[int]:
        """Allocate a state page (on shard ``prefer`` when given; zeroed
        by the next flush unless ``reset=False``, as in ``_kv_alloc``),
        evicting LRU snapshots; a snapshot pinned mid-restore (its
        page's ref > 1) is kept."""
        p = self.st.alloc(prefer)
        while p is None and self.prefix is not None:
            e = self.prefix.evict_lru_snap(
                lambda s: self.st.ref[s.spage] == 1 and
                self._on(self.st, s.spage, prefer))
            if e is None:
                break
            self._drop_snap(e)
            p = self.st.alloc(prefer)
        if p is not None:
            if reset:
                self._st_reset.add(p)
            else:
                self._st_reset.discard(p)
            self._dirty = True
        return p

    def _drop_snap(self, e) -> None:
        if self.st.drop(e.spage):
            self.counters["pages_evicted"] += 1
        for pg in e.kv_pages:
            if self.kv.drop(pg):
                self.counters["pages_evicted"] += 1

    # -- engine lifecycle ---------------------------------------------------
    def admit(self, slot: int, prompt: np.ndarray) -> int:
        """Attach a fresh request to ``slot``: match the prompt against
        the prefix cache, share the hit pages into its table / restore
        the hit state snapshot, cycle the slot onto a fresh state page,
        and set its position.  Returns the number of leading tokens
        whose prefill is skipped (always < len(prompt): the last token
        is recomputed to produce the first sampled logit).  On state
        pool exhaustion everything attached so far is rolled back before
        ``PoolExhausted`` is raised."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        n_cached = 0
        shared: List[int] = []
        snap = None
        if self.prefix is not None:
            self.counters["prefix_queries"] += 1
            limit = len(prompt) - 1
            if self.has_state:
                snap = self.prefix.match_state(prompt, limit)
                if snap is not None:
                    n_cached = snap.n_tokens
                    shared = snap.kv_pages
            elif self.has_kv:
                shared = self.prefix.match_pages(prompt, limit)
                n_cached = len(shared) * self.page
            if n_cached:
                self.counters["prefix_hits"] += 1
                self.counters["tokens_reused"] += n_cached
                self.counters["pages_shared"] += len(shared)
        for i, pg in enumerate(shared):
            self.kv.share(slot, i, pg)
        if self.has_state:
            if snap is not None:
                # pin the matched snapshot across the alloc below: its
                # eviction would free (and possibly recycle) the very
                # page the restore copy is about to read
                self.st.retain(snap.spage)
            # a restore copies the snapshot to the fresh page: it must
            # lie on the snapshot's shard (a shard-local copy)
            new = self._st_alloc(self.st.shard_of(snap.spage)
                                 if snap is not None and self.n_shards > 1
                                 else None)
            if new is None:
                if snap is not None:
                    self.st.drop(snap.spage)     # release the admit pin
                for i in range(len(shared)):
                    pg = int(self.kv.table[slot, i])
                    self.kv.table[slot, i] = 0
                    self.kv.drop(pg)
                raise PoolExhausted("paged state pool exhausted")
            old = int(self.st.table[slot, 0])
            if old:
                self.st.drop(old)
            self.st.table[slot, 0] = new
            if snap is not None:
                self._push_st_copy(snap.spage, new)
                self.st.drop(snap.spage)         # release the admit pin
                self.counters["snap_restores"] += 1
        self.pos[slot] = n_cached
        self._dirty = True
        return n_cached

    def plan_writes(self, n_valid: np.ndarray) -> None:
        """Pre-dispatch (host only): make every kv page this dispatch will
        write exclusively owned: fresh alloc for null blocks,
        copy-on-write for shared ones."""
        if not self.has_kv:
            return
        for s, nv in enumerate(np.asarray(n_valid)):
            if nv <= 0:
                continue
            p0 = int(self.pos[s])
            blocks = sorted({(p % self.ring) // self.page
                             for p in range(p0, p0 + int(nv))})
            fresh, copies = self.kv.write_plan(s, blocks,
                                               alloc=self._kv_alloc,
                                               on_copy=self._push_kv_copy)
            self.counters["pages_cowed"] += len(copies)
            if fresh:
                self._dirty = True

    def prepare(self, cache: Dict, n_valid: np.ndarray) -> None:
        """plan_writes + flush."""
        self.plan_writes(n_valid)
        self.flush(cache)

    def advance(self, n_valid: np.ndarray) -> None:
        self.pos += np.asarray(n_valid, np.int64)

    def active_blocks(self, n_valid: np.ndarray) -> Optional[int]:
        """Block-table width this dispatch needs (host-side, count-based:
        no device sync), None for a model without kv.  Every position a
        slot has written or will write this step lies below ``max(pos +
        n_valid)``, so the columns past ``ceil(need / page)`` hold only
        null pages.  A width below ``n_blocks`` changes the ring modulus,
        which is sound only while no slot has wrapped: ``pos + n_valid``
        is clamped to ``ring``, so a wrap forces the full width.  (JAX
        buckets the width to multiples of 4 to bound its compiled
        variants; eager torch needs no bucket.)"""
        if not self.has_kv:
            return None
        need = int(np.minimum(self.pos + np.asarray(n_valid, np.int64),
                              self.ring).max(initial=0))
        return min(max(1, -(-need // self.page)), self.n_blocks)

    def maybe_snapshot(self, slot: int, prompt: np.ndarray,
                       offset: int) -> None:
        """Called just before the dispatch that finishes ``slot``'s
        prompt: snapshot the recurrent state at ``offset`` (a page-aligned
        chunk boundary) keyed by ``prompt[:offset]``, retaining the
        shared-attention pages below it for a hybrid model."""
        if self.prefix is None or not self.has_state:
            return
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if offset <= 0 or offset % self.page or offset > len(prompt) - 1:
            return
        if self.has_kv and offset > self.ring:
            return                       # ring wrapped: pages incomplete
        if self.prefix.has_state(prompt, offset):
            return
        cur = int(self.st.table[slot, 0])
        spage = self._st_alloc(self.st.shard_of(cur)
                               if self.n_shards > 1 else None)
        if spage is None:
            return                       # snapshot budget exhausted
        self._push_st_copy(cur, spage)
        kv_pages: List[int] = []
        if self.has_kv:
            kv_pages = [int(self.kv.table[slot, i])
                        for i in range(offset // self.page)]
            for pg in kv_pages:
                self.kv.retain(pg)
        self.prefix.insert_state(prompt, offset, spage, kv_pages)
        self.counters["snapshots"] += 1
        self._dirty = True

    def publish(self, slot: int, prompt: np.ndarray) -> None:
        """Called when ``slot`` finishes prefill (attention families):
        publish the full pages of its prompt into the prefix trie.
        Prompts longer than the sliding-window ring have wrapped by now;
        those were published at the last pre-wrap page boundary by
        ``maybe_publish_prewrap``.  A model with state publishes
        snapshots instead (``maybe_snapshot``)."""
        if self.prefix is None or not self.has_kv or self.has_state:
            return
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) > self.ring:
            return
        n_full = (len(prompt) // self.page) * self.page
        self._insert(slot, prompt, n_full)

    def maybe_publish_prewrap(self, slot: int, prompt: np.ndarray,
                              offset: int, take: int) -> None:
        """Called pre-dispatch for every prefilling slot about to consume
        ``take`` tokens at ``offset``: on the dispatch that first writes
        past the ring, publish the prefix while it is still intact: the
        full pages [0, offset) of an attention family, the state snapshot
        at ``offset`` of a hybrid."""
        if self.prefix is None or not self.has_kv:
            return
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) <= self.ring:
            return                       # no wrap: publish() covers it
        if not (offset <= self.ring < offset + take):
            return                       # not the wrap-crossing dispatch
        if self.has_state:
            self.maybe_snapshot(slot, prompt, offset)
            return
        n_full = (min(offset, len(prompt) - 1) // self.page) * self.page
        if n_full > 0:
            self._insert(slot, prompt, n_full)

    def _insert(self, slot: int, prompt: np.ndarray, n_full: int) -> None:
        new = self.prefix.insert_pages(
            prompt, n_full, lambda i: self.kv.table[slot, i])
        for pg in new:
            self.kv.retain(pg)
        self.counters["pages_published"] += len(new)

    def release(self, slot: int) -> None:
        """Evict a finished request: drop its kv page refs (pages still
        pinned by the prefix cache survive for future hits).  Its state
        page stays its own until the next admission cycles it."""
        if self.has_kv:
            self.kv.release_slot(slot)
        self.pos[slot] = 0
        self._dirty = True

    # -- preemption: spill / restore ---------------------------------------
    def _walk_kv(self, cache: Dict, fn) -> None:
        """``fn(leaf)`` on every kv-pool leaf, in ``_KV_KEYS`` order."""
        def kv(node):
            for key in _KV_KEYS:
                if key in node:
                    fn(node[key])
            return node

        for node in _cache_nodes(cache):
            map_kv_nodes(node, kv)

    def _walk_state(self, cache: Dict, fn) -> None:
        for node in _cache_nodes(cache):
            map_state_leaves(node, lambda a: (fn(a), a)[1])

    def _to_host(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Device -> host copies of ``parts``, waited for once."""
        out = [a.to("cpu", non_blocking=True) for a in parts]
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def spill(self, slot: int, cache: Dict) -> SpillRecord:
        """Preempt ``slot``: move its cache contents off the device pool
        so that its pages can serve other requests, and return a record
        that ``restore`` replays into any free slot later.  Shared pages
        (the prefix trie or another slot holds them too) are not copied:
        the record keeps them by reference.  Exclusive pages and the
        slot's state page are copied to the host after the pending edits
        are applied (one wait for the device).  The slot keeps its state
        page; only the contents move."""
        if self.n_shards > 1:
            raise ValueError("spill / restore runs on one device "
                             "(layout='paged')")
        self.flush(cache)
        rec = SpillRecord(pos=int(self.pos[slot]))
        parts: List[torch.Tensor] = []
        n_kv = 0
        if self.has_kv:
            copied: List[Tuple[int, int]] = []
            for b in np.nonzero(self.kv.table[slot])[0]:
                pg = int(self.kv.table[slot, b])
                if self.kv.ref[pg] > 1:
                    self.kv.retain(pg)
                    self._spill_kv[pg] = self._spill_kv.get(pg, 0) + 1
                    rec.kv_kept.append((int(b), pg))
                else:
                    copied.append((int(b), pg))
            if copied:
                rec.kv_blocks = [b for b, _ in copied]
                ids = upload(np.asarray([pg for _, pg in copied], np.int64),
                             self.device)
                self._walk_kv(cache, lambda a: parts.append(a[:, ids]))
                n_kv = len(parts)
            self.kv.release_slot(slot)
        if self.has_state:
            sp = int(self.st.table[slot, 0])
            self._walk_state(cache, lambda a: parts.append(a[:, sp]))
        host = self._to_host(parts)
        rec.kv_host, rec.st_host = host[:n_kv], host[n_kv:]
        self.pos[slot] = 0
        self._dirty = True
        rec.nbytes = int(sum(a.numel() * a.element_size() for a in host))
        self.spill_events["spills"] += 1
        self.spill_events["spilled_bytes"] += rec.nbytes
        return rec

    def restore(self, slot: int, rec: SpillRecord, cache: Dict) -> None:
        """Re-admit a spilled request into (free) ``slot``: allocate fresh
        pages for the copied contents, point the table back at the pages
        kept by reference, copy the host images in (direct copies on the
        cache's stream) and restore the position.  Every allocation comes
        before any table edit: on exhaustion the fresh pages go back and
        ``PoolExhausted`` leaves the pool as it was (the engine may spill
        another victim and retry)."""
        if self.n_shards > 1:
            raise ValueError("spill / restore runs on one device "
                             "(layout='paged')")
        fresh: List[int] = []
        for _ in rec.kv_blocks:
            p = self._kv_alloc(reset=False)
            if p is None:
                for q in fresh:
                    self.kv.unalloc(q)
                raise PoolExhausted("paged KV pool exhausted (restore)")
            fresh.append(p)
        st_new = 0
        if self.has_state:
            st_new = self._st_alloc(reset=False)
            if st_new is None:
                for q in fresh:
                    self.kv.unalloc(q)
                raise PoolExhausted("paged state pool exhausted (restore)")
        if self.has_kv:
            assert not self.kv.table[slot].any(), "restore into a live slot"
            for b, pg in rec.kv_kept:
                # the spill's hold becomes the table's reference
                self.kv.table[slot, b] = pg
                n = self._spill_kv[pg] - 1
                if n:
                    self._spill_kv[pg] = n
                else:
                    del self._spill_kv[pg]
            for b, p in zip(rec.kv_blocks, fresh):
                self.kv.table[slot, b] = p
        if self.has_state:
            old = int(self.st.table[slot, 0])
            self.st.table[slot, 0] = st_new
            if old:
                self.st.drop(old)
        self.pos[slot] = rec.pos
        self._dirty = True
        dev = self.device
        if rec.kv_host:
            ids = upload(np.asarray(fresh, np.int64), dev)
            it = iter(rec.kv_host)
            self._walk_kv(cache, lambda a: a.index_copy_(
                1, ids, next(it).to(dev, non_blocking=True)))
        if rec.st_host:
            it = iter(rec.st_host)
            self._walk_state(cache, lambda a: a[:, st_new].copy_(
                next(it), non_blocking=True))
        self.spill_events["restores"] += 1

    # -- speculative decoding: fork / rollback ------------------------------
    # A round is a block-table operation: the fork records the committed
    # position and the slot's table row (and backs the state page up);
    # rollback drops the pages the round allocated past the accepted
    # prefix and truncates the position.  KV contents never move.

    def spec_fork(self, slot: int) -> SpecFork:
        """Restore point of ``slot`` before a speculative round.  Raises
        ``PoolExhausted`` when no state page is free for the backup (the
        round falls back to one vanilla step)."""
        rec = SpecFork(slot=slot, pos=int(self.pos[slot]))
        if self.has_kv:
            rec.kv_row = self.kv.table[slot].copy()
        if self.has_state:
            backup = self._st_alloc(reset=False)
            if backup is None:
                raise PoolExhausted("paged state pool exhausted (spec fork)")
            rec.st_backup = backup
            # the copy rides the next flush, before the first draft
            # dispatch advances the live page
            self._push_st_copy(int(self.st.table[slot, 0]), backup)
        return rec

    def spec_set_pos(self, slot: int, pos: int) -> None:
        """Override ``slot``'s position (back to the fork before verify,
        on to the accepted prefix after it); the next flush uploads it."""
        self.pos[slot] = int(pos)
        self._dirty = True

    def spec_restore_state(self, rec: SpecFork) -> None:
        """Queue the backup -> live state-page copy."""
        if rec.st_backup:
            self._push_st_copy(rec.st_backup, int(self.st.table[rec.slot, 0]))

    def spec_rollback_pages(self, rec: SpecFork, committed_pos: int) -> int:
        """Drop the blocks the round allocated FRESH wholly past the
        accepted prefix (null in the fork row, first position >=
        ``committed_pos``); blocks copied on write are kept, their stale
        rows mask themselves.  Fresh blocks exist only before the ring
        wraps, where block ``b`` holds positions [b page, (b + 1) page).
        -> the number dropped."""
        if not self.has_kv:
            return 0
        dropped = 0
        for b in range(self.n_blocks):
            pg = int(self.kv.table[rec.slot, b])
            if pg and rec.kv_row[b] == 0 and b * self.page >= committed_pos:
                self.kv.drop(pg)
                self.kv.table[rec.slot, b] = 0
                dropped += 1
        if dropped:
            self._dirty = True
        return dropped

    def spec_drop_backup(self, rec: SpecFork) -> None:
        """Release the state backup page (safe with a restore copy still
        queued: ``_push_st_copy`` pinned its source until the flush)."""
        if rec.st_backup:
            self.st.drop(rec.st_backup)
            rec.st_backup = 0

    def spec_abort(self, rec: SpecFork) -> None:
        """Unwind a round that ran out of pages mid-flight: back to the
        fork's position, the partial round's fresh pages dropped (the
        fork row's diff covers what ``write_plan`` touched before it
        raised), the state backup restored and released."""
        self.spec_rollback_pages(rec, rec.pos)
        if rec.st_backup:
            self.spec_restore_state(rec)
            self.spec_drop_backup(rec)
        self.spec_set_pos(rec.slot, rec.pos)

    def external_refs(self, table: str = "kv") -> Dict[int, int]:
        """Refcount holders OUTSIDE the block tables (prefix-trie retains,
        pending-copy source pins and, for kv, the pages spilled requests
        keep by reference) of the ``"kv"`` or the ``"state"`` pages, in
        the shape ``BlockAllocator.check`` expects."""
        refs: Dict[int, int] = {}
        if table == "kv":
            held = dict(self.prefix.page_refs()) if self.prefix else {}
            pending = self._kv_copies
            for p, n in self._spill_kv.items():
                held[p] = held.get(p, 0) + n
        else:
            held = self.prefix.state_refs() if self.prefix else {}
            pending = self._st_copies
        for p, n in held.items():
            if p:
                refs[p] = refs.get(p, 0) + n
        for s, _ in pending:
            refs[s] = refs.get(s, 0) + 1
        return refs

    # -- reporting ----------------------------------------------------------
    def alloc_events(self) -> Dict:
        """Cumulative allocator alloc/free event counts per table."""
        out: Dict = {}
        if self.has_kv:
            out["kv_alloc"] = self.kv.events["alloc"]
            out["kv_free"] = self.kv.events["free"]
        if self.has_state:
            out["state_alloc"] = self.st.events["alloc"]
            out["state_free"] = self.st.events["free"]
        return out

    def reset_event_counters(self) -> None:
        """Zero the cumulative event counters (prefix counters + alloc
        events); occupancy is left intact."""
        for k in self.counters:
            self.counters[k] = 0
        for k in self.spill_events:
            self.spill_events[k] = 0
        for al in (self.kv, self.st):
            if al is not None:
                al.events = {"alloc": 0, "free": 0}

    def shard_report(self) -> Dict:
        """Per-shard page occupancy, current and high-water (the null
        page on shard 0 is pinned, never allocated, and not counted)."""
        rep: Dict = {"n_shards": self.n_shards}
        for name, alloc in (("kv", self.kv), ("state", self.st)):
            if alloc is not None:
                rep[f"{name}_pages_per_shard"] = alloc.pages_per_shard
                rep[f"{name}_pages_in_use_per_shard"] = alloc.in_use.tolist()
                rep[f"{name}_pages_hiwater_per_shard"] = \
                    alloc.hiwater.tolist()
        return rep

    def report(self) -> Dict:
        rep = {"page": self.page, "n_blocks": self.n_blocks,
               "ring": self.ring, "n_pages": self.n_pages,
               "n_state_pages": self.n_spages,
               "prefix_caching": self.prefix is not None}
        if self.has_kv:
            rep["pages_in_use"] = int(np.sum(self.kv.ref > 0) - 1)
        if any(self.spill_events.values()):
            rep.update({f"spill_{k}": v for k, v in self.spill_events.items()})
        if self.n_shards > 1:
            rep["sharding"] = self.shard_report()
        if self.prefix is not None:
            q = max(self.counters["prefix_queries"], 1)
            n_pages, n_snaps = self.prefix.n_entries
            rep.update(self.counters,
                       hit_rate=self.counters["prefix_hits"] / q,
                       trie_pages=n_pages, trie_snapshots=n_snaps)
        return rep
