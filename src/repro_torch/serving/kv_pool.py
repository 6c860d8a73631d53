"""Serving cache layouts (``repro.serving.kv_pool``): the contiguous slot
pool and the paged pool (fixed-size pages + block tables + refcounts +
copy-on-write + prefix caching).

**Slot pool** (``init`` / ``reset_slots``): every slot owns a contiguous
ring row.  Layout: {"pos": (n_slots,) int32 next position per slot,
"layers": {"k", "v": (L, n_slots, Lr, hkv, hd), "pos": (L, n_slots, Lr)
int32 position tags, -1 = empty}}: the JAX layout, with the page/slot
dim at axis 1 of every stacked leaf.  An MLA model holds its latent
rows instead, over the full ``max_len`` (no ring): {"c_kv" (L, n_slots,
max_len, kv_lora_rank), "k_pe" (..., qk_rope_head_dim), "pos"}.  All L
layers of a moe model form one stack (JAX keeps one per layer group).

**Paged pool** (``PagedPool``): the engine's default layout.  Physical
storage is a pool of fixed-size pages; a slot's logical ring row ``r``
lives at ``(block_table[slot, r // page], r % page)``.  Page 0 is the
reserved null page (position tags -1, never written), so unallocated
table entries read as empty.  The host half (``BlockAllocator``,
``PrefixCache``) is numpy; ``PagedPool`` turns its decisions into ONE
packed int32 vector per dirty dispatch that ``apply_cache_ops`` applies
to the device cache in place.  KV pages only, on one device: recurrent
state pages are queue A 9 of the port, the mesh-sharded pool queue A 14,
preemption (``spill`` / ``restore``) and speculation forks queue A 11.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import get_model
from repro_torch.models.layers.attention import ring_rows
from repro_torch.serving.prefix_cache import PrefixCache

# families whose cache carries recurrent state pages (queue A 9)
_STATE_FAMILIES = ("ssm", "hybrid")


class PoolExhausted(RuntimeError):
    """A paged pool ran out of pages (after prefix-cache eviction)."""


def ring_cfg(cfg: ModelConfig, chunk: int) -> ModelConfig:
    """Config used ONLY for cache allocation: window + chunk ring slack."""
    if cfg.sliding_window:
        cfg = cfg.replace(sliding_window=cfg.sliding_window + chunk)
    return cfg


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without waiting for the device: a
    pinned staging copy and an asynchronous transfer on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone().to(device)


# ==========================================================================
# slot-pool layout (contiguous per-slot rows)
# ==========================================================================

def init(cfg: ModelConfig, n_slots: int, max_len: int, chunk: int = 0,
         dtype=None, device="cuda") -> Dict:
    """Allocate the slot-pool cache for ``n_slots`` sequences of up to
    ``max_len`` positions."""
    chunk = chunk or cfg.serve_chunk
    api = get_model(cfg)
    cache = api.cache_init(ring_cfg(cfg, chunk), n_slots, max_len,
                           dtype or cfg.tdtype, device)
    layers = dict(cache["layers"])
    if "k" in layers:                 # GQA rings: per-slot position tags
        L, Lr = layers["pos"].shape
        layers["pos"] = torch.full((L, n_slots, Lr), -1, dtype=torch.int32,
                                   device=device)
    return {"pos": torch.zeros((n_slots,), dtype=torch.int32,
                               device=device),
            "layers": layers}


def reset_slots(cache: Dict, slots: torch.Tensor) -> Dict:
    """Recycle cache slots IN PLACE: zero state / -1 kv tags / 0 position
    for every slot where ``slots`` (n_slots,) bool is True."""
    for key, a in cache["layers"].items():
        m = slots.reshape((1, -1) + (1,) * (a.ndim - 2))
        a.masked_fill_(m, -1 if key == "pos" else 0)
    cache["pos"].masked_fill_(slots, 0)
    return cache


# ==========================================================================
# paged layout: applying the packed edits
# ==========================================================================

def apply_cache_ops(cache: Dict, ops: torch.Tensor, n_reset: int,
                    n_copy: int) -> None:
    """Apply one packed vector of host-planned pool edits to the device
    cache IN PLACE: the ``pos`` and ``block_table`` uploads, page-tag
    resets (-1) for freshly allocated pages, then page copies
    (copy-on-write) on every layer's pools (K, V or the MLA latent rows,
    and the tags).

    ``ops`` (int32, on the cache's device) is laid out by
    ``PagedPool.drain``: pos (n_slots) | block_table (n_slots * n_blocks)
    | reset page ids (n_reset) | copy sources (n_copy) | copy
    destinations (n_copy).  JAX pads the copies out of bounds to static
    widths for ``jit``; eager torch passes exactly the real ones, so
    nothing is dropped here."""
    S, NB = cache["block_table"].shape
    cache["pos"].copy_(ops[:S])
    cache["block_table"].copy_(ops[S:S + S * NB].view(S, NB))
    i = S + S * NB
    layers = cache["layers"]
    if n_reset:
        layers["pos"][:, ops[i:i + n_reset]] = -1
    i += n_reset
    if n_copy:
        src, dst = ops[i:i + n_copy], ops[i + n_copy:i + 2 * n_copy]
        for a in layers.values():
            a[:, dst] = a[:, src]


# ==========================================================================
# BlockAllocator: host-side page accounting
# ==========================================================================

class BlockAllocator:
    """Free list + refcounts + per-slot block tables for one page pool
    (``repro.serving.kv_pool.BlockAllocator`` on one device; its
    ownership-aware mesh-sharded form is queue A 14).

    Page ids are ints in ``[1, n_pages)``; id 0 is the reserved null
    page and is never allocated.  A page's refcount equals the number of
    holders: block-table entries pointing at it plus external retains
    (prefix-cache entries, pending-copy pins).  ``ref == 1`` with a
    single table entry means the slot owns the page exclusively and may
    write it in place; ``write_plan`` enforces that, allocating fresh
    pages for null entries and copy-on-writing shared ones."""

    def __init__(self, n_pages: int, n_slots: int, n_blocks: int):
        assert n_pages >= 2 and n_slots >= 1 and n_blocks >= 1
        self.n_pages = n_pages
        self.table = np.zeros((n_slots, n_blocks), np.int32)
        self.ref = np.zeros((n_pages,), np.int64)
        self.ref[0] = 1                          # null page, pinned
        self.free: List[int] = list(range(n_pages - 1, 0, -1))  # LIFO
        # cumulative alloc/free event counts
        self.events = {"alloc": 0, "free": 0}

    # -- primitive ops -----------------------------------------------------
    def alloc(self) -> Optional[int]:
        if not self.free:
            return None
        p = self.free.pop()
        assert self.ref[p] == 0, "free list held a referenced page"
        self.ref[p] = 1
        self.events["alloc"] += 1
        return p

    def retain(self, page: int) -> None:
        assert page != 0 and self.ref[page] > 0, "retain of unowned page"
        self.ref[page] += 1

    def drop(self, page: int) -> bool:
        """Drop one reference; returns True if the page was freed."""
        assert page != 0 and self.ref[page] > 0, "drop of unowned page"
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self.free.append(page)
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
        src against eviction by that very alloc."""
        alloc = alloc or self.alloc
        fresh: List[int] = []
        copies: List[Tuple[int, int]] = []
        for b in blocks:
            cur = int(self.table[slot, b])
            if cur != 0 and self.ref[cur] == 1:
                continue                          # already exclusive
            new = alloc()
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


# ==========================================================================
# PagedPool: device pool + prefix caching on top of the allocator
# ==========================================================================

class PagedPool:
    """The paged serving cache: builds the device cache, owns the host
    allocator and the prefix cache, and turns host-side decisions into
    ONE packed int32 vector per dirty dispatch (``drain``), uploaded and
    applied in place by ``flush``; a clean dispatch uploads nothing.

    Device layout (``build``): one tensor per leaf, {"pos": (n_slots,),
    "block_table": (n_slots, n_blocks) int32, "layers": {"k", "v": (L,
    n_pages + 1, page, hkv, hd), "pos": (L, n_pages + 1, page) int32
    position tags}}, updated in place; an MLA model's layers hold the
    latent pools {"c_kv" (L, n_pages + 1, page, kv_lora_rank), "k_pe"
    (..., qk_rope_head_dim), "pos"} instead of "k" and "v".  JAX keeps
    per-layer tuples of pool leaves only so that XLA can alias each
    scatter to its donated buffer; eager torch writes in place anyway.
    The trailing page ``n_pages`` is a scratch page that no table ever
    holds: the attention write sends the tokens it drops there (torch
    has no ``mode="drop"`` scatter), so every real page stays
    bit-identical."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, *,
                 chunk: int = 0, page: int = 0, dtype=None,
                 spare_pages: Optional[int] = None,
                 prefix_cache: bool = True, n_shards: int = 1,
                 device="cuda"):
        if n_shards != 1:
            raise NotImplementedError(
                "a mesh-sharded paged pool (n_shards > 1) is queue A 14 "
                "of the port")
        if cfg.family in _STATE_FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: recurrent state pages are queue A 9 of the "
                f"port")
        chunk = chunk or cfg.serve_chunk
        page = page or cfg.serve_page
        assert page >= 1
        self.cfg, self.n_slots, self.max_len = cfg, n_slots, max_len
        self.chunk, self.page = chunk, page
        self.dtype = dtype or cfg.tdtype
        self.device = torch.device(device)
        # ring length rounded up to a page multiple: position p maps to
        # ring row p % ring, block r // page, offset r % page
        rows = ring_rows(ring_cfg(cfg, chunk), max_len)
        self.n_blocks = max(1, -(-rows // page))
        self.ring = self.n_blocks * page
        spare = (n_slots * self.n_blocks if spare_pages is None
                 else spare_pages)
        self.n_pages = 1 + n_slots * self.n_blocks + spare
        self.kv = BlockAllocator(self.n_pages, n_slots, self.n_blocks)
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
        self._dirty = False

    # -- device cache ------------------------------------------------------
    def build(self) -> Dict:
        """Allocate the paged device cache: pools zeroed, position tags
        -1, block tables null."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.n_layers, self.n_pages + 1, self.page)
        if cfg.mla:
            feats = {"c_kv": (cfg.kv_lora_rank,),
                     "k_pe": (cfg.qk_rope_head_dim,)}
        else:
            feats = {k: (cfg.n_kv_heads, cfg.head_dim) for k in ("k", "v")}
        layers = {k: torch.zeros(shape + f, dtype=self.dtype, device=dev)
                  for k, f in feats.items()}
        layers["pos"] = torch.full(shape, -1, dtype=torch.int32, device=dev)
        return {
            "pos": torch.zeros((self.n_slots,), dtype=torch.int32,
                               device=dev),
            "block_table": torch.zeros((self.n_slots, self.n_blocks),
                                       dtype=torch.int32, device=dev),
            "layers": layers,
        }

    def drain(self) -> Optional[Tuple[np.ndarray, int, int]]:
        """-> (ops, n_reset, n_copy): the pending edits as ONE packed
        int32 vector in the layout ``apply_cache_ops`` reads, or None
        when clean.  Emitting a copy releases its source's pin."""
        if not self._dirty:
            return None
        resets = sorted(self._kv_reset)
        self._kv_reset.clear()
        src = [s for s, _ in self._kv_copies]
        dst = [d for _, d in self._kv_copies]
        self._kv_copies.clear()
        for s in src:
            self.kv.drop(s)              # release the pending-src pin
        self._dirty = False
        ops = np.concatenate([self.pos.astype(np.int32),
                              self.kv.table.reshape(-1),
                              np.asarray(resets + src + dst, np.int32)])
        return ops, len(resets), len(src)

    def flush(self, cache: Dict) -> None:
        """Apply all pending edits to ``cache`` now: one pinned,
        non-blocking host -> device transfer of the packed vector, then
        ``apply_cache_ops`` on the same stream.  No-op when clean."""
        drained = self.drain()
        if drained is not None:
            ops, n_reset, n_copy = drained
            apply_cache_ops(cache, upload(ops, self.device), n_reset,
                            n_copy)

    # pending page copies: the src is PINNED (one extra ref) from queueing
    # until ``drain`` emits the pair, so no interleaved eviction/free can
    # recycle it and reset it ahead of the copy
    def _push_kv_copy(self, src: int, dst: int) -> None:
        self.kv.retain(src)
        self._kv_copies.append((src, dst))
        self._kv_reset.add(dst)
        self._dirty = True

    def _kv_alloc(self) -> Optional[int]:
        """Allocate a page, evicting LRU prefix-cache pages whose page
        actually frees (an entry still shared into a live slot reclaims
        nothing: keep it for future hits)."""
        p = self.kv.alloc()
        while p is None and self.prefix is not None:
            pg = self.prefix.evict_lru_page(lambda q: self.kv.ref[q] == 1)
            if pg is None:
                break
            self.kv.drop(pg)
            self.counters["pages_evicted"] += 1
            p = self.kv.alloc()
        if p is not None:
            self._kv_reset.add(p)
            self._dirty = True
        return p

    # -- engine lifecycle ---------------------------------------------------
    def admit(self, slot: int, prompt: np.ndarray) -> int:
        """Attach a fresh request to ``slot``: match the prompt against
        the prefix cache, share the hit pages into its table and set its
        position.  Returns the number of leading tokens whose prefill is
        skipped (always < len(prompt): the last token is recomputed to
        produce the first sampled logit)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        shared: List[int] = []
        if self.prefix is not None:
            self.counters["prefix_queries"] += 1
            shared = self.prefix.match_pages(prompt, len(prompt) - 1)
            if shared:
                self.counters["prefix_hits"] += 1
                self.counters["tokens_reused"] += len(shared) * self.page
                self.counters["pages_shared"] += len(shared)
        for i, pg in enumerate(shared):
            self.kv.share(slot, i, pg)
        self.pos[slot] = len(shared) * self.page
        self._dirty = True
        return int(self.pos[slot])

    def plan_writes(self, n_valid: np.ndarray) -> None:
        """Pre-dispatch (host only): make every page this dispatch will
        write exclusively owned: fresh alloc for null blocks,
        copy-on-write for shared ones."""
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

    def active_blocks(self, n_valid: np.ndarray) -> int:
        """Block-table width this dispatch needs (host-side, count-based:
        no device sync).  Every position a slot has written or will
        write this step lies below ``max(pos + n_valid)``, so the columns
        past ``ceil(need / page)`` hold only null pages.  A width below
        ``n_blocks`` changes the ring modulus, which is sound only while
        no slot has wrapped: ``pos + n_valid`` is clamped to ``ring``, so
        a wrap forces the full width.  (JAX buckets the width to
        multiples of 4 to bound its compiled variants; eager torch needs
        no bucket.)"""
        need = int(np.minimum(self.pos + np.asarray(n_valid, np.int64),
                              self.ring).max(initial=0))
        return min(max(1, -(-need // self.page)), self.n_blocks)

    def publish(self, slot: int, prompt: np.ndarray) -> None:
        """Called when ``slot`` finishes prefill: publish the full pages
        of its prompt into the prefix trie.  Prompts longer than the
        sliding-window ring have wrapped by now; those were published at
        the last pre-wrap page boundary by ``maybe_publish_prewrap``."""
        if self.prefix is None:
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
        past the ring, publish the full pages [0, offset) while the
        prefix is still intact."""
        if self.prefix is None:
            return
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) <= self.ring:
            return                       # no wrap: publish() covers it
        if not (offset <= self.ring < offset + take):
            return                       # not the wrap-crossing dispatch
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
        """Evict a finished request: drop its page refs (pages still
        pinned by the prefix cache survive for future hits)."""
        self.kv.release_slot(slot)
        self.pos[slot] = 0
        self._dirty = True

    def spill(self, *args, **kwargs):
        raise NotImplementedError(
            "preemption (PagedPool.spill / restore) is queue A 11 of the "
            "port")

    restore = spill

    def spec_fork(self, *args, **kwargs):
        raise NotImplementedError(
            "speculative decoding (PagedPool.spec_*) is queue A 11 of the "
            "port")

    def external_refs(self) -> Dict[int, int]:
        """Refcount holders OUTSIDE the block tables (prefix-trie
        retains and pending-copy source pins), in the shape
        ``BlockAllocator.check`` expects."""
        refs: Dict[int, int] = {}
        if self.prefix is not None:
            refs.update(self.prefix.page_refs())
        for s, _ in self._kv_copies:
            refs[s] = refs.get(s, 0) + 1
        return refs

    # -- reporting ----------------------------------------------------------
    def alloc_events(self) -> Dict:
        """Cumulative allocator alloc/free event counts."""
        return {"kv_alloc": self.kv.events["alloc"],
                "kv_free": self.kv.events["free"]}

    def reset_event_counters(self) -> None:
        """Zero the cumulative event counters (prefix counters + alloc
        events); occupancy is left intact."""
        for k in self.counters:
            self.counters[k] = 0
        self.kv.events = {"alloc": 0, "free": 0}

    def report(self) -> Dict:
        rep = {"page": self.page, "n_blocks": self.n_blocks,
               "ring": self.ring, "n_pages": self.n_pages,
               "prefix_caching": self.prefix is not None,
               "pages_in_use": int(np.sum(self.kv.ref > 0) - 1)}
        if self.prefix is not None:
            q = max(self.counters["prefix_queries"], 1)
            n_pages, n_snaps = self.prefix.n_entries
            rep.update(self.counters,
                       hit_rate=self.counters["prefix_hits"] / q,
                       trie_pages=n_pages, trie_snapshots=n_snaps)
        return rep
