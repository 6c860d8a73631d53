"""Prefix cache: a hash-trie of full KV pages plus recurrent-state
snapshots, keyed by token prefixes (a copy of
``repro.serving.prefix_cache``; host numpy only).

Two kinds of reusable artifacts come out of serving a prompt:

  * **KV pages** (attention families): a physical page holding the kv
    rows for positions ``[i*page, (i+1)*page)`` is valid for ANY later
    request whose first ``(i+1)*page`` tokens are identical — the keys
    are RoPE'd at absolute positions, which match by construction.  The
    trie stores one entry per *full* page, keyed by the entire token
    prefix up to that page boundary (so a lookup walks parent-to-child:
    a page only matches if everything before it matched too — the trie
    property, realised as a dict of prefix keys).  Sliding-window
    prompts longer than their ring publish at the LAST PRE-WRAP page
    boundary (``PagedPool.maybe_publish_prewrap``) — by prefill's end
    the ring has wrapped and its pages hold the tail, not the prefix.
    Entries store GLOBAL page ids, so the trie works unchanged over the
    mesh-sharded pool (ids partition deterministically across shards).
  * **State snapshots** (ssm / hybrid families): recurrent state at a
    page-aligned prompt offset, keyed by the exact token prefix it
    summarises.  A hybrid snapshot also records the KV page ids of the
    shared-attention ring below that offset, so a hit restores both.

This module is pure host-side bookkeeping: it stores *page ids* and
*snapshot page ids*, never device arrays.  Refcount changes are the
caller's job (``kv_pool.PagedPool`` retains a page per trie entry that
lists it and drops it on eviction), which keeps this class trivially
testable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixCache", "PageEntry", "SnapEntry"]


@dataclass
class PageEntry:
    """One full KV page: positions [depth*page, (depth+1)*page)."""
    page: int                    # physical page id in the paged pool
    depth: int                   # page index within the prompt
    last_used: int = 0


@dataclass
class SnapEntry:
    """Recurrent state at ``n_tokens`` (page-aligned), plus the KV pages
    of the shared-attention ring below it (empty for pure-ssm)."""
    n_tokens: int
    spage: int                   # physical state-page id
    kv_pages: List[int] = field(default_factory=list)
    last_used: int = 0


class PrefixCache:
    def __init__(self, page: int):
        assert page >= 1
        self.page = page
        self.pages: Dict[bytes, PageEntry] = {}
        self.snaps: Dict[bytes, SnapEntry] = {}
        self._clock = 0

    # -- keys --------------------------------------------------------------
    def _key(self, prompt: np.ndarray, n: int) -> bytes:
        return np.ascontiguousarray(prompt[:n], np.int32).tobytes()

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # -- KV page chain (attention families) --------------------------------
    def match_pages(self, prompt: np.ndarray, limit: int) -> List[int]:
        """Longest chain of cached full pages covering a prefix of
        ``prompt``; never spans past ``limit`` tokens (callers pass
        ``len(prompt) - 1`` so at least one token is recomputed).
        Returns the physical page ids, parent-to-child."""
        out: List[int] = []
        n_full = min(limit, len(prompt)) // self.page
        for i in range(n_full):
            e = self.pages.get(self._key(prompt, (i + 1) * self.page))
            if e is None:
                break
            e.last_used = self._tick()
            out.append(e.page)
        return out

    def insert_pages(self, prompt: np.ndarray, n_tokens: int,
                     get_page: Callable[[int], int]) -> List[int]:
        """Publish the full pages of ``prompt[:n_tokens]``.  Existing
        entries (same key) are kept — the first publisher wins, later
        identical prompts just reuse it.  Returns the page ids of the
        entries NEWLY inserted (the caller must retain a ref on each)."""
        new: List[int] = []
        for i in range(n_tokens // self.page):
            key = self._key(prompt, (i + 1) * self.page)
            if key in self.pages:
                continue
            pg = int(get_page(i))
            self.pages[key] = PageEntry(pg, i, self._tick())
            new.append(pg)
        return new

    def evict_lru_page(self, evictable=None) -> Optional[int]:
        """Drop the least-recently-used DEEPEST page entry (children
        before parents, so match chains never dangle mid-walk for long)
        among those whose page id satisfies ``evictable`` (the pool
        passes "dropping the trie ref actually frees the page" — an
        entry still shared into live slots is kept: evicting it would
        reclaim nothing and just forfeit future hits).  Returns the
        physical page id (caller drops the trie's ref)."""
        keys = [k for k in self.pages
                if evictable is None or evictable(self.pages[k].page)]
        if not keys:
            return None
        key = min(keys, key=lambda k: (-self.pages[k].depth,
                                       self.pages[k].last_used))
        return self.pages.pop(key).page

    # -- state snapshots (ssm / hybrid families) ---------------------------
    def match_state(self, prompt: np.ndarray, limit: int
                    ) -> Optional[SnapEntry]:
        """Longest snapshot whose key prefix-matches ``prompt`` with
        n_tokens <= limit."""
        best: Optional[SnapEntry] = None
        for n in sorted({e.n_tokens for e in self.snaps.values()},
                        reverse=True):
            if n > limit or n > len(prompt):
                continue
            e = self.snaps.get(self._key(prompt, n))
            if e is not None:
                e.last_used = self._tick()
                best = e
                break
        return best

    def has_state(self, prompt: np.ndarray, n_tokens: int) -> bool:
        return self._key(prompt, n_tokens) in self.snaps

    def insert_state(self, prompt: np.ndarray, n_tokens: int, spage: int,
                     kv_pages: List[int]) -> SnapEntry:
        key = self._key(prompt, n_tokens)
        assert key not in self.snaps, "snapshot key already published"
        e = SnapEntry(n_tokens, spage, list(kv_pages), self._tick())
        self.snaps[key] = e
        return e

    def evict_lru_snap(self, evictable=None) -> Optional[SnapEntry]:
        """Drop the LRU snapshot among those satisfying ``evictable``
        (the pool excludes snapshots pinned mid-restore and, when
        hunting kv pages, snapshots whose pages would not free); caller
        frees its state page and drops the refs on its kv_pages."""
        keys = [k for k in self.snaps
                if evictable is None or evictable(self.snaps[k])]
        if not keys:
            return None
        key = min(keys, key=lambda k: self.snaps[k].last_used)
        return self.snaps.pop(key)

    # -- introspection ------------------------------------------------------
    @property
    def n_entries(self) -> Tuple[int, int]:
        return len(self.pages), len(self.snaps)

    def page_refs(self) -> Dict[int, int]:
        """KV-pool refcounts the trie is responsible for, per page id:
        one per page entry plus one per snapshot that lists the page in
        its shared-attention ring.  Feed into
        ``BlockAllocator.check(external_refs=...)`` to audit that every
        non-table ref is accounted for (no leak, no over-release)."""
        refs: Dict[int, int] = {}
        for e in self.pages.values():
            refs[e.page] = refs.get(e.page, 0) + 1
        for s in self.snaps.values():
            for pg in s.kv_pages:
                refs[pg] = refs.get(pg, 0) + 1
        return refs

    def state_refs(self) -> Dict[int, int]:
        """State-pool refcounts the trie holds (one per snapshot)."""
        refs: Dict[int, int] = {}
        for s in self.snaps.values():
            refs[s.spage] = refs.get(s.spage, 0) + 1
        return refs

    def stats(self) -> Dict[str, int]:
        """Trie introspection for the obs registry: entry counts, how
        deep the cached chains go, and the token span they cover."""
        max_depth = max((e.depth + 1 for e in self.pages.values()),
                        default=0)
        return {
            "trie_pages": len(self.pages),
            "trie_snapshots": len(self.snaps),
            "max_chain_pages": max_depth,
            "tokens_covered": len(self.pages) * self.page,
            "snap_tokens_covered": sum(e.n_tokens
                                       for e in self.snaps.values()),
        }
