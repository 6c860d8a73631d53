"""The continuous-batching serving engine (``repro.serving.engine``).

One chunk step per dispatch drives the whole request stream: the
scheduler packs each dispatch ((B, chunk) mixed or (B, 1) decode-only),
the paged kv pool allocates / copy-on-writes the pages the dispatch will
touch (host-side, count-based: no device sync), the model's
``prefill_chunk`` updates the cache in place, the telemetry accumulates
per-layer tile liveness from every dispatch's MoR stats, and
``calibrate_capacities`` turns that into per-layer (for a moe model's
experts, per-(layer, expert)) gather_matmul capacity fractions.

Cache layouts: ``layout="paged"`` (default) runs on ``kv_pool.PagedPool``
(block-table indirection, refcounted pages, prefix caching: requests
sharing a prompt prefix map their leading table entries to the same
physical pages, and fully-hit prefill chunks are never dispatched; a
recurrent model's hits are state snapshots, taken just before the
dispatch that finishes a prompt and restored by a page copy at
admission).  ``layout="paged-sharded"`` is the same pool split over
the ranks of a page group (``launch.mesh.make_page_group``; every rank
runs this engine on the same requests): each rank holds one page range
of every pool, the host half is replicated, and the step runs inside the
page-shard context (``serving.mesh``), where attention is a distributed
flash decode with one merge collective per layer.  ``layout="slotted"``
is the contiguous slot layout, kept as the differential baseline.

The hot loop is device-resident: each slot's last sampled token stays on
the device (``_pending``), each dispatch's sampled tokens and the
kernels' tile counters are logged as device tensors, and host inputs go
up through pinned buffers without blocking.  Nothing is read back until
the flush at the end of ``run``, so no dispatch waits for the device.

Sampling is greedy.  Speculation, shadow scoring, observability and
preemption are later slices: where the JAX engine would spill a victim
to free pages, this one raises ``PoolExhausted``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.decode_attention import page_shard_context
from repro_torch.models import get_model
from repro_torch.serving import kv_pool
from repro_torch.serving import mesh
from repro_torch.serving.policy import Policy
from repro_torch.serving.scheduler import Request, RequestRejected, Scheduler
from repro_torch.serving.telemetry import (ServingTelemetry,
                                           calibrate_capacity, mor_group_map)

__all__ = ["Engine", "Request", "RequestRejected"]


_NO_PREEMPTION = ("the paged pool is exhausted; the JAX engine would "
                  "spill a victim slot here, and preemption is ROADMAP "
                  "queue A 5 of the port (raise spare_pages)")


def _zero_counters() -> Dict:
    return {"prefill_tokens": 0, "decode_tokens": 0, "dispatches": 0,
            "wall_s": 0.0, "requests_rejected": 0}


class Engine:
    """Continuous-batching serving engine over a fixed slot pool.

    ``params`` decide the device.  ``mor`` is the RAW calibrated MoR tree
    ({layer group -> stacked MoRLayer}, a moe model's expert group
    {"experts": (L, E)-stacked MoRLayer}) from ``deploy.calibrate_lm``
    or ``deploy.calibrate_moe``; the engine attaches the execution plans
    itself so that capacity calibration can re-attach them with
    per-layer (and per-expert) budgets.

    ``layout="paged-sharded"`` takes the rank's ``group``
    (``launch.mesh.PageGroup``): ``params`` and ``mor`` must be the same
    on every rank (checked at start-up, one collective each), and so
    must the requests each rank submits."""

    def __init__(self, cfg: ModelConfig, params, *, mor: Optional[Dict] = None,
                 mor_mode: str = "dense", n_slots: int = 8,
                 max_len: int = 256, chunk: int = 0,
                 capacities: Optional[Dict] = None, telemetry: bool = True,
                 layout: str = "paged", page: int = 0,
                 prefix_cache: bool = True,
                 spare_pages: Optional[int] = None, temperature: float = 0.0,
                 policy: Optional[Policy] = None, group=None):
        if layout not in ("paged", "paged-sharded", "slotted"):
            raise ValueError(f"unknown layout {layout!r}")
        if (layout == "paged-sharded") != (group is not None):
            raise ValueError(
                "layout='paged-sharded' runs on every rank of a page group "
                "and takes that rank's group= (launch.mesh.make_page_group, "
                "or launch.mesh.run_ranks); the other layouts take none")
        if temperature > 0.0:
            raise NotImplementedError(
                "temperature sampling comes with the speculation / SLO "
                "slice of the port (ROADMAP queue A 5); this engine "
                "samples greedily")
        self.cfg = cfg
        self.api = get_model(cfg)
        if not self.api.has_decode:
            raise ValueError(f"{cfg.name} is encoder-only: it does not "
                             f"decode")
        self.params = params
        self.device = params["embed"].device
        self.mor_mode = mor_mode
        self.raw_mor = mor if mor_mode != "dense" else None
        self.chunk = chunk or cfg.serve_chunk
        self.n_slots = n_slots
        self.max_len = max_len
        self.layout = layout
        self.capacities = capacities
        self.group = group
        if group is not None:
            mesh.check_replicated(params, group, "the parameters")
            mesh.check_replicated(self.raw_mor, group, "the MoR trees")
        self.mor = self._attach(capacities)
        if layout != "slotted":
            self.pool: Optional[kv_pool.PagedPool] = kv_pool.PagedPool(
                cfg, n_slots, max_len, chunk=self.chunk, page=page,
                spare_pages=spare_pages, prefix_cache=prefix_cache,
                n_shards=group.size if group else 1,
                shard=group.rank if group else 0, device=self.device)
            self.cache = self.pool.build()
        else:
            self.pool = None
            self.cache = kv_pool.init(cfg, n_slots, max_len, self.chunk,
                                      device=self.device)
        self.scheduler = Scheduler(n_slots, self.chunk, policy=policy)
        self.policy: Policy = self.scheduler.policy
        self.telemetry = ServingTelemetry() if telemetry else None
        self._next_rid = 0
        self._aux_log: List[Dict] = []
        self._pending = torch.zeros((n_slots,), dtype=torch.int32,
                                    device=self.device)
        self._tok_log: List = []
        self._tok_checked = 0        # dispatches whose tokens ranks agreed
        self.results: Dict[int, List[int]] = {}
        self.counters = _zero_counters()
        self.rejections: Dict[str, int] = {}

    # -- plan attachment ---------------------------------------------------
    def _attach(self, capacities: Optional[Dict]):
        if self.raw_mor is None:
            return None
        from repro_torch.core.deploy import attach_plans
        caps = None
        if capacities is not None:
            gmap = mor_group_map(self.cfg)
            caps = {gmap.get(k, k): v for k, v in capacities.items()}
        return attach_plans(self.raw_mor, self.cfg, self.mor_mode,
                            capacities=caps)

    # -- flushes -----------------------------------------------------------
    def _flush_tokens(self) -> None:
        if self._tok_log:
            toks = torch.stack([e[1] for e in self._tok_log])
            if self.group is not None:
                # the ranks' schedulers stay in step only while their
                # tokens agree: raise at the first dispatch that differs
                mesh.check_tokens(toks, self.group, self._tok_checked)
                self._tok_checked += len(toks)
            # ONE device -> host transfer for the whole log
            fetched = toks.cpu()
            for (emits, _), toks in zip(self._tok_log, fetched.numpy()):
                for s, rid in emits:
                    self.results.setdefault(rid, []).append(int(toks[s]))
            self._tok_log.clear()

    def _flush_telemetry(self) -> None:
        if self.telemetry is not None:
            for aux in self._aux_log:
                self.telemetry.update(
                    {g: {k: v.cpu().numpy() for k, v in st.items()}
                     for g, st in aux.items()})
            if self.pool is not None and self.pool.prefix is not None:
                self.telemetry.update_prefix(self._prefix_counters())
        self._aux_log.clear()

    # -- request API -------------------------------------------------------
    def _reject(self, reason: str, msg: str) -> None:
        self.counters["requests_rejected"] += 1
        self.rejections[reason] = self.rejections.get(reason, 0) + 1
        raise RequestRejected(reason, msg)

    def submit(self, prompt, max_new_tokens: int = 16) -> int:
        """Queue a request; returns its rid.  Unservable requests raise
        ``RequestRejected`` before touching the queue."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            self._reject("empty_prompt", "prompt must have >= 1 token")
        if max_new_tokens < 1:
            self._reject("nonpositive_max_new_tokens",
                         f"max_new_tokens={max_new_tokens} must be >= 1")
        if prompt.size + max_new_tokens + 1 > self.max_len:
            self._reject("oversize",
                         f"prompt {prompt.size} + max_new "
                         f"{max_new_tokens} exceeds max_len {self.max_len}")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab_size:
            self._reject("bad_token", "prompt token ids must lie in "
                         f"[0, {self.cfg.vocab_size})")
        rid = self._next_rid
        self._next_rid += 1
        self.scheduler.add(Request(rid, prompt, max_new_tokens))
        return rid

    def _place(self, slot: int, entry) -> int:
        """Scheduler admission hook (paged layout): prefix-cache
        admission through the pool; returns the prompt offset to start
        from."""
        return self.pool.admit(slot, entry.req.prompt)

    @torch.no_grad()
    def step(self) -> List[int]:
        """One scheduler iteration: admit, dispatch, ingest.  Returns the
        rids that finished this step."""
        t0 = time.perf_counter()
        sched = self.scheduler
        pool = self.pool
        admitted = sched.admit(self._place if pool is not None else None)
        if admitted and pool is None:
            mask = np.zeros((self.n_slots,), bool)
            mask[admitted] = True
            kv_pool.reset_slots(self.cache,
                                kv_pool.upload(mask, self.device))
        kind = sched.peek_kind()
        if kind is None:
            return []
        tokens, n_valid, use_pending, emits, finishing, prefilling = \
            sched.build_batch(kind)
        cache = self.cache
        if pool is not None:
            # pre-dispatch: snapshot the recurrent state of slots whose
            # prompt finishes here (the state at ``off`` is what the
            # earlier dispatches left in the pool), publish the prefix of
            # windowed prompts about to wrap their ring, then allocate /
            # copy-on-write every page this dispatch will touch and
            # apply the edits (one upload when dirty, none when clean)
            for s, off in finishing:
                pool.maybe_snapshot(s, sched.slots[s].req.prompt, off)
            for s, off, take in prefilling:
                pool.maybe_publish_prewrap(s, sched.slots[s].req.prompt,
                                           off, take)
            try:
                pool.plan_writes(n_valid)
            except kv_pool.PoolExhausted as e:
                raise kv_pool.PoolExhausted(_NO_PREEMPTION) from e
            pool.flush(cache)
            # the attends never touch the provably-null tail columns;
            # the table itself is only edited host-side, through flush
            W = pool.active_blocks(n_valid)
            if W is not None:
                cache = dict(cache, block_table=cache["block_table"][:, :W])
        sched.dispatch_kinds[kind] += 1
        ndec = int(use_pending.sum()) if kind == "mixed" else 0
        tok = kv_pool.upload(tokens, self.device)
        nv = kv_pool.upload(n_valid, self.device)
        up = kv_pool.upload(use_pending, self.device)
        # splice each decoding slot's device-resident last token in
        tok[:, 0] = torch.where(up, self._pending, tok[:, 0])
        with (contextlib.nullcontext() if self.group is None else
              page_shard_context(self.group)):
            logits, aux = self.api.prefill_chunk(
                self.params, self.cfg, tok, cache, n_valid=nv,
                mor=self.mor, mor_mode=self.mor_mode)
        last = torch.clamp(nv - 1, min=0).long()
        lg = logits[torch.arange(self.n_slots, device=self.device), last]
        nxt = torch.argmax(lg, dim=-1).to(torch.int32)   # greedy, first max
        self._pending = torch.where(nv > 0, nxt, self._pending)
        if pool is not None:
            pool.advance(n_valid)
        if emits:
            self._tok_log.append((emits, nxt))
        if self.telemetry is not None and aux:
            self._aux_log.append(aux)
        finished, entering = sched.feed(n_valid)
        if pool is not None:
            # publish AFTER the dispatch that wrote the prompt's last
            # pages; release AFTER publish so a request finishing in the
            # same step still shares its pages
            for s, req in entering:
                pool.publish(s, req.prompt)
            for s, _ in finished:
                pool.release(s)
        self.counters["dispatches"] += 1
        nv_total = int(n_valid.sum())
        if kind == "decode":
            self.counters["decode_tokens"] += nv_total
        else:
            self.counters["decode_tokens"] += ndec
            self.counters["prefill_tokens"] += nv_total - ndec
        self.counters["wall_s"] += time.perf_counter() - t0
        return [req.rid for _, req in finished]

    def reset_counters(self) -> None:
        """Zero the throughput AND prefix-cache counters (e.g. between a
        warm-up pass and a timed pass), so that a report's hit rate and
        skipped chunks describe the same pass as its token counts; the
        cache contents survive."""
        self.counters = _zero_counters()
        self.rejections = {}
        self.scheduler.chunks_skipped = 0
        self.scheduler.tokens_skipped = 0
        self.scheduler.dispatch_kinds = {"mixed": 0, "decode": 0}
        if self.pool is not None:
            self.pool.reset_event_counters()

    def run(self, requests=None) -> Dict[int, List[int]]:
        """Drive the queue (plus optional (prompt, max_new) pairs) to
        completion; returns {rid: generated tokens} for the requests
        submitted by THIS call (all-time results stay in ``results``)."""
        first_rid = self._next_rid
        for prompt, max_new in requests or ():
            self.submit(prompt, max_new)
        while self.scheduler.has_work:
            self.step()
        self._flush_tokens()
        self._flush_telemetry()
        if requests:
            return {rid: toks for rid, toks in self.results.items()
                    if rid >= first_rid}
        return dict(self.results)

    # -- telemetry-driven capacity calibration -----------------------------
    def calibrate_capacities(self, quantile: float = 0.95,
                             floor: float = 0.05) -> Dict[str, np.ndarray]:
        """Set per-layer gather_matmul capacities from the accumulated
        tile-liveness histograms and re-attach the execution plans."""
        if self.telemetry is None or self.raw_mor is None:
            raise ValueError("capacity calibration needs telemetry and a "
                             "calibrated MoR tree")
        self._flush_telemetry()
        caps = calibrate_capacity(self.telemetry, quantile=quantile,
                                  floor=floor)
        self.capacities = caps
        self.mor = self._attach(caps)
        return caps

    def update_mor(self, raw_mor: Dict) -> None:
        """Swap the calibrated MoR tree in place (the online
        recalibration hook), keeping the current capacities."""
        if self.raw_mor is None:
            raise ValueError("engine was built without a MoR tree")
        self.raw_mor = raw_mor
        self.mor = self._attach(self.capacities)

    def _prefix_counters(self) -> Dict:
        """Prefix-cache counters merged across the pool (pages, hits)
        and the scheduler (chunks whose dispatch was skipped)."""
        pc = self.pool.report()
        return {
            "hit_rate": pc.get("hit_rate", 0.0),
            "prefix_queries": pc.get("prefix_queries", 0),
            "prefix_hits": pc.get("prefix_hits", 0),
            "tokens_reused": pc.get("tokens_reused", 0),
            "pages_shared": pc.get("pages_shared", 0),
            "pages_published": pc.get("pages_published", 0),
            "pages_cowed": pc.get("pages_cowed", 0),
            "pages_evicted": pc.get("pages_evicted", 0),
            "snapshots": pc.get("snapshots", 0),
            "snap_restores": pc.get("snap_restores", 0),
            "chunks_skipped": self.scheduler.chunks_skipped,
            "tokens_skipped": self.scheduler.tokens_skipped,
        }

    def report(self) -> Dict:
        self._flush_tokens()
        c = dict(self.counters)
        # counters["wall_s"] is HOST dispatch time (the loop never waits
        # for the device): an upper bound on throughput.  launch.serve
        # replaces the rates with a wall clock that ends in a sync.
        wall = max(c["wall_s"], 1e-9)
        rep = {
            "n_slots": self.n_slots, "chunk": self.chunk,
            "mor_mode": self.mor_mode, "layout": self.layout,
            "device": str(self.device),
            "requests_finished": len(self.results),
            "tokens_per_s": (c["decode_tokens"] + c["prefill_tokens"]) / wall,
            "decode_tokens_per_s": c["decode_tokens"] / wall,
            **c,
        }
        if self.pool is not None:
            rep["page"] = self.pool.page
            if self.pool.prefix is not None:
                rep["prefix_cache"] = self._prefix_counters()
            if self.pool.n_shards > 1:
                rep["sharding"] = dict(self.pool.shard_report(),
                                       backend=self.group.backend)
        if self.telemetry is not None:
            self._flush_telemetry()
            rep["telemetry"] = self.telemetry.summary()
        if self.capacities is not None:
            rep["per_layer_capacity"] = {
                k: np.asarray(v).tolist() for k, v in self.capacities.items()}
        return rep
