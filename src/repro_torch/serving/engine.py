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

Observability (``obs=`` an ``obs.Observability``): a packed int32
metrics block on the device (``obs.device``) gains each dispatch's
counts in place and is read once a flush, the tracer records host-clock
spans, and ``_flush_obs`` mirrors every counter source into the
registry.  ``shadow_rate`` > 0 scores the predictor against the dense
oracle on 1 in ``round(1 / shadow_rate)`` dispatches: tiled plans run
the sampled dispatch itself through their ``scored`` twin (bitwise the
tiled path), kernel and exact plans run a dense ``shadow`` twin just
before the primary dispatch on a view of the cache
(``kv_pool.shadow_view``), so tokens stay those of shadow-off.  On the
page-sharded layout every rank runs the twin inside the page-shard
context on the view of its own shard.  The drift detector
(``obs.quality``) reads the quality lanes at each flush.

Sampling: greedy argmax by default; ``temperature`` > 0 samples from
the temperature / top-k distribution by Gumbel-max, its noise drawn on
the device from a ``torch.Generator`` reseeded each dispatch from
(``sample_seed``, dispatch index): no host read, and the same seed gives
the same tokens (the port's own stream, not ``jax.random``'s).

SLO scheduling: ``policy`` (``serving.policy``: "fcfs", "priority",
"sjf", or an instance) orders admission; on the paged layout a
priority arrival may preempt a lower class, and when the pool runs out
of pages at admission or while planning a dispatch the engine spills a
victim (``PagedPool.spill``: its exclusive pages and state to the host,
its shared pages kept by reference) and requeues it at its exact
progress; ``restore`` brings it back in any free slot.  ``spec_k`` > 0
replaces decode dispatches with self-speculative rounds
(``serving.spec``: drafts under the ``draft_cap`` budget, one verify at
full capacity).

Streaming: ``submit(..., on_token=cb)`` registers a per-request token
callback, fired in order at the token flush; ``run(stream_interval=N)``
flushes every N dispatches and ``stream()`` wraps one request as a
generator.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.decode_attention import page_shard_context
from repro_torch.models import get_model
from repro_torch.serving import kv_pool
from repro_torch.serving import mesh
from repro_torch.serving.policy import Policy, get_policy
from repro_torch.serving.scheduler import (FREE, Request, RequestRejected,
                                           Scheduler, new_dispatch_kinds)
from repro_torch.serving.spec import (SpecDecoder, gumbel_from_uniform,
                                      sample_step)
from repro_torch.serving.telemetry import (ServingTelemetry,
                                           calibrate_capacity,
                                           export_telemetry, mor_group_map)

__all__ = ["Engine", "Request", "RequestRejected"]


def _kernel_launches() -> Dict[str, int]:
    """The serving kernels' launch counters (process-wide)."""
    from repro_torch.kernels import gather_matmul as gm
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import mor_predict as mp
    from repro_torch.kernels import paged_attention as pa
    return {"mor_tile_mask": mp.launches, "gather_matmul": gm.launches,
            "masked_matmul_kdim": mm.launches,
            "gqa_paged_flash": pa.launches,
            "mla_paged_flash": pa.mla_launches}


def _zero_counters() -> Dict:
    return {"prefill_tokens": 0, "decode_tokens": 0, "dispatches": 0,
            "wall_s": 0.0, "preemptions": 0, "requests_rejected": 0}


def _fold(seed: int, index: int) -> int:
    """The generator seed of dispatch ``index`` under ``seed`` (the
    port's counterpart of ``jax.random.fold_in``): host arithmetic."""
    state = np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


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
    must the requests each rank submits.

    ``obs`` (an ``obs.Observability``) turns on the device metrics block
    and the tracer; ``shadow_rate`` > 0 (which needs ``obs`` with device
    metrics and a MoR tree) samples dispatches through the predictor's
    shadow twin, and ``drift_threshold`` / ``drift_detector`` set up the
    drift detector over its scores.

    ``temperature`` / ``top_k`` / ``sample_seed`` set the sampling,
    ``policy`` the admission and preemption policy (a name or a
    ``Policy``), and ``spec_k`` > 0 (paged layout, ``spec_k <= chunk``)
    self-speculative decoding with drafts under ``draft_cap`` (0: the
    target plans) at ``spec_draft_temperature`` (default: the
    target's)."""

    def __init__(self, cfg: ModelConfig, params, *, mor: Optional[Dict] = None,
                 mor_mode: str = "dense", n_slots: int = 8,
                 max_len: int = 256, chunk: int = 0,
                 capacities: Optional[Dict] = None, telemetry: bool = True,
                 layout: str = "paged", page: int = 0,
                 prefix_cache: bool = True,
                 spare_pages: Optional[int] = None, temperature: float = 0.0,
                 top_k: int = 0, sample_seed: int = 0, policy=None,
                 group=None, obs=None, spec_k: int = 0,
                 draft_cap: float = 0.0,
                 spec_draft_temperature: Optional[float] = None,
                 shadow_rate: float = 0.0, drift_threshold: float = 0.25,
                 drift_detector: str = "ewma"):
        if layout not in ("paged", "paged-sharded", "slotted"):
            raise ValueError(f"unknown layout {layout!r}")
        if (layout == "paged-sharded") != (group is not None):
            raise ValueError(
                "layout='paged-sharded' runs on every rank of a page group "
                "and takes that rank's group= (launch.mesh.make_page_group, "
                "or launch.mesh.run_ranks); the other layouts take none")
        if spec_k > 0 and layout != "paged":
            raise ValueError("speculative decoding runs on layout='paged'")
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
        if isinstance(policy, str):
            policy = get_policy(policy)
        self.scheduler = Scheduler(n_slots, self.chunk, policy=policy)
        self.policy: Policy = self.scheduler.policy
        # preemption spills through host copies of one device's pool
        # leaves: the paged layout only, as in the JAX package
        self._can_preempt = layout == "paged"
        self._spilled: Dict[int, kv_pool.SpillRecord] = {}
        self.telemetry = ServingTelemetry() if telemetry else None
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.sample_seed = int(sample_seed)
        self._gen = torch.Generator(device=self.device)
        self._stream_cbs: Dict[int, Callable[[int, int], None]] = {}
        self._stream_done: set = set()
        self._next_rid = 0
        self._aux_log: List[Dict] = []
        self._pending = torch.zeros((n_slots,), dtype=torch.int32,
                                    device=self.device)
        self._tok_log: List = []
        self._tok_checked = 0        # dispatches whose tokens ranks agreed
        self.results: Dict[int, List[int]] = {}
        self.counters = _zero_counters()
        self.rejections: Dict[str, int] = {}
        self._init_obs(obs, shadow_rate, drift_threshold, drift_detector)
        self.spec: Optional[SpecDecoder] = None
        if spec_k > 0:
            # draft rows past the committed position must stay inside the
            # ring's slack of ``chunk`` rows
            if spec_k > self.chunk:
                raise ValueError(f"spec_k={spec_k} must be <= chunk="
                                 f"{self.chunk}")
            self.spec = SpecDecoder(self, spec_k=spec_k, draft_cap=draft_cap,
                                    draft_temperature=spec_draft_temperature)

    # -- sampling noise ----------------------------------------------------
    def _noise(self, B: int, K: int = 0):
        """This dispatch's draws, on the device from the generator reseeded
        from (sample_seed, dispatch index): -> ((B, K) uniforms, a
        verify's acceptance draws, or None when K is 0; (B, V) Gumbel
        noise)."""
        self._gen.manual_seed(_fold(self.sample_seed,
                                    self.counters["dispatches"]))

        def rand(*shape):
            return torch.rand(shape, generator=self._gen, device=self.device)

        u = rand(B, K) if K else None
        return u, gumbel_from_uniform(rand(B, self.cfg.vocab_size))

    def _prepare(self, n_valid: np.ndarray):
        """Apply the pool's pending edits (one upload when dirty) and slice
        the block table to the width this dispatch needs (the attends
        never touch the provably-null tail columns; the table itself is
        only edited host-side, through the flush) -> (cache view, ops)."""
        ops = self.pool.flush(self.cache)
        cache = self.cache
        W = self.pool.active_blocks(n_valid)
        if W is not None:
            cache = dict(cache, block_table=cache["block_table"][:, :W])
        return cache, ops

    # -- observability -----------------------------------------------------
    def _init_obs(self, obs, shadow_rate: float, drift_threshold: float,
                  drift_detector: str) -> None:
        self.obs = obs
        self._tr = obs.tracer if obs is not None else None
        self._mspec = self._mblock = None
        if obs is not None and obs.device_metrics:
            from repro_torch.obs.device import DeviceMetricsSpec
            self._mspec = DeviceMetricsSpec(self._stat_shapes())
            self._mblock = self._mspec.init(1, self.device)
            # the device's constant 1: a counted lane's value a dispatch
            self._one = torch.ones((), dtype=torch.int32,
                                   device=self.device)
        # last host-side read of the block (``_flush_obs``)
        self._last_device_metrics: Optional[Dict] = None
        self.shadow_rate = float(shadow_rate)
        self._shadow_every: Optional[int] = None
        self._shadow_mor = None
        self._twin = False
        self.drift = None
        if self.shadow_rate <= 0.0:
            return
        if self.raw_mor is None:
            raise ValueError("shadow_rate needs a calibrated MoR tree "
                             "(mor_mode != 'dense')")
        if self._mspec is None:
            raise ValueError("shadow_rate needs "
                             "Observability(device_metrics=True)")
        from repro_torch.obs.quality import DriftDetector
        self._shadow_every = max(1, int(round(1.0 / self.shadow_rate)))
        # tiled plans score in step; kernel / exact plans need the dense
        # twin (kernel sums in another order, exact is neuron-granular)
        self._twin = self.mor_mode != "tiled"
        self._shadow_mor = self._shadow_tree()
        self.drift = DriftDetector(threshold=drift_threshold,
                                   detector=drift_detector)

    def _shadow_tree(self):
        from repro_torch.core.executor import map_plans
        return map_plans(self.mor, (lambda p: p.as_shadow()) if self._twin
                         else (lambda p: p.as_scored()))

    def _stat_shapes(self) -> Dict[str, tuple]:
        """Shape of each aux stat group's per-layer leaves, read off the
        attached MoR tree: (L,) for a layer stack, (L, E) for the expert
        group, (segments,) for a hybrid's one shared MLP (applied once a
        segment).  Fixes the metrics block's layout before any
        dispatch, as the JAX package's ``_probe_stat_shapes`` does."""
        out: Dict[str, tuple] = {}
        for key, group in mor_group_map(self.cfg).items():
            entry = (self.mor or {}).get(group)
            plan = entry.get("experts") if isinstance(entry, dict) else entry
            if plan is None or plan.mor is None:
                continue
            if self.cfg.family == "hybrid":
                from repro_torch.models.hybrid import _seg_counts
                out[key] = (_seg_counts(self.cfg)[0],)
            else:
                out[key] = tuple(plan.mor["m"].shape[:-1])
        return out

    def _count_dispatch(self, aux: Dict, nv: torch.Tensor, up: torch.Tensor,
                        bt: Optional[torch.Tensor], ops) -> None:
        """Add this dispatch's counts to the metrics block, in place, from
        values on the device: tokens from ``n_valid`` / ``use_pending``,
        pages touched from the active block table, page edits from the
        ops vector, tile lanes from ``aux``."""
        dec = torch.where(up, nv, 0).sum(dtype=torch.int32)
        scalars = dict(dispatches=self._one, decode_tokens=dec,
                       prefill_tokens=nv.sum(dtype=torch.int32) - dec)
        # an in-step scored dispatch carries the shadow_* leaves: it IS
        # the primary, so the base lanes count once and the quality
        # lanes ride the same update
        if any(isinstance(st, dict) and "shadow_false_skip" in st
               for st in aux.values()):
            scalars["shadow_dispatches"] = self._one
        self._accumulate(scalars, aux, nv, bt, ops)

    def _accumulate(self, scalars: Dict, aux: Dict, nv: torch.Tensor,
                    bt: Optional[torch.Tensor], ops) -> None:
        """``scalars`` and ``aux`` into the metrics block, with the page
        edits of ``ops`` and the pages the active table ``bt`` shows."""
        if ops is not None:
            scalars = dict(kv_pool.ops_counts(self.cache, ops[0], *ops[1]),
                           **scalars)
        if bt is not None:
            scalars["pages_touched"] = ((bt > 0) & (nv > 0)[:, None]).sum(
                dtype=torch.int32)
        self._mspec.accumulate(self._mblock, scalars, aux)

    def _shadow_dispatch(self, tok, nv, cache) -> None:
        """The dense twin of this dispatch on a view of the cache (the
        live cache is left as it was): only its ``shadow_*`` stat leaves
        go into the metrics block.  On the page-sharded layout every rank
        runs it inside the page-shard context on the view of its own
        shard (``kv_pool.shadow_view``): the same merge collective a
        attention layer and the same state gather a leaf as the primary
        step, the same dispatches sampled on every rank, each rank's
        counters in its own row of the block (the reference's
        ``make_sharded_shadow_step``)."""
        with (contextlib.nullcontext() if self.group is None else
              page_shard_context(self.group)):
            _, aux = self.api.prefill_chunk(
                self.params, self.cfg, tok,
                kv_pool.shadow_view(cache, self.group), n_valid=nv,
                mor=self._shadow_mor, mor_mode=self.mor_mode)
        qaux = {}
        for g, st in (aux or {}).items():
            if isinstance(st, dict):
                sh = {k: v for k, v in st.items() if k.startswith("shadow_")}
                if sh:
                    qaux[g] = sh
        self._mspec.accumulate(self._mblock,
                               {"shadow_dispatches": self._one}, qaux)

    def _read_block(self) -> Dict:
        """The metrics block on the host: ONE device -> host transfer (a
        page-sharded rank first gathers every rank's row, one
        collective, so that shard-local fields sum over the shards)."""
        block = self._mblock
        if self.group is not None:
            from repro_torch.distributed.collectives import all_ranks
            block = all_ranks(block[0], self.group, "obs_block")
        return self._mspec.read(block)

    def _flush_obs(self) -> None:
        """Mirror every counter source into the obs registry: the
        device metrics block (one host transfer), the pool's host-side
        accounting, the kernels' launch counters and the telemetry
        summary.  Runs at flushes only, never on the dispatch loop.
        Every series is labeled by layout and written with ``set``, so
        repeated flushes (and engines sharing one registry) overwrite
        their own series."""
        if self.obs is None:
            return
        reg = self.obs.registry
        lay = self.layout
        if self._mblock is not None:
            dm = self._read_block()
            self._last_device_metrics = dm
            self._mirror_block(reg, lay, dm)
        csd = reg.counter("repro_scheduler_dispatches_total",
                          "dispatches built, by kind", ("layout", "kind"))
        for kind, v in self.scheduler.dispatch_kinds.items():
            csd.set(v, layout=lay, kind=kind)
        crj = reg.counter("repro_requests_rejected_total",
                          "requests rejected at submit validation",
                          ("layout", "reason"))
        for reason, v in self.rejections.items():
            crj.set(v, layout=lay, reason=reason)
        if self.pool is not None:
            self._mirror_pool(reg, lay)
        ckl = reg.counter("repro_kernel_launches_total",
                          "CUDA kernel launches in this process since the "
                          "counters were last zeroed", ("kernel",))
        for name, v in _kernel_launches().items():
            ckl.set(v, kernel=name)
        if self.telemetry is not None:
            export_telemetry(reg, self.telemetry, layout=lay,
                             capacities=self.capacities)

    def _mirror_block(self, reg, lay: str, dm: Dict) -> None:
        reg.counter("repro_engine_dispatches_total",
                    "engine dispatches (device-counted)",
                    ("layout",)).set(dm["dispatches"], layout=lay)
        ctok = reg.counter("repro_engine_tokens_total",
                           "tokens processed by the dispatches",
                           ("layout", "phase"))
        ctok.set(dm["prefill_tokens"], layout=lay, phase="prefill")
        ctok.set(dm["decode_tokens"], layout=lay, phase="decode")
        reg.counter("repro_engine_pages_touched_total",
                    "live (slot, block) table entries visible to the paged "
                    "attends, summed over dispatches",
                    ("layout",)).set(dm["pages_touched"], layout=lay)
        reg.counter("repro_spec_tokens_drafted_total",
                    "draft tokens proposed by speculative rounds "
                    "(device-counted)",
                    ("layout",)).set(dm["tokens_drafted"], layout=lay)
        reg.counter("repro_spec_tokens_accepted_total",
                    "draft tokens the target verify accepted "
                    "(device-counted)",
                    ("layout",)).set(dm["tokens_accepted"], layout=lay)
        cpe = reg.counter("repro_pool_page_events_total",
                          "device page edits applied by the packed ops",
                          ("layout", "table", "event"))
        for table in ("kv", "state"):
            cpe.set(dm[f"{table}_page_resets"], layout=lay, table=table,
                    event="reset")
            cpe.set(dm[f"{table}_page_copies"], layout=lay, table=table,
                    event="copy")
        lab_names = ("layout", "group", "layer", "expert")
        ct = reg.counter("repro_mor_tiles_total",
                         "predictor tile-grid size, summed over dispatches",
                         lab_names)
        cs = reg.counter("repro_mor_tiles_skipped_total",
                         "tiles the predictor skipped, summed over "
                         "dispatches", lab_names)
        gl = reg.gauge("repro_mor_frac_tiles_live",
                       "mean live-tile fraction (device fixed-point)",
                       lab_names)

        def cells(g, d, key):
            for idx in np.ndindex(d[key].shape):
                yield idx, {"layout": lay, "group": g, "layer": idx[0],
                            "expert": idx[1] if len(idx) > 1 else ""}

        for g, d in dm["groups"].items():
            for idx, lab in cells(g, d, "tiles_total"):
                ct.set(int(d["tiles_total"][idx]), **lab)
                cs.set(int(d["tiles_skipped"][idx]), **lab)
                gl.set(float(d["mean_frac_tiles_live"][idx]), **lab)
        if self._shadow_every is None:
            return
        # predictor-quality mirrors and drift detection over the freshly
        # read shadow-oracle counters
        reg.counter("repro_engine_shadow_dispatches_total",
                    "dispatches scored by the shadow-oracle twin",
                    ("layout",)).set(dm["shadow_dispatches"], layout=lay)
        cfs = reg.counter("repro_mor_false_skip_total",
                          "tiles the predictor skipped that the dense "
                          "oracle says were live (shadow-sampled)",
                          lab_names)
        cfk = reg.counter("repro_mor_false_keep_total",
                          "tiles the predictor kept that the dense oracle "
                          "says were dead (shadow-sampled)", lab_names)
        gfs = reg.gauge("repro_mor_false_skip_rate",
                        "false skips over truly-live tiles, last flush "
                        "window (drift-detector input)", lab_names)
        gsa = reg.gauge("repro_mor_shadow_sign_agree",
                        "mean predictor/oracle sign-agreement rate per "
                        "shadow dispatch", lab_names)
        gse = reg.gauge("repro_mor_shadow_err",
                        "mean relative output-error norm of the "
                        "MoR-masked activation vs dense, per shadow "
                        "dispatch", lab_names)
        gdr = reg.gauge("repro_mor_drift",
                        "1 while the drift detector flags this series",
                        lab_names)
        for ev in self.drift.update(dm):
            if self._tr is not None:
                self._tr.on_drift(ev["group"], ev["layer"], ev["expert"],
                                  ev["rate"])
        dst = self.drift.state()
        for g, d in dm["groups"].items():
            drifted = dst.get(g, {}).get("drifted")
            for idx, lab in cells(g, d, "false_skip"):
                cfs.set(int(d["false_skip"][idx]), **lab)
                cfk.set(int(d["false_keep"][idx]), **lab)
                gfs.set(float(d["false_skip_rate"][idx]), **lab)
                gsa.set(float(d["mean_sign_agree"][idx]), **lab)
                gse.set(float(d["mean_shadow_err"][idx]), **lab)
                gdr.set(1.0 if drifted is not None and bool(drifted[idx])
                        else 0.0, **lab)

    def _mirror_pool(self, reg, lay: str) -> None:
        cpre = reg.counter("repro_preemptions_total",
                           "slot preemptions: page spills to host and "
                           "restores", ("layout", "event"))
        for k, v in self.pool.spill_events.items():
            cpre.set(v, layout=lay, event=k)
        cal = reg.counter("repro_pool_alloc_events_total",
                          "host allocator page alloc/free events",
                          ("layout", "table", "event"))
        for k, v in self.pool.alloc_events().items():
            table, event = k.split("_")
            cal.set(v, layout=lay, table=table, event=event)
        sh = self.pool.shard_report()
        giu = reg.gauge("repro_pool_pages_in_use",
                        "pages currently allocated, per shard",
                        ("layout", "table", "shard"))
        ghw = reg.gauge("repro_pool_pages_hiwater",
                        "page-occupancy high-water mark, per shard",
                        ("layout", "table", "shard"))
        for table in ("kv", "state"):
            key = f"{table}_pages_in_use_per_shard"
            if key not in sh:
                continue
            for s, v in enumerate(sh[key]):
                giu.set(v, layout=lay, table=table, shard=s)
            for s, v in enumerate(sh[f"{table}_pages_hiwater_per_shard"]):
                ghw.set(v, layout=lay, table=table, shard=s)
        if self.pool.prefix is not None:
            pc = self._prefix_counters()
            cpr = reg.counter("repro_prefix_events_total",
                              "prefix-cache event counters",
                              ("layout", "event"))
            for k, v in pc.items():
                if k != "hit_rate":
                    cpr.set(v, layout=lay, event=k)
            reg.gauge("repro_prefix_hit_rate",
                      "prefix-cache hit rate since last reset",
                      ("layout",)).set(pc["hit_rate"], layout=lay)
            gtr = reg.gauge("repro_prefix_trie", "prefix-trie occupancy",
                            ("layout", "stat"))
            for k, v in self.pool.prefix.stats().items():
                gtr.set(v, layout=lay, stat=k)

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
        """Deliver the token log to ``results`` and the stream callbacks,
        in order.  Entries are (emits, tokens (B,)) of a vanilla dispatch
        or (emits, tokens (B, K+1), host counts (B,)) of a speculative
        round; the whole log comes to the host in ONE transfer."""
        if self._tok_log:
            if self.group is not None:
                # the ranks' schedulers stay in step only while their
                # tokens agree: raise at the first dispatch that differs
                toks = torch.stack([e[1] for e in self._tok_log])
                mesh.check_tokens(toks, self.group, self._tok_checked)
                self._tok_checked += len(toks)
            flat = torch.cat([e[1].reshape(-1) for e in self._tok_log])
            flat = flat.cpu().numpy()
            i = 0
            for entry in self._tok_log:
                emits, n = entry[0], entry[1].numel()
                toks = flat[i:i + n].reshape(entry[1].shape)
                i += n
                for s, rid in emits:
                    vals = ((toks[s],) if len(entry) == 2
                            else toks[s, :int(entry[2][s])])
                    res = self.results.setdefault(rid, [])
                    cb = self._stream_cbs.get(rid)
                    for t in vals:
                        res.append(int(t))
                        if cb is not None:
                            cb(rid, int(t))
            self._tok_log.clear()
        # a flush delivers every logged token, so the finished requests'
        # callbacks have had their last one
        for rid in self._stream_done:
            self._stream_cbs.pop(rid, None)
        self._stream_done.clear()

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

    def submit(self, prompt, max_new_tokens: int = 16,
               on_token: Optional[Callable[[int, int], None]] = None,
               priority: int = 0) -> int:
        """Queue a request; returns its rid.  ``on_token(rid, token)`` is
        called for each generated token, in order, when the engine
        flushes its token log (the end of ``run``, or every
        ``stream_interval`` dispatches): streaming adds no device sync.
        ``priority`` feeds the policy (higher admits first; under
        ``PriorityPolicy`` it may preempt lower classes).  Unservable
        requests raise ``RequestRejected`` before touching the queue."""
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
        if on_token is not None:
            self._stream_cbs[rid] = on_token
        if self._tr is not None:
            self._tr.on_submit(rid)
        self.scheduler.add(Request(rid, prompt, max_new_tokens,
                                   priority=priority))
        return rid

    # -- preemption --------------------------------------------------------
    def _preempt(self, slot: int) -> None:
        """Spill ``slot``'s pages to the host and requeue its request at
        its exact progress.  The slot's pending token (its last sample)
        rides in the spill record (one read of the device a spill), and
        ``_place`` puts it back on restore."""
        if not self._can_preempt:
            raise ValueError(f"preemption spills pages of layout='paged', "
                             f"not {self.layout!r}")
        req = self.scheduler.slots[slot].req
        rec = self.pool.spill(slot, self.cache)
        rec.rid = req.rid
        rec.last_token = int(self._pending[slot].item())
        self._spilled[req.rid] = rec
        self.scheduler.preempt(slot)
        self.counters["preemptions"] += 1
        if self._tr is not None:
            self._tr.on_preempt(req.rid, slot)

    def _place(self, slot: int, entry) -> Optional[int]:
        """Scheduler admission hook (paged layouts): prefix-cache
        admission for a fresh request, the spill record's restore for a
        preempted one.  -> the prompt offset to start from, or None to
        defer the admission (pool exhausted: the engine may spill a
        victim and retry)."""
        if entry.resume:
            rec = self._spilled[entry.req.rid]
            try:
                self.pool.restore(slot, rec, self.cache)
            except kv_pool.PoolExhausted:
                return None
            del self._spilled[entry.req.rid]
            self._pending[slot] = rec.last_token
            if self._tr is not None:
                self._tr.on_restore(entry.req.rid, slot)
            return entry.offset
        try:
            return self.pool.admit(slot, entry.req.prompt)
        except kv_pool.PoolExhausted:
            return None

    @torch.no_grad()
    def step(self) -> List[int]:
        """One scheduler iteration: admit (preempting victims when the
        policy or the pool's pressure asks for it), dispatch, ingest.
        Returns the rids that finished this step."""
        t0 = time.perf_counter()
        sched = self.scheduler
        pool = self.pool
        # policy preemption: with no slot free, the policy may evict a
        # running victim for the head of the (ordered) queue
        if self._can_preempt and sched.waiting and \
                not any(s.state is FREE for s in sched.slots):
            self.policy.order(sched.waiting)
            victim = self.policy.select_victim(sched.slots, sched.waiting[0])
            if victim is not None:
                self._preempt(victim)
        place = self._place if pool is not None else None
        admitted = sched.admit(place)
        if pool is not None:
            # admission deferred for want of pages: spill victims and
            # retry, never a slot admitted in this step
            for _ in range(self.n_slots):
                if not sched.deferred or not self._can_preempt:
                    break
                victim = self.policy.spill_victim(sched.slots,
                                                  exclude=admitted)
                if victim is None:
                    break
                self._preempt(victim)
                admitted += sched.admit(place)
        if admitted and pool is None:
            mask = np.zeros((self.n_slots,), bool)
            mask[admitted] = True
            kv_pool.reset_slots(self.cache,
                                kv_pool.upload(mask, self.device))
        kind = sched.peek_kind()
        if kind is None:
            if sched.waiting:
                raise kv_pool.PoolExhausted(
                    "no waiting request can be admitted and nothing is "
                    "running: the pool is exhausted with no victim to spill")
            return []
        # a decode-only step becomes a speculative round (atomic inside
        # this step, so that a preemption above sees committed state);
        # ready() backs off one step after a round aborted for pages
        if self.spec is not None and kind == "decode" and self.spec.ready():
            return self.spec.round(t0, admitted)
        tokens, n_valid, use_pending, emits, finishing, prefilling = \
            sched.build_batch(kind)
        cache = self.cache
        ops = None
        if pool is not None:
            # pre-dispatch: snapshot the recurrent state of slots whose
            # prompt finishes here (the state at ``off`` is what the
            # earlier dispatches left in the pool), publish the prefix of
            # windowed prompts about to wrap their ring, then allocate /
            # copy-on-write every page this dispatch will touch and
            # apply the edits (one upload when dirty, none when clean).
            # Running out of pages mid-plan spills a victim and rebuilds
            # the batch (the victim may have been in it); the hooks are
            # idempotent and the plan resumes past blocks already made
            # exclusive, so the retry is safe.
            for _ in range(self.n_slots + 1):
                for s, off in finishing:
                    pool.maybe_snapshot(s, sched.slots[s].req.prompt, off)
                for s, off, take in prefilling:
                    pool.maybe_publish_prewrap(s, sched.slots[s].req.prompt,
                                               off, take)
                try:
                    pool.plan_writes(n_valid)
                    break
                except kv_pool.PoolExhausted:
                    victim = (self.policy.spill_victim(sched.slots,
                                                       exclude=admitted)
                              if self._can_preempt else None)
                    if victim is None:
                        raise
                    self._preempt(victim)
                    kind = sched.peek_kind()
                    if kind is None:            # spilled the whole batch
                        return []
                    (tokens, n_valid, use_pending, emits, finishing,
                     prefilling) = sched.build_batch(kind)
            else:
                raise kv_pool.PoolExhausted(
                    "the dispatch does not fit even after spilling victims")
            cache, ops = self._prepare(n_valid)
        sched.dispatch_kinds[kind] += 1
        ndec = int(use_pending.sum()) if kind == "mixed" else 0
        tok = kv_pool.upload(tokens, self.device)
        nv = kv_pool.upload(n_valid, self.device)
        up = kv_pool.upload(use_pending, self.device)
        # splice each decoding slot's device-resident last token in
        tok[:, 0] = torch.where(up, self._pending, tok[:, 0])
        ann = contextlib.nullcontext()
        if self._tr is not None:
            # rid lookups before feed() below frees finished slots
            slots = sched.slots
            tr_t0 = self._tr.now()
            tr_admitted = [(s, slots[s].req.rid) for s in admitted]
            tr_prefilling = [(s, slots[s].req.rid, off, take)
                             for s, off, take in prefilling]
            ann = self._tr.annotation(kind)
        # shadow-oracle sampling: tiled plans swap their scored twin into
        # this dispatch; kernel / exact plans run the dense twin first,
        # on a view of the cache, and keep the primary's tokens
        sampled = (self._shadow_every is not None and
                   self.counters["dispatches"] % self._shadow_every == 0)
        if sampled and self._twin:
            self._shadow_dispatch(tok, nv, cache)
        mor = self._shadow_mor if sampled and not self._twin else self.mor
        with ann, (contextlib.nullcontext() if self.group is None else
                   page_shard_context(self.group)):
            logits, aux = self.api.prefill_chunk(
                self.params, self.cfg, tok, cache, n_valid=nv,
                mor=mor, mor_mode=self.mor_mode)
        last = torch.clamp(nv - 1, min=0).long()
        lg = logits[torch.arange(self.n_slots, device=self.device), last]
        # the sampling head the speculative verify shares (serving.spec)
        nxt, _ = sample_step(lg, temperature=self.temperature,
                             top_k=self.top_k,
                             gumbel=self._noise(self.n_slots)[1]
                             if self.temperature > 0.0 else None)
        self._pending = torch.where(nv > 0, nxt, self._pending)
        if self._mblock is not None:
            self._count_dispatch(aux, nv, up, cache.get("block_table"), ops)
        if pool is not None:
            pool.advance(n_valid)
        if emits:
            self._tok_log.append((emits, nxt))
        if self.telemetry is not None and aux:
            self._aux_log.append(aux)
        finished, entering = sched.feed(n_valid)
        for _, req in finished:
            if req.rid in self._stream_cbs:
                self._stream_done.add(req.rid)
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
        if self._tr is not None:
            self._tr.on_dispatch(
                kind, tr_t0, self._tr.now(), admitted=tr_admitted,
                prefilling=tr_prefilling, emits=emits,
                finished=[req.rid for _, req in finished],
                queue_depth=len(sched.waiting),
                n_active=int(np.count_nonzero(n_valid)))
        return [req.rid for _, req in finished]

    def reset_counters(self) -> None:
        """Zero the throughput AND prefix-cache counters (e.g. between a
        warm-up pass and a timed pass), so that a report's hit rate and
        skipped chunks describe the same pass as its token counts; the
        cache contents survive.  With observability on, the metrics
        block and the tracer reset with them."""
        self.counters = _zero_counters()
        self.rejections = {}
        self.scheduler.chunks_skipped = 0
        self.scheduler.tokens_skipped = 0
        self.scheduler.dispatch_kinds = new_dispatch_kinds()
        if self.spec is not None:
            self.spec.reset()
        if self.pool is not None:
            self.pool.reset_event_counters()
        if self._mblock is not None:
            self._mblock.zero_()
        if self.drift is not None:
            # the cumulative source counters just zeroed; the detectors'
            # state (EWMA / Page-Hinkley accumulators, raised flags) stays
            self.drift.rebase()
        if self._tr is not None:
            self._tr.reset()

    def drain(self) -> None:
        """A flush without serving: deliver the token log (and the stream
        callbacks) and push the telemetry and obs mirrors.  Open-loop
        drivers that step the engine themselves call it at the end."""
        self._flush_tokens()
        self._flush_telemetry()
        self._flush_obs()

    def run(self, requests=None,
            stream_interval: int = 0) -> Dict[int, List[int]]:
        """Drive the queue (plus optional (prompt, max_new) pairs) to
        completion; returns {rid: generated tokens} for the requests
        submitted by THIS call (all-time results stay in ``results``).
        ``stream_interval`` > 0 flushes the token log (firing the
        ``on_token`` callbacks) every that many dispatches instead of
        only at the end: a device sync each time, for incremental
        delivery."""
        first_rid = self._next_rid
        for prompt, max_new in requests or ():
            self.submit(prompt, max_new)
        while self.scheduler.has_work:
            self.step()
            if stream_interval > 0 and \
                    self.counters["dispatches"] % stream_interval == 0:
                self._flush_tokens()
        self.drain()
        if requests:
            return {rid: toks for rid, toks in self.results.items()
                    if rid >= first_rid}
        return dict(self.results)

    def stream(self, prompt, max_new_tokens: int = 16,
               interval: int = 1) -> Iterator[int]:
        """Submit ONE request now and return a generator of its tokens as
        they reach the host (the log flushes every ``interval``
        dispatches).  Other queued requests are served by the same
        dispatches."""
        got: List[int] = []
        self.submit(prompt, max_new_tokens,
                    on_token=lambda _rid, tok: got.append(tok))

        def gen() -> Iterator[int]:
            served = 0
            while self.scheduler.has_work:
                self.step()
                if self.counters["dispatches"] % max(interval, 1) == 0:
                    self._flush_tokens()
                while served < len(got):
                    yield got[served]
                    served += 1
            self.drain()
            while served < len(got):
                yield got[served]
                served += 1

        return gen()

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
        if self._shadow_mor is not None:
            # the shadow twin mirrors the active plans' capacity clip
            self._shadow_mor = self._shadow_tree()
        if self.spec is not None:
            # the draft tree wraps the re-attached target plans
            self.spec.refresh()
        return caps

    def update_mor(self, raw_mor: Dict) -> None:
        """Swap the calibrated MoR tree in place (the online
        recalibration hook), keeping the current capacities."""
        if self.raw_mor is None:
            raise ValueError("engine was built without a MoR tree")
        self.raw_mor = raw_mor
        self.mor = self._attach(self.capacities)
        if self._shadow_mor is not None:
            self._shadow_mor = self._shadow_tree()
        if self.spec is not None:
            self.spec.refresh()

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
        if self.temperature > 0.0:
            rep["sampling"] = {"temperature": self.temperature,
                               "top_k": self.top_k,
                               "sample_seed": self.sample_seed}
        if self.spec is not None:
            rep["spec"] = self.spec.report()
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
        if self.obs is not None:
            self._flush_obs()
            obs_rep: Dict = {}
            if self._last_device_metrics is not None:
                from repro_torch.obs.device import to_json
                obs_rep["device_metrics"] = to_json(
                    self._last_device_metrics)
            if self._tr is not None:
                obs_rep["tracing"] = self._tr.summary()
            rep["obs"] = obs_rep
        if self._shadow_every is not None:
            rep["quality"] = self._quality_report()
        return rep

    def _quality_report(self) -> Dict:
        q: Dict = {"shadow_rate": self.shadow_rate,
                   "shadow_every": self._shadow_every}
        dm = self._last_device_metrics
        if dm is not None:
            q["shadow_dispatches"] = dm["shadow_dispatches"]
            q["groups"] = {
                g: {"shadow_tiles": int(d["shadow_tiles"].sum()),
                    "false_skip": int(d["false_skip"].sum()),
                    "false_keep": int(d["false_keep"].sum()),
                    "truth_live": int(d["truth_live"].sum()),
                    **{k: np.round(d[k], 6).tolist() for k in (
                        "false_skip_rate", "false_keep_rate",
                        "mean_sign_agree", "mean_shadow_err")}}
                for g, d in dm["groups"].items()}
        if self.drift is not None:
            q["drift"] = self.drift.summary()
        return q
