"""Self-speculative decoding: MoR-capacitated draft passes verified
through the paged pool's block tables (``repro.serving.spec``).

One set of weights plays both roles.  The DRAFT pass is the same model
under clamped execution plans (``MoRExecutionPlan.as_draft`` with
``attach_draft_caps``: the rookies skip more tiles), proposing up to
``k`` tokens a decoding slot, one 1-wide dispatch each.  The VERIFY pass
is one prefill-shaped dispatch of ``k + 1`` rows a slot under the
full-capacity target plans; the acceptance rule keeps the longest
target-consistent prefix plus one correction (or bonus) token, so
greedy output is the target's own argmax stream, and sampled output
follows the exact rejection rule (the emitted marginal is the target
distribution for any proposal).

A round is a block-table operation (``PagedPool.spec_fork`` ...
``spec_abort``): draft rows land in pages planned like any dispatch's,
rollback truncates the position and drops the pages the round
allocated wholly past the accepted prefix, and stale draft rows carry
position tags above any later query's, so the paged attentions mask
them.  A model with recurrent state backs its state page up at the
fork, restores it before verify and, on a partial accept, once more
before ONE batched replay of the accepted tokens, so that the device
state always ends at the last verified token.

The random draws are arguments of the pure functions here:
``sample_step`` takes Gumbel noise and ``accept_sampled`` the uniforms
and the correction's Gumbel noise, so that given JAX's draws they give
JAX's tokens.  The engine draws them on its own device from a
``torch.Generator`` seeded from (``sample_seed``, dispatch index): a
sampled stream is a function of the seed, but not ``jax.random``'s.

A round reads ONE value back to the host: the per-slot emit counts.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving import kv_pool

__all__ = ["sample_step", "accept_greedy", "accept_sampled", "emit_matrix",
           "gumbel_from_uniform", "SpecDecoder"]


# -- sampling (shared with the engine's vanilla step) ----------------------

def _scaled_logits(lg: torch.Tensor, temperature: float,
                   top_k: int) -> torch.Tensor:
    """Temperature-scaled, optionally top-k-truncated logits (float32)."""
    lgs = lg.float() / temperature
    if top_k > 0:
        k = min(top_k, lgs.shape[-1])
        kth = torch.topk(lgs, k, dim=-1).values[..., -1:]
        lgs = torch.where(lgs < kth, float("-inf"), lgs)
    return lgs


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in [0, 1) (clamped above 0, as
    ``jax.random.gumbel`` draws them)."""
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_step(lg: torch.Tensor, *, temperature: float, top_k: int,
                gumbel: Optional[torch.Tensor] = None,
                with_probs: bool = False):
    """One sampling step over logits ``lg`` (..., V): the argmax at
    ``temperature == 0`` (``gumbel`` unused), else Gumbel-max over the
    temperature / top-k logits, ``argmax(logits + gumbel)``, which is
    what ``jax.random.categorical`` computes from its own noise.  ->
    (tokens int32, probs): ``probs`` the post-truncation distribution
    (..., V) float32 the tokens were drawn from (the speculative
    rejection rule reads it), None when greedy or not asked for."""
    if temperature > 0.0:
        lgs = _scaled_logits(lg, temperature, top_k)
        toks = torch.argmax(lgs + gumbel, dim=-1).to(torch.int32)
        return toks, (torch.softmax(lgs, dim=-1) if with_probs else None)
    return torch.argmax(lg, dim=-1).to(torch.int32), None


# -- acceptance rules (pure) -----------------------------------------------

def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a (B, N, ...) at per-row index idx (B,) -> (B, ...)."""
    return a[torch.arange(a.shape[0], device=a.device), idx.long()]


def accept_greedy(drafts: torch.Tensor, targets: torch.Tensor,
                  k_valid: torch.Tensor):
    """Greedy acceptance: the longest prefix of ``drafts`` (B, K) equal
    to the target argmax ``targets`` (B, K+1), over the first
    ``k_valid`` (B,) drafted positions.  -> (n_accept (B,), correction
    (B,)): the target token at the first mismatch (the bonus token when
    all matched), so the emitted stream is the target's greedy one
    whatever the draft proposed."""
    K = drafts.shape[1]
    idx = torch.arange(K, device=drafts.device)[None, :]
    match = (drafts == targets[:, :K]) & (idx < k_valid[:, None])
    n_accept = torch.cumprod(match.to(torch.int32), dim=1).sum(
        dim=1, dtype=torch.int32)
    return n_accept, _take(targets, n_accept).to(torch.int32)


def accept_sampled(drafts: torch.Tensor, draft_probs: torch.Tensor,
                   tgt_probs: torch.Tensor, k_valid: torch.Tensor,
                   u: torch.Tensor, gumbel: torch.Tensor):
    """The exact speculative rejection rule: position ``i`` accepts draft
    ``d_i`` iff ``u_i q_i(d_i) <= p_i(d_i)`` (``p`` the target, ``q``
    the draft distribution); the first rejection samples the correction
    from the residual ``norm(max(p - q, 0))`` and a full accept samples
    the bonus from ``p`` at the next position.

    drafts (B, K) int; draft_probs (B, K, V); tgt_probs (B, K+1, V);
    k_valid (B,) drafted counts; u (B, K) uniforms; gumbel (B, V) the
    correction's noise.  -> (n_accept, correction)."""
    K = drafts.shape[1]
    d = drafts.long()[..., None]
    p_d = torch.gather(tgt_probs[:, :K], -1, d)[..., 0]
    q_d = torch.gather(draft_probs, -1, d)[..., 0]
    idx = torch.arange(K, device=drafts.device)[None, :]
    ok = (u * torch.clamp(q_d, min=1e-20) <= p_d) & (idx < k_valid[:, None])
    n_accept = torch.cumprod(ok.to(torch.int32), dim=1).sum(
        dim=1, dtype=torch.int32)
    # the residual at the rejection position (clamped; fully accepted
    # rows take the bonus below)
    j = torch.clamp(n_accept, max=K - 1)
    p_j, q_j = _take(tgt_probs, j), _take(draft_probs, j)
    resid = torch.clamp(p_j - q_j, min=0.0)
    rs = resid.sum(dim=-1, keepdim=True)
    # an empty residual (q covers p) falls back to p itself
    resid = torch.where(rs > 1e-20, resid / torch.clamp(rs, min=1e-20), p_j)
    p_bonus = _take(tgt_probs, k_valid)
    dist = torch.where((n_accept >= k_valid)[:, None], p_bonus, resid)
    correction = torch.argmax(torch.log(torch.clamp(dist, min=1e-30))
                              + gumbel, dim=-1).to(torch.int32)
    return n_accept, correction


def emit_matrix(drafts: torch.Tensor, n_accept: torch.Tensor,
                correction: torch.Tensor, n_valid: torch.Tensor):
    """A round's emissions: (B, K+1) tokens, the accepted draft prefix
    then the correction at column ``n_accept``, and the per-slot emit
    count ``n_accept + 1`` (0 for a slot that sat the round out)."""
    B, K = drafts.shape
    idx = torch.arange(K + 1, device=drafts.device)[None, :]
    toks = torch.where(idx[:, :K] < n_accept[:, None], drafts.to(torch.int32),
                       0)
    toks = torch.cat([toks, torch.zeros((B, 1), dtype=torch.int32,
                                        device=drafts.device)], dim=1)
    toks = torch.where(idx == n_accept[:, None], correction[:, None], toks)
    n_emit = torch.where(n_valid > 0, n_accept + 1, 0).to(torch.int32)
    return toks.to(torch.int32), n_emit


# -- the phase bodies (eager) ----------------------------------------------

def _dispatch_core(cfg, api, mor_mode, params, mor, cache, tokens, n_valid,
                   pending):
    """Splice each live slot's pending token into column 0 of ``tokens``
    (B, C) and run the chunk step on ``cache`` in place.  -> (logits
    (B, C, V), aux)."""
    tokens[:, 0] = torch.where(n_valid > 0, pending, tokens[:, 0])
    return api.prefill_chunk(params, cfg, tokens, cache, n_valid=n_valid,
                             mor=mor, mor_mode=mor_mode)


def draft_step_impl(cfg, api, mor_mode, temperature, top_k, params, mor,
                    cache, n_valid, pending, gumbel=None):
    """One draft step under the clamped plans: feed each live slot's
    pending token, propose the next.  Slots past their draft length ride
    with ``n_valid == 0`` (no state change, no kv write, pending kept).
    -> (proposals (B,), probs (B, V) or None, new pending)."""
    tokens = torch.zeros((n_valid.shape[0], 1), dtype=torch.int32,
                         device=n_valid.device)
    logits, _ = _dispatch_core(cfg, api, mor_mode, params, mor, cache,
                               tokens, n_valid, pending)
    nxt, probs = sample_step(logits[:, 0], temperature=temperature,
                             top_k=top_k, gumbel=gumbel,
                             with_probs=temperature > 0.0)
    return nxt, probs, torch.where(n_valid > 0, nxt, pending)


def verify_step_impl(cfg, api, mor_mode, temperature, top_k, params, mor,
                     cache, tokens, n_valid, pending, draft_probs=None,
                     u=None, gumbel=None):
    """The prefill-shaped verify: ``tokens`` (B, K+1) holds the pending
    token (spliced into column 0) and the drafted continuation, and
    ``n_valid[s] = k_s + 1`` scores every position under the target
    plans in one pass (the draft kv rows are rewritten before any
    attend).  A slot with ``k_s == 0`` is a vanilla decode.  -> (emit
    matrix, emit counts, new pending, aux)."""
    drafts = tokens[:, 1:]
    logits, aux = _dispatch_core(cfg, api, mor_mode, params, mor, cache,
                                 tokens, n_valid, pending)
    k_valid = torch.clamp(n_valid - 1, min=0)
    if temperature > 0.0:
        tgt_probs = torch.softmax(_scaled_logits(logits, temperature, top_k),
                                  dim=-1)
        if draft_probs is None:
            # a greedy draft under a sampled target: q is a point mass
            draft_probs = torch.nn.functional.one_hot(
                drafts.long(), logits.shape[-1]).float()
        n_accept, correction = accept_sampled(drafts, draft_probs, tgt_probs,
                                              k_valid, u, gumbel)
    else:
        targets = torch.argmax(logits, dim=-1).to(torch.int32)
        n_accept, correction = accept_greedy(drafts, targets, k_valid)
    emit_toks, n_emit = emit_matrix(drafts, n_accept, correction, n_valid)
    return (emit_toks, n_emit, torch.where(n_valid > 0, correction, pending),
            aux)


def replay_step_impl(cfg, api, mor_mode, params, mor, cache, tokens, n_valid,
                     pending):
    """Partial-accept replay: feed the ACCEPTED tokens (``n_valid[s] =
    m_s``) again from the restored fork-point state under the target
    plans, so that the recurrent state lands on the last verified token.
    The kv rows it writes equal the verify's; logits are dropped and
    nothing is emitted."""
    _dispatch_core(cfg, api, mor_mode, params, mor, cache, tokens, n_valid,
                   pending)


# -- the round -------------------------------------------------------------

class SpecDecoder:
    """Speculative rounds for an ``Engine`` (paged layout): holds the
    draft plan tree; ``round`` stands in for the vanilla decode dispatch
    of ``Engine.step`` whenever every live slot decodes."""

    def __init__(self, engine, *, spec_k: int, draft_cap: float = 0.0,
                 draft_temperature: Optional[float] = None):
        if spec_k < 1:
            raise ValueError(f"spec_k {spec_k} < 1")
        self.eng = engine
        self.k = int(spec_k)
        self.draft_cap = float(draft_cap)
        # a greedy target may still DRAFT at a temperature: rejections
        # run the rollback paths while the output stays greedy
        self.draft_temperature = (engine.temperature
                                  if draft_temperature is None
                                  else float(draft_temperature))
        self.counters: Dict[str, int] = {
            "rounds": 0, "tokens_drafted": 0, "tokens_accepted": 0,
            "replays": 0, "aborts": 0}
        self._cooldown = 0
        self.refresh()

    def refresh(self) -> None:
        """(Re)derive the draft plans from the engine's current plans (at
        construction and after ``calibrate_capacities`` / ``update_mor``
        re-attach them).  Dense engines draft with the target itself;
        with plans, ``draft_cap > 0`` clamps every layer's live-tile
        budget for the draft pass."""
        if self.eng.mor is None:
            self.mor_draft = None
            return
        from repro_torch.core.executor import attach_draft_caps, map_plans
        md = self.eng.mor
        if self.draft_cap > 0.0:
            md = attach_draft_caps(md, self.draft_cap)
        self.mor_draft = map_plans(md, lambda p: p.as_draft())

    def reset(self) -> None:
        for k in self.counters:
            self.counters[k] = 0
        self._cooldown = 0

    def report(self) -> Dict:
        c = dict(self.counters)
        return {"k": self.k, "draft_cap": self.draft_cap,
                "draft_temperature": self.draft_temperature,
                "acceptance_rate": (c["tokens_accepted"]
                                    / max(c["tokens_drafted"], 1)),
                **c}

    def ready(self) -> bool:
        """One step of backoff after an aborted round: the next step
        takes the vanilla path, whose spills can free pages."""
        if self._cooldown > 0:
            self._cooldown -= 1
            return False
        return True

    def _plan_round(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-slot draft lengths ``min(k, remaining - 1)`` (a round never
        overshoots a request's budget), capped so that the verify's
        drafted positions fit the policy's ``prefill_budget`` (the first
        speculating slot keeps at least one)."""
        eng = self.eng
        k_s = np.zeros((eng.n_slots,), np.int64)
        active = np.zeros((eng.n_slots,), bool)
        budget = eng.policy.prefill_budget
        left = budget if budget > 0 else None
        for s in range(eng.n_slots):
            rem = eng.scheduler.decode_remaining(s)
            if rem <= 0:
                continue
            active[s] = True
            take = min(self.k, rem - 1)
            if left is not None and take > 0:
                cap = max(left, 0) if k_s.any() else max(left, 1)
                take = min(take, cap)
                left -= take
            k_s[s] = take
        return k_s, active

    def _abort(self, forks: List) -> None:
        for f in forks:
            self.eng.pool.spec_abort(f)
        self.counters["aborts"] += 1
        self._cooldown = 1

    def _prepare(self, nv_np: np.ndarray):
        """``Engine._prepare`` and ``n_valid`` uploaded -> (cache view,
        nv, ops)."""
        cache, ops = self.eng._prepare(nv_np)
        return cache, kv_pool.upload(nv_np, self.eng.device), ops

    def round(self, t0: float, admitted: List[int]) -> List[int]:
        """One speculative round: fork, up to k draft dispatches, one
        verify dispatch, commit / rollback (and one state replay where a
        partial accept needs it), feed.  Falls back to one vanilla
        ``Engine.step`` when the pool cannot host the round."""
        eng = self.eng
        sched, pool = eng.scheduler, eng.pool
        K, B = self.k, eng.n_slots
        e = (eng.cfg, eng.api, eng.mor_mode)
        k_s, active = self._plan_round()
        kmax = int(k_s.max(initial=0))
        forks: List = []
        try:
            for s in np.nonzero(k_s > 0)[0]:
                forks.append(pool.spec_fork(int(s)))
        except kv_pool.PoolExhausted:
            self._abort(forks)
            return eng.step()
        tr = eng._tr
        ann = (tr.annotation if tr is not None
               else lambda _k: contextlib.nullcontext())
        pending = eng._pending          # the committed pending stays put
        draft_toks: List[torch.Tensor] = []
        draft_probs: List[torch.Tensor] = []
        try:
            for i in range(kmax):
                nv_np = (k_s > i).astype(np.int32)
                pool.plan_writes(nv_np)
                cache, nv, ops = self._prepare(nv_np)
                g = (eng._noise(B)[1] if self.draft_temperature > 0.0
                     else None)
                tr_t0 = tr.now() if tr is not None else 0.0
                with ann("draft"):
                    nxt, probs, pending = draft_step_impl(
                        *e, self.draft_temperature, eng.top_k, eng.params,
                        self.mor_draft, cache, nv, pending, g)
                if eng._mblock is not None:
                    eng._accumulate(
                        {"dispatches": eng._one,
                         "tokens_drafted": nv.sum(dtype=torch.int32)},
                        {}, nv, cache.get("block_table"), ops)
                pool.advance(nv_np)
                draft_toks.append(nxt)
                draft_probs.append(probs)
                eng.counters["dispatches"] += 1
                sched.dispatch_kinds["draft"] += 1
                self.counters["tokens_drafted"] += int(nv_np.sum())
                if tr is not None:
                    tr.on_dispatch("draft", tr_t0, tr.now(),
                                   queue_depth=len(sched.waiting),
                                   n_active=int(nv_np.sum()))
            # verify: back to the fork point, k + 1 positions scored
            # under the target plans in one prefill-shaped pass
            for f in forks:
                pool.spec_set_pos(f.slot, f.pos)
                pool.spec_restore_state(f)
            nvv_np = np.where(active, k_s + 1, 0).astype(np.int32)
            pool.plan_writes(nvv_np)
        except kv_pool.PoolExhausted:
            self._abort(forks)
            return eng.step()
        cache, nvv, ops = self._prepare(nvv_np)
        dev = eng.device
        zeros = torch.zeros((B, K + 1 - kmax), dtype=torch.int32, device=dev)
        tokens = torch.cat([zeros[:, :1]] + [t[:, None] for t in draft_toks]
                           + [zeros[:, 1:]], dim=1)
        qstack = None
        if eng.temperature > 0.0 and self.draft_temperature > 0.0:
            V = draft_probs[0].shape[-1] if kmax else eng.cfg.vocab_size
            pad = torch.ones((B, K - kmax, V), dtype=torch.float32,
                             device=dev)
            qstack = torch.cat([p[:, None] for p in draft_probs] + [pad],
                               dim=1)
        u = g = None
        if eng.temperature > 0.0:
            u, g = eng._noise(B, K)
        tr_t0 = tr.now() if tr is not None else 0.0
        with ann("verify"):
            emit_toks, n_emit_dev, new_pending, aux = verify_step_impl(
                *e, eng.temperature, eng.top_k, eng.params, eng.mor, cache,
                tokens, nvv, eng._pending, qstack, u, g)
        if eng._mblock is not None:
            acc = torch.where(nvv > 0, n_emit_dev - 1, 0).sum(
                dtype=torch.int32)
            eng._accumulate({"dispatches": eng._one,
                             "decode_tokens": n_emit_dev.sum(
                                 dtype=torch.int32),
                             "tokens_accepted": acc},
                            aux, nvv, cache.get("block_table"), ops)
        pool.advance(nvv_np)
        eng.counters["dispatches"] += 1
        sched.dispatch_kinds["verify"] += 1
        if eng.telemetry is not None and aux:
            eng._aux_log.append(aux)
        # the round's one host read: the per-slot emit counts drive the
        # host-side commit / rollback and the scheduler
        n_emit = np.asarray(n_emit_dev.tolist(), np.int64)

        # -- commit / rollback -------------------------------------------
        replays: List[Tuple] = []
        for f in forks:
            m = int(n_emit[f.slot])
            committed = f.pos + m
            if m < int(k_s[f.slot]) + 1:
                pool.spec_rollback_pages(f, committed)
                pool.spec_set_pos(f.slot, committed)
                if f.st_backup:
                    replays.append((f, m))
                    continue
            pool.spec_drop_backup(f)
        if replays:
            # one batched replay puts the recurrent state back on the last
            # verified token (the verify advanced it over the rejected
            # tail); attention-only models need none
            nvr_np = np.zeros((B,), np.int32)
            for f, m in replays:
                pool.spec_set_pos(f.slot, f.pos)
                pool.spec_restore_state(f)
                nvr_np[f.slot] = m
            # every page involved is already exclusive (written this
            # round): this plan cannot raise
            pool.plan_writes(nvr_np)
            cache, nvr, ops = self._prepare(nvr_np)
            tr_t0r = tr.now() if tr is not None else 0.0
            with ann("replay"):
                replay_step_impl(*e, eng.params, eng.mor, cache, tokens, nvr,
                                 eng._pending)
            if eng._mblock is not None:
                eng._accumulate({"dispatches": eng._one}, {}, nvr,
                                cache.get("block_table"), ops)
            pool.advance(nvr_np)
            eng.counters["dispatches"] += 1
            sched.dispatch_kinds["replay"] += 1
            self.counters["replays"] += 1
            for f, _ in replays:
                pool.spec_drop_backup(f)
            if tr is not None:
                tr.on_dispatch("replay", tr_t0r, tr.now(),
                               queue_depth=len(sched.waiting),
                               n_active=len(replays))

        # -- feed / emit ---------------------------------------------------
        eng._pending = new_pending
        slots = sched.slots
        emits = [(int(s), slots[s].req.rid) for s in np.nonzero(active)[0]]
        if tr is not None:
            tr_admitted = [(s, slots[s].req.rid) for s in admitted]
            tr_counts = [int(n_emit[s]) for s, _ in emits]
        eng._tok_log.append((emits, emit_toks, n_emit))
        finished = sched.feed_counts(n_emit)
        for _, req in finished:
            if req.rid in eng._stream_cbs:
                eng._stream_done.add(req.rid)
        for s, _ in finished:
            pool.release(s)
        emitted = int(n_emit.sum())
        self.counters["rounds"] += 1
        self.counters["tokens_accepted"] += emitted - len(emits)
        eng.counters["decode_tokens"] += emitted
        eng.counters["wall_s"] += time.perf_counter() - t0
        if tr is not None:
            tr.on_dispatch("verify", tr_t0, tr.now(), admitted=tr_admitted,
                           emits=emits, emit_counts=tr_counts,
                           finished=[req.rid for _, req in finished],
                           queue_depth=len(sched.waiting),
                           n_active=int(np.count_nonzero(nvv_np)))
        return [req.rid for _, req in finished]
