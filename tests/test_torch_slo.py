"""The port's SLO layer against the JAX package: the admission and
preemption policies, the scheduler's preempt / resume / count feeds,
the open-loop load generator, ``PagedPool.spill`` / ``restore``, the
engine's three preemption paths (also in the middle of speculation),
speculation from a warm prefix cache, and the request API (``on_token``,
``priority``, ``drain``, ``run(stream_interval=)``, ``stream``).

Host-side pieces run with no device in the loop and must make the
reference's decisions on the same seeded inputs.  Engines run reduced
float32 granite-3-2b and rwkv6-3b on the JAX ``init`` weights carried
across as numpy, in dense mode: tokens, preemption counts and the
pool's spill events must equal JAX's engine's under the same sequence,
and a preempted request's tokens those of an untouched run.  Everything
compared is integer (tokens, tables, refcounts, counts) or a bit-exact
copy of a page (a spill's round trip): it must be equal.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import kv_pool as jkv
from repro.serving import loadgen as jloadgen
from repro.serving import policy as jpolicy
from repro.serving import scheduler as jsched
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.serving import Engine, kv_pool, loadgen, policy, scheduler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

POLICIES = ("fcfs", "priority", "sjf")
KW = dict(n_slots=2, max_len=48, chunk=8, telemetry=False)


# -- policies and scheduler against the reference ------------------------------

def _queues(rng, mods):
    """The same random waiting queue and running slots in each package
    of ``mods`` (scheduler modules): priorities in {0, 1, 2}, prompt
    lengths, offsets, generated counts, arrival seqs, resumes."""
    n_wait, n_slots = int(rng.integers(1, 7)), int(rng.integers(1, 5))
    spec_w = [(int(rng.integers(0, 3)), int(rng.integers(2, 20)),
               int(rng.integers(0, 8)), int(rng.integers(0, 5)),
               int(rng.integers(1, 9)), bool(rng.random() < 0.3),
               int(rng.integers(0, 50))) for _ in range(n_wait)]
    spec_s = [None if rng.random() < 0.25 else
              (int(rng.integers(0, 3)), int(rng.integers(2, 20)),
               int(rng.integers(0, 8)), int(rng.integers(0, 5)),
               int(rng.integers(1, 9)), int(rng.integers(0, 50)))
              for _ in range(n_slots)]
    out = []
    for m in mods:
        waiting = []
        for rid, (pri, P, off, ng, mx, res, seq) in enumerate(spec_w):
            req = m.Request(rid, np.ones(P, np.int32), mx, priority=pri)
            waiting.append(m.PendingEntry(req, offset=min(off, P),
                                          n_generated=ng, resume=res,
                                          seq=seq))
        slots = []
        for j, sp in enumerate(spec_s):
            if sp is None:
                slots.append(m._Slot())
                continue
            pri, P, off, ng, mx, seq = sp
            slots.append(m._Slot(state=m.DECODE if off >= P else m.PREFILL,
                                 req=m.Request(100 + j, np.ones(P, np.int32),
                                               mx, priority=pri),
                                 offset=min(off, P), n_generated=ng,
                                 seq=seq))
        out.append((waiting, slots))
    return out


@pytest.mark.parametrize("name", POLICIES)
def test_policies_decide_as_the_reference_on_seeded_queues(name):
    """``order``, ``select_victim`` and ``spill_victim`` (with random
    exclusions) over 200 seeded queues: the same rid orders and the same
    victims as ``repro.serving.policy``."""
    rng = np.random.default_rng(POLICIES.index(name))
    tp, jp = policy.get_policy(name), jpolicy.get_policy(name)
    assert type(tp).__name__ == type(jp).__name__
    for _ in range(200):
        (tw, ts), (jw, js) = _queues(rng, (scheduler, jsched))
        tp.order(tw)
        jp.order(jw)
        assert [e.req.rid for e in tw] == [e.req.rid for e in jw]
        assert tp.select_victim(ts, tw[0]) == jp.select_victim(js, jw[0])
        excl = [s for s in range(len(ts)) if rng.random() < 0.3]
        assert tp.spill_victim(ts, exclude=excl) == \
            jp.spill_victim(js, exclude=excl)
    with pytest.raises(ValueError, match="unknown policy"):
        policy.get_policy("lifo")


def test_scheduler_preempt_and_count_feeds_match_the_reference():
    """One seeded event sequence (add, admit with resumes placed at their
    offset, mixed / decode batches under a prefill budget, feeds,
    preemptions, speculative count feeds) through both schedulers:
    slots, queues, batches, finished requests and ``decode_remaining``
    equal after every event."""
    rng = np.random.default_rng(5)
    ts = scheduler.Scheduler(3, 4, policy=policy.get_policy("sjf", 5))
    js = jsched.Scheduler(3, 4, policy=jpolicy.get_policy("sjf", 5))
    assert ts.dispatch_kinds == js.dispatch_kinds

    def same():
        for a, b in zip(ts.slots, js.slots):
            assert (a.state, a.offset, a.n_generated, a.seq) == \
                (b.state, b.offset, b.n_generated, b.seq)
            assert (a.req is None) == (b.req is None)
            if a.req is not None:
                assert a.req.rid == b.req.rid
        assert [(e.req.rid, e.offset, e.n_generated, e.resume, e.seq)
                for e in ts.waiting] == \
            [(e.req.rid, e.offset, e.n_generated, e.resume, e.seq)
             for e in js.waiting]
        for s in range(3):
            assert ts.decode_remaining(s) == js.decode_remaining(s)

    place = lambda s, entry: entry.offset
    for rid in range(12):
        P, g, pri = (int(rng.integers(2, 14)), int(rng.integers(1, 7)),
                     int(rng.integers(0, 2)))
        for m, sc in ((scheduler, ts), (jsched, js)):
            sc.add(m.Request(rid, np.arange(1, P + 1, dtype=np.int32), g,
                             priority=pri))
    n_preempt = n_counts = 0
    while ts.has_work:
        assert ts.admit(place) == js.admit(place)
        same()
        kind = ts.peek_kind()
        assert kind == js.peek_kind()
        if kind is None:
            break
        tb, jb = ts.build_batch(kind), js.build_batch(kind)
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(np.asarray(a, dtype=object),
                                          np.asarray(b, dtype=object))
        r = rng.random()
        if kind == "decode" and r < 0.4:
            counts = np.array([min(int(rng.integers(1, 4)),
                                   ts.decode_remaining(s))
                               for s in range(3)])
            got = ts.feed_counts(counts)
            want = js.feed_counts(counts)
            n_counts += 1
        else:
            got, _ = ts.feed(tb[1])
            want, _ = js.feed(jb[1])
        assert [(s, q.rid) for s, q in got] == [(s, q.rid) for s, q in want]
        same()
        busy = [s for s in range(3) if ts.slots[s].req is not None]
        if busy and rng.random() < 0.3:
            s = int(rng.choice(busy))
            assert ts.preempt(s).rid == js.preempt(s).rid
            n_preempt += 1
            same()
    assert not js.has_work and n_preempt > 2 and n_counts > 2


# -- the load generator ----------------------------------------------------------

def test_poisson_trace_and_latency_stats_equal_the_reference():
    """The seeded trace is the reference's arrival for arrival (times,
    prompts, budgets, priorities, oversize injections), and
    ``latency_stats`` gives its per-class quantiles."""
    kw = dict(rate=40.0, duration_s=2.0, vocab_size=128, seed=7,
              hi_pri_frac=0.3, oversize_frac=0.1, max_len=64)
    got, want = loadgen.poisson_trace(**kw), jloadgen.poisson_trace(**kw)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert (a.t, a.max_new_tokens, a.priority) == \
            (b.t, b.max_new_tokens, b.priority)
        np.testing.assert_array_equal(a.prompt, b.prompt)
    assert any(a.priority == 5 for a in got)
    assert any(len(a.prompt) == 64 for a in got)
    rng = np.random.default_rng(0)
    spans = {i: {"ttft_s": None if i % 7 == 3 else float(rng.exponential())}
             for i in range(len(got))}
    sub = {i: i for i in range(len(got))}
    st = loadgen.latency_stats(spans, sub, got)
    assert st == jloadgen.latency_stats(spans, sub, want)
    assert st["pri5"]["n"] + st["pri0"]["n"] == st["all"]["n"]
    with pytest.raises(ValueError):
        loadgen.poisson_trace(0.0, 1.0, 128)


# -- spill / restore on the pool ----------------------------------------------------

def _fill(cache, gen):
    """Random contents in every pool leaf of a port cache (tags too)."""
    for k, v in cache.items():
        if k in ("pos", "block_table", "state_table"):
            continue
        stack = [v]
        while stack:
            node = stack.pop()
            for a in node.values():
                if isinstance(a, dict):
                    stack.append(a)
                elif a.dtype.is_floating_point:
                    a.copy_(torch.randn(a.shape, generator=gen))
                else:
                    a.copy_(torch.randint(0, 40, a.shape, generator=gen))


def _slot_image(pool, cache, slot):
    """(kv pages of the slot's table, the slot's state page) contents."""
    kv, st = [], []
    table = pool.kv.table[slot] if pool.has_kv else []
    ids = [int(p) for p in table if p]
    pool._walk_kv(cache, lambda a: kv.append(a[:, ids].clone()))
    if pool.has_state:
        sp = int(pool.st.table[slot, 0])
        pool._walk_state(cache, lambda a: st.append(a[:, sp].clone()))
    return kv, st


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b"])
def test_spill_restore_round_trip_matches_jax(arch):
    """Two slots admitted over a shared prefix (granite: its pages shared
    through the prefix cache; zamba2: its state snapshot restored), one
    step of writes, then a spill of slot 1 and its restore into slot 0:
    block tables, refcounts (``check`` with the spill's kept pages as
    external refs), free lists, spill events and the record's kept /
    copied blocks equal the JAX pool's after the same calls, and the
    restored slot's pages and state hold what the spilled slot held."""
    jcfg = jreduce_config(jget_config(arch))
    cfg = reduce_config(get_config(arch))
    kw = dict(chunk=8, page=4, spare_pages=6)
    jpool = jkv.PagedPool(jcfg, 2, 40, **kw)
    tpool = kv_pool.PagedPool(cfg, 2, 40, device="cpu", **kw)
    jcache, tcache = jpool.build(), tpool.build()
    _fill(tcache, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    prefix = rng.integers(1, 50, 16)
    prompts = [np.concatenate([prefix, rng.integers(1, 50, n)]).astype(
        np.int32) for n in (5, 9)]

    def same():
        for name in ("kv", "st"):
            t, j = getattr(tpool, name), getattr(jpool, name)
            if t is None:
                continue
            np.testing.assert_array_equal(t.table, j.table)
            np.testing.assert_array_equal(t.ref, j.ref)
            assert t.free == j.free
        np.testing.assert_array_equal(tpool.pos, jpool.pos)
        assert tpool.spill_events == jpool.spill_events
        if tpool.has_kv:
            tpool.kv.check(tpool.external_refs("kv"))
            assert tpool.external_refs("kv") == jpool.external_refs("kv")
        if tpool.has_state:
            tpool.st.check(tpool.external_refs("state"))

    # slot 0 writes the first prompt in two dispatches (its state
    # snapshotted at 16 between them) and publishes it
    for pool in (jpool, tpool):
        assert pool.admit(0, prompts[0]) == 0
    for n in (16, len(prompts[0]) - 16):
        nv = np.array([n, 0], np.int32)
        for pool in (jpool, tpool):
            if n != 16:
                pool.maybe_snapshot(0, prompts[0], 16)
            pool.plan_writes(nv)
        jcache = jpool.flush(jcache)
        tpool.flush(tcache)
        for pool in (jpool, tpool):
            pool.advance(nv)
    for pool in (jpool, tpool):
        pool.publish(0, prompts[0])
    off = tpool.admit(1, prompts[1])
    assert off == jpool.admit(1, prompts[1]) and off > 0
    for pool in (jpool, tpool):
        pool.plan_writes(np.array([0, len(prompts[1]) - off], np.int32))
    same()
    tpool.flush(tcache)
    before = _slot_image(tpool, tcache, 1)
    jcache, jrec = jpool.spill(1, jcache)
    trec = tpool.spill(1, tcache)
    same()
    assert (trec.pos, trec.kv_kept, trec.kv_blocks, trec.nbytes) == \
        (jrec.pos, jrec.kv_kept, jrec.kv_blocks, jrec.nbytes)
    assert trec.nbytes > 0
    if tpool.has_kv:
        assert trec.kv_kept, "no shared page kept by reference"
    for pool in (jpool, tpool):
        pool.release(0)
    jcache = jpool.restore(0, jrec, jcache)
    tpool.restore(0, trec, tcache)
    same()
    tpool.flush(tcache)
    after = _slot_image(tpool, tcache, 0)
    assert len(after[0]) == len(before[0])
    assert len(after[1]) == len(before[1])
    assert bool(after[1]) == tpool.has_state
    for a, b in zip(before[0] + before[1], after[0] + after[1]):
        assert torch.equal(a, b)


# -- the engine's preemption paths against JAX's ------------------------------------

@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("granite-3-2b", "rwkv6-3b"):
        jcfg = jreduce_config(jget_config(arch)).replace(serve_chunk=8)
        cfg = reduce_config(get_config(arch)).replace(serve_chunk=8)
        jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
        params = convert.params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        rng = np.random.default_rng(4)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)
                   for n in (10, 14, 7, 12)]
        out[arch] = (jcfg, jparams, cfg, params, prompts)
    return out


def _engines(m, **kw):
    jcfg, jparams, cfg, params, _ = m
    return (JEngine(jcfg, jparams, **KW, **kw),
            Engine(cfg, params, **KW, **kw))


def _checked(eng):
    if eng.pool.has_kv:
        eng.pool.kv.check(eng.pool.external_refs("kv"))
    if eng.pool.has_state:
        eng.pool.st.check(eng.pool.external_refs("state"))


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-3b"])
def test_forced_preemption_matches_jax(models, arch):
    """A spill forced mid-flight and the restore: every request's tokens
    equal an untouched run's and JAX's under the same sequence, the
    allocator invariants hold with the spill record's kept pages counted,
    and no record leaks."""
    prompts = models[arch][-1][:3]
    want = Engine(*models[arch][2:4], **KW).run([(p, 5) for p in prompts])
    outs = []
    for eng in _engines(models[arch]):
        rids = [eng.submit(p, 5) for p in prompts]
        eng.step()
        eng.step()
        victim = eng.policy.spill_victim(eng.scheduler.slots)
        eng._preempt(victim)
        if isinstance(eng, Engine):
            _checked(eng)
        while eng.scheduler.has_work:
            eng.step()
        eng.drain()
        assert not eng._spilled
        outs.append(([eng.results[r] for r in rids], victim,
                      dict(eng.pool.spill_events), eng.counters["preemptions"],
                      eng.counters["dispatches"]))
    assert outs[0] == outs[1]
    assert outs[1][0] == [want[r] for r in sorted(want)]
    assert outs[1][2]["spills"] == outs[1][2]["restores"] == 1
    _checked(eng)


def test_priority_preemption_matches_jax(models):
    """A high-priority arrival preempts a running low-priority slot under
    ``policy="priority"``; the victim resumes later: tokens, preemptions
    and spill events equal JAX's, every request its full budget, and the
    tracer records the spill and the restore."""
    from repro_torch.obs import Observability
    prompts = models["granite-3-2b"][-1]
    outs = []
    for eng in _engines(models["granite-3-2b"], policy="priority"):
        lo = [eng.submit(p, 6, priority=0) for p in prompts[:2]]
        eng.step()
        eng.step()
        hi = eng.submit(prompts[2], 6, priority=5)
        while eng.scheduler.has_work:
            eng.step()
        eng.drain()
        outs.append(([eng.results[r] for r in lo + [hi]],
                     eng.counters["preemptions"],
                     dict(eng.pool.spill_events)))
    assert outs[0] == outs[1]
    assert outs[1][1] >= 1 and all(len(t) == 6 for t in outs[1][0])
    obs = Observability()
    eng = Engine(*models["granite-3-2b"][2:4], policy="priority", obs=obs,
                 **KW)
    for p in prompts[:2]:
        eng.submit(p, 6)
    eng.step()
    eng.step()
    eng.submit(prompts[2], 6, priority=5)
    eng.run()
    assert obs.tracer.summary()["n_preemptions"] >= 1
    fam = obs.registry.snapshot()["repro_preemptions_total"]
    got = {s["labels"]["event"]: s["value"] for s in fam["values"]}
    assert got["spills"] == got["restores"] >= 1


def test_plan_writes_exhaustion_spills_and_rebuilds_as_jax(models,
                                                          monkeypatch):
    """Running out of pages inside ``plan_writes`` (injected on the
    second dispatch) spills a victim and rebuilds the batch: tokens and
    counts equal JAX's, and the requests lose nothing."""
    prompts = models["granite-3-2b"][-1][:2]
    outs = []
    for eng in _engines(models["granite-3-2b"]):
        real = eng.pool.plan_writes
        calls = {"n": 0}
        exc = (jkv if isinstance(eng, JEngine) else kv_pool).PoolExhausted

        def flaky(n_valid, _real=real, _calls=calls, _exc=exc):
            _calls["n"] += 1
            if _calls["n"] == 2:
                raise _exc("injected")
            return _real(n_valid)

        monkeypatch.setattr(eng.pool, "plan_writes", flaky)
        out = eng.run([(p, 5) for p in prompts])
        outs.append((out, eng.counters["preemptions"],
                     eng.counters["dispatches"]))
    assert outs[0] == outs[1] and outs[1][1] == 1
    assert all(len(t) == 5 for t in outs[1][0].values())


def test_pool_pressure_spills_and_serves_as_jax(models):
    """A kv pool cut below what both slots' requests need at once (7
    pages short of a full ring a slot) under speculation (without it:
    ``test_pool_too_small_exhausts_as_jax``): the engine spills victims
    where pages run out (at admission and mid-plan; a speculative round
    that cannot fit aborts to a vanilla step) and serves every request:
    tokens, preemptions, spill events and spec counters equal JAX's,
    and the tokens an unpressured run's."""
    spec_k = 3
    prompts = models["granite-3-2b"][-1]
    reqs = [(p, 10) for p in prompts]
    want = Engine(*models["granite-3-2b"][2:4], **KW).run(list(reqs))
    outs = []
    for eng in _engines(models["granite-3-2b"], spec_k=spec_k,
                        spare_pages=-7, prefix_cache=False):
        got = eng.run(list(reqs))
        outs.append((got, eng.counters["preemptions"],
                     dict(eng.pool.spill_events),
                     eng.spec.report()))
        _checked(eng) if isinstance(eng, Engine) else None
    assert outs[0] == outs[1]
    assert outs[1][0] == want
    assert outs[1][1] > 0, "the pool never ran out of pages"


@pytest.mark.parametrize("spare,completes", [(-9, True), (-10, False)])
def test_pool_too_small_exhausts_as_jax(models, spare, completes):
    """The reference's limit under a tight pool, reproduced: with 9
    pages short the engines thrash (a restore takes back every page it
    spilled, FCFS puts the last victim at the queue's head) but finish
    with JAX's tokens and preemptions; with 10 short both end in
    ``PoolExhausted`` (the retry protects the slots admitted in the same
    step, and only those remain)."""
    reqs = [(p, 10) for p in models["granite-3-2b"][-1]]
    outs = []
    for eng in _engines(models["granite-3-2b"], spare_pages=spare,
                        prefix_cache=False):
        exc = (jkv if isinstance(eng, JEngine) else kv_pool).PoolExhausted
        if completes:
            outs.append((eng.run(list(reqs)), eng.counters["preemptions"]))
        else:
            with pytest.raises(exc):
                eng.run(list(reqs))
    if completes:
        assert outs[0] == outs[1] and outs[1][1] > 0


def test_layouts_without_preemption_refuse_it(models):
    """Only the paged layout spills: the slotted layout refuses a
    preemption, and a paged pool with no page to give and no victim to
    spill still raises ``PoolExhausted``."""
    cfg, params = models["granite-3-2b"][2:4]
    eng = Engine(cfg, params, layout="slotted", **KW)
    eng.submit(models["granite-3-2b"][-1][0], 3)
    eng.step()
    with pytest.raises(ValueError, match="layout='paged'"):
        eng._preempt(0)
    with pytest.raises(ValueError, match="layout='paged'"):
        Engine(cfg, params, layout="slotted", spec_k=2, **KW)
    with pytest.raises(ValueError, match="must be <= chunk"):
        Engine(cfg, params, spec_k=9, **KW)
    eng = Engine(cfg, params, spare_pages=0, prefix_cache=False, **KW)
    eng.pool.kv.free.clear()
    eng.submit(np.arange(5), 2)
    with pytest.raises(kv_pool.PoolExhausted):
        eng.step()


@pytest.mark.parametrize("arch", ["granite-3-2b", "rwkv6-3b"])
def test_spec_preemption_mid_round_matches_jax(models, arch):
    """A spill forced after a speculative round (rounds are atomic inside
    ``step``, so the spill reads committed state) and the restore: every
    request's tokens equal vanilla's and JAX's under the same sequence,
    with the same victim, spill counts and spec counters."""
    reqs = [(p, 12) for p in models[arch][-1][:3]]
    want = Engine(*models[arch][2:4], **KW).run(list(reqs))
    outs = []
    for eng in _engines(models[arch], spec_k=3):
        rids = [eng.submit(p, g) for p, g in reqs]
        for _ in range(30):
            eng.step()
            if eng.spec.counters["rounds"] >= 1:
                break
        victim = eng.policy.spill_victim(eng.scheduler.slots)
        assert victim is not None
        eng._preempt(victim)
        while eng.scheduler.has_work:
            eng.step()
        eng.drain()
        assert eng.counters["preemptions"] == 1
        assert eng.pool.spill_events["restores"] == 1
        outs.append(([eng.results[r] for r in rids], eng.spec.report(),
                     victim))
    assert outs[0] == outs[1]
    assert outs[1][0] == [want[r] for r in sorted(want)]


@pytest.mark.parametrize("arch", ["granite-3-2b"])
def test_spec_prefix_warm_matches_jax(models, arch):
    """Speculation from prefix-cache hits (shared pages): the first and
    the fully warm second pass give vanilla's tokens, JAX's, and JAX's
    prefix and spec counters (state snapshots under speculation: the
    smoke's ``reference spec`` runs a shared-prefix trace on rwkv6 and
    zamba2, card against CPU)."""
    cfg = models[arch][2]
    rng = np.random.default_rng(1)
    prefix = rng.integers(1, cfg.vocab_size, size=24).astype(np.int32)
    reqs = [(np.concatenate([prefix, rng.integers(1, cfg.vocab_size, 4)
                             ]).astype(np.int32), 6) for _ in range(3)]
    want = Engine(*models[arch][2:4], **KW).run(list(reqs))
    jeng, teng = _engines(models[arch], spec_k=3)
    for _ in range(2):
        got = teng.run(list(reqs))
        assert got == jeng.run(list(reqs))
        assert sorted(got.values()) == sorted(want.values())
    assert teng._prefix_counters() == jeng._prefix_counters()
    assert teng._prefix_counters()["prefix_hits"] > 0
    assert teng.spec.report() == jeng.spec.report()
    assert teng.spec.counters["rounds"] > 0


# -- the request API ------------------------------------------------------------

def test_stream_api_delivers_in_order(models):
    """``stream()`` yields what ``run`` returns; ``on_token`` fires in
    order with each request's tokens; ``run(stream_interval=2)`` flushes
    every second dispatch (callbacks fire mid-run); ``drain`` delivers
    the log of a hand-stepped engine; finished requests' callbacks are
    dropped."""
    cfg, params, prompts = *models["granite-3-2b"][2:4], \
        models["granite-3-2b"][-1]
    reqs = [(p, 6) for p in prompts[:3]]
    want = Engine(cfg, params, **KW).run(list(reqs))
    eng = Engine(cfg, params, spec_k=2, **KW)
    assert list(eng.stream(*reqs[0])) == want[0]
    seen, flushes = [], []
    eng2 = Engine(cfg, params, **KW)
    real = eng2._flush_tokens

    def counted():
        flushes.append(eng2.counters["dispatches"])
        real()
    eng2._flush_tokens = counted
    rids = [eng2.submit(p, g, on_token=lambda r, t: seen.append((r, t)))
            for p, g in reqs]
    eng2.run(stream_interval=2)
    assert all(d % 2 == 0 for d in flushes[:-1]) and len(flushes) > 2
    for r in rids:
        assert [t for rr, t in seen if rr == r] == want[r]
    assert not eng2._stream_cbs
    eng3 = Engine(cfg, params, **KW)
    got = []
    eng3.submit(*reqs[1], on_token=lambda r, t: got.append(t))
    while eng3.scheduler.has_work:
        eng3.step()
    assert got == []
    eng3.drain()
    assert got == want[1]
