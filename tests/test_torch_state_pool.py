"""The state half of the port's serving caches against the JAX package:
the slot pool's tree walkers, ``PagedPool``'s state pages, state tables
and prefix-cache state snapshots, and ``Engine`` on reduced rwkv6-3b
(state only) and zamba2-7b (mamba state + the shared attention's paged
ring), paged with prefix caching and slotted, in dense / tiled / kernel
mode.

Weights come from the JAX ``init`` and calibration and pass to the port
as numpy; the MoR layer's odd column tiles are made statically dead so
that tiled and kernel mode really skip.  Everything compared here is
integer (tokens, tables, refcounts, counters, page ids) or a tile
fraction computed from integers: it must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core.deploy import calibrate_hybrid as jcalibrate_hybrid
from repro.core.deploy import calibrate_lm as jcalibrate_lm
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import kv_pool as jkv
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import pipeline as tpipe
from repro_torch.serving import Engine, kv_pool
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.scheduler import Request, Scheduler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RECURRENT = ("rwkv6-3b", "zamba2-7b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch, **replace):
    return (jreduce_config(jget_config(arch)).replace(**replace),
            reduce_config(get_config(arch)).replace(**replace))


# -- the prefix cache's state snapshots ---------------------------------------

def test_state_snapshot_match_is_longest_and_exact():
    """(``tests/test_paged_pool.py``'s case on the port's copy.)"""
    pc = PrefixCache(4)
    base = np.arange(24, dtype=np.int32)
    pc.insert_state(base, 8, spage=3, kv_pages=[1, 2])
    pc.insert_state(base, 16, spage=4, kv_pages=[1, 2, 5, 6])
    hit = pc.match_state(base, limit=23)
    assert hit is not None and hit.n_tokens == 16 and hit.spage == 4
    assert pc.match_state(base, limit=12).n_tokens == 8
    # a diverging prompt must not match deeper than the divergence
    other = base.copy()
    other[10] = 99
    assert pc.match_state(other, limit=23).n_tokens == 8
    other[3] = 99
    assert pc.match_state(other, limit=23) is None
    # LRU eviction returns entries for the caller to unref
    e = pc.evict_lru_snap()
    assert e is not None and pc.evict_lru_snap() is not None
    assert pc.evict_lru_snap() is None


def test_admit_rollback_on_state_exhaustion_leaks_nothing():
    """(``tests/test_paged_pool.py``'s case on the port's pool.)  State
    pool exhaustion mid-``admit`` rolls back the shared prefix kv pages
    and the snapshot pin and raises ``PoolExhausted``, leaving every
    refcount as it was."""
    _, cfg = _cfgs("zamba2-7b", serve_chunk=8)
    pool = kv_pool.PagedPool(cfg, 2, 64, chunk=8, device="cpu")
    pool.build()
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, cfg.vocab_size, size=17).astype(np.int32)
    assert pool.admit(0, prompt) == 0
    pool.kv.write_plan(0, [0, 1, 2], alloc=pool._kv_alloc)
    pool.advance(np.array([17, 0]))
    pool.maybe_snapshot(0, prompt, 16)
    assert pool.counters["snapshots"] == 1
    pool.release(0)
    snap = pool.prefix.match_state(prompt, len(prompt))
    assert snap is not None and snap.kv_pages
    pool.st.retain(snap.spage)
    held = []
    while (p := pool._st_alloc()) is not None:
        held.append(p)
    ext = {**{p: 1 for p in held}, snap.spage: 1}
    kv_refs_before = pool.kv.ref.copy()
    st_refs_before = pool.st.ref.copy()
    with pytest.raises(kv_pool.PoolExhausted):
        pool.admit(1, np.concatenate([prompt, prompt[:4]]))
    assert not pool.kv.table[1].any(), "rollback left shared pages mapped"
    np.testing.assert_array_equal(pool.kv.ref, kv_refs_before)
    np.testing.assert_array_equal(pool.st.ref, st_refs_before)
    pool.kv.check(pool.external_refs("kv"))
    st_ext = pool.external_refs("state")
    for p, n in ext.items():
        st_ext[p] = st_ext.get(p, 0) + n
    pool.st.check(st_ext)


# -- the slot pool and the paged pool's layout ---------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_slotted_init_and_reset_match_jax(arch):
    """The slot pool's tree (state leaves, the hybrid's ring with per-slot
    tags, slot dim at axis 1) equals JAX's leaf for leaf, and
    ``reset_slots`` zeroes state / sets -1 tags on the recycled slots
    only."""
    jcfg, cfg = _cfgs(arch)
    jcache = jkv.init(jcfg, 3, 24, 8)
    cache = kv_pool.init(cfg, 3, 24, 8, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    tflat = jax.tree_util.tree_flatten_with_path(cache)[0]
    assert [p for p, _ in tflat] == [p for p, _ in jflat]
    for (_, t), (_, j) in zip(tflat, jflat):
        assert tuple(t.shape) == j.shape and str(t.dtype).endswith(
            str(j.dtype))
    jcache = jax.tree_util.tree_map(lambda a: jnp.full_like(a, 7), jcache)
    for _, t in tflat:
        t.fill_(7)
    slots = np.array([True, False, True])
    want = jkv.reset_slots(jcache, jnp.asarray(slots))
    got = kv_pool.reset_slots(cache, torch.as_tensor(slots))
    for (_, t), (_, j) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                              jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_paged_build_layout():
    """The paged cache: rwkv's state leaves become (L, n_state_pages,
    ...) pools behind a state table and no kv tables; zamba2 holds both,
    its shared attention's ring (window 16 + chunk 8 = 24 rows = 3
    pages) as (n_seg, n_pages + 1, page, ...) pools; the state pages
    equal JAX's count (1 null + 2 a slot + one snapshot a slot)."""
    for arch in RECURRENT:
        jcfg, cfg = _cfgs(arch)
        jpool = jkv.PagedPool(jcfg, 3, 40, chunk=8, page=8)
        pool = kv_pool.PagedPool(cfg, 3, 40, chunk=8, page=8, device="cpu")
        assert (pool.has_kv, pool.has_state) == (jpool.has_kv,
                                                 jpool.has_state)
        assert (pool.n_blocks, pool.ring, pool.n_pages, pool.n_spages) == \
            (jpool.n_blocks, jpool.ring, jpool.n_pages, jpool.n_spages)
        np.testing.assert_array_equal(pool.st.table, jpool.st.table)
        cache = pool.build()
        assert cache["state_table"].tolist() == [1, 2, 3]
        assert pool.n_spages == 1 + 2 * 3 + 3
        if arch == "rwkv6-3b":
            assert "block_table" not in cache and not pool.has_kv
            assert cache["wkv"].shape == (cfg.n_layers, pool.n_spages, 8,
                                          16, 16)
            assert cache["wkv"].dtype == torch.float32
        else:
            assert pool.ring == 24 and pool.n_blocks == 3
            sa = cache["shared_attn"]
            assert sa["k"].shape == (2, pool.n_pages + 1, 8, 4, 32)
            assert sa["pos"].shape == (2, pool.n_pages + 1, 8)
            assert cache["mamba"]["ssm"].shape[:2] == (4, pool.n_spages)
            assert cache["tail"]["conv"].shape[:2] == (1, pool.n_spages)


def test_state_copies_and_resets_on_the_device_cache():
    """``apply_cache_ops`` on rwkv's paged cache: a snapshot copies a
    slot's state page to a fresh page, a later admission restores it
    into the next request's fresh page, and a freshly allocated page is
    zeroed, on every state leaf; all in one packed vector per flush."""
    _, cfg = _cfgs("rwkv6-3b")
    pool = kv_pool.PagedPool(cfg, 2, 40, chunk=8, page=8, device="cpu")
    cache = pool.build()
    prompt = np.arange(20, dtype=np.int32)
    assert pool.admit(0, prompt) == 0
    pool.flush(cache)
    page0 = int(pool.st.table[0, 0])
    for k in ("tm_shift", "wkv", "cm_shift"):
        cache[k][:, page0] = 3.0
    pool.advance(np.array([16, 0]))
    pool.maybe_snapshot(0, prompt, 16)
    ops, n_reset, n_copy, n_st_reset, n_st_copy = pool.drain()
    assert (n_reset, n_copy, n_st_reset, n_st_copy) == (0, 0, 1, 1)
    kv_pool.apply_cache_ops(cache, torch.as_tensor(ops), n_reset, n_copy,
                            n_st_reset, n_st_copy)
    snap = pool.prefix.match_state(prompt, 19)
    assert snap is not None and snap.n_tokens == 16
    for k in ("tm_shift", "wkv", "cm_shift"):
        assert bool((cache[k][:, snap.spage] == 3.0).all())
    # a second request with the same prefix restores the snapshot
    assert pool.admit(1, prompt) == 16
    assert pool.counters["snap_restores"] == 1
    pool.flush(cache)
    page1 = int(pool.st.table[1, 0])
    assert page1 not in (page0, snap.spage)
    assert cache["state_table"].tolist() == [page0, page1]
    for k in ("tm_shift", "wkv", "cm_shift"):
        assert bool((cache[k][:, page1] == 3.0).all())
    pool.st.check(pool.external_refs("state"))


def test_state_pool_matches_jax():
    """One seeded request stream through the port's scheduler drives both
    zamba2 pools (admit, snapshot, pre-wrap publish, plan_writes, drain,
    advance, release) with small spare budgets, so that snapshots and kv
    pages are evicted: kv and state tables, refcounts, free lists,
    counters and the drained edits are equal after every call."""
    jcfg, cfg = _cfgs("zamba2-7b")
    kw = dict(chunk=8, page=4, spare_pages=4, snap_slots=0)
    jpool = jkv.PagedPool(jcfg, 3, 40, **kw)
    tpool = kv_pool.PagedPool(cfg, 3, 40, device="cpu", **kw)
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, 50, size=12) for _ in range(2)]
    sched = Scheduler(3, 8)
    prompts = []
    for rid in range(14):
        head = prefixes[rid % 2][:int(rng.integers(4, 13))]
        tail = rng.integers(0, 50, size=int(rng.integers(6, 30)))
        prompts.append(np.concatenate([head, tail]).astype(np.int32))
        if rid % 3 == 2:                 # a repeat: its snapshot hits
            prompts[-1] = prompts[rid - 2].copy()
        sched.add(Request(rid, prompts[-1], int(rng.integers(1, 6))))

    def place(s, entry):
        off = jpool.admit(s, entry.req.prompt)
        assert tpool.admit(s, entry.req.prompt) == off
        return off

    def same_state():
        for name in ("kv", "st"):
            t, j = getattr(tpool, name), getattr(jpool, name)
            np.testing.assert_array_equal(t.table, j.table)
            np.testing.assert_array_equal(t.ref, j.ref)
            assert t.free == j.free
        assert tpool.counters == jpool.counters
        np.testing.assert_array_equal(tpool.pos, jpool.pos)
        tpool.kv.check(tpool.external_refs("kv"))
        tpool.st.check(tpool.external_refs("state"))

    def split(flags_pads, n_pages, n_copy_pad):
        flags = flags_pads[:n_pages]
        src, dst = np.split(flags_pads[n_pages:n_pages + 2 * n_copy_pad], 2)
        real = dst < n_pages
        return (list(np.nonzero(flags)[0]), list(src[real]),
                list(dst[real]))

    while sched.has_work:
        sched.admit(place)
        same_state()
        kind = sched.peek_kind()
        tokens, n_valid, _, _, finishing, prefilling = sched.build_batch(
            kind)
        for pool in (jpool, tpool):
            for s, off in finishing:
                pool.maybe_snapshot(s, sched.slots[s].req.prompt, off)
            for s, off, take in prefilling:
                pool.maybe_publish_prewrap(s, sched.slots[s].req.prompt,
                                           off, take)
            pool.plan_writes(n_valid)
        same_state()
        _, jops = jpool.drain(None)
        got = tpool.drain()
        assert (jops is None) == (got is None)
        if got is not None:
            ops, n_reset, n_copy, n_st_reset, n_st_copy = got
            jops = np.asarray(jops)
            S, NB, NP, NS = 3, jpool.n_blocks, jpool.n_pages, jpool.n_spages
            head = S + S * NB + S
            np.testing.assert_array_equal(ops[:head], jops[:head])
            kv_pad, st_pad = jpool.last_pads
            jkv_ops = split(jops[head:head + NP + 2 * kv_pad], NP, kv_pad)
            jst_ops = split(jops[head + NP + 2 * kv_pad:], NS, st_pad)
            i = head
            tkv = (list(ops[i:i + n_reset]),
                   list(ops[i + n_reset:i + n_reset + n_copy]),
                   list(ops[i + n_reset + n_copy:i + n_reset + 2 * n_copy]))
            i += n_reset + 2 * n_copy
            tst = (list(ops[i:i + n_st_reset]),
                   list(ops[i + n_st_reset:i + n_st_reset + n_st_copy]),
                   list(ops[i + n_st_reset + n_st_copy:]))
            assert tkv == jkv_ops and tst == jst_ops
        same_state()
        jpool.advance(n_valid)
        tpool.advance(n_valid)
        finished, _ = sched.feed(n_valid)
        for s, _ in finished:
            jpool.release(s)
            tpool.release(s)
        same_state()
    c = tpool.counters
    assert c["snapshots"] and c["snap_restores"] and c["pages_evicted"]
    assert tpool.alloc_events() == jpool.alloc_events()


# -- the engine against JAX's --------------------------------------------------

TRACE = ((3, 4), (9, 3), (8, 4))    # (unique prompt tokens, new tokens)


def _calibrated(arch):
    jcfg, cfg = _cfgs(arch)
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    bs = [{"tokens": jnp.asarray(tpipe.make_batch(cfg, 2, 32, seed=0,
                                                  step=i)["tokens"])}
          for i in range(2)]
    cal = jcalibrate_hybrid if cfg.family == "hybrid" else jcalibrate_lm
    jparams, jmor, _ = cal(jparams, jcfg, jget_model(jcfg).forward,
                           iter(bs), 2)
    (group, layer), = _np(jmor).items()
    layer = {k: np.array(v) for k, v in layer.items()}
    dead = (np.arange(layer["m"].shape[-1]) // 128) % 2 == 1
    layer["bn_bias"] = np.where(dead, -1e3, layer["bn_bias"]).astype(
        np.float32)
    layer["enable"] = layer["enable"] | dead
    layer["is_proxy"] = layer["is_proxy"] & ~dead
    layer["proxy_slot"] = np.where(dead, -1, layer["proxy_slot"]).astype(
        np.int32)
    jmor = {group: {k: jnp.asarray(v) for k, v in layer.items()}}
    tmor = convert.mor_from_numpy({group: layer}, device="cpu")
    params = convert.params_from_numpy(cfg, _np(jparams), device="cpu")
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, cfg.vocab_size, 16)
    reqs = [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)]
                            ).astype(np.int32), g) for n, g in TRACE]
    reqs.append((reqs[1][0].copy(), 3))
    return jcfg, jparams, jmor, cfg, params, tmor, reqs


@pytest.fixture(scope="module")
def models():
    return {arch: _calibrated(arch) for arch in RECURRENT}


@pytest.mark.parametrize("mode", ["dense", "tiled", "kernel"])
@pytest.mark.parametrize("layout", ["paged", "slotted"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_engine_matches_jax(models, arch, layout, mode):
    """Greedy tokens on one ragged trace (a 16-token shared prefix, one
    prompt repeated) and the dispatch count equal JAX's engine; paged:
    the prefix counters too (state snapshots taken and restored, and for
    zamba2 its shared attention's pages shared and copied on write);
    tiled / kernel: the per-application tile fractions (zamba2's shared
    MLP stats n_seg-stacked)."""
    jcfg, jparams, jmor, cfg, params, tmor, reqs = models[arch]
    kw = dict(n_slots=2, max_len=48, mor_mode=mode, layout=layout)
    mor = (jmor, tmor) if mode != "dense" else (None, None)
    jeng = JEngine(jcfg, jparams, mor=mor[0], **kw)
    want = jeng.run(list(reqs))
    teng = Engine(cfg, params, mor=mor[1], **kw)
    assert teng.run(list(reqs)) == want
    assert teng.counters["dispatches"] == jeng.counters["dispatches"]
    if layout == "paged":
        pc = teng._prefix_counters()
        assert pc == jeng._prefix_counters()
        assert pc["snapshots"] > 0 and pc["snap_restores"] > 0
        assert pc["chunks_skipped"] > 0
        if arch == "zamba2-7b":
            assert pc["pages_shared"] > 0
    if mode != "dense":
        jtel, ttel = jeng.telemetry.summary(), teng.telemetry.summary()
        for name in ("frac_tiles_live", "frac_tiles_computed"):
            np.testing.assert_array_equal(ttel["mor_stats"][name],
                                          jtel["mor_stats"][name])
        assert len(ttel["mor_stats"]["frac_tiles_computed"]) == 2
        assert max(ttel["mor_stats"]["frac_tiles_computed"]) < 1.0


def test_recurrent_hot_loop_reads_nothing_back_before_the_flush(
        models, monkeypatch):
    """The paged zamba2 engine in kernel mode (state tables, snapshots,
    the shared attention's pages) moves no tensor to the host before
    ``run``'s flush."""
    _, _, _, cfg, params, tmor, reqs = models["zamba2-7b"]
    eng = Engine(cfg, params, mor=tmor, mor_mode="kernel", n_slots=2,
                 max_len=48)
    for p, g in reqs:
        eng.submit(p, g)
    calls = []
    for name in ("item", "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    while eng.scheduler.has_work:
        eng.step()
    assert calls == []
    monkeypatch.undo()
    eng._flush_tokens()
    assert eng.pool.counters["snapshots"] > 0
    assert sorted(len(v) for v in eng.results.values()) == \
        sorted(g for _, g in reqs)


@pytest.mark.parametrize("arch", RECURRENT)
def test_serve_cli_recurrent_on_cpu(arch):
    """``launch.serve --reduced --arch rwkv6-3b|zamba2-7b --mor kernel``
    calibrates with ``calibrate_lm`` / ``calibrate_hybrid``, serves a
    shared-prefix trace on the paged pool (state snapshots hit) and
    reports its agreement with dense."""
    from repro_torch.launch import serve
    rep = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--requests", "3", "--prompt-min",
                      "3", "--prompt-max", "12", "--gen-len", "3",
                      "--shared-prefix", "8", "--mor", "kernel",
                      "--compare"])
    assert rep["requests_finished"] == 3
    assert rep["prefix_cache"]["snap_restores"] > 0
    assert 0.0 <= rep["token_agreement_vs_dense"] <= 1.0


def test_remaining_refusals_name_current_roadmap_items():
    """Preemption and speculation are served for the recurrent families:
    a zamba2 pool spills a slot and restores it (state page and kv pages
    back, refcounts consistent) and forks a speculative round (a backup
    state page pinned until the fork is aborted).  What remains refused
    is the reference's own limit, a spill of a page-sharded pool; that
    pool holds its half of the state pages and a scratch page."""
    _, cfg = _cfgs("zamba2-7b")
    shard = kv_pool.PagedPool(cfg, 2, 32, n_shards=2, shard=1, device="cpu")
    assert shard.local_pages()[1] == shard.n_spages // 2 + 1
    with pytest.raises(ValueError, match="one device"):
        shard.spill(0, None)
    pool = kv_pool.PagedPool(cfg, 2, 32, device="cpu")
    cache = pool.build()
    pool.admit(0, np.arange(1, 12, dtype=np.int32))
    pool.plan_writes(np.array([11, 0]))
    pool.flush(cache)
    pool.advance(np.array([11, 0]))
    rec = pool.spill(0, cache)
    assert rec.pos == 11 and rec.st_host and rec.nbytes > 0
    pool.restore(1, rec, cache)
    assert pool.pos[1] == 11 and pool.spill_events["restores"] == 1
    fork = pool.spec_fork(1)
    assert fork.st_backup and pool.st.ref[fork.st_backup] == 1
    pool.spec_abort(fork)
    assert fork.st_backup == 0 and pool.pos[1] == 11
    pool.flush(cache)
    pool.kv.check(pool.external_refs("kv"))
    pool.st.check(pool.external_refs("state"))


def test_recurrent_warm_prefix_pass_repeats_the_first_as_jax_does():
    """A second pass of a shared-prefix trace over the warm prefix cache
    (state snapshots restored, prefix chunks skipped, the rest chunked
    from the snapshot's offset: chunk 16 over pages of 4) against the
    first pass, on reduced float32 rwkv6-3b in both packages on the same
    weights: each package's first and warm tokens equal the other's, and
    in float32 the warm pass repeats the first exactly in both."""
    jcfg, cfg = _cfgs("rwkv6-3b")
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(cfg, _np(jparams), device="cpu")
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab_size, 24)
    reqs = [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)]
                            ).astype(np.int32), 8) for n in (3, 9, 14, 5)]
    kw = dict(n_slots=2, max_len=64, chunk=16, page=4)
    passes = {}
    for name, eng in (("jax", JEngine(jcfg, jparams, **kw)),
                      ("torch", Engine(cfg, params, **kw))):
        runs = []
        for _ in range(2):
            out = eng.run(list(reqs))
            runs.append([out[k] for k in sorted(out)])
        assert eng._prefix_counters()["snap_restores"] > 0
        passes[name] = runs
    assert passes["torch"] == passes["jax"]
    first, warm = passes["torch"]
    assert warm == first
