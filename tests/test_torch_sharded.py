"""The port's page-sharded serving layout against the JAX package.

- ``gqa_paged_flash`` / ``mla_paged_flash`` in their shard-window,
  partial form (``lo``, ``n_local``, ``partial=True``; the plain
  versions on the CPU) against the Pallas kernels in interpret mode and
  ``ref.gqa_paged_ref`` / ``ref.mla_paged_ref``, window by window over 4
  windows of a global pool; ``merge_stacked`` of the 4 windows against
  the single-pass Pallas kernel;
- the ownership-aware ``BlockAllocator(n_shards=4)`` against JAX's on one
  scripted sequence;
- ``Engine(layout="paged-sharded")`` on 4 gloo ranks (one spawn for the
  whole matrix) against JAX's single-device paged engine over its five
  families, with the prefix cache on and off and with shared-prefix
  dedup, counting the collectives;
- the serve CLI's ``--layout paged-sharded``.

Tolerances: the partial statistics are float32 computations of one
softmax over at most 24 keys of magnitude ~1, in different summation
orders: rtol = atol = 1e-5.  The two sentinel conventions of the Pallas
kernel are exact: a window with no live page gives m = -1e30, l = 0,
acc = 0; a window whose live keys are all masked gives m = -1e30 and l
= the count of its live keys.  The reference oracle counts every row of
the ring view instead, so it is compared where m is a real score.
Tokens, tables and counters are integers: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.kernels import paged_attention as jpk
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import kv_pool as jkv
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.distributed import collectives
from repro_torch.kernels import paged_attention as tpk
from repro_torch.launch.mesh import run_ranks
from repro_torch.serving import Engine, kv_pool
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = ATOL = 1e-5
NEG = -1e30
N_WIN, N_LOCAL, PAGE = 4, 4, 4
FAMILIES = ("granite-3-2b", "deepseek-v2-236b", "rwkv6-3b", "zamba2-7b",
            "mixtral-8x7b")


# -- the partial forms against the Pallas kernels ---------------------------

def _window_case(seed, C=2):
    """A global pool of N_WIN x N_LOCAL pages of PAGE rows and a table of
    6 entries over 5 slots: slot 0 spans every window (and a null
    entry); slot 1 holds window 1's pages and, in window 0, one page
    whose tags lie past its query positions (its live keys all masked);
    slot 2 has no page in windows 0 and 1 (wholly foreign there); slot 3
    is idle; slot 4 shares slot 0's first page.  Tags follow each slot's
    blocks, a fifth of them unwritten (-1)."""
    rng = np.random.default_rng(seed)
    tbl = np.array([[1, 2, 0, 5, 9, 13], [4, 6, 7, 0, 0, 3],
                    [8, 10, 11, 12, 14, 15], [0] * 6, [1, 0, 0, 0, 0, 0]],
                   np.int32)
    pp = np.full((N_WIN * N_LOCAL, PAGE), -1, np.int32)
    for b in (0, 1, 2):
        for j, pg in enumerate(tbl[b]):
            if pg:
                tags = j * PAGE + np.arange(PAGE)
                pp[pg] = np.where(rng.random(PAGE) < 0.2, -1, tags)
    pp[1, 0] = 0                        # slot 4 sees position 0
    qpos = (np.array([22, 10, 22, 0, 2])[:, None]
            + np.arange(C)[None, :]).astype(np.int32)
    return rng, tbl, pp, qpos


def _local(a, i, scratch=False):
    """Window i's pages of a global pool (the port's local pool carries a
    trailing scratch page, garbage here)."""
    part = a[i * N_LOCAL:(i + 1) * N_LOCAL]
    if scratch:
        part = np.concatenate([part, np.full_like(part[:1], 7)])
    return part


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _same_stats(got, want, seen):
    """Port and Pallas statistics of one window: allclose, the sentinel
    m bit-equal with l (a count) exact under it; -> (m, l)."""
    m, l, acc = (np.asarray(t) for t in got)
    jm, jl, jacc = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(m == NEG, jm == NEG)
    sent = jm == NEG
    np.testing.assert_array_equal(l[sent], jl[sent])
    np.testing.assert_array_equal(m[sent], jm[sent])
    for a, b in ((m, jm), (l, jl), (acc, jacc)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert np.array_equal(~sent, seen)
    return m, l


@pytest.mark.parametrize("D,window", [(64, 0), (64, 6), (112, 6)])
def test_gqa_partial_windows_match_jax(D, window):
    """Each of 4 windows (``lo = i n_local``): the port's partial
    statistics equal the Pallas kernel's (interpret mode) and, where m is
    a real score, ``ref.gqa_paged_ref``'s; both sentinel conventions
    occur (no live page: slot 2 in windows 0-1, the idle slot; live keys
    all masked: slot 1 in window 0).  ``merge_stacked`` of the 4 equals
    the single-pass kernel on every row (the idle slot exact zeros), and
    so does the port's own single pass."""
    rng, tbl, pp, qpos = _window_case(D)
    B, C, hkv, G = tbl.shape[0], qpos.shape[1], 2, 2
    q = rng.normal(size=(B, C, hkv * G, D)).astype(np.float32)
    kp = rng.normal(size=(N_WIN * N_LOCAL, PAGE, hkv, D)).astype(np.float32)
    vp = rng.normal(size=kp.shape).astype(np.float32)
    parts = []
    kinds = set()
    for i in range(N_WIN):
        lo = i * N_LOCAL
        loc = [_local(a, i) for a in (kp, vp, pp)]
        win = dict(window=window, lo=lo, n_local=N_LOCAL, partial=True)
        want = jpk.gqa_paged_flash(*map(jnp.asarray, (q, *loc, tbl, qpos)),
                                   interpret=True, **win)
        got = tpk.gqa_paged_flash(*_t(q, *(_local(a, i, True)
                                           for a in (kp, vp, pp)),
                                      tbl, qpos), **win)
        oracle = jref.gqa_paged_ref(*map(jnp.asarray,
                                         (q, *loc, tbl, qpos)), **win)
        live = (tbl > 0) & (tbl >= lo) & (tbl < lo + N_LOCAL)
        m, l = _same_stats(got, want, np.asarray(want[0]) > NEG)
        real = m > NEG
        for a, b in zip(got, oracle):
            np.testing.assert_allclose(np.asarray(a)[real],
                                       np.asarray(b)[real], rtol=RTOL,
                                       atol=ATOL)
        for b in range(B):
            if not live[b].any():
                assert np.all(m[b] == NEG) and np.all(l[b] == 0)
                assert np.all(np.asarray(got[2])[b] == 0)
                kinds.add("no live page")
            elif np.all(m[b] == NEG):
                assert np.all(l[b] == live[b].sum() * PAGE)
                kinds.add("live keys all masked")
        parts.append(got)
    assert kinds == {"no live page", "live keys all masked"}
    merged = collectives.merge_stacked(*(torch.stack(t) for t in
                                         zip(*parts)))
    merged = merged.permute(0, 3, 1, 2, 4).reshape(B, C, hkv * G, D)
    single = jpk.gqa_paged_flash(*map(jnp.asarray, (q, kp, vp, pp, tbl,
                                                     qpos)),
                                 window=window, interpret=True)
    np.testing.assert_allclose(merged.numpy(), np.asarray(single),
                               rtol=RTOL, atol=ATOL)
    assert np.all(merged.numpy()[3] == 0.0)
    plain = tpk.gqa_paged_flash(*_t(q, kp, vp, pp, tbl, qpos),
                                window=window)
    np.testing.assert_allclose(plain.numpy(), np.asarray(single),
                               rtol=RTOL, atol=ATOL)


def test_mla_partial_windows_match_jax():
    """``mla_paged_flash``'s partial form over the same 4 windows: equal
    to the Pallas kernel (sentinels exact) and, where m is real, to
    ``ref.mla_paged_ref``; the 4 windows merged equal the single pass."""
    rng, tbl, pp, qpos = _window_case(5)
    B, C, h, kr, rd = tbl.shape[0], qpos.shape[1], 4, 16, 8
    q_lat = rng.normal(size=(B, C, h, kr)).astype(np.float32)
    q_pe = rng.normal(size=(B, C, h, rd)).astype(np.float32)
    ck = rng.normal(size=(N_WIN * N_LOCAL, PAGE, kr)).astype(np.float32)
    cpe = rng.normal(size=(N_WIN * N_LOCAL, PAGE, rd)).astype(np.float32)
    scale = 0.3
    parts = []
    for i in range(N_WIN):
        win = dict(scale=scale, lo=i * N_LOCAL, n_local=N_LOCAL,
                   partial=True)
        loc = [_local(a, i) for a in (ck, cpe, pp)]
        want = jpk.mla_paged_flash(*map(jnp.asarray, (q_lat, q_pe, *loc,
                                                      tbl, qpos)),
                                   interpret=True, **win)
        got = tpk.mla_paged_flash(*_t(q_lat, q_pe, *(_local(a, i, True)
                                                     for a in (ck, cpe, pp)),
                                      tbl, qpos), **win)
        oracle = jref.mla_paged_ref(*map(jnp.asarray, (q_lat, q_pe, *loc,
                                                       tbl, qpos)), **win)
        m, _ = _same_stats(got, want, np.asarray(want[0]) > NEG)
        for a, b in zip(got, oracle):
            np.testing.assert_allclose(np.asarray(a)[m > NEG],
                                       np.asarray(b)[m > NEG], rtol=RTOL,
                                       atol=ATOL)
        parts.append(got)
    merged = collectives.merge_stacked(*(torch.stack(t) for t in
                                         zip(*parts))).permute(0, 2, 1, 3)
    single = jpk.mla_paged_flash(*map(jnp.asarray, (q_lat, q_pe, ck, cpe,
                                                     pp, tbl, qpos)),
                                 scale=scale, interpret=True)
    np.testing.assert_allclose(merged.numpy(), np.asarray(single),
                               rtol=RTOL, atol=ATOL)


# -- the ownership-aware allocator ------------------------------------------

def test_sharded_allocator_matches_jax():
    """One scripted sequence on ``BlockAllocator(n_shards=4)`` in both
    packages: round-robin fresh pages, a shared page copied on write (its
    destination on the source's shard), ``prefer``, frees and a released
    slot.  Tables, free pages, ``shard_of``, ``in_use`` and ``hiwater``
    are equal after every step, and the invariants hold."""
    ja, ta = (mod.BlockAllocator(24, 3, 4, n_shards=4)
              for mod in (jkv, kv_pool))
    held = {}                         # pages allocated outside the tables

    def same():
        np.testing.assert_array_equal(ta.table, ja.table)
        assert ta.free == ja.free
        np.testing.assert_array_equal(ta.in_use, ja.in_use)
        np.testing.assert_array_equal(ta.hiwater, ja.hiwater)
        assert [ta.shard_of(p) for p in range(24)] == \
            [ja.shard_of(p) for p in range(24)]
        ta.check(held)
        ja.check(held)

    def both(name, *args, **kw):
        got = getattr(ta, name)(*args, **kw)
        assert got == getattr(ja, name)(*args, **kw)
        if name == "alloc":
            held[got] = 1
        same()
        return got

    both("write_plan", 0, [0, 1, 2])
    both("write_plan", 1, [0, 1])
    shared = int(ta.table[0, 1])
    for a in (ta, ja):
        a.share(2, 0, shared)
    same()
    fresh, copies = both("write_plan", 2, [0, 1])
    assert copies and ta.shard_of(copies[0][1]) == ta.shard_of(shared)
    for shard in (3, 3, 1, 0):
        both("alloc", prefer=shard)
    page = int(ta.table[1, 0])
    ta.table[1, 0] = ja.table[1, 0] = 0
    both("drop", page)
    both("release_slot", 0)
    both("write_plan", 0, [0, 1, 2, 3])
    assert (ta.hiwater > 0).sum() == 4


# -- the sharded engine on 4 gloo ranks -------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _trace(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size,
                          size=int(rng.integers(3, 18))).astype(np.int32),
             int(rng.integers(3, 7))) for _ in range(3)]


def _shared_trace(cfg):
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, size=24)
    return [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size,
                                                  size=4)]).astype(np.int32),
             4) for _ in range(3)]


def _matrix_rank(group, cases):
    """One rank of the matrix: each case's sharded engine run, its
    collectives counted from just after the engine is built to the end
    of its run (the flush included), and what a dispatch should issue:
    one merge per attention layer, one gather per state leaf."""
    out = {}
    for name, arch, tree, reqs, kw in cases:
        cfg = reduce_config(get_config(arch))
        params = convert.params_from_numpy(cfg, tree, device="cpu")
        eng = Engine(cfg, params, n_slots=2, max_len=64,
                     layout="paged-sharded", group=group, **kw)
        attn, leaves = [0], [0]

        def kv(node):
            attn[0] += (node["pos"] if "pos" in node else
                        node["c_kv"]).shape[0]
            return node

        def st(a):
            leaves[0] += 1
            return a

        for k, v in eng.cache.items():
            if k not in ("pos", "block_table", "state_table"):
                kv_pool.map_state_leaves(kv_pool.map_kv_nodes(v, kv), st)
        collectives.reset_counts()
        res = eng.run(list(reqs))
        rep = eng.report()
        out[name] = {"tokens": res, "counts": dict(collectives.counts),
                     "dispatches": rep["dispatches"],
                     "per_dispatch": {"flash_merge": attn[0],
                                      "state_take": leaves[0]},
                     "sharding": rep["sharding"],
                     "prefix": eng._prefix_counters()}
    return out


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """The port's sharded engine on 4 gloo ranks (one spawn, run in a
    thread) and, meanwhile, JAX's single-device paged engine on each
    case, on the same weights."""
    import threading
    cases, jax_runs = [], []
    for arch in FAMILIES:
        jcfg = jreduce_config(jget_config(arch))
        jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
        tree = _np(jparams)
        reqs = _trace(jcfg)
        cases.append((arch, arch, tree, reqs, {}))
        jax_runs.append((arch, jcfg, jparams, reqs, {}))
        if arch == "granite-3-2b":
            off, shared = _trace(jcfg, seed=1), _shared_trace(jcfg)
            cases += [("prefix_off", arch, tree, off,
                       {"prefix_cache": False}),
                      ("dedup", arch, tree, shared, {"chunk": 8}),
                      ("dedup_cold", arch, tree, shared,
                       {"chunk": 8, "prefix_cache": False})]
            jax_runs += [("prefix_off", jcfg, jparams, off,
                          {"prefix_cache": False}),
                         ("dedup", jcfg, jparams, shared, {"chunk": 8})]
    got = []
    ranks = threading.Thread(target=lambda: got.append(run_ranks(
        _matrix_rank, 4, "cpu", cases,
        workdir=str(tmp_path_factory.mktemp("ranks")))))
    ranks.start()
    want = {name: JEngine(jcfg, jparams, n_slots=2, max_len=64,
                          layout="paged", **kw).run(list(reqs))
            for name, jcfg, jparams, reqs, kw in jax_runs}
    ranks.join()
    assert got, "the ranks failed (their error is printed above)"
    return want, got[0]


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_engine_matches_jax_paged(matrix, arch):
    """Every rank's tokens equal JAX's single-device paged engine; pages
    spread over at least 2 of the 4 shards; the report names 4 shards."""
    want, got = matrix
    for rank in got:
        r = rank[arch]
        assert r["tokens"] == want[arch]
        sh = r["sharding"]
        assert sh["n_shards"] == 4 and sh["backend"] == "gloo"
        hw = (sh.get("kv_pages_hiwater_per_shard")
              or sh["state_pages_hiwater_per_shard"])
        assert sum(1 for n in hw if n > 0) >= 2, sh


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_merge_per_attention_layer_per_dispatch(matrix, arch):
    """Within the run's dispatches the ranks issue exactly one merge
    collective per attention layer and one gather per state leaf, and
    nothing else; the run's one flush adds the ranks' token check."""
    _, got = matrix
    for rank in got:
        r = rank[arch]
        want = {k: n * r["dispatches"] for k, n in r["per_dispatch"].items()
                if n}
        assert r["dispatches"] > 0 and want
        assert r["counts"] == dict(want, check_tokens=1)


def test_sharded_engine_prefix_off_and_dedup(matrix):
    """granite with the prefix cache off gives JAX's tokens; on the
    shared-prefix trace the sharded engine skips prefill chunks and
    gives both JAX's tokens and its own with the cache off."""
    want, got = matrix
    for rank in got:
        assert rank["prefix_off"]["tokens"] == want["prefix_off"]
        assert rank["dedup"]["tokens"] == want["dedup"] == \
            rank["dedup_cold"]["tokens"]
        assert rank["dedup"]["prefix"]["chunks_skipped"] > 0
        assert rank["dedup_cold"]["prefix"]["chunks_skipped"] == 0


def test_serve_cli_paged_sharded_on_cpu(capfd):
    """``launch.serve --layout paged-sharded --shards 2`` on the CPU:
    rank 0 calibrates (kernel mode) and hands its tree to rank 1, the
    dense baseline agrees, and the page mesh line prints the per-shard
    high-water mark."""
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--device", "cpu", "--layout",
                      "paged-sharded", "--shards", "2", "--batch", "2",
                      "--requests", "3", "--prompt-min", "3",
                      "--prompt-max", "12", "--gen-len", "3",
                      "--shared-prefix", "8", "--mor", "kernel",
                      "--compare"])
    assert rep["requests_finished"] == 3
    assert rep["sharding"]["n_shards"] == 2
    assert all(n > 0 for n in rep["sharding"]["kv_pages_hiwater_per_shard"])
    out = capfd.readouterr().out
    assert "page mesh: 2 shards (gloo), kv pages hiwater/shard" in out


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-236b",
                                  "rwkv6-3b", "zamba2-7b"])
def test_fold_permutations_gives_the_calibrated_weights(arch):
    """What a rank that did not calibrate does with rank 0's tree:
    ``deploy.fold_permutations`` of the calibrated tree into the fresh
    weights equals the weights the family's calibration returned, bit
    for bit (the FFN stacks, a MoE layer's experts, the hybrid's shared
    MLP, RWKV's channel mix)."""
    from repro_torch.core import deploy
    from repro_torch.launch.serve import calibrate
    from repro_torch.models import get_model
    cfg = reduce_config(get_config(arch))
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    calibrated, mor, _ = calibrate(params, cfg, api, "cpu", 2)
    folded = deploy.fold_permutations(params, mor)

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield path, tree

    got, want = dict(leaves(folded)), dict(leaves(calibrated))
    assert got.keys() == want.keys()
    moved = [p for p in want if not torch.equal(want[p], dict(
        leaves(params))[p])]
    assert moved, "the calibration permuted nothing"
    for p in want:
        assert torch.equal(got[p], want[p]), p
