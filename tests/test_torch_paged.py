"""The port's paged serving slice against the JAX package: the
``gqa_paged_flash`` plain version against the Pallas kernel (interpret
mode) and ``ref.gqa_paged_ref``, the ``PagedPool`` host state against
JAX's under one seeded operation sequence, and ``Engine(layout="paged")``
against JAX's on reduced granite-3-2b.

The engine runs a sliding window of 16 (a ring of 24 rows = 3 pages):
prompts longer than the ring wrap it back over blocks they share with
the prefix cache, which is what makes the pool copy on write.  Without
a window no slot ever writes a shared page again (JAX admission shares
only the full pages below the last prompt token), so neither engine
copies on write.

Tolerances: the kernel's plain version and the JAX oracles are float32
computations of one softmax in different summation orders over at most
48 keys of magnitude ~1: rtol = atol = 1e-5.  They are compared on the
query rows that see at least one key; a row that sees none is defined
differently by the Pallas kernel (exp(0) weights over the live pages)
and the dense oracle (over the whole ring view).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core.deploy import calibrate_lm as jcalibrate_lm
from repro.kernels import paged_attention as jpk
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import kv_pool as jkv
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import paged_attention as tpk
from repro_torch.models import get_model
from repro_torch.serving import Engine, kv_pool
from repro_torch.serving.scheduler import Request, Scheduler
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "granite-3-2b"
WINDOW = 16
RTOL = ATOL = 1e-5


# -- the kernel's plain version against the Pallas kernel and the oracle ----

def _paged_case(seed, B, C, n_blocks, page, hkv, G, D, window, extra_cols):
    """Random pools and a table with null entries, a page shared by
    slots 0 and 1, and slot B-1 entirely null.  ``extra_cols`` > 0 makes
    the table a column slice of a wider one (a strided view)."""
    rng = np.random.default_rng(seed)
    n_pages = 2 * B * n_blocks + 1
    ring = n_blocks * page
    q = rng.normal(size=(B, C, hkv * G, D)).astype(np.float32)
    kp = rng.normal(size=(n_pages, page, hkv, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, hkv, D)).astype(np.float32)
    pp = rng.integers(-1, ring, size=(n_pages, page)).astype(np.int32)
    pp[0] = -1                                   # the null page
    wide = rng.integers(0, n_pages, size=(B, n_blocks + extra_cols))
    wide[:, :n_blocks][rng.random((B, n_blocks)) < 0.25] = 0
    wide[1, 0] = wide[0, n_blocks - 1] = n_pages - 1     # a shared page
    wide[B - 1] = 0                              # an idle slot
    wide = wide.astype(np.int32)
    qpos = (ring // 2 + rng.integers(0, ring // 2, size=(B, 1))
            + np.arange(C)[None, :]).astype(np.int32)
    return q, kp, vp, pp, wide, qpos


def _seen(pp, tbl, qpos, window):
    """(B, C) bool: the query row sees at least one key."""
    tags = np.where((tbl > 0)[..., None], pp[tbl], -1).reshape(
        tbl.shape[0], -1)
    rel = qpos[:, :, None] - tags[:, None, :]
    ok = (tags[:, None, :] >= 0) & (rel >= 0)
    if window:
        ok &= rel < window
    return ok.any(-1)


CASES = {   # B, C, n_blocks, page, hkv, G, D, window, extra_cols
    "decode": (3, 1, 4, 4, 2, 2, 8, 0, 0),
    "mixed": (3, 5, 4, 4, 2, 2, 8, 0, 0),
    "window": (3, 3, 5, 4, 2, 3, 16, 7, 0),
    "sliced": (4, 2, 3, 8, 1, 4, 8, 0, 3),
    "gqa8": (2, 4, 6, 8, 4, 1, 32, 11, 2),
    "mqa": (3, 2, 4, 8, 1, 12, 32, 0, 2),        # granite-20b's hkv 1
    "d96": (3, 3, 4, 4, 2, 2, 96, 9, 0),         # phi-3's head dim
    "d112": (3, 2, 4, 8, 2, 1, 112, 9, 0),       # zamba2-7b's, G 1
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_gqa_paged_flash_matches_jax(case):
    B, C, n_blocks, page, hkv, G, D, window, extra = CASES[case]
    q, kp, vp, pp, wide, qpos = _paged_case(len(case), B, C, n_blocks, page,
                                            hkv, G, D, window, extra)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, pp, wide[:, :n_blocks],
                                      qpos)]
    want_k = np.asarray(jpk.gqa_paged_flash(*jargs, window=window,
                                            interpret=True))
    want_r = np.asarray(jref.gqa_paged_ref(*jargs, window=window))
    twide = torch.from_numpy(wide)
    tbl = twide[:, :n_blocks]
    assert tbl.is_contiguous() == (extra == 0)
    got = tpk.gqa_paged_flash(*(torch.from_numpy(a) for a in (q, kp, vp,
                                                               pp)),
                              tbl, torch.from_numpy(qpos), window=window)
    assert got.shape == (B, C, hkv * G, D) and got.dtype == torch.float32
    seen = _seen(pp, wide[:, :n_blocks], qpos, window)
    assert seen[:-1].any() and not seen[-1].any()
    got = got.numpy()
    np.testing.assert_allclose(got[seen], want_k[seen], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got[seen], want_r[seen], rtol=RTOL,
                               atol=ATOL)
    # the idle slot (all-null table) gives exact zeros, like the kernel
    assert np.all(got[-1] == 0.0) and np.all(want_k[-1] == 0.0)


# -- the bf16 kernel's context split: its plan and its merge ----------------

def _gqa_plan_cases():
    """(B, C, H, hkv, W, page, sms): ``chip_smoke.py``'s decode, mixed,
    window and split-edge dispatches, granite's served decode and chunk,
    tables narrower than a split, pages wider than a K tile, then a
    seeded sweep."""
    cases = [(8, 1, 32, 8, 512, 8, 132), (8, 32, 32, 8, 12, 8, 132),
             (4, 4, 32, 8, 16, 8, 132), (8, 1, 32, 8, 96, 8, 132),
             (8, 1, 32, 8, 24, 8, 132), (8, 32, 32, 8, 24, 8, 132),
             (1, 1, 32, 8, 3, 64, 132), (2, 1, 16, 2, 2, 128, 132),
             (1, 1, 8, 8, 1, 8, 132), (4, 1, 4, 2, 40, 16, 78)]
    rng = np.random.default_rng(19)
    for _ in range(10):
        hkv = int(rng.choice([1, 2, 8]))
        cases.append((int(rng.integers(1, 17)), int(rng.integers(1, 65)),
                      hkv * int(rng.choice([1, 4, 8])), hkv,
                      int(rng.integers(1, 700)), int(rng.choice([8, 16, 64])),
                      int(rng.choice([78, 114, 132]))))
    return cases


@pytest.mark.parametrize("B,C,H,hkv,W,page,sms", _gqa_plan_cases())
def test_gqa_plan_splits_the_table_in_whole_entries(B, C, H, hkv, W, page,
                                                    sms):
    """The split plan: 1 <= split <= 8 and <= W; the ranks' ranges, as
    the kernel computes them, tile [0, W) in rank order in whole table
    entries, none empty; a split only where the 64-pair tiles leave SMs
    idle, into no more blocks than seven eighths of one wave of
    ``gqa_resident(64)`` an SM, and leaving every rank at least two 64-key
    tiles of the table (the rule at head dim 64, the default)."""
    split = tpk.gqa_plan(B, C, H, hkv, W, page, sms=sms)
    assert 1 <= split <= 8 and split <= W
    ranges = tpk.split_ranges(W, split)
    assert len(ranges) == split and ranges[0][0] == 0 and ranges[-1][1] == W
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    tiles = B * hkv * -(-(C * (H // hkv)) // 64)
    if split > 1:
        assert tiles < sms
        assert tiles * split <= tpk.gqa_resident(64) * sms * 7 // 8
        assert 2 * split <= -(-(W * page) // 64)


def test_gqa_plan_at_the_main_path_shapes():
    """Granite (32 / 8 heads, head dim 64, pages of 8) on 132 SMs: the
    smoke's decode dispatch (8 slots x 1 row over 512 entries, 64 tiles)
    splits 7 ways (448 blocks: seven eighths of a wave of four an SM),
    its split-edge
    table of 96 entries (12 key tiles) 6 ways; the mixed dispatch (8 x 32
    rows, 128 tiles) over 512 entries 3 ways, over 12 entries and a
    served chunk over 24 entries not at all, nor does a served decode over 24 entries (3 key tiles:
    fewer than two a rank).  bf16 at head dims 64, 96, 112 and 128 takes
    the tensor cores; float32, and bf16 at head dim 32, the CUDA cores."""
    assert tpk.gqa_plan(8, 1, 32, 8, 512, 8, sms=132) == 7
    assert tpk.gqa_plan(8, 1, 32, 8, 96, 8, sms=132) == 6
    assert tpk.split_ranges(96, 6)[1] == (16, 32)
    assert tpk.gqa_plan(8, 32, 32, 8, 512, 8, sms=132) == 3
    assert tpk.gqa_plan(8, 32, 32, 8, 12, 8, sms=132) == 1
    assert tpk.gqa_plan(8, 32, 32, 8, 24, 8, sms=132) == 1
    assert tpk.gqa_plan(8, 1, 32, 8, 24, 8, sms=132) == 1
    assert tpk.gqa_body(torch.bfloat16, 64) == "tensor_cores"
    assert tpk.gqa_body(torch.float32, 64) == "cuda_cores"
    assert {tpk.gqa_body(torch.bfloat16, d) for d in (64, 96, 112, 128)} \
        == {"tensor_cores"}
    assert {tpk.gqa_body(torch.bfloat16, 32)} | \
        {tpk.gqa_body(torch.float32, d) for d in tpk.HEAD_DIMS} == \
        {"cuda_cores"}


# (arch, decode split, mixed split, long mixed split) of the bf16 kernel
# on 132 SMs at the zoo's head geometries: decode 8 slots x 1 row over
# tables of 512 entries (750 under a 4,096 window: contexts to 6,000),
# mixed 8 x 32 rows over 12 entries, and over the decode table (a long
# prompt's chunks), pages of 8
ZOO_PLANS = [("qwen2-7b", 8, 1, 4), ("granite-20b", 8, 1, 2),
             ("mixtral-8x7b", 7, 1, 4), ("phi-3-vision-4.2b", 2, 1, 2),
             ("zamba2-7b", 2, 1, 2)]


@pytest.mark.parametrize("arch,decode,mixed,mixed_long", ZOO_PLANS)
def test_gqa_plan_at_the_zoo_geometries(arch, decode, mixed, mixed_long):
    """The context split of the tensor-core body at each zoo geometry
    (``gqa_plan(..., D=)``), as written out in ``ZOO_PLANS``: qwen2-7b's
    32 pair tiles (G 7, D 128) and granite-20b's 8 (MQA: all 48 query
    heads in one 64-pair tile) split 8 ways, mixtral's 64 tiles 7 ways,
    phi-3's and zamba2's 256 (G 1) 2 ways, no mixed dispatch over 12
    entries (3 K tiles of 32 keys), and over the long table the seven
    eighths of a wave rounded to the nearest rank (qwen2's and mixtral's
    128 tiles 4 ways, granite-20b's 192 and G 1's 256 2 ways).  No plan exceeds one wave of
    ``gqa_resident(D)`` blocks an SM, which is 4 at every tensor-core
    head dim (as at D 64)."""
    cfg = get_config(arch)
    H, hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert tpk.gqa_body(torch.bfloat16, D) == "tensor_cores"
    assert tpk.gqa_resident(D) == tpk.gqa_resident(64) == 4
    assert tpk.gqa_tile_keys(D) * tpk.gqa_cols(D) == 4096
    long = 750 if cfg.sliding_window or cfg.shared_attn_window else 512
    for C, W, want in ((1, long, decode), (32, 12, mixed),
                       (32, long, mixed_long)):
        split = tpk.gqa_plan(8, C, H, hkv, W, 8, sms=132, D=D)
        assert split == want, (arch, C, split)
        tiles = 8 * hkv * -(-(C * (H // hkv)) // 64)
        assert tiles * split <= tpk.gqa_resident(D) * 132


@pytest.mark.parametrize("D", [96, 112])
def test_padded_columns_keep_the_real_head_dims_result(D):
    """The tensor-core body computes over ``gqa_cols(D)`` = 128 columns
    at D 96 and 112: q, K and V zero-padded from D to 128 columns, scored
    with the real D's scale D^-0.5 (here q times sqrt(128 / D), which
    turns the plain version's 128^-0.5 into D^-0.5), give the unpadded
    result on the D columns and exact zeros in the pad (the plain version
    in float32, with a window, a null entry and an idle slot)."""
    q, kp, vp, pp, tbl, qpos = (torch.from_numpy(a) for a in _paged_case(
        7, 3, 2, 4, 8, 2, 3, D, 6, 0))
    DC = tpk.gqa_cols(D)
    assert DC == 128
    pad = lambda t: torch.nn.functional.pad(t, (0, DC - D))
    got = tpk.gqa_paged_flash_plain(pad(q) * (DC / D) ** 0.5, pad(kp),
                                    pad(vp), pp, tbl, qpos, window=6)
    want = tpk.gqa_paged_flash_plain(q, kp, vp, pp, tbl, qpos, window=6)
    torch.testing.assert_close(got[..., :D], want, rtol=RTOL, atol=ATOL)
    assert bool(torch.all(got[..., D:] == 0))
    # the pad's scale is not the real one: 128^-0.5 gives another result
    other = tpk.gqa_paged_flash_plain(pad(q), pad(kp), pad(vp), pp, tbl,
                                      qpos, window=6)
    assert not torch.allclose(other[..., :D], want, rtol=RTOL, atol=ATOL)


def _gqa_merge(parts):
    """The kernel's merge of the ranks' (m, l, acc) in float32, in rank
    order: M = max m, w_q = exp(m_q - M), L = sum l_q w_q, o = sum acc_q
    w_q / max(L, 1e-30); JAX's (B, hkv, G, C, D) -> (B, C, H, D)."""
    m = np.stack([np.asarray(p[0], np.float32) for p in parts])
    M = m.max(0)
    num = np.zeros(np.asarray(parts[0][2]).shape, np.float32)
    den = np.zeros(M.shape, np.float32)
    for q, (_, lq, aq) in enumerate(parts):
        w = np.exp(m[q] - M).astype(np.float32)
        den = (np.asarray(lq, np.float32) * w + den).astype(np.float32)
        num = (np.asarray(aq, np.float32) * w[..., None] + num).astype(
            np.float32)
    o = num / np.maximum(den, np.float32(1e-30))[..., None]
    B, hkv, G, C, D = o.shape
    return o.transpose(0, 3, 1, 2, 4).reshape(B, C, hkv * G, D)


def _gqa_split_case(D=8):
    """Four slots over a table of 6 entries split 3 ways ((0, 2), (2, 4),
    (4, 6)), pages of 4 rows: slot 0's middle range is wholly null, and
    under a window of 6 its first range holds no key in the window;
    slot 1's middle range holds live pages whose keys are all masked
    (tags past every query position, or -1), and its query row 0 sees no
    key at all; slot 2 holds positions 0..23 in order, so a window of 6
    excludes its first two ranks; slot 3 is idle (its whole table
    null).  ``D`` the head dim."""
    rng = np.random.default_rng(29)
    B, C, hkv, G, page, W = 4, 2, 2, 2, 4, 6
    n_pages = 16
    q = rng.normal(size=(B, C, hkv * G, D)).astype(np.float32)
    kp = rng.normal(size=(n_pages, page, hkv, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages, page, hkv, D)).astype(np.float32)
    pp = np.full((n_pages, page), -1, np.int32)
    tbl = np.zeros((B, W), np.int32)
    tbl[0] = [1, 2, 0, 0, 3, 4]
    tbl[1] = [5, 6, 7, 8, 0, 9]
    tbl[2] = [10, 11, 12, 13, 14, 15]
    for pg, tags in ((1, [0, 1, 2, 3]), (2, [4, 5, -1, 6]),
                     (3, [7, 8, 9, 10]), (4, [11, -1, 12, 13]),
                     (5, [4, 5, 6, 7]), (6, [8, -1, 9, 10]),
                     (7, [50, 51, -1, 52]), (8, [-1, 60, 61, 62]),
                     (9, [11, 12, 13, 14])):
        pp[pg] = tags
    pp[10:16] = np.arange(24).reshape(6, 4)
    qpos = np.array([[12, 13], [3, 12], [22, 23], [5, 6]], np.int32)
    return q, kp, vp, pp, tbl, qpos


# (window, D): the kernel's split at head dim 8, and at the tensor-core
# body's head dims 64, 112 (zamba2's) and 128
SPLIT_MERGE = [pytest.param(w, 8, id=str(w)) for w in (0, 6)] + \
    [pytest.param(w, d, id=f"{w}-d{d}") for d in (64, 112, 128)
     for w in (0, 6)]


@pytest.mark.parametrize("window,D", SPLIT_MERGE)
def test_gqa_split_merge_matches_jax_single_pass(window, D):
    """What the bf16 kernel does at decode, in float32: the JAX kernel's
    partial statistics (``partial=True``, Pallas in interpret mode) on
    each rank's table columns, merged in rank order as the kernel merges
    them, equal the single pass (the JAX kernel on the whole table, and
    on the rows that see a key the port's plain version and
    ``ref.gqa_paged_ref``).  A wholly null range merges as (m, l, acc) =
    (-1e30, 0, 0); an all-masked range, and under the window a range
    wholly outside it, has m = -1e30 and loses to any real score; a row
    that sees no key keeps the single pass's exp(0) weights over the
    live pages; the idle slot gives exact zeros.  At every head dim the
    tensor-core body serves (64 to 128)."""
    q, kp, vp, pp, tbl, qpos = _gqa_split_case(D)
    page = kp.shape[1]
    ranges = tpk.split_ranges(tbl.shape[1], 3)
    assert ranges == [(0, 2), (2, 4), (4, 6)]
    jq = [jnp.asarray(a) for a in (q, kp, vp, pp)]
    parts = [jpk.gqa_paged_flash(*jq, jnp.asarray(tbl[:, lo:hi]),
                                 jnp.asarray(qpos), window=window,
                                 partial=True, interpret=True)
             for lo, hi in ranges]
    m0 = np.asarray(parts[0][0])
    m1, l1, a1 = (np.asarray(t) for t in parts[1])
    # slot 0's null range, slot 1's all-masked one (2 live pages)
    assert np.all(m1[0] == -1e30) and np.all(l1[0] == 0)
    assert np.all(a1[0] == 0)
    assert np.all(m1[1] == -1e30) and np.all(l1[1] == 2 * page)
    if window:      # slot 0's and slot 2's first range: outside the window
        assert np.all(m0[0] == -1e30) and np.all(m0[2] == -1e30)
        assert np.all(np.asarray(parts[1][0])[2] == -1e30)
    got = _gqa_merge(parts)
    targs = [jnp.asarray(tbl), jnp.asarray(qpos)]
    want_k = np.asarray(jpk.gqa_paged_flash(*jq, *targs, window=window,
                                            interpret=True))
    np.testing.assert_allclose(got, want_k, rtol=RTOL, atol=ATOL)
    assert np.all(got[3] == 0.0) and np.all(want_k[3] == 0.0)
    seen = _seen(pp, tbl, qpos, window)
    assert seen[0].all() and not seen[1, 0] and seen[1, 1]
    assert seen[2].all() and not seen[3].any()
    want_r = np.asarray(jref.gqa_paged_ref(*jq, *targs, window=window))
    plain = tpk.gqa_paged_flash(*(torch.from_numpy(a) for a in (
        q, kp, vp, pp, tbl, qpos)), window=window).numpy()
    for want in (want_r, plain):
        np.testing.assert_allclose(got[seen], want[seen], rtol=RTOL,
                                   atol=ATOL)
    assert np.all(plain[3] == 0.0)


# -- the pool's host state against JAX's ------------------------------------

def _windowed(get, reduce):
    return reduce(get(ARCH)).replace(sliding_window=WINDOW)


def test_paged_pool_matches_jax():
    """One seeded request stream drives both pools through the port's
    scheduler (admit, pre-wrap publish, plan_writes, drain, advance,
    publish, release), with a small spare budget so that the prefix
    cache evicts.  Block tables, refcounts, free lists, counters and the
    drained edits must be equal after every call."""
    jcfg = _windowed(jget_config, jreduce_config)
    cfg = _windowed(get_config, reduce_config)
    kw = dict(chunk=8, page=4, spare_pages=4)
    jpool = jkv.PagedPool(jcfg, 3, 40, **kw)
    tpool = kv_pool.PagedPool(cfg, 3, 40, device="cpu", **kw)
    assert (tpool.n_blocks, tpool.ring, tpool.n_pages) == \
        (jpool.n_blocks, jpool.ring, jpool.n_pages)
    rng = np.random.default_rng(0)
    prefixes = [rng.integers(0, 50, size=12) for _ in range(2)]
    sched = Scheduler(3, 8)
    for rid in range(14):
        head = prefixes[rid % 2][:int(rng.integers(4, 13))]
        tail = rng.integers(0, 50, size=int(rng.integers(6, 21)))
        sched.add(Request(rid, np.concatenate([head, tail]).astype(np.int32),
                          int(rng.integers(1, 6))))

    def place(s, entry):
        off = jpool.admit(s, entry.req.prompt)
        assert tpool.admit(s, entry.req.prompt) == off
        return off

    def same_state():
        np.testing.assert_array_equal(tpool.kv.table, jpool.kv.table)
        np.testing.assert_array_equal(tpool.kv.ref, jpool.kv.ref)
        assert tpool.kv.free == jpool.kv.free
        assert tpool.counters == jpool.counters
        np.testing.assert_array_equal(tpool.pos, jpool.pos)
        tpool.kv.check(tpool.external_refs())

    while sched.has_work:
        sched.admit(place)
        same_state()
        kind = sched.peek_kind()
        tokens, n_valid, _, _, _, prefilling = sched.build_batch(kind)
        for s, off, take in prefilling:
            for pool in (jpool, tpool):
                pool.maybe_publish_prewrap(s, sched.slots[s].req.prompt,
                                           off, take)
        jpool.plan_writes(n_valid)
        tpool.plan_writes(n_valid)
        same_state()
        _, jops = jpool.drain(None)
        got = tpool.drain()
        assert (jops is None) == (got is None)
        if got is not None:
            ops, n_reset, n_copy, n_st_reset, n_st_copy = got
            assert n_st_reset == n_st_copy == 0      # no state pages
            jops = np.asarray(jops)
            S, NB, NP = 3, jpool.n_blocks, jpool.n_pages
            np.testing.assert_array_equal(ops[:S + S * NB],
                                          jops[:S + S * NB])
            flags = jops[S + S * NB:S + S * NB + NP]
            i = S + S * NB
            assert list(ops[i:i + n_reset]) == list(np.nonzero(flags)[0])
            pads = jops[S + S * NB + NP:]
            jsrc, jdst = np.split(pads, 2)
            real = jdst < NP
            assert list(ops[i + n_reset:i + n_reset + n_copy]) == \
                list(jsrc[real])
            assert list(ops[i + n_reset + n_copy:]) == list(jdst[real])
        same_state()
        jpool.advance(n_valid)
        tpool.advance(n_valid)
        finished, entering = sched.feed(n_valid)
        for s, req in entering:
            jpool.publish(s, req.prompt)
            tpool.publish(s, req.prompt)
        for s, _ in finished:
            jpool.release(s)
            tpool.release(s)
        same_state()
    c = tpool.counters
    assert c["prefix_hits"] and c["pages_cowed"] and c["pages_evicted"]
    assert tpool.alloc_events() == jpool.alloc_events()


def test_paged_write_drops_invalid_tokens_off_every_real_page():
    """A mixed dispatch with a partial chunk and an idle slot: the
    invalid tokens land on the scratch page, the null page keeps its -1
    tags, and no page outside the written (page, offset) set changes."""
    cfg = reduce_config(get_config(ARCH))
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    pool = kv_pool.PagedPool(cfg, 3, 32, device="cpu")
    cache = pool.build()
    for s, n in ((0, 5), (2, 12)):
        pool.admit(s, np.arange(n))
    n_valid = np.array([5, 0, 8])
    pool.prepare(cache, n_valid)
    before = {k: v.clone() for k, v in cache["layers"].items()}
    toks = torch.randint(0, cfg.vocab_size, (3, 8), dtype=torch.int32)
    api.prefill_chunk(params, cfg, toks, cache,
                      n_valid=torch.as_tensor(n_valid, dtype=torch.int32))
    written = np.zeros((pool.n_pages + 1, pool.page), bool)
    for s, nv in enumerate(n_valid):
        for p in range(nv):
            written[pool.kv.table[s, p // pool.page], p % pool.page] = True
    written[pool.n_pages] = True                      # the scratch page
    keep = torch.from_numpy(~written)
    for k, v in cache["layers"].items():
        assert torch.equal(v[:, keep], before[k][:, keep]), k
    assert torch.all(cache["layers"]["pos"][:, 0] == -1)
    np.testing.assert_array_equal(cache["pos"].numpy(), [5, 0, 8])


# -- the engine against JAX's -----------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """Reduced windowed granite, the JAX calibration's MoR tree with the
    odd 128-column tiles made statically dead (so that the predictor
    really skips), carried across as numpy; a trace of a 16-token shared
    prefix plus suffixes, two of them identical with a page-aligned
    length of 24."""
    jcfg = _windowed(jget_config, jreduce_config)
    api = jget_model(jcfg)
    params = api.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield {"tokens": jnp.asarray(
                rng.integers(0, jcfg.vocab_size, (2, 32)), jnp.int32)}

    params, mor, _ = jcalibrate_lm(params, jcfg, api.forward, batches(), 2)
    layer = {k: np.array(v) for k, v in
             jax.tree_util.tree_map(np.asarray, mor["layers"]).items()}
    dead = (np.arange(layer["m"].shape[-1]) // 128) % 2 == 1
    layer["bn_bias"] = np.where(dead, -1e3, layer["bn_bias"]).astype(
        np.float32)
    layer["enable"] = layer["enable"] | dead
    layer["is_proxy"] = layer["is_proxy"] & ~dead
    layer["proxy_slot"] = np.where(dead, -1, layer["proxy_slot"]).astype(
        np.int32)
    jmor = {"layers": {k: jnp.asarray(v) for k, v in layer.items()}}
    cfg = _windowed(get_config, reduce_config)
    tparams = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tmor = convert.mor_from_numpy({"layers": layer}, device="cpu")
    prng = np.random.default_rng(7)
    prefix = prng.integers(0, cfg.vocab_size, 16)
    reqs = [(np.concatenate([prefix, prng.integers(0, cfg.vocab_size, n)]
                            ).astype(np.int32), g)
            for n, g in ((3, 4), (9, 3), (8, 5), (5, 3))]
    reqs.append((reqs[2][0].copy(), 4))
    return jcfg, params, jmor, cfg, tparams, tmor, reqs


KW = dict(n_slots=2, max_len=48)


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("mode,capacity", [("dense", None),
                                           ("exact", None),
                                           ("tiled", None),
                                           ("kernel", None),
                                           ("kernel", 0.5)])
def test_paged_engine_matches_jax(setup, mode, capacity, prefix_cache):
    jcfg, params, jmor, cfg, tparams, tmor, reqs = setup
    caps = None if capacity is None else {"mor_stats": capacity}
    kw = dict(KW, mor_mode=mode, capacities=caps, prefix_cache=prefix_cache)
    jeng = JEngine(jcfg, params, mor=jmor, **kw)
    want = jeng.run(list(reqs))
    teng = Engine(cfg, tparams, mor=tmor, **kw)
    got = teng.run(list(reqs))
    assert got == want
    assert [len(got[r]) for r in sorted(got)] == [g for _, g in reqs]
    assert teng.counters["dispatches"] == jeng.counters["dispatches"]
    assert teng._prefix_counters() == jeng._prefix_counters()
    pc = teng._prefix_counters()
    if prefix_cache:
        assert pc["prefix_hits"] and pc["chunks_skipped"] and \
            pc["pages_cowed"]
    jtel, ttel = jeng.telemetry.summary(), teng.telemetry.summary()
    assert ttel.get("prefix_cache") == jtel.get("prefix_cache")
    assert ttel["n_dispatches"] == jtel["n_dispatches"]
    if mode == "dense":
        return
    for name in ("frac_tiles_live", "frac_tiles_computed"):
        np.testing.assert_allclose(ttel["mor_stats"][name],
                                   jtel["mor_stats"][name], rtol=1e-12,
                                   err_msg=name)
    assert max(ttel["mor_stats"]["frac_tiles_computed"]) < 1.0


def test_paged_engine_matches_jax_pallas_kernel(setup, monkeypatch):
    """Kernel mode with a warm prefix cache against the JAX engine
    running its Pallas paged kernel in interpret mode."""
    jcfg, params, jmor, cfg, tparams, tmor, reqs = setup
    small = [reqs[0], reqs[0], reqs[3]]
    monkeypatch.setenv("REPRO_PAGED_KERNEL", "1")
    jpk.reset_kernel_traces()
    kw = dict(KW, mor_mode="kernel")
    jeng = JEngine(jcfg, params, mor=jmor, **kw)
    teng = Engine(cfg, tparams, mor=tmor, **kw)
    for eng in (jeng, teng):
        eng.run(small[:1])                          # warm the prefix cache
    assert teng.run(small) == jeng.run(small)
    assert jpk.kernel_traces()["gqa"] > 0
    assert teng._prefix_counters() == jeng._prefix_counters()
    assert teng._prefix_counters()["prefix_hits"] == 3


def test_paged_engine_matches_slotted(setup):
    _, _, _, cfg, tparams, tmor, reqs = setup
    kw = dict(KW, mor=tmor, mor_mode="kernel")
    paged = Engine(cfg, tparams, **kw)
    assert paged.run(list(reqs)) == \
        Engine(cfg, tparams, layout="slotted", **kw).run(list(reqs))
    rep = paged.report()
    assert rep["layout"] == "paged" and rep["page"] == cfg.serve_page
    assert rep["prefix_cache"]["pages_cowed"] > 0


def test_update_mor_swaps_the_tree(setup):
    _, _, _, cfg, tparams, tmor, reqs = setup
    eng = Engine(cfg, tparams, mor=tmor, mor_mode="tiled", **KW)
    before = eng.run(list(reqs[:2]))
    eng.update_mor({"layers": {k: v.clone() for k, v in
                               tmor["layers"].items()}})
    assert eng.run(list(reqs[:2])) == {r + 2: t for r, t in before.items()}


def test_paged_hot_loop_reads_nothing_back_before_the_flush(setup,
                                                            monkeypatch):
    """No dispatch of the paged engine moves a tensor to the host: the
    pool decides from counts, and tokens and tile counters stay device
    tensors until ``run`` flushes."""
    _, _, _, cfg, tparams, tmor, reqs = setup
    eng = Engine(cfg, tparams, mor=tmor, mor_mode="kernel", **KW)
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
    assert sorted(len(v) for v in eng.results.values()) == \
        sorted(g for _, g in reqs)
    assert eng.pool.counters["pages_cowed"] > 0


def test_pool_exhaustion_raises_without_preemption():
    """Where its pool runs out of pages the paged engine spills a victim
    to the host and serves every request with the tokens of an
    unpressured run; only with no victim to spill (the one running
    request was admitted in this step) does it raise ``PoolExhausted``.
    The slotted layout has no pages to spill and refuses a preemption."""
    cfg = reduce_config(get_config(ARCH))
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, cfg.vocab_size, n).astype(np.int32), 8)
            for n in (10, 14, 7)]
    kw = dict(n_slots=2, max_len=32, prefix_cache=False)
    want = Engine(cfg, params, **kw).run(list(reqs))
    # 4 blocks a slot: 5 pages for two slots that need up to 3 each
    eng = Engine(cfg, params, spare_pages=-3, **kw)
    assert eng.run(list(reqs)) == want
    assert eng.counters["preemptions"] > 0
    assert eng.pool.spill_events["restores"] == \
        eng.pool.spill_events["spills"] > 0
    eng.pool.kv.check(eng.pool.external_refs())
    eng = Engine(cfg, params, spare_pages=0, **kw)
    eng.pool.kv.free.clear()
    eng.submit(np.arange(5), 2)
    with pytest.raises(kv_pool.PoolExhausted, match="exhausted"):
        eng.step()
    slotted = Engine(cfg, params, layout="slotted", **kw)
    slotted.submit(np.arange(5), 2)
    slotted.step()
    with pytest.raises(ValueError, match="layout='paged'"):
        slotted._preempt(0)
    # a page-sharded pool (rank 1 of 2) holds its half of the pages
    shard = kv_pool.PagedPool(cfg, 2, 32, n_shards=2, shard=1,
                              device="cpu")
    assert shard.n_pages % 2 == 0
    assert shard.build()["layers"]["k"].shape[1] == shard.n_pages // 2 + 1


def test_serve_cli_paged_shared_prefix_on_cpu(capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                      "--requests", "3", "--prompt-min", "3",
                      "--prompt-max", "9", "--gen-len", "3", "--layout",
                      "paged", "--shared-prefix", "8", "--mor", "kernel",
                      "--compare"])
    assert rep["layout"] == "paged"
    assert rep["prefix_cache"]["prefix_hits"] > 0
    assert rep["token_agreement_vs_dense"] == 1.0
    assert "prefix cache: hit rate" in capsys.readouterr().out
