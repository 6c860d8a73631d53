"""The port's MLA slice against the JAX package on reduced
deepseek-v2-236b (float32): the ``mla_paged_flash`` plain version
against the Pallas kernel (interpret mode) and ``ref.mla_paged_ref``,
``mla_forward`` and ``mla_chunk`` (slotted and paged) on carried-across
weights and caches, and the model's chunked prefill over the slotted
cache.

Tolerances: the kernel's plain version and the JAX oracles are float32
computations of one softmax in different summation orders over at most
64 keys of magnitude ~1: rtol = atol = 1e-5, on the query rows that see
at least one key (a row that sees none is defined differently by the
Pallas kernel, exp(0) weights over the live pages, and by the dense
oracle, over the whole ring view).  The attention layers and the
2-layer model compose several float32 matmuls and a softmax: rtol =
atol = 2e-4, the bound the JAX package's own chunked-prefill test uses.
Position tags are integers and must be equal.
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
from repro.models.layers import attention as jattn
from repro.serving import kv_pool as jkv
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels import paged_attention as tpk
from repro_torch.models import get_model
from repro_torch.models.layers import attention as tattn
from repro_torch.serving import kv_pool
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "deepseek-v2-236b"
RTOL = ATOL = 1e-5
TOL = 2e-4


# -- the kernel's plain version against the Pallas kernel and the oracle ----

def _mla_case(seed, B, C, n_blocks, page, h, kr, rd, extra_cols):
    """Random latent pools and a table with null entries, a page shared
    by slots 0 and 1, and slot B-1 entirely null (``tests/
    test_paged_kernel.py``'s case, drawn with numpy).  ``extra_cols`` >
    0 makes the table a column slice of a wider one."""
    rng = np.random.default_rng(seed)
    n_pages = 2 * B * n_blocks + 1
    ring = n_blocks * page
    q_lat = rng.normal(size=(B, C, h, kr)).astype(np.float32)
    q_pe = rng.normal(size=(B, C, h, rd)).astype(np.float32)
    ck = rng.normal(size=(n_pages, page, kr)).astype(np.float32)
    cpe = rng.normal(size=(n_pages, page, rd)).astype(np.float32)
    cp = rng.integers(-1, ring, size=(n_pages, page)).astype(np.int32)
    cp[0] = -1                                   # the null page
    wide = rng.integers(0, n_pages, size=(B, n_blocks + extra_cols))
    wide[:, :n_blocks][rng.random((B, n_blocks)) < 0.25] = 0
    wide[1, 0] = wide[0, n_blocks - 1] = n_pages - 1     # a shared page
    wide[B - 1] = 0                              # an idle slot
    qpos = np.arange(ring // 2, ring // 2 + B * C).reshape(B, C)
    return (q_lat, q_pe, ck, cpe, cp, wide.astype(np.int32),
            qpos.astype(np.int32))


CASES = {   # B, C, n_blocks, page, h, kr, rd, extra_cols
    "jax_case": (3, 2, 4, 4, 3, 8, 4, 0),
    "decode": (3, 1, 6, 8, 4, 32, 8, 0),
    "mixed": (3, 5, 4, 8, 4, 32, 8, 0),
    "sliced": (4, 3, 3, 8, 2, 16, 8, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mla_paged_flash_matches_jax(case):
    B, C, n_blocks, page, h, kr, rd, extra = CASES[case]
    q_lat, q_pe, ck, cpe, cp, wide, qpos = _mla_case(len(case), B, C,
                                                     n_blocks, page, h, kr,
                                                     rd, extra)
    scale = (kr + rd) ** -0.5
    tbl = wide[:, :n_blocks]
    jargs = [jnp.asarray(a) for a in (q_lat, q_pe, ck, cpe, cp, tbl, qpos)]
    want_k = np.asarray(jpk.mla_paged_flash(*jargs, scale=scale,
                                            interpret=True))
    want_r = np.asarray(jref.mla_paged_ref(*jargs, scale=scale))
    ttbl = torch.from_numpy(wide)[:, :n_blocks]
    assert ttbl.is_contiguous() == (extra == 0)
    got = tpk.mla_paged_flash(*(torch.from_numpy(a) for a in (
        q_lat, q_pe, ck, cpe, cp)), ttbl, torch.from_numpy(qpos),
        scale=scale)
    assert got.shape == (B, C, h, kr) and got.dtype == torch.float32
    tags = np.where((tbl > 0)[..., None], cp[tbl], -1).reshape(B, -1)
    seen = ((tags[:, None, :] >= 0)
            & (tags[:, None, :] <= qpos[:, :, None])).any(-1)
    assert seen[:-1].any() and not seen[-1].any()
    got = got.numpy()
    np.testing.assert_allclose(got[seen], want_k[seen], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[seen], want_r[seen], rtol=RTOL, atol=ATOL)
    # the idle slot (all-null table) gives exact zeros, like the kernel
    assert np.all(got[-1] == 0.0) and np.all(want_k[-1] == 0.0)


# -- the bf16 kernel's context split: its plan and its merge ----------------

def _plan_cases():
    """(B, C, h, W, page, sms): ``chip_smoke.py``'s decode and mixed
    dispatches, deepseek's serving chunk, tables narrower than a split
    of 8, pages wider than a K tile, then a seeded sweep."""
    cases = [(8, 1, 128, 512, 8, 132), (8, 32, 128, 12, 8, 132),
             (8, 32, 128, 40, 8, 132), (1, 1, 128, 3, 64, 132),
             (2, 1, 128, 2, 128, 132), (1, 1, 128, 1, 8, 132),
             (4, 1, 4, 6, 4, 78)]
    rng = np.random.default_rng(17)
    for _ in range(9):
        cases.append((int(rng.integers(1, 17)), int(rng.integers(1, 65)),
                      int(rng.choice([4, 16, 128])),
                      int(rng.integers(1, 700)), int(rng.choice([4, 8, 16])),
                      int(rng.choice([78, 114, 132]))))
    return cases


@pytest.mark.parametrize("B,C,h,W,page,sms", _plan_cases())
def test_mla_plan_splits_the_table_in_whole_entries(B, C, h, W, page, sms):
    """The split plan: 1 <= split <= 8 and <= W; the ranks' ranges, as
    the kernel computes them, tile [0, W) in rank order in whole table
    entries, none empty; the split fills no more than one wave of the
    SMs beside the 64-pair tiles (or is 1), and gives no rank less than
    one 64-key tile of the table on average."""
    split = tpk.mla_plan(B, C, h, W, page, sms=sms)
    assert 1 <= split <= 8 and split <= W
    ranges = tpk.split_ranges(W, split)
    assert len(ranges) == split and ranges[0][0] == 0 and ranges[-1][1] == W
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    tiles = B * -(-(C * h) // 64)
    assert split == 1 or tiles * split <= sms
    assert split == 1 or split <= -(-(W * page) // 64)


def test_mla_plan_at_the_main_path_shapes():
    """Decode (8 slots x 1 row, 16 tiles of 64 pairs) splits 8 ways, so
    its 128 blocks fill one wave of 132 SMs; a mixed dispatch (8 x 32
    rows, 512 tiles) does not split; a table of 3 entries splits at most
    3 ways, one entry a rank."""
    assert tpk.mla_plan(8, 1, 128, 512, 8, sms=132) == 8
    assert tpk.mla_plan(8, 32, 128, 12, 8, sms=132) == 1
    assert tpk.mla_plan(1, 1, 128, 3, 64, sms=132) == 3
    assert tpk.split_ranges(3, 3) == [(0, 1), (1, 2), (2, 3)]
    assert tpk.split_ranges(512, 8)[1] == (64, 128)


def _merge(parts):
    """The kernel's merge of the ranks' (m, l, acc) in float32, in rank
    order: M = max m, w_q = exp(m_q - M), L = sum l_q w_q, o = sum acc_q
    w_q / max(L, 1e-30); -> (B, C, h, kr)."""
    m = np.stack([np.asarray(p[0], np.float32) for p in parts])
    M = m.max(0)
    num = np.zeros(np.asarray(parts[0][2]).shape, np.float32)
    den = np.zeros(M.shape, np.float32)
    for q, (mq, lq, aq) in enumerate(parts):
        w = np.exp(m[q] - M).astype(np.float32)
        den = (np.asarray(lq, np.float32) * w + den).astype(np.float32)
        num = (np.asarray(aq, np.float32) * w[..., None] + num).astype(
            np.float32)
    o = num / np.maximum(den, np.float32(1e-30))[..., None]
    return o.transpose(0, 2, 1, 3)


def _split_case():
    """Three slots over a table of 6 entries split 3 ways ((0, 2), (2,
    4), (4, 6)): slot 0's middle range is wholly null; slot 1's middle
    range holds live pages whose keys are all masked (tags past every
    query position, or -1), and its query row 0 sees no key at all;
    slot 2 is idle (its whole table null)."""
    rng = np.random.default_rng(23)
    B, C, h, kr, rd, page, W = 3, 2, 4, 32, 8, 4, 6
    n_pages = 10
    q_lat = rng.normal(size=(B, C, h, kr)).astype(np.float32)
    q_pe = rng.normal(size=(B, C, h, rd)).astype(np.float32)
    ck = rng.normal(size=(n_pages, page, kr)).astype(np.float32)
    cpe = rng.normal(size=(n_pages, page, rd)).astype(np.float32)
    cp = np.full((n_pages, page), -1, np.int32)
    tbl = np.zeros((B, W), np.int32)
    tbl[0] = [1, 2, 0, 0, 3, 4]
    tbl[1] = [5, 6, 7, 8, 0, 9]
    for pg, tags in ((1, [0, 1, 2, 3]), (2, [4, 5, -1, 6]),
                     (3, [7, 8, 9, 10]), (4, [11, -1, 12, 13]),
                     (5, [4, 5, 6, 7]), (6, [8, -1, 9, 10]),
                     (7, [50, 51, -1, 52]), (8, [-1, 60, 61, 62]),
                     (9, [11, 12, 13, 14])):
        cp[pg] = tags
    qpos = np.array([[12, 13], [3, 12]], np.int32)
    qpos = np.concatenate([qpos, [[5, 6]]]).astype(np.int32)
    return q_lat, q_pe, ck, cpe, cp, tbl, qpos


def test_mla_split_merge_matches_jax_single_pass():
    """What the bf16 kernel does at decode, in float32: the JAX kernel's
    partial statistics (``partial=True``, Pallas in interpret mode) on
    each rank's table columns, merged in rank order as the kernel merges
    them, equal the single pass (the JAX kernel on the whole table, and
    on the rows that see a key the port's plain version and
    ``ref.mla_paged_ref``).  A wholly null range merges as (m, l, acc) =
    (-1e30, 0, 0); an all-masked one has m = -1e30 and loses to any real
    score; a row that sees no key keeps the single pass's exp(0) weights
    over the live pages; the idle slot gives exact zeros."""
    q_lat, q_pe, ck, cpe, cp, tbl, qpos = _split_case()
    B, C, h, kr = q_lat.shape
    rd = q_pe.shape[-1]
    scale = (kr + rd) ** -0.5
    ranges = tpk.split_ranges(tbl.shape[1], 3)
    assert ranges == [(0, 2), (2, 4), (4, 6)]
    jq = [jnp.asarray(a) for a in (q_lat, q_pe, ck, cpe, cp)]
    parts = [jpk.mla_paged_flash(*jq, jnp.asarray(tbl[:, lo:hi]),
                                 jnp.asarray(qpos), scale=scale,
                                 partial=True, interpret=True)
             for lo, hi in ranges]
    # slot 0's null range and the idle slot: the finite sentinel, no key
    m1, l1, a1 = (np.asarray(t) for t in parts[1])
    assert np.all(m1[0] == -1e30) and np.all(l1[0] == 0)
    assert np.all(a1[0] == 0)
    assert np.all(m1[1] == -1e30) and np.all(l1[1] == 2 * 4)   # 2 pages
    got = _merge(parts)
    targs = [jnp.asarray(tbl), jnp.asarray(qpos)]
    want_k = np.asarray(jpk.mla_paged_flash(*jq, *targs, scale=scale,
                                            interpret=True))
    np.testing.assert_allclose(got, want_k, rtol=RTOL, atol=ATOL)
    assert np.all(got[2] == 0.0) and np.all(want_k[2] == 0.0)
    tags = np.where((tbl > 0)[..., None], cp[tbl], -1).reshape(B, -1)
    seen = ((tags[:, None, :] >= 0)
            & (tags[:, None, :] <= qpos[:, :, None])).any(-1)
    assert seen[0].all() and not seen[1, 0] and seen[1, 1]
    assert not seen[2].any()
    want_r = np.asarray(jref.mla_paged_ref(*jq, *targs, scale=scale))
    plain = tpk.mla_paged_flash(*(torch.from_numpy(a) for a in (
        q_lat, q_pe, ck, cpe, cp, tbl, qpos)), scale=scale).numpy()
    for want in (want_r, plain):
        np.testing.assert_allclose(got[seen], want[seen], rtol=RTOL,
                                   atol=ATOL)
    assert np.all(plain[2] == 0.0)


# -- the attention layer on carried-across weights --------------------------

@pytest.fixture(scope="module")
def layer():
    """Reduced deepseek configs and layer 0's MLA weights, both ways."""
    jcfg = jreduce_config(jget_config(ARCH))
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["dense_layers"]["attn"])
    cfg = reduce_config(get_config(ARCH))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, cfg, tp


def _x(seed, B, C, d):
    return np.random.default_rng(seed).normal(size=(B, C, d)).astype(
        np.float32)


def test_mla_forward_matches_jax(layer):
    jcfg, jp, cfg, tp = layer
    x = _x(0, 2, 11, cfg.d_model)
    pos = np.broadcast_to(np.arange(11), (2, 11))
    want = jattn.mla_forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tattn.mla_forward(tp, cfg, torch.from_numpy(x),
                            torch.from_numpy(np.array(pos)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_mla_chunk_slotted_matches_jax(layer):
    """Two chained chunks over a slotted latent cache: a prefilling slot,
    an idle slot and a partial chunk.  Outputs allclose on the valid
    rows; the written cache rows allclose, the tags equal, the idle
    slot's rows untouched."""
    jcfg, jp, cfg, tp = layer
    B, C, ML = 3, 4, 16
    jcache = jattn.mla_cache_init(jcfg, B, ML, jnp.float32)
    jcache["pos"] = jnp.full((B, ML), -1, jnp.int32)
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    pos = np.zeros(B, np.int32)
    for step, nv in enumerate((np.array([4, 0, 3]), np.array([2, 0, 4]))):
        x = _x(step + 1, B, C, cfg.d_model)
        valid = np.arange(C)[None, :] < nv[:, None]
        want, jcache = jattn.mla_chunk(jp, jcfg, jnp.asarray(x), jcache,
                                       jnp.asarray(pos), jnp.asarray(valid))
        got = tattn.mla_chunk(tp, cfg, torch.from_numpy(x), tcache,
                              torch.from_numpy(pos),
                              torch.from_numpy(valid))
        np.testing.assert_allclose(got.numpy()[valid],
                                   np.asarray(want)[valid], rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for k in ("c_kv", "k_pe"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=TOL,
                                       atol=TOL)
        assert torch.all(tcache["pos"][1] == -1)
        assert torch.all(tcache["c_kv"][1] == 0)
        pos = pos + nv.astype(np.int32)


def test_mla_chunk_paged_matches_jax(layer):
    """One mixed dispatch over the paged latent pools, with a page shared
    by two slots' tables (read only) and a table column slice: outputs
    allclose on the valid rows, the written pages equal to JAX's (tags
    exactly), every other real page untouched, and the invalid tokens
    on the port's trailing scratch page."""
    jcfg, jp, cfg, tp = layer
    B, C, page, n_pages, W = 3, 5, 4, 12, 4
    kr, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    rng = np.random.default_rng(3)
    # slot 0 has 6 cached positions (pages 1, 2), slot 1 shares page 1
    # and writes page 3, slot 2 is idle
    tags = np.full((n_pages, page), -1, np.int32)
    tags[1] = np.arange(4)
    tags[2, :2] = [4, 5]
    ck = rng.normal(size=(n_pages, page, kr)).astype(np.float32)
    cpe = rng.normal(size=(n_pages, page, rd)).astype(np.float32)
    ck[0] = cpe[0] = 0.0
    wide = np.zeros((B, W + 2), np.int32)
    wide[0, :3] = [1, 2, 5]
    wide[1, :2] = [1, 3]
    pos = np.array([6, 4, 0], np.int32)
    nv = np.array([3, 4, 0])
    valid = np.arange(C)[None, :] < nv[:, None]
    x = _x(9, B, C, cfg.d_model)
    jcache = {"c_kv": jnp.asarray(ck), "k_pe": jnp.asarray(cpe),
              "pos": jnp.asarray(tags)}
    want, jnew = jattn.mla_chunk(jp, jcfg, jnp.asarray(x), jcache,
                                 jnp.asarray(pos), jnp.asarray(valid),
                                 block_table=jnp.asarray(wide[:, :W]))
    # the port's pools carry one trailing scratch page
    pad = lambda a: torch.from_numpy(np.concatenate([a, a[:1]]))  # noqa
    tcache = {"c_kv": pad(ck), "k_pe": pad(cpe), "pos": pad(tags)}
    before = {k: v.clone() for k, v in tcache.items()}
    got = tattn.mla_chunk(tp, cfg, torch.from_numpy(x), tcache,
                          torch.from_numpy(pos), torch.from_numpy(valid),
                          block_table=torch.from_numpy(wide)[:, :W])
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tcache["pos"][:n_pages].numpy(),
                                  np.asarray(jnew["pos"]))
    for k in ("c_kv", "k_pe"):
        np.testing.assert_allclose(tcache[k][:n_pages].numpy(),
                                   np.asarray(jnew[k]), rtol=TOL, atol=TOL)
    for pg in (0, 1, 4, 6, 7, 8, 9, 10, 11):
        for k in tcache:
            assert torch.equal(tcache[k][pg], before[k][pg]), (pg, k)
    assert not torch.equal(tcache["pos"][n_pages], before["pos"][n_pages])


# -- the model's chunked prefill over the slotted cache ---------------------

def test_prefill_chunk_chain_matches_jax():
    """Reduced deepseek (an MLA + dense-FFN layer and an MLA + MoE
    layer) chained over mixed dispatches on the slotted cache: logits
    allclose on the valid rows, tags and positions equal, the idle
    slot's cache rows unchanged."""
    jcfg = jreduce_config(jget_config(ARCH))
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(1), jcfg)
    cfg = reduce_config(get_config(ARCH))
    api = get_model(cfg)
    params = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    B, C, max_len = 3, 5, 24
    jcache = jkv.init(jcfg, B, max_len, C)
    cache = kv_pool.init(cfg, B, max_len, C, device="cpu")
    rng = np.random.default_rng(1)
    for nv in (np.array([5, 0, 3]), np.array([5, 0, 1]),
               np.array([2, 0, 1])):
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        idle = {k: v[:, 1].clone() for k, v in cache["layers"].items()}
        want, jcache, _ = japi.prefill_chunk(
            jparams, jcfg, jnp.asarray(toks), jcache,
            n_valid=jnp.asarray(nv, jnp.int32))
        got, aux = api.prefill_chunk(params, cfg, torch.as_tensor(toks),
                                     cache, n_valid=torch.as_tensor(
                                         nv, dtype=torch.int32))
        assert aux == {}
        for b in range(B):
            np.testing.assert_allclose(got[b, :nv[b]].numpy(),
                                       np.asarray(want)[b, :nv[b]],
                                       rtol=TOL, atol=TOL)
        for k, v in cache["layers"].items():
            assert torch.equal(v[:, 1], idle[k]), k
        jtags = np.concatenate([np.asarray(jcache[g]["pos"]) for g in
                                ("dense_layers", "moe_layers")])
        np.testing.assert_array_equal(cache["layers"]["pos"].numpy(), jtags)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
