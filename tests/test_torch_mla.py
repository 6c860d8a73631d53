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
