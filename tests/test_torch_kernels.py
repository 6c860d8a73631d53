"""The port's MoR kernel wrappers against the JAX wrappers.

On the CPU each wrapper of ``repro_torch.kernels.ops`` runs its kernel's
plain PyTorch version; the JAX side runs the Pallas kernels in interpret
mode (the default off-TPU).  The same inputs come from a numpy seed.
Masks and counters must be equal; float outputs agree to float32
rounding (rtol = atol = 1e-5: both sum float32 products, in different
orders, over at most 384 terms of magnitude ~1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import binary_dot_packed as jbdp
from repro.kernels import gather_matmul as jgm
from repro.kernels import masked_matmul as jmm
from repro.kernels import mor_predict as jmp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import predictor as tpred
from repro_torch.kernels import binary_dot as tbd
from repro_torch.kernels import binary_dot_packed as tbdp
from repro_torch.kernels import gather_matmul as tgm
from repro_torch.kernels import masked_matmul as tmm
from repro_torch.kernels import mor_predict as tmp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import split_k

RTOL = ATOL = 1e-5


def _mor_layer(rng, n):
    """Every odd 128-column tile gets an intercept far below zero (dead
    wherever the proxy agrees), the rest sit around zero (live)."""
    dead = (np.arange(n) // 128) % 2 == 1
    return {"m": rng.uniform(0.01, 0.05, n).astype(np.float32),
            "b": np.where(dead, -50.0, rng.normal(0.0, 1.0, n)
                          ).astype(np.float32),
            "bn_scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
            "bn_bias": rng.normal(0.0, 0.5, n).astype(np.float32),
            "enable": dead | (rng.random(n) < 0.8)}


@pytest.mark.parametrize("shape", [(8, 128, 256), (16, 100, 128),
                                   (13, 64, 200), (24, 256, 384)])
@pytest.mark.parametrize("with_res", [False, True])
def test_mor_tile_mask_matches_jax(shape, with_res):
    """Tile masks equal, incl. an unpadded odd contraction (K=100), a
    ragged M and N (pad sentinel 2), and the residual row."""
    M, K, N = shape
    rng = np.random.default_rng(M * 7 + K + N + with_res)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mor = _mor_layer(rng, N)
    pn = (mor["b"] < -10)[None, :] | (rng.random((M, N)) < 0.7)
    res = rng.normal(0, 2.0, (M, N)).astype(np.float32) if with_res else None
    want = jops.mor_tile_mask(
        jnp.asarray(x), jnp.asarray(w), {k: jnp.asarray(v)
                                         for k, v in mor.items()},
        jnp.asarray(pn), residual=None if res is None else jnp.asarray(res))
    got = tops.mor_tile_mask(
        torch.from_numpy(x), torch.from_numpy(w),
        {k: torch.from_numpy(np.asarray(v)) for k, v in mor.items()},
        torch.from_numpy(pn),
        residual=None if res is None else torch.from_numpy(res))
    want = np.asarray(want)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size or N <= 128


def test_mor_tile_mask_counts_one_predictor_eval():
    rng = np.random.default_rng(0)
    mor = {k: torch.from_numpy(np.asarray(v))
           for k, v in _mor_layer(rng, 128).items()}
    tpred.reset_predictor_eval_count()
    tops.mor_tile_mask(torch.randn(8, 64), torch.randn(64, 128), mor,
                       torch.zeros(8, 128, dtype=torch.bool))
    assert tpred.predictor_eval_count() == 1


def _mor_plan_cases():
    """(E, M, K, N, sms): ``chip_smoke.py``'s shapes (granite's gate at
    decode and at 256 rows, deepseek's expert grid at capacity 8 and
    256, TDS's FC1, the ragged wrapper case), then a seeded sweep."""
    cases = [(1, 8, 2048, 8192, 132), (1, 256, 2048, 8192, 132),
             (160, 8, 5120, 1536, 132), (160, 256, 5120, 1536, 132),
             (1, 8192, 144, 384, 132), (1, 24, 104, 256, 132),
             (1, 16, 100, 128, 114), (4, 72, 96, 256, 78)]
    rng = np.random.default_rng(5)
    for _ in range(8):
        cases.append((int(rng.choice([1, 1, 4, 160])),
                      int(rng.integers(1, 40)) * 8, int(rng.integers(1, 6000)),
                      int(rng.integers(1, 64)) * 128,
                      int(rng.choice([78, 114, 132]))))
    return cases


@pytest.mark.parametrize("E,M,K,N,sms", _mor_plan_cases())
def test_mor_plan_picks_a_built_tile_and_tiles_k(E, M, K, N, sms):
    """mor_tile_mask's plan: the column tile is always the mask's 128
    columns; 16 rows at M <= 16, else 64 (the two tiles the C entry
    instantiates); the split is ``split_k.split_over``'s for the E x row
    x column tiles against two blocks an SM, and its ranks tile [0, K) in
    whole 128-wide k blocks, none empty."""
    bm, bn, split, kb_per = tmp.plan(E, M, K, N, sms=sms)
    assert bn == 128 and bm == (16 if M <= 16 else 64)
    tiles = E * -(-M // bm) * -(-N // bn)
    assert (split, kb_per) == split_k.split_over(
        tiles, K, sms=tbd.RESIDENT * sms)
    assert 1 <= split <= split_k.MAX_SPLIT
    assert (split - 1) * kb_per * split_k.KB < K <= \
        split * kb_per * split_k.KB
    assert split == 1 or tiles * split <= tbd.RESIDENT * sms


def test_mor_plan_at_the_main_path_shapes():
    """Granite's gate at decode takes binary_dot's decode tiling (16 x
    128, split 4: 256 blocks); at 256 rows, the expert grid and TDS the
    tiles fill the card unsplit."""
    assert tmp.plan(1, 8, 2048, 8192, sms=132) == (16, 128, 4, 4)
    assert tbd.plan(8, 2048, 8192, sms=132) == (16, 128, 4, 4)
    assert tmp.plan(1, 256, 2048, 8192, sms=132) == (64, 128, 1, 16)
    assert tmp.plan(160, 8, 5120, 1536, sms=132) == (16, 128, 1, 40)
    assert tmp.plan(160, 256, 5120, 1536, sms=132) == (64, 128, 1, 40)
    assert tmp.plan(1, 8192, 144, 384, sms=132) == (64, 128, 1, 2)


@pytest.mark.parametrize("with_res", [False, True])
def test_mor_tile_mask_expert_stack_matches_jax(with_res):
    """The expert grid (a leading E on every operand) against the JAX
    kernel vmapped over experts (Pallas in interpret mode), on the
    padded interface: 72 rows an expert, so the kernel's second 64-row
    group is mostly past M; expert 1 routed no token (all proxy states
    2: the early exit), expert 2 and 3 hold 40 and 67 tokens (their
    capacity rows past that forced 2, expert 3's inside the second
    64-row group)."""
    E, M, K, N = 4, 72, 96, 256
    rng = np.random.default_rng(31 + with_res)
    x = rng.normal(size=(E, M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    mors = [_mor_layer(rng, N) for _ in range(E)]
    coef = np.stack([np.stack([m["m"], m["b"], m["bn_scale"],
                               m["bn_bias"], m["enable"].astype(np.float32),
                               np.full(N, float(with_res), np.float32)])
                     for m in mors]).astype(np.float32)
    pn = np.stack([((m["b"] < -10)[None, :] | (rng.random((M, N)) < 0.7))
                   for m in mors]).astype(np.int8)
    for e, count in enumerate((M, 0, 40, 67)):
        pn[e, count:] = 2
    res = rng.normal(0, 2.0, (E, M, N)).astype(np.float32)
    r = res if with_res else None
    want = np.asarray(jax.vmap(
        lambda a, b, c, p, q: jmp.mor_tile_mask(
            a, b, c, p, q if with_res else None, interpret=True))(
        *(jnp.asarray(t) for t in (x, w, coef, pn, res))))
    got = tmp.mor_tile_mask(*(torch.from_numpy(t) for t in (x, w, coef, pn)),
                            None if r is None else torch.from_numpy(r))
    assert got.shape == (E, M // 8, N // 128) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not want[1].any() and not want[2, 5:].any() and want[3, 8].any()
    assert 0 < want[0].sum() < want[0].size


def _tile_mask(rng, nm, nn, p=0.6):
    return rng.random((nm, nn)) < p


@pytest.mark.parametrize("shape", [(16, 128, 256), (13, 96, 200),
                                   (32, 512, 384)])
@pytest.mark.parametrize("cap", [(1.0, None), (0.5, None), (1.0, 0.3),
                                 (0.25, 0.6)])
def test_gather_matmul_matches_jax(shape, cap):
    """Output allclose and (n_live_total, n_computed) equal, with the
    static capacity below 1 and the calibrated ``cap_live`` clamp."""
    M, K, N = shape
    frac, live = cap
    rng = np.random.default_rng(M + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mask = _tile_mask(rng, -(-M // 8), -(-N // 128))
    kw = dict(capacity_frac=frac, capacity_frac_live=live, with_counts=True)
    want = jops.gather_matmul(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(mask), **kw)
    got = tops.gather_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])
    assert got[1].dtype == got[2].dtype == torch.int32


def test_gather_matmul_dead_and_overflow_tiles_are_exact_zeros():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 256)).astype(np.float32))
    mask = torch.tensor([[True, True], [True, False]])
    out, n_live, n_comp = tops.gather_matmul(x, w, mask, capacity=2,
                                             with_counts=True)
    assert (int(n_live), int(n_comp)) == (3, 2)
    assert torch.all(out[8:, :] == 0)          # overflow (2, 0) + dead (2, 1)
    torch.testing.assert_close(out[:8], x[:8] @ w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(16, 256, 128), (13, 200, 96),
                                   (24, 384, 300)])
def test_masked_matmul_kdim_matches_jax(shape):
    M, K, N = shape
    rng = np.random.default_rng(M * K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mask = _tile_mask(rng, -(-M // 8), -(-K // 128), p=0.5)
    want = jops.masked_matmul_kdim(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(mask))
    got = tops.masked_matmul_kdim(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


# -- what the Hopper redesign moved into Python ------------------------------

def _jax_kept(mask, capacity, cap_live):
    """The JAX wrapper's ``kept`` tiles and counters for one FFN: Pallas
    (interpret mode) on strictly positive operands, whose product is
    non-zero exactly on the tiles it computed."""
    nm, nn = mask.shape
    x = jnp.ones((nm * 8, 16), jnp.float32)
    w = jnp.ones((16, nn * 128), jnp.float32)
    out, n_live, n_comp = jgm.gather_matmul(
        x, w, jnp.asarray(mask), capacity=capacity, tile_m=8, tile_n=128,
        bk=16, cap_live=None if cap_live is None else jnp.int32(cap_live),
        interpret=True, return_counts=True)
    kept = np.asarray(out).reshape(nm, 8, nn, 128).any(axis=(1, 3))
    return kept, int(n_live), int(n_comp)


KEPT_CASES = {                   # (nm, nn, live prob, capacity, cap_live)
    "random": (3, 3, 0.6, 9, None),
    "capacity_1": (3, 3, 0.6, 1, None),
    "capacity_half_cap_live": (4, 2, 0.7, 4, 2),
    "cap_live_above_capacity": (4, 2, 0.7, 3, 7),
    "all_live": (2, 3, 1.0, 6, None),
    "all_live_capacity": (2, 3, 1.0, 4, None),
    "all_dead": (3, 2, 0.0, 6, None),
}


@pytest.mark.parametrize("case", list(KEPT_CASES))
def test_kept_tiles_match_jax(case):
    """The kept mask and counters that replace the stable argsort equal
    the JAX wrapper's ``kept``, ``n_live_total`` and ``n_live``."""
    nm, nn, p, capacity, cap_live = KEPT_CASES[case]
    rng = np.random.default_rng(nm * 31 + nn + capacity)
    mask = rng.random((nm, nn)) < p
    want = _jax_kept(mask, capacity, cap_live)
    kept, n_live, n_comp = tgm.kept_tiles(torch.from_numpy(mask),
                                          capacity=capacity,
                                          cap_live=cap_live)
    assert kept.dtype == torch.bool and kept.shape == (nm, nn)
    np.testing.assert_array_equal(kept.numpy(), want[0])
    assert (int(n_live), int(n_comp)) == want[1:]
    assert n_live.dtype == n_comp.dtype == torch.int32


@pytest.mark.parametrize("E,p,capacity", [(4, 0.6, 6), (3, 1.0, 4),
                                          (5, 0.3, 1)])
def test_kept_tiles_expert_stack_matches_jax(E, p, capacity):
    """An expert stack with an (E,) int32 ``cap_live`` tensor (one budget
    an expert, one below 1 so that the floor of one tile holds, an
    expert with no live tile): per expert equal to the JAX wrapper."""
    rng = np.random.default_rng(E * 7 + capacity)
    nm, nn = 3, 2
    mask = rng.random((E, nm, nn)) < p
    mask[-1] = False
    cap_live = rng.integers(0, nm * nn + 2, E).astype(np.int32)
    kept, n_live, n_comp = tgm.kept_tiles(
        torch.from_numpy(mask), capacity=capacity,
        cap_live=torch.from_numpy(cap_live))
    assert n_live.shape == n_comp.shape == (E,)
    for e in range(E):
        want = _jax_kept(mask[e], capacity, int(cap_live[e]))
        np.testing.assert_array_equal(kept[e].numpy(), want[0])
        assert (int(n_live[e]), int(n_comp[e])) == want[1:]


def _plan_cases():
    """The kernel phase's shapes, then a seeded sweep of others:
    (E, M, K, N, sms, capacity)."""
    cases = [(1, 8, 2048, 8192, 132, 32), (1, 256, 2048, 8192, 132, 1024),
             (1, 8, 8192, 2048, 132, None), (1, 256, 8192, 2048, 132, None),
             (160, 8, 5120, 1536, 132, 12), (160, 256, 1536, 5120, 132, None),
             (1, 8192, 144, 384, 132, 3072), (1, 24, 144, 384, 132, 3),
             (1, 72, 1024, 300, 132, None), (1, 8, 100, 128, 132, 1)]
    rng = np.random.default_rng(0)
    for _ in range(16):
        E = int(rng.choice([1, 1, 4, 160]))
        M = int(rng.integers(1, 64)) * 8
        K = int(rng.integers(1, 9000))
        N = int(rng.integers(1, 80)) * 128
        cap = None if rng.random() < 0.5 else int(rng.integers(1, 400))
        cases.append((E, M, K, N, int(rng.choice([78, 114, 132])), cap))
    return cases


@pytest.mark.parametrize("E,M,K,N,sms,cap", _plan_cases())
def test_split_k_plan_tiles_k_in_whole_k_blocks(E, M, K, N, sms, cap):
    """The split-K plan: segments in rank order tile [0, K) exactly, each
    starts on a 128-wide k block, none is empty; split <= 8, 1 when the
    live blocks fill the card (in particular at 2 x sms), and otherwise
    as many as still fit one wave, fewer only where that leaves no rank
    empty."""
    split, kb_per = split_k.plan(E, M, K, N, sms=sms, capacity=cap)
    # rank r sums k blocks [r kb_per, (r + 1) kb_per), as the kernels do
    segs = [(r * kb_per * split_k.KB, min(K, (r + 1) * kb_per * split_k.KB))
            for r in range(split)]
    assert 1 <= split <= split_k.MAX_SPLIT and len(segs) == split
    assert segs[0][0] == 0 and segs[-1][1] == K
    for (a0, a1), (b0, _) in zip(segs, segs[1:]):
        assert a1 == b0
    assert all(k0 < k1 and k0 % split_k.KB == 0 for k0, k1 in segs)
    per = -(-M // 64) * -(-N // 128)
    live = E * (per if cap is None else min(per, cap))
    nkb = -(-K // split_k.KB)
    most = max(1, min(split_k.MAX_SPLIT, nkb, sms // live))
    assert kb_per == -(-nkb // most) and split <= most
    assert live * split <= sms or split == 1
    if live >= sms:
        assert split == 1


def test_split_k_plan_at_the_main_path_shapes():
    """Granite's decode shapes have a few dozen live blocks: the gate
    (32 kept column tiles at capacity 0.5) splits 4 ways, the down
    product (16 column tiles) takes the portable cluster of 8; at 256
    rows the down product (64 blocks) splits in 2 and the gate (256)
    does not; the expert grid does not split."""
    assert split_k.plan(1, 8, 2048, 8192, sms=132, capacity=32) == (4, 4)
    assert split_k.plan(1, 8, 8192, 2048, sms=132) == (8, 8)
    assert split_k.plan(1, 256, 8192, 2048, sms=132) == (2, 32)
    assert split_k.plan(1, 256, 2048, 8192, sms=132,
                        capacity=1024) == (1, 16)
    assert split_k.plan(160, 8, 5120, 1536, sms=132, capacity=12) == (1, 40)
    assert split_k.plan(1, 8192, 144, 384, sms=132) == (1, 2)


KDIM_GARBAGE_SHAPES = [(16, 256, 128), (24, 384, 300), (72, 256, 200),
                       (13, 200, 96)]


@pytest.mark.parametrize("shape", KDIM_GARBAGE_SHAPES)
def test_masked_matmul_kdim_ignores_garbage_in_dead_pairs(shape):
    """x holds non-zero values in its dead (row block, k block) pairs:
    the port equals JAX's Pallas kernel (interpret mode), which skips
    those pairs, and equals its own result on the zeroed x bit for bit
    — the semantics a kernel grouping 8 row blocks must keep."""
    M, K, N = shape
    rng = np.random.default_rng(M * 5 + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    mask = _tile_mask(rng, -(-M // 8), -(-K // 128), p=0.5)
    mask[0, 0], mask[-1, -1] = True, False
    keep = np.repeat(np.repeat(mask, 8, 0), 128, 1)[:M, :K]
    assert np.abs(x[~keep]).min() > 0          # garbage everywhere dead
    want = jops.masked_matmul_kdim(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(mask))
    got = tops.masked_matmul_kdim(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    zeroed = tops.masked_matmul_kdim(torch.from_numpy(np.where(keep, x, 0)),
                                     torch.from_numpy(w),
                                     torch.from_numpy(mask))
    assert torch.equal(got, zeroed)


def test_masked_matmul_kdim_expert_grid_ignores_garbage():
    """The expert grid with garbage in every dead pair, and an expert
    whose pairs are all dead (capacity padding): per expert equal to the
    JAX Pallas kernel, vmapped as the JAX package runs it."""
    E, M, K, N = 3, 16, 256, 128
    rng = np.random.default_rng(11)
    x = rng.normal(size=(E, M, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    mask = rng.random((E, M // 8, K // 128)) < 0.5
    mask[1] = False
    want = jax.vmap(lambda a, b, m: jmm.masked_matmul_kdim(
        a, b, m, tile_m=8, tile_k=128, bn=128, interpret=True))(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(mask))
    got = tmm.masked_matmul_kdim(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize("call", ["mor", "gather", "kdim", "paged",
                                  "binary", "packed", "masked"])
def test_kernel_entry_raises_off_cpu_without_fallback(call):
    """A tensor that is not on the CPU never reaches a plain version:
    off the CPU the entry launches the CUDA kernel or raises."""
    x = torch.empty((8, 128), device="meta")
    w = torch.empty((128, 128), device="meta")
    before = (tmp.launches, tgm.launches, tmm.launches, tpa.launches,
              tbd.launches, tbdp.launches, tmm.masked_launches)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        if call == "binary":
            tbd.binary_dot(x, w)
        elif call == "packed":
            tbdp.binary_dot_packed(x, torch.empty((16, 128),
                                                  dtype=torch.uint8,
                                                  device="meta"))
        elif call == "masked":
            tmm.masked_matmul(x, w, torch.ones((1, 1), dtype=torch.bool))
        elif call == "mor":
            tmp.mor_tile_mask(x, w, torch.empty((6, 128), device="meta"),
                              torch.empty((8, 128), dtype=torch.int8,
                                          device="meta"))
        elif call == "gather":
            tgm.gather_matmul(x, w, torch.ones((1, 1), dtype=torch.bool),
                              capacity=1)
        elif call == "paged":
            pool = torch.empty((3, 8, 2, 64), device="meta")
            tpa.gqa_paged_flash(
                torch.empty((2, 1, 4, 64), device="meta"), pool, pool,
                torch.empty((3, 8), dtype=torch.int32, device="meta"),
                torch.ones((2, 1), dtype=torch.int32),
                torch.zeros((2, 1), dtype=torch.int32, device="meta"))
        else:
            tmm.masked_matmul_kdim(x, w, torch.ones((1, 1),
                                                    dtype=torch.int32))
    assert (tmp.launches, tgm.launches, tmm.launches, tpa.launches,
            tbd.launches, tbdp.launches, tmm.masked_launches) == before


def test_kernel_sources_are_in_the_package():
    """The CUDA sources the build compiles ship with the package."""
    from repro_torch.kernels import build
    assert {"paged_attention.cu", "binary_dot.cu",
            "binary_dot_packed.cu"} <= set(build.SOURCES)
    assert set(build.SIGNATURES) >= {"mor_tile_mask", "gather_matmul",
                                     "masked_matmul_kdim", "gqa_paged_flash",
                                     "masked_matmul", "binary_dot",
                                     "binary_dot_packed"}
    for name in build.SOURCES + build.HEADERS:
        src = (build._CSRC / name).read_text()
        assert "repro/kernels" in src or name.endswith(".cuh")
    assert build.build_dir().parts[-2:] == ("build", "repro_torch_kernels")


def test_kernel_signatures_match_the_c_entries():
    """Each ctypes signature the build binds has the C entry's arity and
    kinds (pointer, int, float): ctypes cannot check a call against the
    library, and a wrong count passes a 64-bit pointer as an int."""
    import ctypes
    import re
    from repro_torch.kernels import build
    src = "".join((build._CSRC / n).read_text() for n in build.SOURCES)
    kinds = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    for name, argtypes in build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m.group(1).split(",")]
        want = "".join("p" if "*" in p else "f" if p.startswith("float")
                       else "i" for p in params)
        assert "".join(kinds[a] for a in argtypes) == want, name


# -- the kernel API: binary_dot, binary_dot_packed, masked_matmul ------------

# tests/test_kernels.py's sweep
API_SHAPES = [(8, 128, 128), (16, 256, 384), (48, 200, 300),
              (128, 512, 256), (5, 64, 130)]
API_DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _both(a, dtypes):
    """The same numpy array as a JAX and a torch array of one dtype (the
    float32 -> bfloat16 cast rounds to nearest even in both)."""
    jd, td = dtypes
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


@pytest.mark.parametrize("shape", API_SHAPES)
@pytest.mark.parametrize("dtypes", API_DTYPES, ids=["f32", "bf16"])
def test_binary_dot_matches_jax(shape, dtypes):
    """``ops.binary_dot`` (padded, k_pad added back) bit-equal to the JAX
    wrapper over Pallas in interpret mode, incl. ragged M, K and N."""
    M, K, N = shape
    rng = np.random.default_rng(M * 3 + K + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[:, ::5] = 0.0                          # post-ReLU zeros sign to -1
    w = rng.normal(size=(K, N)).astype(np.float32)
    w[::7] = 0.0                             # zero weights sign to +1
    xj, xt = _both(x, dtypes)
    wj, wt = _both(w, dtypes)
    want = np.asarray(jops.binary_dot(xj, wj))
    got = tops.binary_dot(xt, wt)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.binary_dot_ref(xj, wj)))


@pytest.mark.parametrize("shape", API_SHAPES)
@pytest.mark.parametrize("with_counts", [False, True])
def test_masked_matmul_matches_jax(shape, with_counts):
    """``ops.masked_matmul`` against the JAX wrapper: output allclose
    (float32, rtol = atol = 1e-5), dead tiles exact zeros, and the live
    count equal, an int32 tensor."""
    M, K, N = shape
    rng = np.random.default_rng(M + K * 3 + N)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32) / np.sqrt(K)
    mask = rng.random((-(-M // 8), -(-N // 128))) > 0.5
    mask.flat[0] = True
    want = jops.masked_matmul(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(mask), with_counts=with_counts)
    got = tops.masked_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(mask), with_counts=with_counts)
    if with_counts:
        (want, n_want), (got, n_got) = want, got
        assert n_got.dtype == torch.int32 and n_got.ndim == 0
        assert int(n_got) == int(n_want) == int(mask.sum())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    keep = np.repeat(np.repeat(mask, 8, 0), 128, 1)[:M, :N]
    assert np.all(got.numpy()[~keep] == 0.0)


@pytest.mark.parametrize("shape", [(16, 256, 384), (5, 64, 130)])
def test_masked_matmul_bf16_matches_jax(shape):
    """bfloat16 operands: both sum float32 products in float32 and round
    once to bfloat16, so the two agree to one bfloat16 step (rtol
    2^-7), plus 1e-2 absolute for sums near zero."""
    M, K, N = shape
    rng = np.random.default_rng(K)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32) / np.sqrt(K)
    mask = rng.random((-(-M // 8), -(-N // 128))) > 0.3
    xj, xt = _both(x, API_DTYPES[1])
    wj, wt = _both(w, API_DTYPES[1])
    want = jops.masked_matmul(xj, wj, jnp.asarray(mask))
    got = tops.masked_matmul(xt, wt, torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2 ** -7,
                               atol=1e-2)


@pytest.mark.parametrize("K", [8, 64, 100, 512])
def test_pack_signs_matches_jax(K):
    """The JAX package's bit layout, bit for bit: bit b of packed[k8, n]
    is w[8 k8 + b, n] < 0; padded rows (K % 8) are positive."""
    rng = np.random.default_rng(K)
    w = rng.normal(size=(K, 130)).astype(np.float32)
    w[::3, ::4] = 0.0
    want = np.asarray(jbdp.pack_signs(jnp.asarray(w)))
    got = tbdp.pack_signs(torch.from_numpy(w))
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tbdp.unpack_signs(got, K).numpy(),
        np.asarray(jbdp.unpack_signs(jnp.asarray(want), K)))


@pytest.mark.parametrize("shape", [(16, 128, 256), (32, 512, 384),
                                   (128, 1024, 128)])
def test_binary_dot_packed_matches_jax(shape):
    """``binary_dot_packed`` on ``pack_signs(w)``: bit-equal to the JAX
    kernel (interpret mode) and to the port's ``binary_dot``."""
    M, K, N = shape
    rng = np.random.default_rng(M + K)
    x = rng.normal(size=(M, K)).astype(np.float32)
    x[::2, ::3] = 0.0
    w = rng.normal(size=(K, N)).astype(np.float32)
    packed = np.array(jbdp.pack_signs(jnp.asarray(w)))
    want = np.asarray(jbdp.binary_dot_packed(jnp.asarray(x),
                                             jnp.asarray(packed),
                                             interpret=True))
    got = tbdp.binary_dot_packed(torch.from_numpy(x),
                                 torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tops.binary_dot(torch.from_numpy(x),
                                     torch.from_numpy(w)).numpy())


def test_binary_dot_packed_needs_k_multiple_of_8():
    with pytest.raises(ValueError, match="must be 8 x"):
        tbdp.binary_dot_packed(torch.zeros(4, 12),
                               torch.zeros(2, 8, dtype=torch.uint8))


# -- the kernel API on the CUDA path: no padding, the planners ---------------

# paper-conv-like im2col shapes at a small M: CNN10's first 3 x 3 layer
# (K = 9 x 32), ResNet18's 64-channel layers, a 128-channel layer
PAPER_CONV_SHAPES = [(40, 288, 32), (64, 576, 64), (24, 1152, 128)]


@pytest.mark.parametrize("shape", PAPER_CONV_SHAPES)
@pytest.mark.parametrize("dtypes", API_DTYPES, ids=["f32", "bf16"])
def test_kernel_api_at_paper_conv_shapes(shape, dtypes):
    """Both kernels at paper-conv shapes against the JAX wrappers over
    Pallas in interpret mode, through ``ops`` (the JAX-mirroring padding
    on the CPU) and through the kernel module on the operands as they
    are (what the CUDA path hands it): ``binary_dot`` bit-equal,
    ``masked_matmul`` within float32 rounding (float32) or one bfloat16
    step (bfloat16), dead tiles exact zeros either way."""
    M, K, N = shape
    rng = np.random.default_rng(M + K + N)
    x = np.maximum(rng.normal(size=(M, K)), 0.0).astype(np.float32)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    mask = rng.random((-(-M // 8), -(-N // 128))) > 0.4
    mask.flat[0] = True
    xj, xt = _both(x, dtypes)
    wj, wt = _both(w, dtypes)
    want_b = np.asarray(jops.binary_dot(xj, wj))
    want_m = np.asarray(jops.masked_matmul(xj, wj, jnp.asarray(mask)),
                        np.float32)
    f32 = dtypes[1] == torch.float32
    rtol, atol = (RTOL, ATOL) if f32 else (2 ** -7, 1e-2)
    keep = np.repeat(np.repeat(mask, 8, 0), 128, 1)[:M, :N]
    for bd, mm in ((tops.binary_dot, tops.masked_matmul),
                   (tbd.binary_dot, tmm.masked_matmul)):
        np.testing.assert_array_equal(bd(xt, wt).numpy(), want_b)
        got_m = mm(xt, wt, torch.from_numpy(mask))
        assert got_m.dtype == dtypes[1] and got_m.shape == (M, N)
        np.testing.assert_allclose(got_m.float().numpy(), want_m,
                                   rtol=rtol, atol=atol)
        assert np.all(got_m.float().numpy()[~keep] == 0.0)


@pytest.mark.parametrize("dtypes", API_DTYPES, ids=["f32", "bf16"])
def test_binary_dot_sign_conventions_match_jax(dtypes):
    """The signs the CUDA kernel must reproduce, pinned against
    ``ref.binary_dot_ref``: a zero activation is -1, a -0.0 weight +1
    (the comparison w >= 0, not the sign bit), NaN is -1 in x and in w;
    and the JAX wrapper over Pallas agrees, with and without padding."""
    M, K, N = 16, 100, 130
    rng = np.random.default_rng(7)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    x[:, ::5] = 0.0
    w[::3] = -0.0
    x[0, 1] = x[5, 7] = np.nan
    w[2, 3] = w[9, 0] = np.nan
    assert np.signbit(w[0]).all() and (w[0] == 0).all()
    xj, xt = _both(x, dtypes)
    wj, wt = _both(w, dtypes)
    want = np.asarray(jref.binary_dot_ref(xj, wj))
    np.testing.assert_array_equal(np.asarray(jops.binary_dot(xj, wj)), want)
    for bd in (tops.binary_dot, tbd.binary_dot):   # padded, as they are
        np.testing.assert_array_equal(bd(xt, wt).numpy(), want)
    # one row of +-1 by hand: x row 0 against w column 0
    xs = np.where(x[0] > 0, 1.0, -1.0)
    ws = np.where(w[:, 0] >= 0, 1.0, -1.0)
    assert ws[0] == 1.0 and ws[9] == -1.0 and xs[1] == -1.0
    assert float(tbd.binary_dot_plain(xt, wt)[0, 0]) == float(xs @ ws)


def test_kernel_api_plans_at_the_main_path_shapes():
    """The split plans of the two kernel-API kernels at ``chip_smoke.py``'s
    shapes (132 SMs).  masked_matmul (``split_k.plan``, no capacity, the
    mask never read): granite's gate at 8 rows has 64 column tiles and
    splits K in 2, at 256 rows 256 blocks do not split; Darknet19's
    layer 13 (2 x 8 tiles) takes the portable cluster of 8; ResNet18's
    layer 1 (2,048 row groups) does not split.  binary_dot
    (``binary_dot.plan``): 16 x 128 tiles split 4 ways at decode, 128 x
    64 tiles at 256 rows and at ResNet18's layer 1, 64 x 64 tiles split 8
    ways at Darknet19's layer 13."""
    assert split_k.plan(1, 8, 2048, 8192, sms=132) == (2, 8)
    assert split_k.plan(1, 256, 2048, 8192, sms=132) == (1, 16)
    assert split_k.plan(1, 128, 4608, 1024, sms=132) == (8, 5)
    assert split_k.plan(1, 131072, 576, 64, sms=132) == (1, 5)
    assert tbd.plan(8, 2048, 8192, sms=132) == (16, 128, 4, 4)
    assert tbd.plan(256, 2048, 8192, sms=132) == (128, 64, 1, 16)
    assert tbd.plan(128, 4608, 1024, sms=132) == (64, 64, 8, 5)
    assert tbd.plan(131072, 576, 64, sms=132) == (128, 64, 1, 5)


def _bd_plan_cases():
    """The paper conv layers' shapes at a batch of 128, then a seeded
    sweep: (M, K, N, sms)."""
    cases = [(131072, 576, 64, 132), (32768, 1152, 128, 132),
             (8192, 2304, 256, 132), (2048, 4608, 512, 132),
             (128, 9216, 1024, 132), (5, 100, 130, 132), (1, 1, 1, 132)]
    rng = np.random.default_rng(1)
    for _ in range(9):
        cases.append((int(rng.integers(1, 5000)), int(rng.integers(1, 9000)),
                      int(rng.integers(1, 3000)),
                      int(rng.choice([78, 114, 132]))))
    return cases


@pytest.mark.parametrize("M,K,N,sms", _bd_plan_cases())
def test_binary_dot_plan_picks_a_built_tile_and_tiles_k(M, K, N, sms):
    """binary_dot's plan: a tile the C entry instantiates (16 x 128 at a
    decode dispatch, else 64 or 128 x 64), 128 rows only where 64-row
    tiles outnumber the SMs; split-K segments that tile [0, K) in whole
    128-wide k blocks, at most 8, none empty, and no more than two
    blocks an SM still hold."""
    bm, bn, split, kb_per = tbd.plan(M, K, N, sms=sms)
    assert (bm, bn) in {(16, 128), (64, 64), (128, 64)}
    assert (bm == 16) == (M <= 16)
    if bm > 16:
        assert (bm == 128) == (-(-M // 64) * -(-N // 64) > sms)
    segs = [(r * kb_per * 128, min(K, (r + 1) * kb_per * 128))
            for r in range(split)]
    assert 1 <= split <= 8 and segs[0][0] == 0 and segs[-1][1] == K
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(segs, segs[1:]))
    assert all(k0 < k1 for k0, k1 in segs)
    tiles = -(-M // bm) * -(-N // bn)
    assert tiles * split <= tbd.RESIDENT * sms or split == 1


# (M, K, N): granite's gate at 8 and 256 rows, Darknet19's layer 13,
# ResNet18's layer 1, and chip_smoke.py's ragged packed shape
PACKED_MAIN_SHAPES = [(8, 2048, 8192), (256, 2048, 8192),
                      (128, 4608, 1024), (131072, 576, 64), (24, 104, 130)]
PACKED_TILES = {(16, 128), (64, 64), (128, 64), (64, 128)}


@pytest.mark.parametrize("M,K,N", PACKED_MAIN_SHAPES)
def test_binary_dot_packed_plan_picks_a_built_tile_and_tiles_k(M, K, N):
    """The packed plan (``binary_dot.plan(..., packed=True)``) at the
    main path's shapes on 132 SMs: a tile ``binary_dot_packed``'s C entry
    instantiates, 64 x 128 wherever N > 64, M > 16 and those tiles fit
    two blocks an SM, else ``binary_dot``'s; split-K segments that tile
    [0, K) in whole 128-wide k blocks, at most 8, none empty."""
    bm, bn, split, kb_per = tbd.plan(M, K, N, sms=132, packed=True)
    assert (bm, bn) in PACKED_TILES
    assert (bm == 16) == (M <= 16)
    wide = N > 64 and -(-M // 64) * -(-N // 128) <= tbd.RESIDENT * 132
    if M > 16:
        assert ((bm, bn) == (64, 128)) == wide
        if not wide:
            assert (bm, bn) == tbd.plan(M, K, N, sms=132)[:2]
    segs = [(r * kb_per * 128, min(K, (r + 1) * kb_per * 128))
            for r in range(split)]
    assert 1 <= split <= 8 and segs[0][0] == 0 and segs[-1][1] == K
    assert all(k0 < k1 for k0, k1 in segs)
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(segs, segs[1:]))


def test_binary_dot_packed_plans_at_the_main_path_shapes():
    """The packed tiles at those shapes: decode as ``binary_dot``'s (16 x
    128, K split 4 ways); 64 x 128 at 256 rows (x's signs made once per
    128 columns, not 64; 256 tiles fill two blocks an SM unsplit) and at
    Darknet19's layer 13, split 8; ResNet18's layer 1 (N = 64) keeps
    ``binary_dot``'s 128 x 64."""
    assert tbd.plan(8, 2048, 8192, sms=132, packed=True) == (16, 128, 4, 4)
    assert tbd.plan(256, 2048, 8192, sms=132, packed=True) == \
        (64, 128, 1, 16)
    assert tbd.plan(128, 4608, 1024, sms=132, packed=True) == \
        (64, 128, 8, 5)
    assert tbd.plan(131072, 576, 64, sms=132, packed=True) == \
        (128, 64, 1, 5)
    assert tbd.plan(24, 104, 130, sms=132, packed=True) == (64, 128, 1, 1)


def test_packed_sign_spread_matches_unpack_signs():
    """The weight stage's bit spread (``sign_mma.cuh`` ``spread_signs``:
    a nibble times 0x00204081, masked with 0x01010101, then 0 -> 0x01
    and 1 -> 0xFF) turns every byte into the 8 int8 signs
    ``unpack_signs`` gives for its 8 rows, row 8 k8 + b at byte b."""
    b = np.arange(256, dtype=np.uint32)
    words = []
    for nib in (b & 0xF, b >> 4):
        bits = (nib * np.uint32(0x00204081)) & np.uint32(0x01010101)
        words.append(bits * np.uint32(0xFE) | np.uint32(0x01010101))
    spread = np.stack(words, 1).astype("<u4").view(np.int8).reshape(256, 8)
    want = tbdp.unpack_signs(torch.arange(256, dtype=torch.uint8)[None, :],
                             8).numpy().T
    np.testing.assert_array_equal(spread, want)


def test_binary_dot_packed_at_the_ragged_shape():
    """chip_smoke.py's ragged packed case (M 24, K 104, N 130: 13 packed
    rows, a last column chunk of 2, shapes the JAX kernel's blocks do
    not take unpadded): bit-equal to ``ref.binary_dot_ref`` on the
    unpacked weight and to ``binary_dot`` on the same operands."""
    rng = np.random.default_rng(104)
    x = rng.normal(size=(24, 104)).astype(np.float32)
    x[::3, ::2] = 0.0
    w = rng.normal(size=(104, 130)).astype(np.float32)
    packed = np.array(jbdp.pack_signs(jnp.asarray(w)))
    want = np.asarray(jref.binary_dot_ref(jnp.asarray(x), jnp.asarray(w)))
    got = tbdp.binary_dot_packed(torch.from_numpy(x),
                                 torch.from_numpy(packed))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), tbd.binary_dot(torch.from_numpy(x),
                                    torch.from_numpy(w)).numpy())


@pytest.mark.parametrize("shape", [(5, 100, 130), (40, 288, 32),
                                   (13, 37, 129), (64, 576, 64)])
@pytest.mark.parametrize("element_size", [4, 2])
def test_cuda_operand_preparation_meets_the_c_entries(shape, element_size):
    """The CUDA path's operand preparation (pure functions on shapes):
    ``ops.launch_pads`` pads nothing for either kernel; masked_matmul's
    module rounds K and N up to a 16-byte chunk (``chunk_pads``), less
    than a chunk, as its C entry takes; binary_dot's C entry takes any
    M, K, N.  On the CPU the chunk-padded operands give the unpadded
    product's columns (zeros add nothing), the kernel modules on the
    unpadded operands equal the JAX-mirroring path, and the off-CUDA
    pads are the JAX wrapper's."""
    M, K, N = shape
    for kernel in ("binary_dot", "masked_matmul"):
        assert tops.launch_pads(kernel, M, K, N, cuda=True) == (0, 0, 0)
    epc = 16 // element_size
    pk, pn = tmm.chunk_pads(K, N, element_size)
    assert 0 <= pk < epc and 0 <= pn < epc
    assert (K + pk) % epc == 0 and (N + pn) % epc == 0
    bm_, bk_, bn_ = min(128, max(M, 8)), min(512, K), min(128, N)
    assert tops.launch_pads("binary_dot", M, K, N, cuda=False) == (
        (-M) % bm_, (-K) % bk_, (-N) % bn_)
    assert tops.launch_pads("masked_matmul", M, K, N, cuda=False) == (
        (-M) % 8, 0, (-N) % 128)
    rng = np.random.default_rng(M + K + N + element_size)
    dt = torch.float32 if element_size == 4 else torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dt)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(dt)
    mask = torch.from_numpy(rng.random((-(-M // 8), -(-N // 128))) > 0.3)
    xp = torch.nn.functional.pad(x, (0, pk))
    wp = torch.nn.functional.pad(w, (0, pn, 0, pk))
    want = tmm.masked_matmul_plain(x, w, mask).float()
    got = tmm.masked_matmul_plain(xp, wp, mask)[:, :N].float()
    rtol, atol = (RTOL, ATOL) if element_size == 4 else (2 ** -7, 1e-2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                               atol=atol)
    assert torch.equal(tbd.binary_dot(x, w), tops.binary_dot(x, w))
    np.testing.assert_allclose(
        tmm.masked_matmul(x, w, mask).float().numpy(),
        tops.masked_matmul(x, w, mask).float().numpy(), rtol=rtol,
        atol=atol)
