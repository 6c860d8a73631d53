"""The port's MoR kernel wrappers against the JAX wrappers.

On the CPU each wrapper of ``repro_torch.kernels.ops`` runs its kernel's
plain PyTorch version; the JAX side runs the Pallas kernels in interpret
mode (the default off-TPU).  The same inputs come from a numpy seed.
Masks and counters must be equal; float outputs agree to float32
rounding (rtol = atol = 1e-5: both sum float32 products, in different
orders, over at most 384 terms of magnitude ~1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import predictor as tpred
from repro_torch.kernels import gather_matmul as tgm
from repro_torch.kernels import masked_matmul as tmm
from repro_torch.kernels import mor_predict as tmp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

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


@pytest.mark.parametrize("call", ["mor", "gather", "kdim", "paged"])
def test_kernel_entry_raises_off_cpu_without_fallback(call):
    """A tensor that is not on the CPU never reaches a plain version:
    off the CPU the entry launches the CUDA kernel or raises."""
    x = torch.empty((8, 128), device="meta")
    w = torch.empty((128, 128), device="meta")
    before = (tmp.launches, tgm.launches, tmm.launches, tpa.launches)
    with pytest.raises(ValueError, match="no CUDA kernel"):
        if call == "mor":
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
    assert (tmp.launches, tgm.launches, tmm.launches,
            tpa.launches) == before


def test_kernel_sources_are_in_the_package():
    """The CUDA sources the build compiles ship with the package."""
    from repro_torch.kernels import build
    assert "paged_attention.cu" in build.SOURCES
    assert set(build.SIGNATURES) >= {"mor_tile_mask", "gather_matmul",
                                     "masked_matmul_kdim", "gqa_paged_flash"}
    for name in build.SOURCES + build.HEADERS:
        src = (build._CSRC / name).read_text()
        assert "repro/kernels" in src or name.endswith(".cuh")
    assert build.build_dir().parts[-2:] == ("build", "repro_torch_kernels")
