"""Fused MoR tile-mask predictor: the CUDA kernel
(``csrc/mor_predict.cu`` on ``csrc/sign_mma.cuh``, binary_dot's int8
tensor-core core), its plain PyTorch version, the tile and split-K plan,
and the launch counter.

Replaces ``repro/kernels/mor_predict.py`` ``mor_tile_mask`` (Pallas).
Bound on the H100: bytes — the whole weight is read for its signs; see
the source for what the design does about it.

The coef table carries six rows: [m, b, bn_scale, bn_bias, enable,
res_scale]; ``proxy_neg`` is tri-state int8 (0/1 = the proxy rookie's
verdict, 2 = forced skip: padding).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import split_k
from repro_torch.kernels.binary_dot import RESIDENT
from repro_torch.kernels.build import check
from repro_torch.kernels.launch import (counted, cuda_stream, dense16,
                                        dtype_code, lib, ptr)

N_COEF_ROWS = 6
TILE_M, TILE_N = 8, 128     # the CUDA kernel's fixed mask geometry

# kernel launches since the last reset (the smoke run zeroes it)
launches = 0


def mor_tile_mask_plain(x: torch.Tensor, w: torch.Tensor,
                        coef: torch.Tensor, proxy_neg: torch.Tensor,
                        residual: Optional[torch.Tensor] = None, *,
                        tile_m: int = TILE_M,
                        tile_n: int = TILE_N) -> torch.Tensor:
    """Plain version (the port of ``repro.kernels.ref.mor_tile_mask_ref``
    on the kernel's padded interface).  x: (M, K), w: (K, N) with
    M % tile_m == 0 and N % tile_n == 0 -> (M/tile_m, N/tile_n) int32.
    The expert grid adds a leading E dim to every operand (coef (E, 6,
    N)) and to the result."""
    M, N = x.shape[-2], w.shape[-1]
    xs = torch.where(x > 0, 1.0, -1.0).float()
    ws = torch.where(w >= 0, 1.0, -1.0).float()
    p_bin = xs @ ws                       # exact: integers below 2^24
    m, b, sc, bi, en, rs = (coef[..., i, :].unsqueeze(-2)
                            for i in range(N_COEF_ROWS))
    p_hat = (m * p_bin + b) * sc + bi
    if residual is not None:
        p_hat = p_hat + rs * residual
    skip = ((p_hat < 0.0) & (en > 0.5) & (proxy_neg == 1)) | (proxy_neg > 1)
    t = (~skip).reshape(*x.shape[:-2], M // tile_m, tile_m, N // tile_n,
                        tile_n)
    return t.any(dim=-1).any(dim=-2).int()


def work(x: torch.Tensor, w: torch.Tensor, coef: torch.Tensor,
         proxy_neg: torch.Tensor, residual: Optional[torch.Tensor] = None,
         **_) -> Tuple[int, int, str]:
    """-> (bytes, operations, kind) of one call on these inputs: every
    proxy state (the early exit reads them); for each expert holding a
    live row (one whose proxy states are not all 2, forced skip) its
    whole weight and coef table; x's rows of every 8-row block holding
    a live row; the residual; the tile bits out.  Operations: a sign
    product of K for each (row of such a block, column), on the int8
    tensor cores.  Reads the proxy states back."""
    E = x.shape[0] if x.ndim == 3 else 1
    M, K = x.shape[-2:]
    N = w.shape[-1]
    elt = x.element_size()
    live = (proxy_neg != 2).any(-1).reshape(E, M // TILE_M, TILE_M)
    busy = int(live.any(-1).any(-1).sum())
    row_blocks = int(live.any(-1).sum())
    nbytes = (proxy_neg.numel() + busy * (K * N * elt + N_COEF_ROWS * N * 4)
              + row_blocks * TILE_M * K * elt
              + (0 if residual is None else residual.numel() * 4)
              + E * (M // TILE_M) * (N // TILE_N) * 4)
    return nbytes, row_blocks * TILE_M * 2 * K * N, "int8"


@counted("mor_tile_mask", work)
def mor_tile_mask(x: torch.Tensor, w: torch.Tensor, coef: torch.Tensor,
                  proxy_neg: torch.Tensor,
                  residual: Optional[torch.Tensor] = None, *,
                  tile_m: int = TILE_M, tile_n: int = TILE_N
                  ) -> torch.Tensor:
    """Padded-interface entry: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor, an error for anything else.  2-D
    operands are one FFN; 3-D operands (leading E) the expert grid."""
    if x.device.type == "cpu":
        return mor_tile_mask_plain(x, w, coef, proxy_neg, residual,
                                   tile_m=tile_m, tile_n=tile_n)
    return _launch(x, w, coef, proxy_neg, residual, tile_m, tile_n)


def plan(E: int, M: int, K: int, N: int, *,
         sms: int) -> Tuple[int, int, int, int]:
    """-> (bm, bn, split, kb_per): the kernel's tile and its split-K over
    a cluster.  The column tile is the mask's 128 columns, so no mask
    block spans two blocks; 16 rows at a decode dispatch (M <= 16: the
    expert grid's capacity of 8 too), else 64.  ``split_k.split_over``
    splits K until the E x row x column tiles fill one wave of
    ``binary_dot.RESIDENT`` blocks an SM.  Pure Python on host ints."""
    bm = 16 if M <= 16 else 64
    tiles = E * -(-M // bm) * -(-N // TILE_N)
    split, kb_per = split_k.split_over(tiles, K, sms=RESIDENT * sms)
    return bm, TILE_N, split, kb_per


def _launch(x, w, coef, proxy_neg, residual, tile_m, tile_n):
    global launches
    stream = cuda_stream(x.device)
    if (tile_m, tile_n) != (TILE_M, TILE_N):
        raise ValueError(f"the CUDA kernel takes tile ({TILE_M}, {TILE_N}),"
                         f" got ({tile_m}, {tile_n})")
    lead = tuple(x.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"at most one leading (expert) dim, got {lead}")
    E = lead[0] if lead else 1
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if M % TILE_M or N % TILE_N or tuple(w.shape) != lead + (K, N):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    if tuple(coef.shape) != lead + (N_COEF_ROWS, N) or \
            coef.dtype != torch.float32:
        raise ValueError("coef must be (..., 6, N) float32")
    if tuple(proxy_neg.shape) != lead + (M, N) or \
            proxy_neg.dtype != torch.int8:
        raise ValueError("proxy_neg must be (..., M, N) int8")
    if residual is not None and (tuple(residual.shape) != lead + (M, N)
                                 or residual.dtype != torch.float32):
        raise ValueError("residual must be (..., M, N) float32")
    code = dtype_code(x, w)
    bm, _, split, kb_per = plan(E, M, K, N, sms=split_k.sm_count(x.device))
    out = torch.empty(lead + (M // TILE_M, N // TILE_N), dtype=torch.int32,
                      device=x.device)
    # the epilogue reads coef, the proxy states and the residual 16 bytes
    # at a time
    args = [x, w, dense16(coef), dense16(proxy_neg),
            None if residual is None else dense16(residual), out]
    err = lib().mor_tile_mask(*(ptr(a, x.device) for a in args), E, M, K,
                              N, bm, split, kb_per, code, stream)
    launches += 1
    check(err, "mor_tile_mask")
    return out
