"""Public wrappers around the MoR kernels (the kernel API): shape
padding, the K-pad compensation, the tri-state pad sentinel, and the
MoRLayer-facing coef table — the counterpart of ``repro/kernels/ops.py``.

Each wrapper pads exactly as the JAX wrapper does, then calls the kernel
module, which launches the CUDA kernel for a CUDA tensor and runs its
plain PyTorch version for a CPU tensor.  ``binary_dot`` and
``masked_matmul`` pad only off CUDA: their CUDA kernels take the
operands as they are (``launch_pads``).  Every operand may carry a
leading expert dim E: that is the expert grid (``executor.expert_ffn``,
where the JAX package vmaps the Pallas calls), one launch for all
experts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import binary_dot as _bd
from repro_torch.kernels import gather_matmul as _gm
from repro_torch.kernels import masked_matmul as _mm
from repro_torch.kernels import mor_predict as _mp

# the JAX wrappers' blocks, which decide how far they pad off CUDA:
# binary_dot's (bm, bk, bn) and masked_matmul's contraction block (the
# CUDA kernels themselves take any M, K, N: ``launch_pads``)
BD_BM, BD_BK, BD_BN = 128, 512, 128
MM_BK = 512


def _pad_to(x: torch.Tensor, mult0: int, mult1: int,
            value=0) -> torch.Tensor:
    """Pad the last two dims up to multiples of (mult0, mult1)."""
    p0 = (-x.shape[-2]) % mult0
    p1 = (-x.shape[-1]) % mult1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0), value=value)
    return x


def _pad_mask(mask: torch.Tensor, nm: int, nn: int) -> torch.Tensor:
    """A tile mask padded with dead tiles up to (..., nm, nn)."""
    if tuple(mask.shape[-2:]) == (nm, nn):
        return mask
    return F.pad(mask.int(), (0, nn - mask.shape[-1],
                              0, nm - mask.shape[-2]))


def _bk(K: int, bk: int) -> int:
    """The JAX wrapper's contraction block: ``bk`` when it divides K,
    else K itself (so the contraction is never padded)."""
    bk_ = min(bk, K)
    return bk_ if K % bk_ == 0 else K


def launch_pads(kernel: str, M: int, K: int, N: int, *,
                cuda: bool) -> Tuple[int, int, int]:
    """Zero padding (rows, contraction, columns) that ``binary_dot`` /
    ``masked_matmul`` add before the kernel module.  Off CUDA they pad as
    the JAX wrapper pads for its Pallas blocks: binary_dot's (BD_BM,
    BD_BK, BD_BN), masked_matmul's 8 x 128 output tiles (its K block
    divides K, so K is never padded).  The CUDA kernels take any M, K, N
    (masked_matmul's module rounds K and N to a 16-byte chunk itself,
    ``masked_matmul.chunk_pads``), so the CUDA path pads nothing.  Pure
    Python on host ints."""
    if kernel not in ("binary_dot", "masked_matmul"):
        raise ValueError(f"no padding rule for {kernel!r}")
    if cuda:
        return 0, 0, 0
    if kernel == "binary_dot":
        bm_, bk_, bn_ = min(BD_BM, max(M, 8)), min(BD_BK, K), min(BD_BN, N)
        return (-M) % bm_, (-K) % bk_, (-N) % bn_
    return (-M) % _mm.TILE_M, (-K) % _bk(K, MM_BK), (-N) % _mm.TILE_N


def _padded(kernel, x, w):
    """(x, w) padded as ``launch_pads`` says for x's device, and the
    padding (rows, contraction, columns)."""
    M, K = x.shape
    pm, pk, pn = launch_pads(kernel, M, K, w.shape[1],
                             cuda=x.device.type != "cpu")
    if pm or pk:
        x = F.pad(x, (0, pk, 0, pm))
    if pk or pn:
        w = F.pad(w, (0, pn, 0, pk))
    return x, w, (pm, pk, pn)


def binary_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign_act(x) @ sign(w) -> (M, N) float32, padded as
    ``launch_pads`` says for x's device.  A padded k adds sign_act(0) *
    sign(0) = (-1) * (+1) = -1 to every cell, exactly, so it is added
    back."""
    M, K = x.shape
    N = w.shape[1]
    xp, wp, (pm, pk, pn) = _padded("binary_dot", x, w)
    out = _bd.binary_dot(xp.contiguous(), wp.contiguous())
    if pk:
        out = out + float(pk)
    return out[:M, :N] if pm or pn else out


def masked_matmul(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor,
                  *, with_counts: bool = False):
    """x @ w with each (8 x 128) output tile whose mask is 0 written as
    zeros, padded as ``launch_pads`` says for x's device.
    ``with_counts`` also returns the live-tile count of the mask, an
    int32 device tensor (no host sync)."""
    M, K = x.shape
    N = w.shape[1]
    xp, wp, (pm, pk, pn) = _padded("masked_matmul", x, w)
    mask = _pad_mask(tile_mask, -(-(M + pm) // _mm.TILE_M),
                     -(-(N + pn) // _mm.TILE_N))
    out = _mm.masked_matmul(xp.contiguous(), wp.contiguous(), mask)
    if pm or pn:
        out = out[:M, :N]
    if with_counts:
        return out, mask.sum(dtype=torch.int32)
    return out


def gather_matmul(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor,
                  *, capacity: Optional[int] = None,
                  capacity_frac: float = 1.0,
                  capacity_frac_live: Optional[float] = None,
                  tile_m: int = 8, tile_n: int = 128, bk: int = 512,
                  with_counts: bool = False):
    """``capacity``/``capacity_frac`` provision the static slot list;
    ``capacity_frac_live`` (the serving telemetry's calibrated budget)
    clamps the realised live count under it: a host float for one FFN,
    an (E,) float32 device tensor for the expert grid.  ``with_counts``
    also returns (n_live_total, n_computed)."""
    M, K = x.shape[-2:]
    N = w.shape[-1]
    bk_ = _bk(K, bk)
    xp = _pad_to(x, tile_m, bk_)
    wp = _pad_to(w, bk_, tile_n)
    nm = xp.shape[-2] // tile_m
    nn = wp.shape[-1] // tile_n
    mask = _pad_mask(tile_mask, nm, nn)
    if capacity is None:
        capacity = max(1, int(capacity_frac * nm * nn))
    capacity = min(capacity, nm * nn)
    cap_live = None
    if torch.is_tensor(capacity_frac_live):
        # float32 on the device, in the JAX wrapper's order: (frac * nm)
        # * nn, rounded up
        f = capacity_frac_live.float() * nm * nn
        cap_live = torch.clamp(torch.ceil(f), min=1).to(torch.int32)
    elif capacity_frac_live is not None:
        f = np.float32(capacity_frac_live) * np.float32(nm) * np.float32(nn)
        cap_live = max(1, int(np.ceil(f)))
    out, n_live, n_comp = _gm.gather_matmul(
        xp.contiguous(), wp.contiguous(), mask, capacity=capacity,
        cap_live=cap_live,
        tile_m=tile_m, tile_n=tile_n)
    out = out[..., :M, :N]
    if with_counts:
        return out, n_live, n_comp
    return out


def masked_matmul_kdim(x: torch.Tensor, w: torch.Tensor,
                       tile_mask: torch.Tensor, *, tile_m: int = 8,
                       tile_k: int = 128, bn: int = 128) -> torch.Tensor:
    """Contraction-masked matmul (MoR down projection): tile_mask[i, k]
    gates the (tile_m x tile_k) block of x rows feeding output row-block
    i — dead FFN hidden tiles (exact zeros) are skipped."""
    M, K = x.shape[-2:]
    N = w.shape[-1]
    bn_ = min(bn, N)
    xp = _pad_to(x, tile_m, tile_k)
    wp = _pad_to(w, tile_k, bn_)
    # padded x blocks are zero -> mark them dead (skip is exact)
    mask = _pad_mask(tile_mask, xp.shape[-2] // tile_m,
                     xp.shape[-1] // tile_k)
    out = _mm.masked_matmul_kdim(xp.contiguous(), wp.contiguous(), mask,
                                 tile_m=tile_m, tile_k=tile_k)
    return out[..., :M, :N]


def mor_tile_mask(x: torch.Tensor, w_perm: torch.Tensor, mor,
                  proxy_neg: torch.Tensor, *,
                  residual: Optional[torch.Tensor] = None, tile_m: int = 8,
                  tile_n: int = 128, bk: int = 512) -> torch.Tensor:
    """Fused predictor: build the (6, N) coef table from a MoRLayer and
    run the fused kernel.  proxy_neg: (M, N) bool or tri-state int8 (0/1
    = proxy verdict, 2 = forced skip).  Counts as ONE predictor
    evaluation (the expert grid too, as the JAX package's vmapped body
    traces once).  -> (ceil(M/tile_m), ceil(N/tile_n)) bool, with the
    operands' leading E dim if any."""
    from repro_torch.core.predictor import note_predictor_eval
    note_predictor_eval()
    K = x.shape[-1]
    N = w_perm.shape[-1]
    res_row = (torch.ones_like if residual is not None else
               torch.zeros_like)(mor["m"], dtype=torch.float32)
    coef = torch.stack([mor["m"], mor["b"], mor["bn_scale"], mor["bn_bias"],
                        mor["enable"].float(), res_row], -2)
    bk_ = _bk(K, bk)
    xp = _pad_to(x, tile_m, bk_)
    wp = _pad_to(w_perm, bk_, tile_n)
    # K padding adds (-1)*(+1) to every p_bin entry -> pre-compensate b
    k_pad = xp.shape[-1] - K
    if k_pad:
        coef[..., 1, :] = coef[..., 1, :] + coef[..., 0, :] * k_pad
    n_pad = wp.shape[-1] - N
    if n_pad:
        coef = F.pad(coef, (0, n_pad))
    # padded rows/cols must never mark a tile live: proxy_neg = 2 is the
    # kernel's forced-skip sentinel
    pn = _pad_to(proxy_neg.to(torch.int8), tile_m, tile_n, value=2)
    res = None
    if residual is not None:
        res = _pad_to(residual.float(), tile_m, tile_n).contiguous()
    mask = _mp.mor_tile_mask(xp.contiguous(), wp.contiguous(),
                             coef.contiguous(), pn.contiguous(), res,
                             tile_m=tile_m, tile_n=tile_n)
    return mask.bool()
