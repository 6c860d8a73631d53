"""Capacity-compacted MoR matmul: the CUDA kernel
(``csrc/gather_matmul.cu``), its plain PyTorch version, and the launch
counter.

Replaces ``repro/kernels/gather_matmul.py`` ``gather_matmul`` (Pallas).
x (M, K) @ w (K, N) over only the first ``capacity`` live (tile_m x
tile_n) tiles in row-major order, clamped by ``cap_live``; dead and
overflow tiles are exact zeros.  Bound on the H100: bytes — the live
share of the weight; see the source for the design.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import check
from repro_torch.kernels.launch import cuda_stream, dtype_code, lib, ptr

TILE_M, TILE_N = 8, 128

launches = 0


def _budget(capacity: int, cap_live):
    """The slot budget in force: the static ``capacity`` clamped by the
    calibrated ``cap_live`` (never below one tile).  ``cap_live`` is a
    host int, or an (E,) int32 tensor on the operands' device for the
    expert grid (one budget per expert, no host sync)."""
    if cap_live is None:
        return capacity
    if torch.is_tensor(cap_live):
        return torch.clamp(cap_live, min=1, max=capacity).to(torch.int32)
    return min(capacity, max(int(cap_live), 1))


def _counts(flat: torch.Tensor, cap_eff):
    """(n_live_total, n_computed) as int32 device tensors, one per
    expert (0-dim for a single FFN)."""
    n_live_total = flat.sum(-1, dtype=torch.int32)
    if torch.is_tensor(cap_eff):
        return n_live_total, torch.minimum(n_live_total, cap_eff)
    return n_live_total, torch.clamp(n_live_total, max=cap_eff)


def _kept(flat: torch.Tensor, cap_eff) -> torch.Tensor:
    """The first ``cap_eff`` live tiles of each row-major tile list."""
    limit = cap_eff[..., None] if torch.is_tensor(cap_eff) else cap_eff
    return flat & (torch.cumsum(flat, -1) - 1 < limit)


def gather_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        tile_mask: torch.Tensor, *, capacity: int,
                        cap_live=None, tile_m: int = TILE_M,
                        tile_n: int = TILE_N
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version (the port of ``ref.gather_matmul_cap_ref``, plus the
    kernel's two counters): x @ w in float32 where the kept tiles
    are, zeros elsewhere, returned in x.dtype.  A leading E dim on every
    operand is the expert grid, with per-expert counters."""
    cap_eff = _budget(capacity, cap_live)
    flat = tile_mask.flatten(-2).bool()
    kept = _kept(flat, cap_eff).reshape(tile_mask.shape)
    keep = kept.repeat_interleave(tile_m, -2).repeat_interleave(tile_n, -1)
    out = torch.where(keep[..., :x.shape[-2], :w.shape[-1]],
                      x.float() @ w.float(), 0.0).to(x.dtype)
    return (out, *_counts(flat, cap_eff))


def gather_matmul(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor,
                  *, capacity: int, cap_live=None,
                  tile_m: int = TILE_M, tile_n: int = TILE_N):
    """-> (out (..., M, N) in x.dtype, n_live_total, n_computed),
    counters as int32 device tensors.  The CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor, an error for anything
    else.  ``capacity`` (static slot provisioning) is a host int, and
    ``cap_live`` a host int or an (E,) device tensor, so nothing here
    waits for the device."""
    nm, nn = tile_mask.shape[-2:]
    if not 1 <= capacity <= nm * nn:
        raise ValueError(f"capacity {capacity} outside [1, {nm * nn}]")
    if x.device.type == "cpu":
        return gather_matmul_plain(x, w, tile_mask, capacity=capacity,
                                   cap_live=cap_live, tile_m=tile_m,
                                   tile_n=tile_n)
    return _launch(x, w, tile_mask, capacity, cap_live, tile_m, tile_n)


def _launch(x, w, tile_mask, capacity, cap_live, tile_m, tile_n):
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
    if M % TILE_M or N % TILE_N or tuple(w.shape) != lead + (K, N) or \
            tuple(tile_mask.shape) != lead + (M // TILE_M, N // TILE_N):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} mask {tuple(tile_mask.shape)}")
    code = dtype_code(x, w)
    cap_eff = _budget(capacity, cap_live)
    flat = tile_mask.reshape(E, -1).bool()
    # per expert: live tiles first, each group in row-major order
    order = torch.argsort((~flat).to(torch.int8), dim=-1, stable=True)
    slots = order[:, :capacity].to(torch.int32).contiguous()
    n_live_total, n_live = _counts(flat, cap_eff)
    n_live = n_live.to(torch.int32).reshape(E).contiguous()
    out = torch.zeros(lead + (M, N), dtype=x.dtype, device=x.device)
    err = lib().gather_matmul(ptr(x, x.device), ptr(w, x.device),
                              ptr(slots, x.device), ptr(n_live, x.device),
                              ptr(out, x.device), E, M, K, N, capacity,
                              code, stream)
    launches += 1
    check(err, "gather_matmul")
    return out, n_live_total.reshape(lead), n_live.reshape(lead)
