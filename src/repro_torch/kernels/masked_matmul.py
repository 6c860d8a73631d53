"""The two masked matmuls of ``csrc/masked_matmul.cu``, each with its
plain PyTorch version and launch counter.

- ``masked_matmul_kdim`` (counter ``launches``) replaces
  ``repro/kernels/masked_matmul.py`` ``masked_matmul_kdim`` (Pallas): the
  contraction-masked MoR down projection, x (M, K) @ w (K, N) skipping
  each (row block i, k block) whose mask is 0 — dead FFN hidden tiles,
  known to be zero.  Bound on the H100: bytes — the weight rows of live
  k blocks.
- ``masked_matmul`` (counter ``masked_launches``) replaces
  ``masked_matmul`` of the same file: x @ w with each (8-row,
  128-column) output tile whose mask is 0 written as zeros, without
  multiply-adds.  Bound on the H100: bytes — the live column strips of
  w.  See the source for both designs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check
from repro_torch.kernels.launch import cuda_stream, dtype_code, lib, ptr

TILE_M, TILE_K, TILE_N = 8, 128, 128

launches = 0            # masked_matmul_kdim
masked_launches = 0     # masked_matmul


def masked_matmul_kdim_plain(x: torch.Tensor, w: torch.Tensor,
                             tile_mask: torch.Tensor, *,
                             tile_m: int = TILE_M,
                             tile_k: int = TILE_K) -> torch.Tensor:
    """Plain version (the port of ``ref.masked_matmul_kdim_ref``): zero
    the dead (row block, k block) pairs of x, then a float32 matmul,
    returned in x.dtype.  A leading E dim on every operand is the
    expert grid."""
    keep = tile_mask.bool().repeat_interleave(tile_m, -2).repeat_interleave(
        tile_k, -1)[..., :x.shape[-2], :x.shape[-1]]
    xz = torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))
    return (xz.float() @ w.float()).to(x.dtype)


def masked_matmul_kdim(x: torch.Tensor, w: torch.Tensor,
                       tile_mask: torch.Tensor, *, tile_m: int = TILE_M,
                       tile_k: int = TILE_K) -> torch.Tensor:
    """The CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor, an error for anything else.  x (M, K), w (K, N), mask (M/8,
    K/128), or each with a leading E dim (the expert grid)."""
    if x.device.type == "cpu":
        return masked_matmul_kdim_plain(x, w, tile_mask, tile_m=tile_m,
                                        tile_k=tile_k)
    return _launch(x, w, tile_mask, tile_m, tile_k)


def _launch(x, w, tile_mask, tile_m, tile_k):
    global launches
    stream = cuda_stream(x.device)
    if (tile_m, tile_k) != (TILE_M, TILE_K):
        raise ValueError(f"the CUDA kernel takes tile ({TILE_M}, {TILE_K}),"
                         f" got ({tile_m}, {tile_k})")
    lead = tuple(x.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"at most one leading (expert) dim, got {lead}")
    E = lead[0] if lead else 1
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if M % TILE_M or K % TILE_K or tuple(w.shape) != lead + (K, N) or \
            tuple(tile_mask.shape) != lead + (M // TILE_M, K // TILE_K):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} mask {tuple(tile_mask.shape)}")
    code = dtype_code(x, w)
    mask = tile_mask.to(torch.int32).contiguous()
    out = torch.empty(lead + (M, N), dtype=x.dtype, device=x.device)
    err = lib().masked_matmul_kdim(ptr(x, x.device), ptr(w, x.device),
                                   ptr(mask, x.device), ptr(out, x.device),
                                   E, M, K, N, code, stream)
    launches += 1
    check(err, "masked_matmul_kdim")
    return out


def masked_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        tile_mask: torch.Tensor) -> torch.Tensor:
    """Plain version (the port of ``ref.masked_matmul_ref``): a float32
    x @ w whose (8 x 128) tiles with mask 0 are exact zeros, returned in
    x.dtype."""
    keep = tile_mask.bool().repeat_interleave(TILE_M, 0).repeat_interleave(
        TILE_N, 1)[:x.shape[0], :w.shape[1]]
    return torch.where(keep, x.float() @ w.float(), 0.0).to(x.dtype)


def masked_matmul(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor
                  ) -> torch.Tensor:
    """x (M, K), w (K, N), mask (M/8, N/128): the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor, an error for anything
    else."""
    if x.device.type == "cpu":
        return masked_matmul_plain(x, w, tile_mask)
    return _launch_masked(x, w, tile_mask)


def _launch_masked(x, w, tile_mask):
    global masked_launches
    stream = cuda_stream(x.device)
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    N = w.shape[-1]
    if M % TILE_M or N % TILE_N or tuple(w.shape) != (K, N) \
            or tuple(tile_mask.shape) != (M // TILE_M, N // TILE_N):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} mask {tuple(tile_mask.shape)}")
    code = dtype_code(x, w)
    mask = tile_mask.to(torch.int32).contiguous()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    err = lib().masked_matmul(ptr(x, x.device), ptr(w, x.device),
                              ptr(mask, x.device), ptr(out, x.device), M, K,
                              N, code, stream)
    masked_launches += 1
    check(err, "masked_matmul")
    return out
