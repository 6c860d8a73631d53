"""The two masked matmuls of ``csrc/masked_matmul.cu``, each with its
plain PyTorch version and launch counter.

- ``masked_matmul_kdim`` (counter ``launches``) replaces
  ``repro/kernels/masked_matmul.py`` ``masked_matmul_kdim`` (Pallas): the
  contraction-masked MoR down projection, x (M, K) @ w (K, N) where each
  (row block i, k block) pair whose mask is 0 contributes nothing,
  whatever x holds there (dead FFN hidden tiles).  The wrapper plans the
  split-K (``split_k.plan``); ``launch_kdim`` is the kernel alone.
  Bound on the H100: bytes — the weight rows of live k blocks.
- ``masked_matmul`` (counter ``masked_launches``) replaces
  ``masked_matmul`` of the same file: x @ w with each (8-row,
  128-column) output tile whose mask is 0 written as exact zeros, its x
  rows never read.  The same tile core, split-K planned by
  ``split_k.plan`` (the plan never reads the mask); any M, K and N, K
  and N rounded up to a 16-byte chunk with zeros (``chunk_pads``).
  Bound on the H100: bytes in bf16 (the live column strips of w),
  operations in float32 at a conv layer's im2col.  See the source for
  both designs.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import split_k
from repro_torch.kernels.build import check
from repro_torch.kernels.launch import (check16, counted, cuda_stream,
                                        dense16, dtype_code, lib,
                                        mask_bytes, ptr, require_cuda)

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


def _kind(x: torch.Tensor) -> str:
    return "bf16" if x.dtype == torch.bfloat16 else "fp32"


def work_kdim(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor,
              **_) -> Tuple[int, int, str]:
    """-> (bytes, operations, kind) of one ``masked_matmul_kdim`` call:
    x's live (row block, k block) pairs, the 128 weight rows of every k
    block live in some row block, once, and the output.  Operations: 2
    x 8 x 128 x N a live pair.  Reads the mask back."""
    N = w.shape[-1]
    elt = x.element_size()
    live = tile_mask.bool()
    n_pairs = int(live.sum())
    k_live = int(live.any(-2).sum())
    out = x.numel() // x.shape[-1] * N
    nbytes = (n_pairs * TILE_M * TILE_K * elt + k_live * TILE_K * N * elt
              + out * elt)
    return nbytes, n_pairs * 2 * TILE_M * TILE_K * N, _kind(x)


@counted("masked_matmul_kdim", work_kdim)
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
    require_cuda(x.device)
    if (tile_m, tile_k) != (TILE_M, TILE_K):
        raise ValueError(f"the CUDA kernel takes tile ({TILE_M}, {TILE_K}),"
                         f" got ({tile_m}, {tile_k})")
    lead = tuple(x.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"at most one leading (expert) dim, got {lead}")
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if M % TILE_M or K % TILE_K or tuple(w.shape) != lead + (K, N) or \
            tuple(tile_mask.shape) != lead + (M // TILE_M, K // TILE_K):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} mask {tuple(tile_mask.shape)}")
    # the kernel copies 16-byte chunks: zero-pad ragged output columns
    _, pad = chunk_pads(K, N, x.element_size())
    if pad:
        w = F.pad(w, (0, pad))
    out = launch_kdim(dense16(x), dense16(w), tile_mask, plan(x, w))
    return out[..., :N] if pad else out


def plan(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int]:
    """The split-K plan (split, kb_per) for these operands (every block
    may be live)."""
    E = x.shape[0] if x.ndim == 3 else 1
    M, K = x.shape[-2:]
    return split_k.plan(E, M, K, w.shape[-1],
                        sms=split_k.sm_count(x.device))


def launch_kdim(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor,
                split_plan: Tuple[int, int]) -> torch.Tensor:
    """The kernel alone, split as ``split_plan`` = (split, kb_per) says.
    x (E?, M, K), w (E?, K, N) contiguous, 16-byte aligned CUDA tensors
    of one dtype, M % 8 == K % 128 == 0, N a multiple of a 16-byte
    chunk; tile_mask (E?, M/8, K/128).  Counts one launch."""
    global launches
    stream = cuda_stream(x.device)
    code = dtype_code(x, w)
    E = x.shape[0] if x.ndim == 3 else 1
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if N % (16 // x.element_size()):
        raise ValueError(f"N = {N} is not a multiple of a 16-byte chunk")
    check16(x, w)
    split, kb_per = split_plan
    dev = x.device
    out = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device=dev)
    err = lib().masked_matmul_kdim(ptr(x, dev), ptr(w, dev),
                                   ptr(mask_bytes(tile_mask), dev),
                                   ptr(out, dev), E, M, K, N, split, kb_per,
                                   code, stream)
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


def work_masked(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor,
                **_) -> Tuple[int, int, str]:
    """-> (bytes, operations, kind) of one ``masked_matmul`` call: the
    live tiles' column strips of w and row blocks of x once, the whole
    output (dead tiles are written as zeros), and 2 K multiply-adds a
    live output; a tile of the ragged edge counts its real rows and
    columns.  Reads the mask back."""
    M, K = x.shape
    N = w.shape[1]
    elt = x.element_size()
    dev = tile_mask.device
    rows = torch.clamp(M - TILE_M * torch.arange(tile_mask.shape[0],
                                                 device=dev), max=TILE_M)
    cols = torch.clamp(N - TILE_N * torch.arange(tile_mask.shape[1],
                                                 device=dev), max=TILE_N)
    live = tile_mask.bool()
    nbytes = (int((live.any(0) * cols).sum()) * K * elt
              + int((live.any(1) * rows).sum()) * K * elt + M * N * elt)
    outs = int((live * rows[:, None] * cols[None, :]).sum())
    return nbytes, 2 * K * outs, _kind(x)


@counted("masked_matmul", work_masked)
def masked_matmul(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor
                  ) -> torch.Tensor:
    """x (M, K), w (K, N), mask (ceil(M/8), ceil(N/128)): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor, an error for
    anything else."""
    if x.device.type == "cpu":
        return masked_matmul_plain(x, w, tile_mask)
    return _launch_masked(x, w, tile_mask)


def chunk_pads(K: int, N: int, element_size: int) -> Tuple[int, int]:
    """Zero padding (contraction, columns) that rounds K and N up to a
    16-byte chunk (8 bf16, 4 float32), as the tile core's copies need:
    zeros add nothing to a sum, so the padded product's first N columns
    are the product.  Pure Python on host ints."""
    epc = 16 // element_size
    return (-K) % epc, (-N) % epc


def _launch_masked(x, w, tile_mask):
    global masked_launches
    stream = cuda_stream(x.device)
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if tuple(tile_mask.shape) != (-(-M // TILE_M), -(-N // TILE_N)):
        raise ValueError(f"mask {tuple(tile_mask.shape)} does not tile "
                         f"({M}, {N}) by ({TILE_M}, {TILE_N})")
    code = dtype_code(x, w)
    pk, pn = chunk_pads(K, N, x.element_size())
    if pk:
        x = F.pad(x, (0, pk))
    if pk or pn:
        w = F.pad(w, (0, pn, 0, pk))
    x, w = dense16(x), dense16(w)
    Kp, Np = w.shape
    split, kb_per = split_k.plan(1, M, Kp, Np,
                                 sms=split_k.sm_count(x.device))
    out = torch.empty((M, Np), dtype=x.dtype, device=x.device)
    err = lib().masked_matmul(ptr(x, x.device), ptr(w, x.device),
                              ptr(mask_bytes(tile_mask), x.device),
                              ptr(out, x.device), M, Kp, Np, split, kb_per,
                              code, stream)
    masked_launches += 1
    check(err, "masked_matmul")
    return out[:, :N] if pn else out
