"""Capacity-compacted MoR matmul: the CUDA kernel
(``csrc/gather_matmul.cu``), its plain PyTorch version, and the launch
counter.

Replaces ``repro/kernels/gather_matmul.py`` ``gather_matmul`` (Pallas).
x (M, K) @ w (K, N) over only the first ``capacity`` live (tile_m x
tile_n) tiles in row-major order, clamped by ``cap_live``; dead and
overflow tiles are exact zeros.  One launch does it all: the kernel
ranks the live tiles under the budget itself (the JAX wrapper's
``kept``; ``kept_tiles`` is its plain version), writes every output
tile, zeros included (the wrapper allocates with ``torch.empty``), and
the two counters.  The wrapper only checks, pads a ragged contraction
and plans the split-K (``split_k.plan``).  Bound on the H100: bytes —
the kept share of the weight; see the source for the design.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import split_k
from repro_torch.kernels.build import check
from repro_torch.kernels.launch import (check16, cuda_stream, dense16,
                                        dtype_code, lib, mask_bytes, ptr,
                                        require_cuda)

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


def kept_tiles(tile_mask: torch.Tensor, *, capacity: int, cap_live=None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (kept, n_live_total, n_computed): the tiles the kernel computes
    (bool, ``tile_mask``'s shape: the first ``cap_eff`` live tiles of
    each row-major tile list) and the two counters as int32 device
    tensors, one per expert (0-dim for a single FFN)."""
    cap_eff = _budget(capacity, cap_live)
    flat = tile_mask.flatten(-2).bool()
    kept = _kept(flat, cap_eff).reshape(tile_mask.shape)
    return (kept, *_counts(flat, cap_eff))


def gather_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                        tile_mask: torch.Tensor, *, capacity: int,
                        cap_live=None, tile_m: int = TILE_M,
                        tile_n: int = TILE_N
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version (the port of ``ref.gather_matmul_cap_ref``, plus the
    kernel's two counters): x @ w in float32 where the kept tiles
    are, zeros elsewhere, returned in x.dtype.  A leading E dim on every
    operand is the expert grid, with per-expert counters."""
    kept, n_live_total, n_comp = kept_tiles(tile_mask, capacity=capacity,
                                            cap_live=cap_live)
    keep = kept.repeat_interleave(tile_m, -2).repeat_interleave(tile_n, -1)
    out = torch.where(keep[..., :x.shape[-2], :w.shape[-1]],
                      x.float() @ w.float(), 0.0).to(x.dtype)
    return out, n_live_total, n_comp


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
    require_cuda(x.device)
    if (tile_m, tile_n) != (TILE_M, TILE_N):
        raise ValueError(f"the CUDA kernel takes tile ({TILE_M}, {TILE_N}),"
                         f" got ({tile_m}, {tile_n})")
    lead = tuple(x.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"at most one leading (expert) dim, got {lead}")
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if M % TILE_M or N % TILE_N or tuple(w.shape) != lead + (K, N) or \
            tuple(tile_mask.shape) != lead + (M // TILE_M, N // TILE_N):
        raise ValueError(f"bad shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} mask {tuple(tile_mask.shape)}")
    # a host budget folds into the capacity; a tensor goes to the kernel
    if cap_live is not None and not torch.is_tensor(cap_live):
        capacity, cap_live = _budget(capacity, cap_live), None
    # the kernel copies 16-byte chunks: zero-pad a ragged contraction
    pad = (-K) % (16 // x.element_size())
    if pad:
        x, w = F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, pad))
    return launch(dense16(x), dense16(w), tile_mask, capacity=capacity,
                  cap_live=cap_live, split_plan=plan(x, w, capacity))


def plan(x: torch.Tensor, w: torch.Tensor, capacity: int
         ) -> Tuple[int, int]:
    """The split-K plan (split, kb_per) for these operands: at most
    ``capacity`` kept tiles an expert, so at most that many of its
    blocks live."""
    E = x.shape[0] if x.ndim == 3 else 1
    M, K = x.shape[-2:]
    return split_k.plan(E, M, K, w.shape[-1],
                        sms=split_k.sm_count(x.device), capacity=capacity)


def launch(x: torch.Tensor, w: torch.Tensor, tile_mask: torch.Tensor, *,
           capacity: int, cap_live: Optional[torch.Tensor],
           split_plan: Tuple[int, int]):
    """The kernel alone: it ranks the live tiles of ``tile_mask`` (E?,
    M/8, N/128) under the budget (``capacity`` clamped by the (E,) int32
    ``cap_live`` tensor, or None), computes x @ w on the kept tiles,
    writes exact zeros elsewhere and the two counters, split as
    ``split_plan`` = (split, kb_per) says.  x (E?, M, K), w (E?,
    K, N) contiguous, 16-byte aligned CUDA tensors of one dtype, K a
    multiple of a 16-byte chunk.  -> (out, n_live_total, n_computed).
    Counts one launch."""
    global launches
    dev = x.device
    stream = cuda_stream(dev)
    code = dtype_code(x, w)
    lead = tuple(x.shape[:-2])
    E = lead[0] if lead else 1
    M, K = x.shape[-2:]
    N = w.shape[-1]
    if K % (16 // x.element_size()):
        raise ValueError(f"K = {K} is not a multiple of a 16-byte chunk")
    check16(x, w)
    split, kb_per = split_plan
    if cap_live is not None:
        cap_live = cap_live.to(torch.int32).reshape(E).contiguous()
    out = torch.empty(lead + (M, N), dtype=x.dtype, device=dev)
    counts = torch.empty((2,) + lead, dtype=torch.int32, device=dev)
    n_live = counts.data_ptr()
    err = lib().gather_matmul(ptr(x, dev), ptr(w, dev),
                              ptr(mask_bytes(tile_mask), dev),
                              ptr(cap_live, dev), ptr(out, dev), n_live,
                              n_live + 4 * E, E, M, K, N, capacity, split,
                              kb_per, code, stream)
    launches += 1
    check(err, "gather_matmul")
    return out, counts[0], counts[1]
