"""GQA paged flash attention: the CUDA kernel
(``csrc/paged_attention.cu``), its plain PyTorch version, and the launch
counter.

Replaces ``repro/kernels/paged_attention.py`` ``gqa_paged_flash``
(Pallas) in its single-device form: the normalised output
(``partial=False``) over the whole page pool (no ``lo`` / ``n_local``
shard window).  The partial-statistics and shard-window forms wait for
the multi-device slice (ROADMAP queue A 14).  Bound on the H100: bytes,
the live pages' K, V and tags; see the source for the design.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check
from repro_torch.kernels.launch import cuda_stream, dtype_code, lib, ptr

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)          # the CUDA kernel's instantiations

launches = 0


def gqa_paged_flash_plain(q: torch.Tensor, kpool: torch.Tensor,
                          vpool: torch.Tensor, ppool: torch.Tensor,
                          block_table: torch.Tensor, qpos: torch.Tensor, *,
                          window: int = 0) -> torch.Tensor:
    """Plain version (the port of ``ref.gqa_paged_ref``, non-partial):
    gather the ring view through the table, null pages as rows tagged
    -1, then a masked softmax with float32 scores, statistics and
    accumulator, cast to q's dtype at the end."""
    B, C, H, D = q.shape
    page, hkv = kpool.shape[1], kpool.shape[2]
    Dv = vpool.shape[-1]
    G = H // hkv
    ring = block_table.shape[1] * page
    live = block_table > 0
    idx = torch.where(live, block_table, 0).long()

    def view(pool, fill):
        out = pool[idx]
        m = live.reshape(live.shape + (1,) * (out.ndim - 2))
        return torch.where(m, out, torch.full((), fill, dtype=out.dtype,
                                              device=out.device))

    gk = view(kpool, 0).reshape(B, ring, hkv, D).float()
    gv = view(vpool, 0).reshape(B, ring, hkv, Dv).float()
    gp = view(ppool, -1).reshape(B, ring)
    qf = q.reshape(B, C, hkv, G, D).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, gk) * (D ** -0.5)
    rel = qpos[:, :, None] - gp[:, None, :]
    ok = (gp[:, None, :] >= 0) & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgqt,btkd->bkgqd", p, gv)
    o = acc / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, Dv).to(q.dtype)


def gqa_paged_flash(q: torch.Tensor, kpool: torch.Tensor,
                    vpool: torch.Tensor, ppool: torch.Tensor,
                    block_table: torch.Tensor, qpos: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """q: (B, C, H, D); pools (n_pages, page, hkv, D) with position tags
    ``ppool`` (n_pages, page) int32; block_table (B, W) int32 page ids
    (a column slice of a wider table is fine); qpos (B, C) int32.
    -> (B, C, H, D) in q's dtype.  The CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor, an error for anything else."""
    if q.device.type == "cpu":
        return gqa_paged_flash_plain(q, kpool, vpool, ppool, block_table,
                                     qpos, window=window)
    return _launch(q, kpool, vpool, ppool, block_table, qpos, window)


def _launch(q, kpool, vpool, ppool, block_table, qpos, window):
    global launches
    stream = cuda_stream(q.device)
    B, C, H, D = q.shape
    n_pages, page, hkv = kpool.shape[:3]
    if D not in HEAD_DIMS or tuple(kpool.shape) != (n_pages, page, hkv, D) \
            or vpool.shape != kpool.shape or H % hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)} kpool "
                         f"{tuple(kpool.shape)} vpool {tuple(vpool.shape)}")
    if tuple(ppool.shape) != (n_pages, page) or \
            block_table.ndim != 2 or block_table.shape[0] != B or \
            tuple(qpos.shape) != (B, C):
        raise ValueError(f"bad shapes ppool {tuple(ppool.shape)} table "
                         f"{tuple(block_table.shape)} qpos "
                         f"{tuple(qpos.shape)}")
    if {ppool.dtype, block_table.dtype, qpos.dtype} != {torch.int32}:
        raise TypeError("ppool, block_table and qpos must be int32")
    code = dtype_code(q, kpool)
    if vpool.dtype != q.dtype:
        raise TypeError(f"vpool is {vpool.dtype}, q is {q.dtype}")
    # the engine passes block_table[:, :W], a strided view: the kernel
    # takes the row stride, and needs unit column stride
    if block_table.device != q.device or block_table.stride(1) != 1:
        raise ValueError("block_table must lie on q's device with unit "
                         "column stride")
    args = [ptr(t, q.device) for t in (q, kpool, vpool)]
    if any(a % 16 for a in args):
        raise ValueError("q and the pools must be 16-byte aligned")
    out = torch.empty((B, C, H, D), dtype=q.dtype, device=q.device)
    err = lib().gqa_paged_flash(
        *args, ptr(ppool, q.device), block_table.data_ptr(),
        ptr(qpos, q.device), ptr(out, q.device), B, C, H, hkv, D, page,
        block_table.shape[1], block_table.stride(0), window, D ** -0.5,
        code, stream)
    launches += 1
    check(err, "gqa_paged_flash")
    return out
