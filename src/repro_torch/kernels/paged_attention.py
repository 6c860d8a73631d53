"""Paged flash attention: the GQA and absorbed-MLA CUDA kernels
(``csrc/paged_attention.cu``, ``csrc/mla_attention.cu``), their plain
PyTorch versions, and their launch counters.

Replace ``repro/kernels/paged_attention.py`` ``gqa_paged_flash`` and
``mla_paged_flash`` (Pallas) in their single-device form: the
normalised output (``partial=False``) over the whole page pool (no
``lo`` / ``n_local`` shard window).  The partial-statistics and
shard-window forms wait for the multi-device slice (ROADMAP queue A
14).  Bounds on the H100: bytes for GQA (the live pages' K, V and
tags); MLA sits near the bf16 ridge, bound by the latent rows' bytes at
decode and by q's and the output's at a mixed dispatch.  The bf16 MLA
kernel runs on the tensor cores with TMA copies of whole 8-row page
boxes (pages of a multiple of 8 rows, a rope of at most 64 columns),
and splits each slot's table over a thread block cluster where its
64-pair tiles alone leave the card idle (``mla_plan``).  See the
sources for the designs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import split_k
from repro_torch.kernels.build import check
from repro_torch.kernels.launch import cuda_stream, dtype_code, lib, ptr

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)          # the CUDA kernel's instantiations
MLA_MAX_RANK = 512                 # the MLA kernel's latent width limit
MLA_MAX_ROPE = 64                  # bf16: the rope's one staged region
MLA_PAGE_ROWS = 8                  # bf16: pages are whole 8-row boxes
MLA_TILE_PAIRS = 64                # bf16: (row, head) pairs a block
MLA_TILE_KEYS = 64                 # bf16: keys a K tile

launches = 0          # gqa_paged_flash launches since the last reset
mla_launches = 0      # mla_paged_flash launches since the last reset


def _paged_view(pool: torch.Tensor, block_table: torch.Tensor, fill):
    """The ring view ``pool[block_table]`` with null entries (page id 0)
    read as ``fill`` (``ref._paged_view``)."""
    live = block_table > 0
    out = pool[torch.where(live, block_table, 0).long()]
    m = live.reshape(live.shape + (1,) * (out.ndim - 2))
    return torch.where(m, out, torch.full((), fill, dtype=out.dtype,
                                          device=out.device))


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
    gk = _paged_view(kpool, block_table, 0).reshape(B, ring, hkv, D).float()
    gv = _paged_view(vpool, block_table, 0).reshape(B, ring, hkv,
                                                    Dv).float()
    gp = _paged_view(ppool, block_table, -1).reshape(B, ring)
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


# ==========================================================================
# absorbed-MLA over paged latent pools
# ==========================================================================

def mla_paged_flash_plain(q_lat: torch.Tensor, q_pe: torch.Tensor,
                          ck_pool: torch.Tensor, cpe_pool: torch.Tensor,
                          cp_pool: torch.Tensor, block_table: torch.Tensor,
                          qpos: torch.Tensor, *,
                          scale: float) -> torch.Tensor:
    """Plain version (the port of ``ref.mla_paged_ref``, non-partial):
    gather the latent ring view through the table, null pages as rows
    tagged -1, then a masked softmax in the latent space with float32
    scores, statistics and accumulator, cast to q_lat's dtype."""
    B, C, h, kr = q_lat.shape
    rd = q_pe.shape[-1]
    ring = block_table.shape[1] * ck_pool.shape[1]
    ck = _paged_view(ck_pool, block_table, 0).reshape(B, ring, kr).float()
    cpe = _paged_view(cpe_pool, block_table, 0).reshape(B, ring,
                                                        rd).float()
    cp = _paged_view(cp_pool, block_table, -1).reshape(B, ring)
    s = (torch.einsum("bchk,btk->bhct", q_lat.float(), ck)
         + torch.einsum("bchr,btr->bhct", q_pe.float(), cpe)) * scale
    ok = (cp[:, None, None, :] >= 0) & \
        (cp[:, None, None, :] <= qpos[:, None, :, None])
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhct,btk->bhck", p, ck)
    o = acc / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return o.permute(0, 2, 1, 3).to(q_lat.dtype)


def mla_plan(B: int, C: int, h: int, W: int, page: int, *,
             sms: int) -> int:
    """-> split: the blocks (one thread block cluster, at most 8) over
    which the bf16 kernel splits each slot's table columns [0, W).  As
    many as still fit the B x ceil(C h / 64) pair tiles into one wave of
    ``sms``, but no more than the slot's 64-key tiles (W page / 64) nor
    its W entries, and at least 1: a decode dispatch splits, a mixed one
    (hundreds of tiles) does not.  Pure Python on host ints: the plan
    never reads the table or qpos."""
    tiles = B * -(-(C * h) // MLA_TILE_PAIRS)
    k_tiles = -(-(W * page) // MLA_TILE_KEYS)
    return max(1, min(split_k.MAX_SPLIT, W, k_tiles, sms // max(1, tiles)))


def mla_ranges(W: int, split: int):
    """The table columns [lo, hi) of each rank of a ``split``, in rank
    order, as the kernel computes them: whole entries, W r / split
    rounded down."""
    return [(W * r // split, W * (r + 1) // split) for r in range(split)]


def mla_paged_flash(q_lat: torch.Tensor, q_pe: torch.Tensor,
                    ck_pool: torch.Tensor, cpe_pool: torch.Tensor,
                    cp_pool: torch.Tensor, block_table: torch.Tensor,
                    qpos: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q_lat: (B, C, h, kr) with W_uk absorbed, q_pe: (B, C, h, rd);
    pools (n_pages, page, kr) / (n_pages, page, rd) with position tags
    ``cp_pool`` (n_pages, page) int32; block_table (B, W) int32 (a
    column slice of a wider table is fine); qpos (B, C) int32.  ->
    o_lat (B, C, h, kr) in q_lat's dtype (the caller absorbs W_uv).
    The CUDA kernel for a CUDA tensor (bf16: pages of a multiple of 8
    rows, rd <= 64), the plain version for a CPU tensor, an error for
    anything else."""
    if q_lat.device.type == "cpu":
        return mla_paged_flash_plain(q_lat, q_pe, ck_pool, cpe_pool,
                                     cp_pool, block_table, qpos,
                                     scale=scale)
    return _launch_mla(q_lat, q_pe, ck_pool, cpe_pool, cp_pool, block_table,
                       qpos, scale)


def _launch_mla(q_lat, q_pe, ck_pool, cpe_pool, cp_pool, block_table, qpos,
                scale):
    global mla_launches
    stream = cuda_stream(q_lat.device)
    B, C, h, kr = q_lat.shape
    rd = q_pe.shape[-1]
    n_pages, page = ck_pool.shape[:2]
    if kr > MLA_MAX_RANK or tuple(q_pe.shape) != (B, C, h, rd) or \
            tuple(ck_pool.shape) != (n_pages, page, kr) or \
            tuple(cpe_pool.shape) != (n_pages, page, rd):
        raise ValueError(f"bad shapes q_lat {tuple(q_lat.shape)} q_pe "
                         f"{tuple(q_pe.shape)} pools "
                         f"{tuple(ck_pool.shape)} {tuple(cpe_pool.shape)}")
    if tuple(cp_pool.shape) != (n_pages, page) or \
            block_table.ndim != 2 or block_table.shape[0] != B or \
            tuple(qpos.shape) != (B, C):
        raise ValueError(f"bad shapes tags {tuple(cp_pool.shape)} table "
                         f"{tuple(block_table.shape)} qpos "
                         f"{tuple(qpos.shape)}")
    if {cp_pool.dtype, block_table.dtype, qpos.dtype} != {torch.int32}:
        raise TypeError("cp_pool, block_table and qpos must be int32")
    code = dtype_code(q_lat, ck_pool)
    if q_pe.dtype != q_lat.dtype or cpe_pool.dtype != q_lat.dtype:
        raise TypeError("q_lat, q_pe and both pools must share a dtype")
    # the engine passes block_table[:, :W], a strided view: the kernel
    # takes the row stride, and needs unit column stride
    if block_table.device != q_lat.device or block_table.stride(1) != 1:
        raise ValueError("block_table must lie on q's device with unit "
                         "column stride")
    vec = 16 // q_lat.element_size()
    if kr % vec or rd % vec:
        raise ValueError(f"kr {kr} and rd {rd} must be multiples of {vec}"
                         f" (16-byte loads)")
    bf16 = q_lat.dtype == torch.bfloat16
    if bf16 and (not 0 < rd <= MLA_MAX_ROPE or page % MLA_PAGE_ROWS):
        raise ValueError(f"the bf16 kernel takes 0 < rd <= {MLA_MAX_ROPE} "
                         f"and pages of a multiple of {MLA_PAGE_ROWS} rows, "
                         f"got rd {rd}, page {page}")
    W = block_table.shape[1]
    if W < 1:
        raise ValueError("the block table has no column")
    q_lat, q_pe = q_lat.contiguous(), q_pe.contiguous()
    dev = q_lat.device
    if any(ptr(t, dev) % 16 for t in (q_lat, q_pe, ck_pool, cpe_pool,
                                       cp_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    # float32 walks each slot whole on the CUDA cores
    split = mla_plan(B, C, h, W, page, sms=split_k.sm_count(dev)) \
        if bf16 else 1
    out = torch.empty((B, C, h, kr), dtype=q_lat.dtype, device=dev)
    err = lib().mla_paged_flash(
        ptr(q_lat, dev), ptr(q_pe, dev), ptr(ck_pool, dev),
        ptr(cpe_pool, dev), ptr(cp_pool, dev), block_table.data_ptr(),
        ptr(qpos, dev), ptr(out, dev), B, C, h, kr, rd, page, n_pages, W,
        block_table.stride(0), split, float(scale), code, stream)
    mla_launches += 1
    check(err, "mla_paged_flash")
    return out
