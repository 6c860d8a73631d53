"""Paged flash attention: the GQA and absorbed-MLA CUDA kernels
(``csrc/paged_attention.cu``, ``csrc/mla_attention.cu``), their plain
PyTorch versions, and their launch counters.

Replace ``repro/kernels/paged_attention.py`` ``gqa_paged_flash`` and
``mla_paged_flash`` (Pallas) whole: the normalised output over the
whole page pool, and a page shard's forms, ``lo`` / ``n_local`` (the
window of global page ids the local pool holds: a page outside it is
skipped like the null page, ``_live_tables``) and ``partial=True``
(the unnormalised float32 statistics (m, l, acc) in the Pallas
kernel's layout, the operands of ``distributed.collectives.
flash_merge``).  Bounds on the H100: bytes for GQA (the live pages' K, V and
tags); MLA sits near the bf16 ridge, bound by the latent rows' bytes at
decode and by q's and the output's at a mixed dispatch.  Both bf16
kernels run on the tensor cores (GQA at head dims 64, 96, 112 and 128,
the last three over columns padded to 128; head dim 32 and float32 keep
the CUDA cores, ``gqa_body``), copy whole pages (of a multiple of 8
rows, or the wrapper raises; MLA by TMA boxes, GQA by cp.async), and
split each slot's table over a thread block cluster where their 64-pair
tiles alone leave part of the card idle (``gqa_plan``, ``mla_plan``;
ranks' ranges ``split_ranges``).  GQA's CUDA-core body takes any G = H / hkv:
a block serves as many query rows and heads of one KV head as its
registers hold (``gqa_heads_plan``).  See the sources for the designs.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.kernels import split_k
from repro_torch.kernels.build import check
from repro_torch.kernels.launch import (counted, cuda_stream, dtype_code,
                                        lib, ptr)

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 96, 112, 128)  # the CUDA kernel's instantiations
GQA_TC_HEAD_DIMS = (64, 96, 112, 128)  # bf16 GQA: the tensor-core body's
GQA_CC_ELEMS = 2048                # CUDA-core GQA: acc slots a block
GQA_TILE_PAIRS = 64                # bf16 GQA: (row, head) pairs a block
GQA_TILE_ELEMS = 4096              # bf16 GQA: keys x columns of a K tile
PAGE_ROWS = 8                      # bf16 tensor-core bodies: 8-row boxes
MLA_MAX_RANK = 512                 # the MLA kernel's latent width limit
MLA_MAX_ROPE = 64                  # bf16: the rope's one staged region
MLA_TILE_PAIRS = 64                # bf16: (row, head) pairs a block
MLA_TILE_KEYS = 64                 # bf16: keys a K tile

launches = 0          # gqa_paged_flash launches since the last reset
mla_launches = 0      # mla_paged_flash launches since the last reset
partial_launches = 0  # ... of them in the partial form (gqa)
mla_partial_launches = 0  # ... (mla)


def _live(block_table: torch.Tensor, lo: Optional[int],
          n_local: Optional[int]):
    """-> (local page id, live) of every table entry (the Pallas
    wrapper's ``_live_tables``): a null entry (id 0) is never live, and
    under a shard window [lo, lo + n_local) a foreign one is not
    either."""
    if lo is None:
        return block_table, block_table > 0
    loc = block_table - lo
    return loc, (block_table > 0) & (loc >= 0) & (loc < n_local)


def _paged_view(pool: torch.Tensor, block_table: torch.Tensor, fill,
                lo: Optional[int] = None, n_local: Optional[int] = None):
    """The ring view through the table, entries that are not live read
    as ``fill`` (``ref._paged_view``)."""
    loc, live = _live(block_table, lo, n_local)
    out = pool[torch.where(live, loc, 0).long()]
    m = live.reshape(live.shape + (1,) * (out.ndim - 2))
    return torch.where(m, out, torch.full((), fill, dtype=out.dtype,
                                          device=out.device))


def _stats(s: torch.Tensor, keys: torch.Tensor, v: torch.Tensor,
           eq: str):
    """(m, l, acc) of masked float32 scores ``s`` (-1e30 where masked)
    over the live pages' keys only (``keys``, broadcast against s), as
    the Pallas kernel keeps them: with no live key m = -1e30, l = 0, acc
    = 0; with live keys all masked m = -1e30 and exp(0) weights."""
    s = torch.where(keys, s, float("-inf"))
    m = torch.clamp(s.amax(-1), min=NEG_INF)
    p = torch.exp(s - m[..., None])
    return m, p.sum(-1), torch.einsum(eq, p, v)


def _check_window(lo, n_local, n_pages):
    if (lo is None) != (n_local is None) or \
            (lo is not None and not (lo >= 0 and 0 <= n_local <= n_pages)):
        raise ValueError(f"a shard window takes lo >= 0 and 0 <= n_local "
                         f"<= {n_pages} together, got {lo}, {n_local}")


def gqa_paged_flash_plain(q: torch.Tensor, kpool: torch.Tensor,
                          vpool: torch.Tensor, ppool: torch.Tensor,
                          block_table: torch.Tensor, qpos: torch.Tensor, *,
                          window: int = 0, lo: Optional[int] = None,
                          n_local: Optional[int] = None,
                          partial: bool = False):
    """Plain version (the port of ``ref.gqa_paged_ref``): gather the
    ring view through the table, entries that are not live as rows
    tagged -1, then a masked softmax over the live pages' keys with
    float32 scores, statistics and accumulator; the output cast to q's
    dtype, or with ``partial`` the statistics, m / l (B, hkv, G, C) and
    acc (B, hkv, G, C, Dv)."""
    B, C, H, D = q.shape
    W, page, hkv = block_table.shape[1], kpool.shape[1], kpool.shape[2]
    Dv = vpool.shape[-1]
    G = H // hkv
    ring = W * page
    _check_window(lo, n_local, kpool.shape[0])
    view = lambda pool, fill: _paged_view(pool, block_table, fill, lo,
                                          n_local)
    gk = view(kpool, 0).reshape(B, ring, hkv, D).float()
    gv = view(vpool, 0).reshape(B, ring, hkv, Dv).float()
    gp = view(ppool, -1).reshape(B, ring)
    keys = _live(block_table, lo, n_local)[1][..., None].expand(
        B, W, page).reshape(B, 1, 1, 1, ring)
    qf = q.reshape(B, C, hkv, G, D).float()
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, gk) * (D ** -0.5)
    rel = qpos[:, :, None] - gp[:, None, :]
    ok = (gp[:, None, :] >= 0) & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    s = torch.where(ok[:, None, None], s, NEG_INF)
    m, l, acc = _stats(s, keys, gv, "bkgqt,btkd->bkgqd")
    if partial:
        return m, l, acc
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, Dv).to(q.dtype)


def _seen(tags: torch.Tensor, block_table: torch.Tensor,
          qpos: torch.Tensor, window: int, lo, n_local):
    """-> (live (B, W), ok (B, C, W page)): the live table entries, and
    which of the ring view's keys each query row admits (a live page's
    written tag, causal, inside the window)."""
    B = block_table.shape[0]
    loc, live = _live(block_table, lo, n_local)
    gp = torch.where(live[..., None], tags[torch.where(live, loc, 0)
                                           .long()], -1).reshape(B, -1)
    rel = qpos[:, :, None] - gp[:, None, :]
    ok = (gp[:, None, :] >= 0) & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    return live, ok


def _unique_pages(block_table: torch.Tensor, which: torch.Tensor) -> int:
    return int(torch.unique(block_table[which]).numel())


def gqa_work(q: torch.Tensor, kpool: torch.Tensor, vpool: torch.Tensor,
             ppool: torch.Tensor, block_table: torch.Tensor,
             qpos: torch.Tensor, *, window: int = 0,
             lo: Optional[int] = None, n_local: Optional[int] = None,
             partial: bool = False) -> Tuple[int, int, str]:
    """-> (bytes, operations, kind) of one ``gqa_paged_flash`` call on
    these inputs: the tags of every distinct live page once; K and V of
    every distinct live page holding a key some query row admits (a
    page wholly outside every row's window is never needed) or, in the
    partial form, of every distinct live page; q, the table and qpos;
    the output, or the float32 statistics (m, l, acc).  Operations: q.k
    and p.v (4 D) for every (query row, head, key) pair the masks let
    through, on the tensor cores of q's dtype.  Reads the table, tags
    and positions back."""
    B, C, H, D = q.shape
    page, hkv = kpool.shape[1], kpool.shape[2]
    elt = q.element_size()
    live, ok = _seen(ppool, block_table, qpos, window, lo, n_local)
    n_pages = _unique_pages(block_table, live)
    if partial:
        n_kv = n_pages
        out = B * H * C * (D + 2) * 4
    else:
        admitted = ok.any(1).reshape(B, -1, page).any(-1)
        n_kv = _unique_pages(block_table, live & admitted)
        out = q.numel() * elt
    nbytes = (n_kv * page * 2 * hkv * D * elt + n_pages * page * 4
              + q.numel() * elt + out + block_table.numel() * 4
              + qpos.numel() * 4)
    kind = "bf16" if q.dtype == torch.bfloat16 else "fp32"
    return nbytes, int(ok.sum()) * H * 4 * D, kind


def gqa_body(dtype: torch.dtype, D: int) -> str:
    """The CUDA body a GQA call takes: ``"tensor_cores"`` for bf16 at
    head dims 64, 96, 112 and 128 (cp.async page copies, wgmma over
    ``gqa_cols(D)`` columns, the context split), else ``"cuda_cores"``
    (float32, and bf16 at head dim 32).  A pure function of (dtype,
    D)."""
    return "tensor_cores" if dtype == torch.bfloat16 and \
        D in GQA_TC_HEAD_DIMS else "cuda_cores"


def gqa_cols(D: int) -> int:
    """Columns the tensor-core body computes over at head dim D: D
    rounded up to whole 64-column panels (one 128-byte swizzle row
    each), 64 at D 64 and 128 at D 96 / 112 / 128; q's pad columns are
    zeros and the scale stays D^-0.5 (the kernel's ``Geo<D>::DC``)."""
    return -(-D // 64) * 64


def gqa_tile_keys(D: int) -> int:
    """Keys a K tile of the tensor-core body holds at head dim D: 4,096
    elements over ``gqa_cols(D)`` columns (8 KB a tile), 64 at D 64 and
    32 at D 96-128 (the kernel's ``Geo<D>::BK``)."""
    return GQA_TILE_ELEMS // gqa_cols(D)


def gqa_resident(D: int) -> int:
    """Blocks of the tensor-core body an SM holds at head dim D (the
    kernel's ``RESIDENT``): 128 registers a thread and at most ~50 KB of
    shared memory a block (~42 KB at D 64) leave room for four at every
    head dim it serves."""
    if D not in GQA_TC_HEAD_DIMS:
        raise ValueError(f"no tensor-core body at head dim {D}")
    return 4


def gqa_cc_rmax(D: int) -> int:
    """(row, head) pairs a block of the CUDA-core body holds at head dim
    D: ``GQA_CC_ELEMS`` accumulator slots over rows of D rounded up to a
    multiple of 32 (a warp's width, so that each register's row is known
    at compile time): 64, 32, 21, 16, 16 at D 32, 64, 96, 112, 128."""
    return GQA_CC_ELEMS // (-(-D // 32) * 32)


def gqa_heads_plan(G: int, D: int) -> Tuple[int, int]:
    """-> (rows, heads): the query rows and the query heads of one KV
    head that a block of the CUDA-core body serves, at most
    ``gqa_cc_rmax(D)`` (row, head) pairs in all (RMAX; a pair's
    accumulator of D floats lives in registers).  All G heads and RMAX //
    G rows where G <= RMAX; else one row and the G heads in ceil(G /
    RMAX) groups of ceil(G / groups) heads (the last group may hold
    fewer).  Pure Python on host ints."""
    rmax = gqa_cc_rmax(D)
    if G < 1 or rmax < 1:
        raise ValueError(f"no CUDA-core plan for G {G} at head dim {D}")
    heads = G if G <= rmax else -(-G // -(-G // rmax))
    return rmax // heads, heads


def gqa_cc_blocks(C: int, G: int, D: int) -> List[Tuple[int, int, int, int]]:
    """(c0, rows, g0, heads) of the query rows [c0, c0 + rows) and
    heads [g0, g0 + heads) (within one KV head's G) that each grid.x
    index of the CUDA-core body serves, in grid order, as the kernel
    computes them from ``gqa_heads_plan``."""
    rows, heads = gqa_heads_plan(G, D)
    groups = -(-G // heads)
    out = []
    for x in range(-(-C // rows) * groups):
        c0, g0 = x // groups * rows, x % groups * heads
        out.append((c0, min(rows, C - c0), g0, min(heads, G - g0)))
    return out


def gqa_plan(B: int, C: int, H: int, hkv: int, W: int, page: int, *,
             sms: int, D: int = 64) -> int:
    """-> split: the blocks (one thread block cluster, at most 8) over
    which the bf16 tensor-core kernel at head dim D splits each slot's
    table columns [0, W).  Its B x hkv x ceil(C G / 64) pair tiles (G = H
    / hkv) split into as many ranks as fill seven eighths of one wave of
    ``gqa_resident(D)`` blocks an SM (clusters are placed GPC by GPC: a
    wave filled to the last slot ran some clusters late in
    ``chip_smoke.py``'s split sweeps), but no more than leaves each rank
    two K tiles of the table (W page / ``gqa_tile_keys(D)`` / 2: the
    merge and a rank's first copies cost about a tile), nor W entries,
    and at least 1.  Two rules for the fill, each the one its sweeps
    measured:

    - D 64 (granite-3-2b): the tiles split only where they leave SMs
      idle, into the whole ranks that fit the seven eighths (granite's
      decode: 64 tiles, 7 ways; a mixed dispatch, 128 tiles, 3 ways over
      a long table, not over a few dozen entries).
    - D 96-128 (32-key tiles over 128 columns): the seven eighths
      rounded to the nearest rank, never past one whole wave, whether or
      not the tiles fill the SMs: at G 1 (zamba2, phi-3: 256 tiles, one
      real pair each at decode) a block walks a slot's whole context one
      short tile at a time, and halving the walk beat a wave of one
      block an SM.  Decode: qwen2's 32 tiles and granite-20b's 8 (MQA)
      split 8 ways, mixtral's 64 7 ways, G 1's 256 2 ways; an 8 x 32
      chunk over a long table: qwen2's 128 tiles 4 ways, G 1's 256 2
      ways (the smoke sweeps both); over a few dozen entries, none.

    Pure Python on host ints: the plan never reads the table or qpos."""
    tiles = B * hkv * -(-(C * (H // hkv)) // GQA_TILE_PAIRS)
    wave = gqa_resident(D) * sms
    k_tiles = -(-(W * page) // gqa_tile_keys(D))
    if gqa_cols(D) == 64:
        fill = wave * 7 // 8 // tiles if tiles < sms else 1
    else:
        fill = min(wave // tiles, (wave * 7 + 4 * tiles) // (8 * tiles))
    return max(1, min(split_k.MAX_SPLIT, W, k_tiles // 2, fill))


def split_ranges(W: int, split: int):
    """The table columns [lo, hi) of each rank of a ``split``, in rank
    order, as both kernels compute them: whole entries, W r / split
    rounded down."""
    return [(W * r // split, W * (r + 1) // split) for r in range(split)]


@counted("gqa_paged_flash", gqa_work)
def gqa_paged_flash(q: torch.Tensor, kpool: torch.Tensor,
                    vpool: torch.Tensor, ppool: torch.Tensor,
                    block_table: torch.Tensor, qpos: torch.Tensor, *,
                    window: int = 0, lo: Optional[int] = None,
                    n_local: Optional[int] = None, partial: bool = False):
    """q: (B, C, H, D); pools (n_pages, page, hkv, D) with position tags
    ``ppool`` (n_pages, page) int32; block_table (B, W) int32 page ids
    (a column slice of a wider table is fine; global ids, with ``lo`` /
    ``n_local`` the window of them that the pools hold at local index id
    - lo); qpos (B, C) int32.  -> (B, C, H, D) in q's dtype, or with
    ``partial`` the float32 statistics (m, l, acc) of shapes (B, hkv, G,
    C) and (B, hkv, G, C, D).  The CUDA kernel for a CUDA tensor (bf16
    at head dims 64-128: pages of a multiple of 8 rows), the plain
    version for a CPU tensor, an error for anything else."""
    if q.device.type == "cpu":
        return gqa_paged_flash_plain(q, kpool, vpool, ppool, block_table,
                                     qpos, window=window, lo=lo,
                                     n_local=n_local, partial=partial)
    return launch(q, kpool, vpool, ppool, block_table, qpos, window, lo=lo,
                  n_local=n_local, partial=partial)


def launch(q, kpool, vpool, ppool, block_table, qpos, window, *,
           split: Optional[int] = None, lo: Optional[int] = None,
           n_local: Optional[int] = None, partial: bool = False):
    """The CUDA kernel on CUDA tensors (``gqa_paged_flash``'s card path):
    the body ``gqa_body`` names, with no fallback (a failed launch
    raises).  The bf16 tensor-core body (head dims 64, 96, 112, 128)
    splits each slot's table over ``split`` ranks, ``gqa_plan``'s at
    this head dim unless given (``chip_smoke.py`` sweeps it); it plans
    over at most ``n_local`` entries, the live pages a window can hold.
    The CUDA-core body takes split 1 and ``gqa_heads_plan``'s rows and
    heads."""
    global launches, partial_launches
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
    W = block_table.shape[1]
    _check_window(lo, n_local, n_pages)
    base, n_loc = (0, n_pages) if lo is None else (int(lo), int(n_local))
    tc = gqa_body(q.dtype, D) == "tensor_cores"
    if tc and page % PAGE_ROWS:
        raise ValueError(f"the bf16 kernel at head dim {D} takes pages of "
                         f"a multiple of {PAGE_ROWS} rows, got {page}")
    q = q.contiguous()
    dev = q.device
    # the tensor-core body also copies the tags 16 bytes at a time
    copied = (q, kpool, vpool, ppool) if tc else (q, kpool, vpool)
    if any(ptr(t, dev) % 16 for t in copied):
        raise ValueError("q and the pools (and, in bf16, the tags) must "
                         "be 16-byte aligned")
    rows, heads = gqa_heads_plan(H // hkv, D)
    if not tc:
        split = 1
    elif split is None:
        split = gqa_plan(B, C, H, hkv, max(1, min(W, n_loc)), page,
                         sms=split_k.sm_count(dev), D=D)
    G = H // hkv
    if partial:
        m = torch.empty((B, hkv, G, C), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        out = torch.empty((B, hkv, G, C, D), dtype=torch.float32,
                          device=dev)
    else:
        m = l = None
        out = torch.empty((B, C, H, D), dtype=q.dtype, device=dev)
    err = lib().gqa_paged_flash(
        ptr(q, dev), ptr(kpool, dev), ptr(vpool, dev), ptr(ppool, dev),
        block_table.data_ptr(), ptr(qpos, dev), ptr(out, dev), ptr(m, dev),
        ptr(l, dev), B, C, H, hkv, D, page, W, block_table.stride(0), window,
        split, rows, heads, base, n_loc, D ** -0.5, code, stream)
    launches += 1
    partial_launches += partial
    check(err, "gqa_paged_flash")
    return (m, l, out) if partial else out


# ==========================================================================
# absorbed-MLA over paged latent pools
# ==========================================================================

def mla_paged_flash_plain(q_lat: torch.Tensor, q_pe: torch.Tensor,
                          ck_pool: torch.Tensor, cpe_pool: torch.Tensor,
                          cp_pool: torch.Tensor, block_table: torch.Tensor,
                          qpos: torch.Tensor, *, scale: float,
                          lo: Optional[int] = None,
                          n_local: Optional[int] = None,
                          partial: bool = False):
    """Plain version (the port of ``ref.mla_paged_ref``): gather the
    latent ring view through the table, entries that are not live as
    rows tagged -1, then a masked softmax over the live pages' keys in
    the latent space with float32 scores, statistics and accumulator;
    o_lat cast to q_lat's dtype, or with ``partial`` m / l (B, h, C) and
    acc (B, h, C, kr)."""
    B, C, h, kr = q_lat.shape
    rd = q_pe.shape[-1]
    W, page = block_table.shape[1], ck_pool.shape[1]
    ring = W * page
    _check_window(lo, n_local, ck_pool.shape[0])
    view = lambda pool, fill: _paged_view(pool, block_table, fill, lo,
                                          n_local)
    ck = view(ck_pool, 0).reshape(B, ring, kr).float()
    cpe = view(cpe_pool, 0).reshape(B, ring, rd).float()
    cp = view(cp_pool, -1).reshape(B, ring)
    keys = _live(block_table, lo, n_local)[1][..., None].expand(
        B, W, page).reshape(B, 1, 1, ring)
    s = (torch.einsum("bchk,btk->bhct", q_lat.float(), ck)
         + torch.einsum("bchr,btr->bhct", q_pe.float(), cpe)) * scale
    ok = (cp[:, None, None, :] >= 0) & \
        (cp[:, None, None, :] <= qpos[:, None, :, None])
    s = torch.where(ok, s, NEG_INF)
    m, l, acc = _stats(s, keys, ck, "bhct,btk->bhck")
    if partial:
        return m, l, acc
    o = acc / torch.clamp(l, min=1e-30)[..., None]
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


def mla_work(q_lat: torch.Tensor, q_pe: torch.Tensor,
             ck_pool: torch.Tensor, cpe_pool: torch.Tensor,
             cp_pool: torch.Tensor, block_table: torch.Tensor,
             qpos: torch.Tensor, *, scale: float = 1.0,
             lo: Optional[int] = None, n_local: Optional[int] = None,
             partial: bool = False) -> Tuple[int, int, str]:
    """-> (bytes, operations, kind) of one ``mla_paged_flash`` call:
    every distinct live page's latent and rope rows and tags once; q
    (latent and rope), the table and qpos; o_lat, or the float32
    statistics.  Operations: the scores (kr + rd) and the latent
    accumulation (kr), 2 each, for every (query row, head, key) pair the
    masks let through.  Reads the table, tags and positions back."""
    B, C, h, kr = q_lat.shape
    rd, page = q_pe.shape[-1], ck_pool.shape[1]
    elt = q_lat.element_size()
    live, ok = _seen(cp_pool, block_table, qpos, 0, lo, n_local)
    n_pages = _unique_pages(block_table, live)
    out = B * h * C * (kr + 2) * 4 if partial else q_lat.numel() * elt
    nbytes = (n_pages * page * ((kr + rd) * elt + 4)
              + (q_lat.numel() + q_pe.numel()) * elt + out
              + block_table.numel() * 4 + qpos.numel() * 4)
    kind = "bf16" if q_lat.dtype == torch.bfloat16 else "fp32"
    return nbytes, int(ok.sum()) * h * 2 * (2 * kr + rd), kind


@counted("mla_paged_flash", mla_work)
def mla_paged_flash(q_lat: torch.Tensor, q_pe: torch.Tensor,
                    ck_pool: torch.Tensor, cpe_pool: torch.Tensor,
                    cp_pool: torch.Tensor, block_table: torch.Tensor,
                    qpos: torch.Tensor, *, scale: float,
                    lo: Optional[int] = None, n_local: Optional[int] = None,
                    partial: bool = False):
    """q_lat: (B, C, h, kr) with W_uk absorbed, q_pe: (B, C, h, rd);
    pools (n_pages, page, kr) / (n_pages, page, rd) with position tags
    ``cp_pool`` (n_pages, page) int32; block_table (B, W) int32 (a
    column slice of a wider table is fine; global ids, ``lo`` /
    ``n_local`` as in ``gqa_paged_flash``); qpos (B, C) int32.  ->
    o_lat (B, C, h, kr) in q_lat's dtype (the caller absorbs W_uv), or
    with ``partial`` the float32 (m, l, acc) of shapes (B, h, C) and (B,
    h, C, kr).  The CUDA kernel for a CUDA tensor (bf16: pages of a
    multiple of 8 rows, rd <= 64), the plain version for a CPU tensor,
    an error for anything else."""
    if q_lat.device.type == "cpu":
        return mla_paged_flash_plain(q_lat, q_pe, ck_pool, cpe_pool,
                                     cp_pool, block_table, qpos,
                                     scale=scale, lo=lo, n_local=n_local,
                                     partial=partial)
    return _launch_mla(q_lat, q_pe, ck_pool, cpe_pool, cp_pool, block_table,
                       qpos, scale, lo, n_local, partial)


def _launch_mla(q_lat, q_pe, ck_pool, cpe_pool, cp_pool, block_table, qpos,
                scale, lo=None, n_local=None, partial=False):
    global mla_launches, mla_partial_launches
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
    if bf16 and (not 0 < rd <= MLA_MAX_ROPE or page % PAGE_ROWS):
        raise ValueError(f"the bf16 kernel takes 0 < rd <= {MLA_MAX_ROPE} "
                         f"and pages of a multiple of {PAGE_ROWS} rows, "
                         f"got rd {rd}, page {page}")
    W = block_table.shape[1]
    if W < 1:
        raise ValueError("the block table has no column")
    _check_window(lo, n_local, n_pages)
    base, n_loc = (0, n_pages) if lo is None else (int(lo), int(n_local))
    q_lat, q_pe = q_lat.contiguous(), q_pe.contiguous()
    dev = q_lat.device
    if any(ptr(t, dev) % 16 for t in (q_lat, q_pe, ck_pool, cpe_pool,
                                       cp_pool)):
        raise ValueError("q and the pools must be 16-byte aligned")
    # float32 walks each slot whole on the CUDA cores; the plan counts
    # at most n_local entries, the live pages a window can hold
    split = mla_plan(B, C, h, max(1, min(W, n_loc)), page,
                     sms=split_k.sm_count(dev)) if bf16 else 1
    if partial:
        m = torch.empty((B, h, C), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        out = torch.empty((B, h, C, kr), dtype=torch.float32, device=dev)
    else:
        m = l = None
        out = torch.empty((B, C, h, kr), dtype=q_lat.dtype, device=dev)
    err = lib().mla_paged_flash(
        ptr(q_lat, dev), ptr(q_pe, dev), ptr(ck_pool, dev),
        ptr(cpe_pool, dev), ptr(cp_pool, dev), block_table.data_ptr(),
        ptr(qpos, dev), ptr(out, dev), ptr(m, dev), ptr(l, dev), B, C, h,
        kr, rd, page, n_pages, W, block_table.stride(0), split, base, n_loc,
        float(scale), code, stream)
    mla_launches += 1
    mla_partial_launches += partial
    check(err, "mla_paged_flash")
    return (m, l, out) if partial else out
