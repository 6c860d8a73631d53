"""GQA and MLA attention: the teacher-forced forward and the serving
chunk step over the slotted cache or the paged pool.

Scores and softmax statistics are float32; activations stay in the
model's compute dtype (``repro.models.layers.attention``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import (gqa_paged_flash,
                                                 mla_paged_flash)
from repro_torch.models.layers.common import dense_init
from repro_torch.models.layers.norms import apply_norm, stacked_norm_init
from repro_torch.models.layers.rope import apply_rope

NEG_INF = -1e30


def gqa_init(gen: torch.Generator, cfg: ModelConfig,
             n_layers: int) -> Dict[str, torch.Tensor]:
    """Layer-stacked (leading ``n_layers`` dim) GQA projections."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pd, L = cfg.tparam_dtype, n_layers
    p = {
        "wq": dense_init(gen, (L, d, h * hd), pd),
        "wk": dense_init(gen, (L, d, hkv * hd), pd),
        "wv": dense_init(gen, (L, d, hkv * hd), pd),
        "wo": dense_init(gen, (L, h * hd, d), pd),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = torch.zeros((L, width), dtype=pd, device=gen.device)
    return p


def _qkv(params, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype
    q = x @ params["wq"].to(dt)
    k = x @ params["wk"].to(dt)
    v = x @ params["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    return (q.reshape(B, S, h, hd), k.reshape(B, S, hkv, hd),
            v.reshape(B, S, hkv, hd))


def position_ok(q_pos, kv_pos, causal: bool, window: int):
    """The slot-pool mask predicate: a kv row is visible iff its tag is a
    real position (>= 0), not in the causal future, and inside the
    sliding window (``repro.distributed.decode_attention.position_ok``)."""
    rel = q_pos - kv_pos
    ok = kv_pos >= 0
    if causal:
        ok = ok & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    return ok


def _bias(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, 0.0, NEG_INF).float()


def _sdpa(q, k, v, bias):
    """q:(B,Sq,H,D) k:(B,Skv,Hkv,D) v:(B,Skv,Hkv,Dv); bias broadcasts
    against the (B, Hkv, G, Sq, Skv) scores."""
    B, Sq, H, D = q.shape
    Hkv, Dv = k.shape[2], v.shape[-1]
    G = H // Hkv
    qf = q.reshape(B, Sq, Hkv, G, D)
    # JAX's preferred_element_type=f32: bf16 products are exact in f32,
    # so casting the operands first gives the f32-accumulated result
    s = torch.einsum("bqkgd,btkd->bkgqt", qf.float(), k.float())
    s = s * (D ** -0.5) + bias
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Sq, H, Dv)


def attend(q, k, v, q_pos, kv_pos, *, causal: bool, window: int = 0):
    """Shared-position attention (the teacher-forced forward).  The JAX
    package switches to a chunked softmax above 4096 kv positions; the
    calibration and serving shapes of this slice stay below that."""
    ok = position_ok(q_pos[:, None], kv_pos[None, :], causal, window)
    return _sdpa(q, k, v, _bias(ok))


def attend_batched(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                   window: int = 0):
    """Attention with PER-SLOT positions: q_pos (B, Sq), kv_pos (B, Skv);
    kv entries tagged -1 are masked."""
    ok = position_ok(q_pos[:, :, None], kv_pos[:, None, :], causal, window)
    return _sdpa(q, k, v, _bias(ok)[:, None, None])


def gqa_forward(params, cfg: ModelConfig, x, positions):
    q, k, v = _qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    pos1 = positions[0] if positions.ndim == 2 else positions
    o = attend(q, k, v, pos1, pos1, causal=cfg.causal,
               window=cfg.sliding_window)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ params["wo"].to(x.dtype)


# --- decode cache -----------------------------------------------------------

def ring_rows(cfg: ModelConfig, max_len: int) -> int:
    """Rows of a slot's kv ring: the window (with the serving chunk
    slack already added by ``kv_pool.ring_cfg``), at most ``max_len``."""
    return min(cfg.sliding_window or max_len, max_len)


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   n_layers: int, device) -> Dict[str, torch.Tensor]:
    Lr = ring_rows(cfg, max_len)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((n_layers, batch, Lr, hkv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((n_layers, batch, Lr, hkv, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((n_layers, Lr), -1, dtype=torch.int32,
                          device=device),
    }


def gqa_decode(params, cfg: ModelConfig, x, cache, pos):
    """One token per sequence at the shared position ``pos`` (a 0-dim
    int tensor) over ``gqa_cache_init``'s layout for one layer ({k, v
    (B, Lr, hkv, hd), pos (Lr,)}): writes ring row ``pos % Lr`` IN PLACE
    and returns the attention output (B, 1, d)
    (``repro.models.layers.attention.gqa_decode``)."""
    B = x.shape[0]
    q, k, v = _qkv(params, cfg, x)
    p1 = pos.reshape(1).long()
    pvec = p1[None, :].expand(B, 1)
    q = apply_rope(q, pvec, cfg.rope_theta)
    k = apply_rope(k, pvec, cfg.rope_theta)
    row = p1 % cache["k"].shape[1]
    cache["k"].index_copy_(1, row, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, row, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(0, row, p1.int())
    o = attend(q, cache["k"], cache["v"], p1, cache["pos"], causal=True,
               window=cfg.sliding_window)
    return o.reshape(B, 1, -1) @ params["wo"].to(x.dtype)


def gqa_chunk(params, cfg: ModelConfig, x, cache, pos, valid,
              block_table=None):
    """Serving chunk step: consume x (B, C, d) at per-slot positions
    ``pos`` (B,), with ``valid`` (B, C) marking real tokens.  UPDATES
    ``cache`` IN PLACE and returns the attention output.

    Slotted layout (``block_table`` None): ``cache`` is {k, v (B, Lr,
    hkv, hd), pos (B, Lr)}.  JAX drops invalid tokens with an
    out-of-range ``mode="drop"`` scatter; torch has none, so every token
    writes its ring row and an invalid token writes back the row's
    current value.  The C rows of one slot are distinct (C <= Lr), so
    the write order is immaterial and an idle slot's cache stays
    bit-identical across the dispatch.

    Paged layout: ``cache`` is one layer's pools {k, v (n_pages + 1,
    page, hkv, hd), pos (n_pages + 1, page)} and ``block_table`` (B, W)
    the (possibly column-sliced) table: ring row ``r = qpos % (W *
    page)`` lives at page ``block_table[b, r // page]``, offset ``r %
    page``.  The pool made every page this dispatch writes exclusively
    owned beforehand (copy-on-write is host-side)."""
    B, C, _ = x.shape
    q, k, v = _qkv(params, cfg, x)
    qpos = pos[:, None].long() + torch.arange(C, device=x.device)[None, :]
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    if block_table is not None:
        ck, cv, cp = cache["k"], cache["v"], cache["pos"]
        page = ck.shape[1]
        r = qpos % (block_table.shape[1] * page)
        pidx = torch.gather(block_table, 1, r // page).long()
        # no mode="drop" scatter in torch, and a dropped token's (page,
        # offset) may be the null page 0, whose tags must stay -1: an
        # invalid token writes the pool's trailing scratch page instead,
        # which no table holds, so every real page stays bit-identical
        pidx = torch.where(valid, pidx, ck.shape[0] - 1)
        off = r % page
        qpos = qpos.int()
        # write before attend: the kernel reads this dispatch's own rows,
        # queued after these writes on the same stream
        ck[pidx, off] = k
        cv[pidx, off] = v
        cp[pidx, off] = qpos
        o = gqa_paged_flash(q, ck, cv, cp, block_table, qpos,
                            window=cfg.sliding_window)
        return o.reshape(B, C, -1) @ params["wo"].to(x.dtype)
    Lr = cache["k"].shape[1]
    if C > Lr:
        raise ValueError(f"chunk {C} exceeds the kv ring length {Lr}")
    rows = qpos % Lr
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, C)
    vk = valid[..., None, None]
    ck, cv, cp = cache["k"], cache["v"], cache["pos"]
    ck[bidx, rows] = torch.where(vk, k, ck[bidx, rows])
    cv[bidx, rows] = torch.where(vk, v, cv[bidx, rows])
    cp[bidx, rows] = torch.where(valid, qpos.int(), cp[bidx, rows])
    o = attend_batched(q, ck, cv, qpos, cp, causal=True,
                       window=cfg.sliding_window)
    return o.reshape(B, C, -1) @ params["wo"].to(x.dtype)


# ===========================================================================
# MLA (DeepSeek-V2): low-rank joint kv compression + decoupled RoPE head
# ===========================================================================

def mla_init(gen: torch.Generator, cfg: ModelConfig,
             n_layers: int) -> Dict[str, torch.Tensor]:
    """Layer-stacked MLA projections and norms."""
    d, h = cfg.d_model, cfg.n_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    pd, L, dev = cfg.tparam_dtype, n_layers, gen.device
    return {
        "wq_a": dense_init(gen, (L, d, qr), pd),
        "q_norm": stacked_norm_init(cfg.norm, qr, L, dev),
        "wq_b": dense_init(gen, (L, qr, h * (nd + rd)), pd),
        "wkv_a": dense_init(gen, (L, d, kr + rd), pd),
        "kv_norm": stacked_norm_init(cfg.norm, kr, L, dev),
        "wk_b": dense_init(gen, (L, kr, h * nd), pd),
        "wv_b": dense_init(gen, (L, kr, h * vd), pd),
        "wo": dense_init(gen, (L, h * vd, d), pd),
    }


def _mla_q(params, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    h = cfg.n_heads
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dt = x.dtype
    cq = apply_norm(cfg.norm, params["q_norm"], x @ params["wq_a"].to(dt))
    q = (cq @ params["wq_b"].to(dt)).reshape(B, S, h, nd + rd)
    q_nope, q_pe = q[..., :nd], q[..., nd:]
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _mla_kv_compress(params, cfg: ModelConfig, x, positions):
    kr = cfg.kv_lora_rank
    kv = x @ params["wkv_a"].to(x.dtype)
    c_kv = apply_norm(cfg.norm, params["kv_norm"], kv[..., :kr])
    k_pe = apply_rope(kv[..., kr:][:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_pe


def mla_forward(params, cfg: ModelConfig, x, positions):
    """Teacher-forced path: expand the latent kv to per-head k / v."""
    B, S, _ = x.shape
    h = cfg.n_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = x.dtype
    q_nope, q_pe = _mla_q(params, cfg, x, positions)
    c_kv, k_pe = _mla_kv_compress(params, cfg, x, positions)
    k_nope = (c_kv @ params["wk_b"].to(dt)).reshape(B, S, h, nd)
    v = (c_kv @ params["wv_b"].to(dt)).reshape(B, S, h, vd)
    # the rope dims ride in k / q so that the shared attend serves
    k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, h, rd)],
                       -1)
    q_full = torch.cat([q_nope, q_pe], -1)
    pos1 = positions[0] if positions.ndim == 2 else positions
    o = attend(q_full, k_full, v, pos1, pos1, causal=True, window=0)
    return o.reshape(B, S, h * vd) @ params["wo"].to(dt)


def mla_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   n_layers: int, device) -> Dict[str, torch.Tensor]:
    """The latent cache holds the full ``max_len`` (no ring)."""
    return {
        "c_kv": torch.zeros((n_layers, batch, max_len, cfg.kv_lora_rank),
                            dtype=dtype, device=device),
        "k_pe": torch.zeros((n_layers, batch, max_len,
                             cfg.qk_rope_head_dim), dtype=dtype,
                            device=device),
        "pos": torch.full((n_layers, batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_chunk(params, cfg: ModelConfig, x, cache, pos, valid,
              block_table=None):
    """Serving chunk step for MLA (absorbed latent attention): x (B, C, d)
    at per-slot positions ``pos`` (B,), ``valid`` (B, C) marking real
    tokens.  UPDATES ``cache`` IN PLACE and returns the attention output.

    Slotted layout: ``cache`` is {c_kv (B, max_len, kr), k_pe (B,
    max_len, rd), pos (B, max_len)}; an invalid token writes back the
    row's current value (no ``mode="drop"`` scatter in torch).  Paged
    layout: one layer's pools {c_kv (n_pages + 1, page, kr), k_pe,
    pos (n_pages + 1, page)}; absolute position p lives at page
    ``block_table[b, p // page]``, offset ``p % page`` (no ring: MLA
    caches the full max_len), and an invalid token writes the trailing
    scratch page.  The paged attend is ``mla_paged_flash`` in the
    latent space; W_uv is absorbed after it.  The JAX package's
    page-sharded branch (a distributed flash decode over a mesh) waits
    for the multi-device slice (ROADMAP queue A 7)."""
    B, C, _ = x.shape
    h, nd, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    kr, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dt = x.dtype
    scale = (nd + rd) ** -0.5
    qpos = pos[:, None].long() + torch.arange(C, device=x.device)[None, :]
    q_nope, q_pe = _mla_q(params, cfg, x, qpos)           # (B,C,h,nd/rd)
    c_kv_t, k_pe_t = _mla_kv_compress(params, cfg, x, qpos)
    wk_b = params["wk_b"].to(dt).reshape(kr, h, nd)
    wv_b = params["wv_b"].to(dt).reshape(kr, h, vd)
    q_lat = torch.einsum("bchd,khd->bchk", q_nope, wk_b)  # absorb W_uk
    ck, cpe, cp = cache["c_kv"], cache["k_pe"], cache["pos"]
    if block_table is not None:
        page = ck.shape[1]
        # an invalid token may sit past the active table width: clamp
        # its block, then send it to the scratch page no table holds
        blk = torch.clamp(qpos // page, max=block_table.shape[1] - 1)
        pidx = torch.gather(block_table, 1, blk).long()
        pidx = torch.where(valid, pidx, ck.shape[0] - 1)
        off = qpos % page
        qpos = qpos.int()
        ck[pidx, off] = c_kv_t
        cpe[pidx, off] = k_pe_t
        cp[pidx, off] = qpos
        o_lat = mla_paged_flash(q_lat, q_pe, ck, cpe, cp, block_table,
                                qpos, scale=scale)
    else:
        if C > ck.shape[1]:
            raise ValueError(f"chunk {C} exceeds the cache length "
                             f"{ck.shape[1]}")
        bidx = torch.arange(B, device=x.device)[:, None].expand(B, C)
        rows = torch.clamp(qpos, max=ck.shape[1] - 1)
        vk = valid[..., None]
        ck[bidx, rows] = torch.where(vk, c_kv_t, ck[bidx, rows])
        cpe[bidx, rows] = torch.where(vk, k_pe_t, cpe[bidx, rows])
        cp[bidx, rows] = torch.where(valid, qpos.int(), cp[bidx, rows])
        s = (torch.einsum("bchk,btk->bhct", q_lat.float(), ck.float())
             + torch.einsum("bchr,btr->bhct", q_pe.float(), cpe.float()))
        s = s * scale
        ok = position_ok(qpos[:, None, :, None], cp[:, None, None, :], True,
                         0)
        p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1).to(dt)
        o_lat = torch.einsum("bhct,btk->bchk", p, ck)
    o = torch.einsum("bchk,khv->bchv", o_lat, wv_b)       # absorb W_uv
    return o.reshape(B, C, h * vd) @ params["wo"].to(dt)
