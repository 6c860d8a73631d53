"""GQA attention: the teacher-forced forward and the serving chunk step
over the slotted ring cache or the paged pool.

Scores and softmax statistics are float32; activations stay in the
model's compute dtype (``repro.models.layers.attention``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention import gqa_paged_flash
from repro_torch.models.layers.common import dense_init
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
