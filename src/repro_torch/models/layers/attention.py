"""GQA and MLA attention: the teacher-forced forward (with the chunked
softmax for long sequences and the banded sliding window), the
static-batch prefill and decode over ``cache_init``'s cache, and the
serving chunk step over the slotted cache or the paged pool.

Scores and softmax statistics are float32; activations stay in the
model's compute dtype (``repro.models.layers.attention``).

Under a mesh (``distributed.sharding_rules.activation_context``) GQA is
tensor-parallel where the layer loop left its projections split over
``model`` (``tp_keep``): ``wq`` (and ``wk`` / ``wv`` where the kv heads
divide; else they are whole and each rank takes the kv heads its query
heads read) by head, ``wo`` by row, one ``all_reduce_sum`` after it.
Under either param layout the form sees the same blocks: the
``"contract_tp"`` splits (``wq`` / ``wk`` / ``wv`` on their input dim,
``wo`` on its output dim) are moved onto the heads by
``sharding_rules.use``.
The static decode over a sequence-sharded ring (``gqa_cache_init`` under
the mesh: rank j holds ring rows [j Lr / MP, (j + 1) Lr / MP) of every
kv head) is the reference's ``_tp_flash_decode``: q and the new row's
k, v gathered over heads, the row written by its owner only, each
rank's flash statistics over its rows merged exactly by
``collectives.flash_merge`` (one collective, where the reference takes
a pmax and two psums).  MLA is tensor-parallel by head where its heads
divide over ``model``: ``wq_b``, ``wk_b`` and ``wv_b`` by head column,
``wo`` by row.  Its latents (the query's ``wq_a`` + ``q_norm``, the kv's
``wkv_a`` + ``kv_norm`` and the rope key) are shared by every head, so
they are computed whole on every rank from the gathered ``wq_a`` /
``wkv_a`` (which ``wkv_a``'s split, cutting the latent mid-way, could
not serve) and enter the region together, one collective in the
backward (``_mla_latents``); the rank expands and attends its own heads
only.  The static prefill and decode take the same form: the latent
cache is whole on every rank.  Under sequence parallelism the
tensor-parallel GQA and MLA take their input gathered over S and close
with a reduce-scatter over S (``sharding_rules.tp_enter`` /
``tp_exit``); the caller gathers and splits
(``sharding_rules.seq_call``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as co
from repro_torch.distributed import decode_attention as da
from repro_torch.distributed import sharding_rules as sr
from repro_torch.kernels.paged_attention import (gqa_paged_flash,
                                                 mla_paged_flash)
from repro_torch.models.layers.common import dense_init
from repro_torch.models.layers.norms import apply_norm, stacked_norm_init
from repro_torch.models.layers.rope import apply_rope
from repro_torch.tree import tree_map

NEG_INF = -1e30
_FLASH_THRESHOLD = 4096   # the chunked softmax above this many kv positions
_CHUNK = 1024


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


def tp_keep(cfg: ModelConfig, specs, mp: int, prefix: str = "attn/"
            ) -> dict:
    """The attention leaves whose ``model`` splits the tensor-parallel
    attention consumes, each with the dim it consumes it on
    (``sharding_rules.use``), where the query heads divide over ``mp``
    ranks (else none: the layer is gathered whole).

    GQA: ``wq`` by head column (dim -1) and ``wo`` by head row (dim -2);
    ``wk`` / ``wv`` by head column too where the kv heads divide (else
    they are gathered whole, and each rank takes the kv heads its query
    heads read).  Under ``"fsdp_tp"`` the splits lie there already, and
    ``bq`` (``bk`` / ``bv``) is split by head as well.  Under
    ``"contract_tp"`` ``wq`` / ``wk`` / ``wv`` are split on their input
    dim and ``wo`` on its output dim, and ``use`` moves each onto the
    form's dim; the biases are replicated, and the form takes its heads'
    slice of them (``_qkv_tp``).  MLA (``"fsdp_tp"`` only): ``wq_b``,
    ``wk_b`` and ``wv_b`` by head column and ``wo`` by row; under
    ``"contract_tp"``, whose ``wq_a`` / ``wkv_a`` / ``wq_b`` splits no
    MLA form consumes, the layer is gathered whole."""
    if mp == 1 or not isinstance(specs, dict) or cfg.n_heads % mp:
        return {}
    if cfg.mla:
        keep = {"wq_b": -1, "wk_b": -1, "wv_b": -1, "wo": -2}
        if not all(sr.on_model(specs, k, d) for k, d in keep.items()):
            return {}
        return {prefix + k: d for k, d in keep.items()}
    if sr.model_dim(specs, "wq") is None or \
            sr.model_dim(specs, "wo") is None:
        return {}
    keep = {"wq": -1, "wo": -2}
    if cfg.qkv_bias and sr.on_model(specs, "bq", -1):
        keep["bq"] = -1
    if cfg.n_kv_heads % mp == 0 and sr.model_dim(specs, "wk") is not None \
            and sr.model_dim(specs, "wv") is not None:
        keep.update(wk=-1, wv=-1)
        if cfg.qkv_bias and sr.on_model(specs, "bk", -1):
            keep.update(bk=-1, bv=-1)
    return {prefix + k: d for k, d in keep.items()}


def tp_group(params):
    """The ``model`` group a tensor-parallel attention layer (GQA or
    MLA) runs over, or None for a layer gathered whole."""
    return sr.split_group(params["wo"])


def _tp_heads(params, cfg: ModelConfig):
    """-> (model group, first local query head, local query heads) of a
    tensor-parallel layer, or None."""
    group = sr.split_group(params["wq"])
    if group is None:
        return None
    h_loc = params["wq"].shape[-1] // cfg.head_dim
    return group, group.rank * h_loc, h_loc


def _proj(x, params, w: str, b: str, cfg: ModelConfig):
    y = x @ params[w].to(x.dtype)
    if cfg.qkv_bias:
        y = y + params[b].to(x.dtype)
    B, S = x.shape[:2]
    return y.reshape(B, S, -1, cfg.head_dim)


def _tp_biases(params, names, group):
    """``params`` with the rank's head slice of each bias in ``names``
    that the layer loop left whole (``"contract_tp"`` replicates them):
    ``sharding_rules.tp_slice``, whose backward gathers the slices'
    gradients, so that the whole bias's is the same on every rank."""
    whole = [n for n in names if n in params
             and sr.split_group(params[n]) is None]
    if not whole:
        return params
    return dict(params, **{n: sr.tp_slice(params[n], -1, group)
                           for n in whole})


def _qkv_tp(params, cfg: ModelConfig, x, tp):
    """The local heads' q (B, S, H/MP, D), and the k, v they read: the
    local kv heads where ``wk`` / ``wv`` are split, else the whole kv
    projection computed on every rank (the replicated region) and the
    heads the local query heads read taken after ``copy_to_model``.
    -> (q, k, v, full k, full v) (the last two None when split)."""
    group, h0, h_loc = tp
    split_kv = sr.split_group(params["wk"]) is not None
    params = _tp_biases(params, ("bq", "bk", "bv") if split_kv else ("bq",),
                        group)
    xf = sr.tp_enter(x, group)
    q = _proj(xf, params, "wq", "bq", cfg)
    if split_kv:
        return (q, _proj(xf, params, "wk", "bk", cfg),
                _proj(xf, params, "wv", "bv", cfg), None, None)
    whole = dict(params, **{n: sr.tp_weight(params[n], group)
                            for n in ("wk", "wv", "bk", "bv")
                            if n in params})
    k_all = _proj(x, whole, "wk", "bk", cfg)
    v_all = _proj(x, whole, "wv", "bv", cfg)
    G = cfg.n_heads // cfg.n_kv_heads
    k_loc, v_loc = sr.tp_enter(k_all, group), sr.tp_enter(v_all, group)
    if h0 % G == 0 and h_loc % G == 0:              # whole kv groups
        sel = slice(h0 // G, (h0 + h_loc) // G)
        return q, k_loc[:, :, sel], v_loc[:, :, sel], k_all, v_all
    if h0 // G == (h0 + h_loc - 1) // G:            # one kv head
        sel = slice(h0 // G, h0 // G + 1)
        return q, k_loc[:, :, sel], v_loc[:, :, sel], k_all, v_all
    idx = torch.arange(h0, h0 + h_loc, device=x.device) // G
    return q, k_loc[:, :, idx], v_loc[:, :, idx], k_all, v_all


def _tp_out(o, params, tp, x):
    """The row-parallel ``wo`` over the local heads' output, summed over
    ``model`` (under sequence parallelism: this rank's S rows of the
    sum, ``sharding_rules.tp_exit``)."""
    B, S = x.shape[:2]
    y = o.reshape(B, S, -1) @ params["wo"].to(x.dtype)
    return sr.tp_exit(y, tp[0], 1)


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


def _mask_bias(q_pos, kv_pos, causal: bool, window: int) -> torch.Tensor:
    """(Sq, Skv) additive float32 bias from shared position vectors."""
    return _bias(position_ok(q_pos[:, None], kv_pos[None, :], causal,
                             window))


def _pad_rows(a: torch.Tensor, n: int, front: bool, value=0):
    """``a`` with ``n`` rows of ``value`` added along dim 1 (dim 0 for a
    position vector), in front or behind."""
    dim = 0 if a.ndim == 1 else 1
    shape = list(a.shape)
    shape[dim] = n
    pad = torch.full(shape, value, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a] if front else [a, pad], dim)


def _flash(q, k, v, q_pos, kv_pos, causal: bool, window: int):
    """Chunked-softmax attention: a loop over kv chunks of ``_CHUNK``
    rows with running float32 (max, denominator, accumulator), so that
    the scores held at once are one (Sq, chunk) tile per head.  q is
    scaled by D^-0.5 in its own dtype before the product; the padding
    of the last chunk carries the position tag -1 (masked)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // Hkv
    C = min(_CHUNK, Skv)
    n_chunks = (Skv + C - 1) // C
    pad = n_chunks * C - Skv
    if pad:
        k, v = _pad_rows(k, pad, False), _pad_rows(v, pad, False)
        kv_pos = _pad_rows(kv_pos, pad, False, -1)
    qf = (q.reshape(B, Sq, Hkv, G, D) * (D ** -0.5)).to(q.dtype).float()
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        kb, vb = k[:, i * C:(i + 1) * C], v[:, i * C:(i + 1) * C]
        s = torch.einsum("bqkgd,btkd->bkgqt", qf, kb.float())
        s += _mask_bias(q_pos, kv_pos[i * C:(i + 1) * C], causal, window)
        m_new = torch.maximum(m, s.amax(-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqt,btkd->bkgqd", p.to(vb.dtype), vb).float()
        m = m_new
        del s, p
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv).to(q.dtype)


def _banded(q, k, v, q_pos, kv_pos, window: int):
    """Sliding-window self-attention over the in-window kv rows only:
    q chunk i attends kv rows [i C - W, i C + C) of the sequence with W
    rows of tag -1 padded in front, O(S (W + C)) work and memory."""
    B, S, H, D = q.shape
    C = min(_CHUNK, S)
    assert S % C == 0, "banded path expects seq % chunk == 0"
    W = window
    span = W + C
    kp, vp = _pad_rows(k, W, True), _pad_rows(v, W, True)
    pp = _pad_rows(kv_pos, W, True, -1)
    outs = []
    for i in range(S // C):
        lo = i * C
        bias = _mask_bias(q_pos[lo:lo + C], pp[lo:lo + span], True, W)
        outs.append(_sdpa(q[:, lo:lo + C], kp[:, lo:lo + span],
                          vp[:, lo:lo + span], bias))
    return torch.cat(outs, 1)


def attend(q, k, v, q_pos, kv_pos, *, causal: bool, window: int = 0,
           threshold: Optional[int] = None):
    """Shared-position attention, by the branch the JAX package takes at
    the same shapes: ``_banded`` for windowed self-attention longer than
    its window (whole chunks), ``_flash`` above ``threshold`` kv
    positions (the model layers pass ``cfg.flash_threshold``; default
    ``_FLASH_THRESHOLD``), else the full (Sq, Skv) bias."""
    Sq, Skv = q.shape[1], k.shape[1]
    if window and Sq == Skv and Sq % min(_CHUNK, Sq) == 0 and Sq > window:
        return _banded(q, k, v, q_pos, kv_pos, window)
    if Skv > (_FLASH_THRESHOLD if threshold is None else threshold):
        return _flash(q, k, v, q_pos, kv_pos, causal, window)
    return _sdpa(q, k, v, _mask_bias(q_pos, kv_pos, causal, window))


def attend_batched(q, k, v, q_pos, kv_pos, *, causal: bool = True,
                   window: int = 0):
    """Attention with PER-SLOT positions: q_pos (B, Sq), kv_pos (B, Skv);
    kv entries tagged -1 are masked."""
    ok = position_ok(q_pos[:, :, None], kv_pos[:, None, :], causal, window)
    return _sdpa(q, k, v, _bias(ok)[:, None, None])


def gqa_forward(params, cfg: ModelConfig, x, positions):
    tp = _tp_heads(params, cfg)
    if tp is not None:
        q, k, v, _, _ = _qkv_tp(params, cfg, x, tp)
    else:
        q, k, v = _qkv(params, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    pos1 = positions[0] if positions.ndim == 2 else positions
    o = attend(q, k, v, pos1, pos1, causal=cfg.causal,
               window=cfg.sliding_window, threshold=cfg.flash_threshold)
    if tp is not None:
        return _tp_out(o, params, tp, x)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ params["wo"].to(x.dtype)


# --- decode cache -----------------------------------------------------------

def ring_rows(cfg: ModelConfig, max_len: int) -> int:
    """Rows of a slot's kv ring: the window (with the serving chunk
    slack already added by ``kv_pool.ring_cfg``), at most ``max_len``."""
    return min(cfg.sliding_window or max_len, max_len)


def gqa_cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   n_layers: int, device) -> Dict[str, torch.Tensor]:
    """The static batch's ring: (L, B, Lr, hkv, hd) k and v and (L, Lr)
    position tags.  Under a mesh of MP > 1 ``model`` ranks where MP
    divides the ring, this rank's block of Lr / MP rows, and a
    ``ring_lo`` leaf (L,) holding the block's first row: the layout of
    the sequence-sharded decode."""
    Lr = ring_rows(cfg, max_len)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    group = sr.model_group()
    out = {}
    if group is not None and Lr % group.size == 0:
        Lr //= group.size
        out["ring_lo"] = torch.full((n_layers,), group.rank * Lr,
                                    dtype=torch.int32, device=device)
    out.update({
        "k": torch.zeros((n_layers, batch, Lr, hkv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((n_layers, batch, Lr, hkv, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((n_layers, Lr), -1, dtype=torch.int32,
                          device=device),
    })
    return out


def gqa_decode(params, cfg: ModelConfig, x, cache, pos):
    """One token per sequence at the shared position ``pos`` (a 0-dim
    int tensor) over ``gqa_cache_init``'s layout for one layer ({k, v
    (B, Lr, hkv, hd), pos (Lr,)}): writes ring row ``pos % Lr`` IN PLACE
    and returns the attention output (B, 1, d)
    (``repro.models.layers.attention.gqa_decode``).  Under a mesh:
    ``_tp_decode``."""
    B = x.shape[0]
    if sr.model_group() is not None:
        return _tp_decode(params, cfg, x, cache, pos)
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
               window=cfg.sliding_window, threshold=cfg.flash_threshold)
    return o.reshape(B, 1, -1) @ params["wo"].to(x.dtype)


def _full_heads(params, cfg: ModelConfig, x, tp):
    """q, k, v of every head on every rank (B, S, heads, D): the local
    heads' all-gathered over ``model`` (a few KB at decode), or the
    whole projections of a layer with no split."""
    if tp is None:
        return _qkv(params, cfg, x)
    group = tp[0]
    q, k, v, k_all, v_all = _qkv_tp(params, cfg, x, tp)
    q = co.all_gather(q, 2, group, "decode_heads")
    if k_all is None:
        k_all = co.all_gather(k, 2, group, "decode_heads")
        v_all = co.all_gather(v, 2, group, "decode_heads")
    return q, k_all, v_all


def _owned_write(buf, dim: int, row, lo: int, new) -> None:
    """Write ``new`` at global ring row ``row`` (a 1-element device
    tensor) of ``buf``'s local block [lo, lo + rows) along ``dim``, IN
    PLACE, where this rank owns it; elsewhere the row is written back
    unchanged (no host read of the position)."""
    rows = buf.shape[dim]
    loc = row - lo
    own = (loc >= 0) & (loc < rows)
    loc = torch.clamp(loc, 0, rows - 1)
    old = buf.index_select(dim, loc)
    buf.index_copy_(dim, loc, torch.where(own, new.to(buf.dtype), old))


def _local_stats(q, k, v, q_pos, kv_pos, window: int):
    """Flash statistics of one query row over this rank's kv rows:
    q (B, 1, H, D), k / v (B, T, Hkv, D) -> m, l (B, Hkv, G, 1) and the
    unnormalised acc (B, Hkv, G, 1, D), float32 (a rank whose rows are
    all masked has m = -1e30 and weighs nothing in the merge)."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qf = q.reshape(B, Sq, Hkv, H // Hkv, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf.float(), k.float())
    s = s * (D ** -0.5) + _mask_bias(q_pos, kv_pos, True, window)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bkgqt,btkd->bkgqd", p.to(v.dtype), v).float()
    return m, p.sum(-1), acc


def _tp_flash_decode(q, k, v, kv_pos, pos, window: int, group):
    """Decode attention over a sequence-sharded kv ring (the reference's
    ``_tp_flash_decode``): q (B, 1, H, D) every head; k, v (B, T, Hkv, D)
    and kv_pos (T,) this rank's rows; pos (1,) the query's position.
    Each rank's flash statistics over its rows, merged exactly over
    ``group`` by ``collectives.flash_merge`` (one collective, in rank
    order) -> (B, 1, H, D) float32, the same bits on every rank."""
    m, l, acc = _local_stats(q, k, v, pos, kv_pos, window)
    o = co.flash_merge(m, l, acc, group)           # (B, Hkv, G, 1, D)
    return o.permute(0, 3, 1, 2, 4).reshape(q.shape)


def _tp_decode(params, cfg: ModelConfig, x, cache, pos):
    """``gqa_decode`` under a mesh of MP > 1 ``model`` ranks (the
    reference's ``_tp_flash_decode`` where the ring is sequence-sharded,
    its present path otherwise): every head's q and new k, v on every
    rank, the row written by its owner, attention over the local rows
    merged over ``model`` (or over the whole ring), then ``wo`` by row
    where the layer is tensor-parallel."""
    B = x.shape[0]
    tp = _tp_heads(params, cfg)
    q, k, v = _full_heads(params, cfg, x, tp)
    p1 = pos.reshape(1).long()
    pvec = p1[None, :].expand(B, 1)
    q = apply_rope(q, pvec, cfg.rope_theta)
    k = apply_rope(k, pvec, cfg.rope_theta)
    if "ring_lo" in cache:
        group = sr.model_group()
        rows = cache["k"].shape[1]
        lo = group.rank * rows
        row = p1 % (rows * group.size)
        _owned_write(cache["k"], 1, row, lo, k)
        _owned_write(cache["v"], 1, row, lo, v)
        _owned_write(cache["pos"], 0, row, lo, p1.int())
        o = _tp_flash_decode(q, cache["k"], cache["v"], cache["pos"], p1,
                             cfg.sliding_window, group).to(x.dtype)
    else:
        row = p1 % cache["k"].shape[1]
        cache["k"].index_copy_(1, row, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, row, v.to(cache["v"].dtype))
        cache["pos"].index_copy_(0, row, p1.int())
        o = attend(q, cache["k"], cache["v"], p1, cache["pos"],
                   causal=True, window=cfg.sliding_window,
                   threshold=cfg.flash_threshold)
    if tp is None:
        return o.reshape(B, 1, -1) @ params["wo"].to(x.dtype)
    _, h0, h_loc = tp
    return _tp_out(o[:, :, h0:h0 + h_loc], params, tp, x)


def _check_ring(S: int, rows: int) -> None:
    if S > rows:
        raise ValueError(f"a batched prefill of {S} tokens needs a cache of "
                         f"at least {S} rows, not {rows}: chunk it "
                         f"(launch.steps.make_prefill_step)")


def gqa_prefill(params, cfg: ModelConfig, x, cache):
    """Batched prefill of one layer: the whole (B, S, d) prompt attends
    within itself (forward-style causal attention, ``attend``'s branch)
    while its S kv rows are written IN PLACE into rows [0, S) of a FRESH
    cache (``repro.models.layers.attention.gqa_prefill``).  ``cache`` is
    ``cache_init``'s layer ({k, v (B, Lr, hkv, hd), pos (Lr,) shared
    tags}) or the slot pool's (pos (B, Lr) per-slot tags); S must fit
    the ring (S <= Lr)."""
    B, S, _ = x.shape
    group = sr.model_group()
    shard = "ring_lo" in cache
    _check_ring(S, cache["k"].shape[1] * (group.size if shard else 1))
    tp = _tp_heads(params, cfg) if group is not None else None
    k_all = v_all = None
    if tp is not None:
        q, k, v, k_all, v_all = _qkv_tp(params, cfg, x, tp)
    else:
        q, k, v = _qkv(params, cfg, x)
    pos1 = torch.arange(S, device=x.device)
    pvec = pos1[None, :].expand(B, S)
    q = apply_rope(q, pvec, cfg.rope_theta)
    k = apply_rope(k, pvec, cfg.rope_theta)
    ck, cv = k, v
    if tp is not None:
        # the cache holds every kv head
        if k_all is None:
            ck = co.all_gather(k, 2, group, "decode_heads")
            cv = co.all_gather(v, 2, group, "decode_heads")
        else:
            ck, cv = apply_rope(k_all, pvec, cfg.rope_theta), v_all
    tags = pos1.int()
    lo, n = 0, S
    if shard:                           # this rank's rows of [0, S)
        rows = cache["k"].shape[1]
        lo = group.rank * rows
        n = max(0, min(S, lo + rows) - lo)
    cache["k"][:, :n] = ck[:, lo:lo + n].to(cache["k"].dtype)
    cache["v"][:, :n] = cv[:, lo:lo + n].to(cache["v"].dtype)
    if cache["pos"].ndim == 2:          # slot-pool layout: per-slot tags
        cache["pos"][:, :n] = tags[None, lo:lo + n]
    else:
        cache["pos"][:n] = tags[lo:lo + n]
    o = attend(q, k, v, pos1, pos1, causal=True, window=cfg.sliding_window,
               threshold=cfg.flash_threshold)
    if tp is not None:
        return _tp_out(o, params, tp, x)
    return o.reshape(B, S, -1) @ params["wo"].to(x.dtype)


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
    owned beforehand (copy-on-write is host-side).  Under a page-shard
    context (``Engine(layout="paged-sharded")``) the pools are this
    rank's page range: the writes keep the pages it holds
    (``decode_attention.pool_set``) and the attend is the distributed
    flash decode, one merge collective per layer."""
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
        off = r % page
        qpos = qpos.int()
        # write before attend: the kernel reads this dispatch's own rows,
        # queued after these writes on the same stream
        for pool, val in ((ck, k), (cv, v), (cp, qpos)):
            da.pool_set(pool, pidx, off, val, valid)
        attend = gqa_paged_flash if da.shard_info() is None else \
            da.gqa_paged_attend
        o = attend(q, ck, cv, cp, block_table, qpos,
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


def _mla_latents(params, cfg: ModelConfig, x, positions):
    """-> (cq (B, S, q_lora_rank), c_kv (B, S, kv_lora_rank), k_pe (B, S,
    rd) roped): what every head shares.  Under tensor parallelism they
    are the replicated region, computed whole on every rank (the whole
    weights through ``sharding_rules.tp_weight``), and enter the region
    as one tensor (``tp_enter``: one all-reduce of their gradient)."""
    kr, dt = cfg.kv_lora_rank, x.dtype
    group = tp_group(params)
    w = params if group is None else {
        n: tree_map(lambda t: sr.tp_weight(t, group), params[n])
        for n in ("wq_a", "q_norm", "wkv_a", "kv_norm")}
    cq = apply_norm(cfg.norm, w["q_norm"], x @ w["wq_a"].to(dt))
    kv = x @ w["wkv_a"].to(dt)
    c_kv = apply_norm(cfg.norm, w["kv_norm"], kv[..., :kr])
    k_pe = apply_rope(kv[..., kr:][:, :, None, :], positions,
                      cfg.rope_theta)[:, :, 0, :]
    if group is None:
        return cq, c_kv, k_pe
    lat = sr.tp_enter(torch.cat([cq, c_kv, k_pe], -1), group)
    return lat.split([cq.shape[-1], kr, k_pe.shape[-1]], -1)


def _mla_q(params, cfg: ModelConfig, cq, positions):
    """The query heads this rank holds (all of them on one device):
    (q_nope (B, S, h, nd), q_pe (B, S, h, rd) roped)."""
    B, S = cq.shape[:2]
    nd, rd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = (cq @ params["wq_b"].to(cq.dtype)).reshape(B, S, -1, nd + rd)
    return q[..., :nd], apply_rope(q[..., nd:], positions, cfg.rope_theta)


def _mla_out(o, params, x):
    """``wo`` over the heads' output o (B, S, h, vd): on a
    tensor-parallel layer the rank's rows, summed over ``model`` (this
    rank's S rows of the sum under sequence parallelism)."""
    B, S = o.shape[:2]
    y = o.reshape(B, S, -1) @ params["wo"].to(x.dtype)
    group = tp_group(params)
    return y if group is None else sr.tp_exit(y, group, 1)


def _mla_expanded(params, cfg: ModelConfig, q_nope, q_pe, c_kv, k_pe,
                  pos1):
    """The teacher-forced attention of the heads ``wk_b`` / ``wv_b``
    hold: the latent kv expanded to per-head k / v, the rope dims riding
    in k and q so that the shared attend serves -> o (B, S, h, vd)."""
    B, S = c_kv.shape[:2]
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = c_kv.dtype
    k_nope = (c_kv @ params["wk_b"].to(dt)).reshape(B, S, -1, nd)
    v = (c_kv @ params["wv_b"].to(dt)).reshape(B, S, -1, vd)
    h = k_nope.shape[2]
    k_full = torch.cat([k_nope, k_pe[:, :, None, :].expand(B, S, h, rd)],
                       -1)
    q_full = torch.cat([q_nope, q_pe], -1)
    return attend(q_full, k_full, v, pos1, pos1, causal=True, window=0,
                  threshold=cfg.flash_threshold)


def mla_forward(params, cfg: ModelConfig, x, positions):
    """Teacher-forced path: expand the latent kv to per-head k / v (the
    rank's heads on a tensor-parallel layer)."""
    cq, c_kv, k_pe = _mla_latents(params, cfg, x, positions)
    q_nope, q_pe = _mla_q(params, cfg, cq, positions)
    pos1 = positions[0] if positions.ndim == 2 else positions
    o = _mla_expanded(params, cfg, q_nope, q_pe, c_kv, k_pe, pos1)
    return _mla_out(o, params, x)


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


def mla_prefill(params, cfg: ModelConfig, x, cache):
    """Batched MLA prefill of one layer: the expanded (forward-style)
    attention over the whole prompt while the latent rows [0, S) of a
    FRESH cache are written IN PLACE, and the position tags where the
    cache carries them (``repro.models.layers.attention.mla_prefill``).
    A tensor-parallel layer attends its own heads: the latents, and so
    the cache, are whole on every rank."""
    B, S, _ = x.shape
    _check_ring(S, cache["c_kv"].shape[1])
    pos1 = torch.arange(S, device=x.device)
    pvec = pos1[None, :].expand(B, S)
    cq, c_kv, k_pe = _mla_latents(params, cfg, x, pvec)
    q_nope, q_pe = _mla_q(params, cfg, cq, pvec)
    cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
    cache["k_pe"][:, :S] = k_pe.to(cache["k_pe"].dtype)
    if "pos" in cache:
        cache["pos"][:, :S] = pos1.int()[None, :]
    o = _mla_expanded(params, cfg, q_nope, q_pe, c_kv, k_pe, pos1)
    return _mla_out(o, params, x)


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
    latent space, or under a page-shard context its distributed flash
    decode (``decode_attention.mla_paged_attend``); W_uv is absorbed
    after it."""
    B, C, _ = x.shape
    h, nd, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    kr, rd = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    dt = x.dtype
    scale = (nd + rd) ** -0.5
    qpos = pos[:, None].long() + torch.arange(C, device=x.device)[None, :]
    cq, c_kv_t, k_pe_t = _mla_latents(params, cfg, x, qpos)
    q_nope, q_pe = _mla_q(params, cfg, cq, qpos)          # (B,C,h,nd/rd)
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
        off = qpos % page
        qpos = qpos.int()
        for pool, val in ((ck, c_kv_t), (cpe, k_pe_t), (cp, qpos)):
            da.pool_set(pool, pidx, off, val, valid)
        attend = mla_paged_flash if da.shard_info() is None else \
            da.mla_paged_attend
        o_lat = attend(q_lat, q_pe, ck, cpe, cp, block_table, qpos,
                       scale=scale)
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


def mla_decode(params, cfg: ModelConfig, x, cache, pos):
    """Absorbed decode of one token per sequence at the shared position
    ``pos`` (a 0-dim int tensor): the latent row ``pos`` is written IN
    PLACE (its tag too, where the cache carries tags) and attention runs
    in the latent space over the full ``max_len``, masked by absolute
    index (t <= pos) (``repro.models.layers.attention.mla_decode``).  A
    tensor-parallel layer absorbs and attends its own heads over the
    whole latent cache, one all-reduce after ``wo``."""
    B = x.shape[0]
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kr = cfg.kv_lora_rank
    dt = x.dtype
    p1 = pos.reshape(1).long()
    pvec = p1[None, :].expand(B, 1)
    cq, c_kv_t, k_pe_t = _mla_latents(params, cfg, x, pvec)
    q_nope, q_pe = _mla_q(params, cfg, cq, pvec)          # (B,1,h,nd/rd)
    ck, cpe = cache["c_kv"], cache["k_pe"]
    ck.index_copy_(1, p1, c_kv_t.to(ck.dtype))
    cpe.index_copy_(1, p1, k_pe_t.to(cpe.dtype))
    if "pos" in cache:
        cache["pos"].index_copy_(1, p1, p1.int()[None, :].expand(B, 1))
    wk_b = params["wk_b"].to(dt).reshape(kr, -1, nd)
    wv_b = params["wv_b"].to(dt).reshape(kr, -1, vd)
    q_lat = torch.einsum("bohd,khd->bhk", q_nope, wk_b)  # absorb W_uk
    s = (torch.einsum("bhk,btk->bht", q_lat.float(), ck.float())
         + torch.einsum("bohr,btr->bht", q_pe.float(), cpe.float()))
    s = s * ((nd + rd) ** -0.5)
    t_idx = torch.arange(ck.shape[1], device=x.device)
    s = torch.where(t_idx[None, None, :] <= p1, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(dt)
    o_lat = torch.einsum("bht,btk->bhk", p, ck)
    o = torch.einsum("bhk,khv->bhv", o_lat, wv_b)        # absorb W_uv
    return _mla_out(o[:, None], params, x)
