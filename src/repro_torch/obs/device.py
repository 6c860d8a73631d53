"""Device-resident dispatch counters (``repro.obs.device``).

A packed int32 metrics block lives on the card for the engine's whole
life: ``init`` allocates it once, each dispatch adds a delta built from
values already on the device (token counts from the uploaded
``n_valid`` / ``use_pending``, page-edit counts from the packed ops
vector, per-layer predictor tile counts from the aux stats) IN PLACE,
with one ``index_add_``, and the host reads the block back ONCE at a
flush (``read``).  No ``.item()`` and no host sync a dispatch: the
dispatch loop runs the same with the block present or absent.

Layout (all int32, the JAX package's, fixed at spec construction):

- header fields (replicated across shard rows; read takes row 0):
  ``dispatches, prefill_tokens, decode_tokens, pages_touched,
  tokens_drafted, tokens_accepted, shadow_dispatches`` (the two
  speculation fields stay 0 until speculation is ported);
- shard-local fields (each shard row accumulates its own; read sums
  rows): ``kv_page_resets, kv_page_copies, state_page_resets,
  state_page_copies``;
- per MoR stat group (``mor_stats`` / ``dense_mor_stats`` /
  ``moe_mor_stats``), flattened per-layer(-expert): ``tiles_total`` and
  ``tiles_skipped`` (exact integer tile counts) and ``live_q`` (running
  sum of ``round(frac_tiles_live * SCALE)``; divide by ``SCALE *
  dispatches`` for the mean);
- per stat group, the predictor-QUALITY lanes fed by shadow-oracle
  dispatches (``QUALITY_FIELDS``, the same per-layer(-expert) shape):
  exact ``shadow_tiles`` / ``false_skip`` / ``false_keep`` /
  ``truth_live`` tile counts plus fixed-point running sums
  ``sign_agree_q`` / ``err_q`` (divide by ``SCALE * shadow_dispatches``
  for the means).  A primary dispatch's aux lacks the ``shadow_*`` keys
  and adds nothing there; a standalone twin's aux is filtered to those
  keys, so it never counts the base tile lanes twice.

The page-sharded layout runs one process per page shard: each keeps a
one-row block of its own, and the engine gathers the rows with one
collective at the flush before ``read`` (header from row 0, shard-local
fields summed), which is what the JAX package's sharded block holds.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["SCALE", "DeviceMetricsSpec", "QUALITY_FIELDS", "to_json"]

# fixed-point scale for fraction lanes; 4096 keeps dispatch-count *
# SCALE well inside int32 for any realistic run length
SCALE = 4096

HEADER_FIELDS = ("dispatches", "prefill_tokens", "decode_tokens",
                 "pages_touched", "tokens_drafted", "tokens_accepted",
                 "shadow_dispatches")
SHARD_LOCAL_FIELDS = ("kv_page_resets", "kv_page_copies",
                      "state_page_resets", "state_page_copies")
GROUP_FIELDS = ("tiles_total", "tiles_skipped", "live_q")
# the base lanes' aux keys, in GROUP_FIELDS order: (aux key, fixed point?)
_GROUP_KEYS = (("n_tiles", False), ("tiles_skipped", False),
               ("frac_tiles_live", True))
# (lane name, aux stats key, fixed-point?) — shadow-oracle quality
# lanes; the aux keys are the SHADOW_STAT_KEYS of core.executor
QUALITY_FIELDS = (
    ("shadow_tiles", "shadow_tiles", False),
    ("false_skip", "shadow_false_skip", False),
    ("false_keep", "shadow_false_keep", False),
    ("truth_live", "shadow_truth_live", False),
    ("sign_agree_q", "shadow_sign_agree", True),
    ("err_q", "shadow_err", True),
)


class DeviceMetricsSpec:
    """Static layout of the packed metrics block.

    ``stat_shapes`` maps aux stat group name -> shape of that group's
    stacked ``frac_tiles_live`` leaf ((L,) or (L, E)); the engine reads
    it off the attached MoR tree (``Engine._stat_shapes``)."""

    def __init__(self, stat_shapes: Dict[str, Tuple[int, ...]]):
        self.stat_shapes: Dict[str, Tuple[int, ...]] = {
            k: tuple(int(d) for d in v)
            for k, v in sorted(stat_shapes.items())}
        self.offsets: Dict[str, Tuple[int, int]] = {}
        off = 0
        for name in HEADER_FIELDS + SHARD_LOCAL_FIELDS:
            self.offsets[name] = (off, 1)
            off += 1
        for g, shp in self.stat_shapes.items():
            n = int(np.prod(shp)) if shp else 1
            for f in GROUP_FIELDS + tuple(q[0] for q in QUALITY_FIELDS):
                self.offsets[f"{g}/{f}"] = (off, n)
                off += n
        self.size = off
        self._index: Dict[Tuple, torch.Tensor] = {}

    def init(self, n_rows: int = 1, device="cpu") -> torch.Tensor:
        return torch.zeros((n_rows, self.size), dtype=torch.int32,
                           device=device)

    # -- device side --------------------------------------------------------
    def _lanes(self, scalars: Dict, aux: Dict):
        """-> [(lane name, int32 device tensor)] for every lane this
        dispatch feeds; a missing scalar or stat key adds zero, so it is
        left out."""
        out = []
        for name in HEADER_FIELDS + SHARD_LOCAL_FIELDS:
            v = scalars.get(name)
            if v is not None:
                out.append((name, v))
        lanes = tuple((lane, key, fp) for lane, (key, fp)
                      in zip(GROUP_FIELDS, _GROUP_KEYS)) + QUALITY_FIELDS
        for g in self.stat_shapes:
            stats = aux.get(g)
            if not stats:
                continue
            for lane, key, fp in lanes:
                v = stats.get(key)
                if v is None:
                    continue
                v = v.reshape(-1)
                if fp:
                    v = torch.round(v.float() * SCALE)
                out.append((f"{g}/{lane}", v))
        return out

    def _index_of(self, names: Tuple[str, ...], device) -> torch.Tensor:
        """The block columns of ``names``' lanes, concatenated: built
        once per lane set (a handful over a run) and kept on the device
        (uploaded without waiting: the dispatch loop never blocks)."""
        key = (names, str(device))
        idx = self._index.get(key)
        if idx is None:
            cols = np.concatenate([
                np.arange(self.offsets[n][0],
                          self.offsets[n][0] + self.offsets[n][1])
                for n in names]).astype(np.int64)
            t = torch.from_numpy(cols)
            idx = (t.pin_memory().to(device, non_blocking=True)
                   if torch.device(device).type == "cuda" else t)
            self._index[key] = idx
        return idx

    def accumulate(self, block: torch.Tensor, scalars: Dict,
                   aux: Dict) -> torch.Tensor:
        """block (n_rows, size) += delta, IN PLACE, in every row.
        ``scalars`` maps header / shard-local field name -> int32 device
        scalar (missing -> 0); ``aux`` maps stat group -> stats dict with
        ``n_tiles`` / ``tiles_skipped`` / ``frac_tiles_live`` (and the
        ``shadow_*`` keys) as stacked device tensors."""
        lanes = self._lanes(scalars, aux)
        if not lanes:
            return block
        names = tuple(n for n, _ in lanes)
        vals = torch.cat([v.reshape(-1).to(torch.int32) for _, v in lanes])
        idx = self._index_of(names, block.device)
        block.index_add_(1, idx, vals[None].expand(block.shape[0], -1))
        return block

    # -- host side ----------------------------------------------------------
    def read(self, block: torch.Tensor) -> Dict:
        """One host transfer; returns plain-python counters plus
        per-group per-layer arrays and derived fractions."""
        b = block.cpu().numpy()
        assert b.ndim == 2 and b.shape[1] == self.size, b.shape

        def seg(name):
            off, n = self.offsets[name]
            return b[:, off:off + n]

        out: Dict = {name: int(seg(name)[0, 0]) for name in HEADER_FIELDS}
        out.update({name: int(seg(name).sum())
                    for name in SHARD_LOCAL_FIELDS})
        disp = max(out["dispatches"], 1)
        sdisp = max(out["shadow_dispatches"], 1)
        groups: Dict = {}
        for g, shp in self.stat_shapes.items():
            total = seg(f"{g}/tiles_total")[0].reshape(shp)
            skipped = seg(f"{g}/tiles_skipped")[0].reshape(shp)
            live_q = seg(f"{g}/live_q")[0].reshape(shp)
            with np.errstate(divide="ignore", invalid="ignore"):
                skip_frac = np.where(total > 0, skipped / np.maximum(
                    total, 1), 0.0)
            stiles = seg(f"{g}/shadow_tiles")[0].reshape(shp)
            fskip = seg(f"{g}/false_skip")[0].reshape(shp)
            fkeep = seg(f"{g}/false_keep")[0].reshape(shp)
            tlive = seg(f"{g}/truth_live")[0].reshape(shp)
            sa_q = seg(f"{g}/sign_agree_q")[0].reshape(shp)
            err_q = seg(f"{g}/err_q")[0].reshape(shp)
            groups[g] = {
                "tiles_total": total.astype(np.int64),
                "tiles_skipped": skipped.astype(np.int64),
                "skip_frac": skip_frac,
                "mean_frac_tiles_live": live_q / (SCALE * disp),
                "shadow_tiles": stiles.astype(np.int64),
                "false_skip": fskip.astype(np.int64),
                "false_keep": fkeep.astype(np.int64),
                "truth_live": tlive.astype(np.int64),
                # rate denominators: a false skip is scored against the
                # truly-live tiles, a false keep against the truly-dead
                "false_skip_rate": fskip / np.maximum(tlive, 1),
                "false_keep_rate": fkeep / np.maximum(stiles - tlive, 1),
                "mean_sign_agree": sa_q / (SCALE * sdisp),
                "mean_shadow_err": err_q / (SCALE * sdisp)}
        out["groups"] = groups
        return out



def to_json(metrics: Dict) -> Dict:
    """A ``DeviceMetricsSpec.read`` dict with its arrays as JSON-safe
    lists (floats rounded to 6 places)."""
    out = dict(metrics)
    out["groups"] = {
        g: {k: (v.tolist() if v.dtype.kind in "iu"
                else np.round(v, 6).tolist()) for k, v in d.items()}
        for g, d in metrics["groups"].items()}
    return out
