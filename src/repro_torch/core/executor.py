"""MoR execution plans: one predictor pass per layer call, reused
everywhere downstream (``repro.core.executor``).

Modes:

  dense  — plain matmul, predictor off.
  exact  — full compute, then zero the neurons the hybrid predictor
           would have skipped (neuron-granular; accuracy mode).
  tiled  — tile-granular skipping in plain PyTorch: the oracle for the
           kernels.
  kernel — the fused ``mor_tile_mask`` predictor feeds
           ``gather_matmul``, which only reads live weight tiles under a
           static ``capacity`` budget; the down projection skips dead
           contraction blocks via ``masked_matmul_kdim``.
  shadow — the dense-oracle scoring twin: propagates the plain dense
           activations while the predictor runs alongside (plain, with
           the capacity clip of the plan it shadows) and its tile
           decisions are scored against the dense truth: false-skip /
           false-keep tile counts, sign agreement and the output error
           the skips would cause land in the stats as ``shadow_*``
           leaves.  The serving engine runs it on 1 in N dispatches.
  scored — the in-step twin of a ``tiled`` plan: the same scoring, but
           propagating the tile-masked activations, bitwise equal to
           ``tiled``; a sampled dispatch runs it in place of the tiled
           plan.

A plan holds a MoRLayer (possibly layer-stacked) and static knobs.  The
calibrated per-layer budget ``cap_live`` is a HOST float (or an (L,)
array): PyTorch does not retrace, so a host value is what keeps the
kernels' slot budgets free of device syncs.  An expert plan (MoE) holds
an (E,)-stacked MoRLayer per layer and runs ``expert_ffn``: the same
body with the expert axis written out where the JAX package vmaps, its
per-expert budget an (E,) float32 device tensor.

``draft_cap`` is a second budget of the same kinds, for the
self-speculative drafter (``serving.spec``): a plan with ``draft=True``
(``as_draft``) clamps under ``draft_cap`` where a target plan clamps
under ``cap_live``, so one set of weights drafts cheaply and verifies
at full capacity.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.predictor import (MoRLayer, cols, hybrid_predict,
                                        proxy_relu_in)
from repro_torch.core.policy import (expand_tile_mask,
                                     tile_mask_from_neuron_mask)

MODES = ("dense", "exact", "tiled", "kernel", "shadow", "scored")

# per-layer predictor-quality leaves the shadow and scored modes add to
# their stats (int tile counters + float32 fractions; the obs device
# block packs them into its quality lanes)
SHADOW_STAT_KEYS = ("shadow_tiles", "shadow_false_skip",
                    "shadow_false_keep", "shadow_truth_live",
                    "shadow_sign_agree", "shadow_err")


def _act(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "relu":
        return F.relu(h)
    if activation == "relu2":
        return torch.square(F.relu(h))
    raise ValueError(f"MoR requires a ReLU-family activation, got "
                     f"{activation!r}")


def _dense_stats(device, shadow: bool = False) -> Dict[str, torch.Tensor]:
    one = torch.ones((), dtype=torch.float32, device=device)
    z = torch.zeros((), dtype=torch.float32, device=device)
    zi = torch.zeros((), dtype=torch.int32, device=device)
    out = {"frac_computed": one, "frac_tiles_live": one,
           "frac_tiles_computed": one.clone(),
           "frac_mispredicted_zero": z, "n_tiles": zi,
           "tiles_skipped": zi.clone()}
    if shadow:
        # an inactive layer in a shadow-mode stack scores nothing but
        # emits the same keys, so that per-layer stacking stays regular
        out.update({"shadow_tiles": zi, "shadow_false_skip": zi,
                    "shadow_false_keep": zi, "shadow_truth_live": zi,
                    "shadow_sign_agree": z, "shadow_err": z})
    return out


class MoRPrediction:
    """The result of ONE predictor pass, shared by every consumer.

    ``computed``: (T, N) bool neuron mask, or None in kernel mode.
    ``tiles``: (T/tile_m, N/tile_n) bool tile-liveness mask.
    ``kept``: tiles actually computed under the capacity budget.
    ``kernel_counts``: (n_live, n_computed) from ``gather_matmul``.
    An expert stack puts a leading E dim on each, and its stats are
    (E,)-shaped."""

    __slots__ = ("computed", "tiles", "kept", "kernel_counts")

    def __init__(self, computed: Optional[torch.Tensor],
                 tiles: torch.Tensor, kept: Optional[torch.Tensor] = None):
        self.computed = computed
        self.tiles = tiles
        self.kept = tiles if kept is None else kept
        self.kernel_counts = None

    def keep_mask(self, T: int, N: int, tile_m: int, tile_n: int):
        return expand_tile_mask(self.kept, tile_m, tile_n, T, N)

    def stats(self) -> Dict[str, torch.Tensor]:
        lead = self.tiles.shape[:-2]
        dev = self.tiles.device
        n_tiles = float(self.tiles.shape[-2] * self.tiles.shape[-1])
        if self.kernel_counts is not None:
            n_live, n_comp = self.kernel_counts
            tiles_live = n_live.float() / n_tiles
            tiles_computed = n_comp.float() / n_tiles
            n_computed = n_comp.int()
        else:
            tiles_live = self.tiles.float().mean((-2, -1))
            tiles_computed = self.kept.float().mean((-2, -1))
            n_computed = self.kept.sum((-2, -1), dtype=torch.int32)
        if self.computed is not None:
            frac_computed = self.computed.float().mean((-2, -1))
        else:
            # kernel mode: the neuron mask never exists; report the
            # tile-level compute fraction (its tight upper bound)
            frac_computed = tiles_live
        n_tiles_i = torch.full(lead, int(n_tiles), dtype=torch.int32,
                               device=dev)
        return {"frac_computed": frac_computed,
                "frac_tiles_live": tiles_live,
                "frac_tiles_computed": tiles_computed,
                "frac_mispredicted_zero": torch.zeros(
                    lead, dtype=torch.float32, device=dev),
                "n_tiles": n_tiles_i,
                "tiles_skipped": n_tiles_i - n_computed}


class MoRExecutionPlan:
    """Per-layer MoR execution plan.

    ``capacity_frac`` (static) provisions the gather_matmul slot list;
    ``cap_live`` (host float, or an (L,) array for a layer-stacked plan;
    for an expert plan an (E,) or (L, E) float32 device tensor) is the
    telemetry-calibrated budget clamped under it.  ``draft_cap`` (the
    same kinds) is the speculative drafter's budget, in force instead of
    ``cap_live`` when ``draft`` is set."""

    def __init__(self, mor: Optional[MoRLayer], *, mode: str = "dense",
                 tile_m: int = 8, tile_n: int = 128,
                 capacity_frac: float = 1.0, cap_live=None,
                 draft_cap=None, draft: bool = False):
        if mode not in MODES:
            raise ValueError(f"unknown MoR mode {mode!r}")
        self.mor = mor
        self.mode = mode
        self.tile_m = tile_m
        self.tile_n = tile_n
        self.capacity_frac = capacity_frac
        self.cap_live = cap_live
        self.draft_cap = draft_cap
        self.draft = draft

    def __repr__(self):
        return (f"MoRExecutionPlan(mode={self.mode!r}, tile_m={self.tile_m},"
                f" tile_n={self.tile_n}, capacity_frac={self.capacity_frac},"
                f" calibrated={self.mor is not None},"
                f" per_layer_capacity={self.cap_live is not None},"
                f" draft={self.draft})")

    def _replace(self, **kw) -> "MoRExecutionPlan":
        args = dict(mode=self.mode, tile_m=self.tile_m, tile_n=self.tile_n,
                    capacity_frac=self.capacity_frac, cap_live=self.cap_live,
                    draft_cap=self.draft_cap, draft=self.draft)
        mor = kw.pop("mor", self.mor)
        args.update(kw)
        return MoRExecutionPlan(mor, **args)

    def as_draft(self) -> "MoRExecutionPlan":
        """The draft-mode twin of this plan: the same weights and
        budgets, ``draft=True`` so that ``draft_cap`` is the budget in
        force (``cap_live`` while it is None)."""
        return self._replace(draft=True)

    def as_shadow(self) -> "MoRExecutionPlan":
        """The dense-oracle scoring twin of this plan: same leaves and
        budgets, ``mode="shadow"``.  An uncalibrated plan passes through
        (there is no predictor to score)."""
        if self.mor is None:
            return self
        return self._replace(mode="shadow")

    def as_scored(self) -> "MoRExecutionPlan":
        """The in-step scoring twin of a ``tiled`` plan: the same scoring
        as ``as_shadow()``, propagating the tile-masked activations,
        which are bitwise those of the tiled plan (tiled mode computes
        the dense product and selects), so a scored dispatch can stand
        in for the tiled one.  Kernel plans cannot be replaced this way
        (``gather_matmul`` sums in another order) nor exact ones
        (neuron-granular)."""
        if self.mor is None:
            return self
        assert self.mode in ("tiled", "scored"), \
            f"as_scored() replaces tiled plans only, not {self.mode!r}"
        return self._replace(mode="scored")

    def layer(self, l: int) -> "MoRExecutionPlan":
        """The plan of layer ``l`` of a layer-stacked plan."""
        mor = None if self.mor is None else {k: v[l]
                                             for k, v in self.mor.items()}

        def at(cap):
            if torch.is_tensor(cap):
                return cap[l]
            if cap is not None:
                c = np.asarray(cap, np.float32)
                return float(c[l]) if c.ndim else float(c)
            return None

        return self._replace(mor=mor, cap_live=at(self.cap_live),
                             draft_cap=at(self.draft_cap))

    @property
    def active(self) -> bool:
        """True when the predictor actually runs (calibrated + not dense)."""
        return self.mor is not None and self.mode != "dense"

    @property
    def active_cap(self):
        """The budget in force: ``draft_cap`` for a drafter that has one,
        ``cap_live`` otherwise."""
        if self.draft and self.draft_cap is not None:
            return self.draft_cap
        return self.cap_live

    # -- the single predictor pass -----------------------------------------
    def predict(self, x: torch.Tensor, w: torch.Tensor, *,
                preact_full: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                row_mask: Optional[torch.Tensor] = None) -> MoRPrediction:
        """Run the hybrid predictor exactly once -> MoRPrediction.
        ``kernel`` mode goes through the fused ``ops.mor_tile_mask``;
        every other mode uses the plain ``hybrid_predict``.  ``row_mask``
        (..., T) marks real rows; the others (an expert buffer's
        capacity padding) are forced dead."""
        assert self.active, "predict() on an inactive plan"
        mor = self.mor
        if self.mode == "kernel" and preact_full is None:
            from repro_torch.kernels import ops as kops
            # proxy rookie at base precision through a plain matmul over
            # a gathered float32 copy of the proxy columns
            proxy_neg = (proxy_relu_in(x, w, mor, residual=residual) < 0.0
                         ) | cols(mor["proxy_slot"] < 0)
            pn = proxy_neg.to(torch.int8)
            if row_mask is not None:
                pn = torch.where(row_mask[..., None], pn,
                                 torch.full((), 2, dtype=torch.int8,
                                            device=pn.device))
            # proxies themselves are always computed: fold ~is_proxy
            # into the kernel's enable row
            mor_eff = dict(mor)
            mor_eff["enable"] = mor["enable"] & ~mor["is_proxy"]
            tiles = kops.mor_tile_mask(x, w, mor_eff, pn, residual=residual,
                                       tile_m=self.tile_m,
                                       tile_n=self.tile_n)
            return MoRPrediction(None, tiles,
                                 kept=self._capacity_clip(tiles))
        computed = hybrid_predict(x, w, mor, preact_full=preact_full,
                                  residual=residual)
        if row_mask is not None:
            computed = computed & row_mask[..., None]
        tiles = tile_mask_from_neuron_mask(computed, self.tile_m,
                                           self.tile_n)
        # shadow / scored clip as the plan they shadow would (identity
        # when uncapped), so that the scored ``kept`` is its decision
        kept = (self._capacity_clip(tiles)
                if self.mode in ("kernel", "shadow", "scored")
                or self.active_cap is not None else None)
        return MoRPrediction(computed, tiles, kept=kept)

    def _capacity_clip(self, tiles: torch.Tensor) -> torch.Tensor:
        """Capacity truncation mirroring gather_matmul's slot list: only
        the first ``capacity`` live tiles (row-major) of each FFN (each
        expert) are computed."""
        cap_live = self.active_cap
        if self.capacity_frac >= 1.0 and cap_live is None:
            return tiles
        n_tiles = tiles.shape[-2] * tiles.shape[-1]
        capacity = max(1, int(self.capacity_frac * n_tiles))
        if torch.is_tensor(cap_live):
            # per expert, float32 on the device: ceil(frac * n_tiles)
            f = torch.ceil(cap_live.float() * n_tiles)
            capacity = torch.clamp(f, min=1, max=capacity)[..., None]
        elif cap_live is not None:
            f = np.float32(cap_live) * np.float32(n_tiles)
            capacity = min(capacity, max(1, int(np.ceil(f))))
        flat = tiles.flatten(-2)
        live_rank = torch.cumsum(flat, -1) - 1
        return (flat & (live_rank < capacity)).reshape(tiles.shape)

    # -- mask-consuming matmuls --------------------------------------------
    def masked_matmul(self, x: torch.Tensor, w: torch.Tensor,
                      pred: MoRPrediction) -> torch.Tensor:
        """x @ w with ``pred``'s tile mask applied — dead tiles are exact
        zeros.  Returns float32 pre-activations; in kernel mode the
        kernel's output is in x.dtype first (as in the JAX package)."""
        T, N = x.shape[-2], w.shape[-1]
        if self.mode == "kernel":
            from repro_torch.kernels import ops as kops
            pre, n_live, n_comp = kops.gather_matmul(
                x, w, pred.tiles, capacity_frac=self.capacity_frac,
                capacity_frac_live=self.active_cap, tile_m=self.tile_m,
                tile_n=self.tile_n, with_counts=True)
            pred.kernel_counts = (n_live, n_comp)
            return pre.float()
        pre = (x @ w).float()
        keep = pred.keep_mask(T, N, self.tile_m, self.tile_n)
        return torch.where(keep, pre, 0.0)

    def down_matmul(self, h: torch.Tensor, w_down: torch.Tensor,
                    pred: Optional[MoRPrediction]) -> torch.Tensor:
        """h @ w_down with dead hidden tiles skipped along the
        contraction (kernel mode); other modes rely on the zeros."""
        if pred is None or self.mode != "kernel":
            return h @ w_down
        from repro_torch.kernels import ops as kops
        return kops.masked_matmul_kdim(h, w_down, pred.kept,
                                       tile_m=self.tile_m,
                                       tile_k=self.tile_n).to(h.dtype)

    # -- the relu_matmul / ffn entry points ---------------------------------
    def relu_matmul(self, x: torch.Tensor, w: torch.Tensor, *,
                    activation: str = "relu",
                    residual: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """y = act(x @ w) with MoR skipping; exactly ONE predictor
        evaluation regardless of mode."""
        y, _, stats = self._relu_matmul_pred(x, w, activation=activation,
                                             residual=residual)
        return y, stats

    def _relu_matmul_pred(self, x, w, *, activation: str,
                          residual: Optional[torch.Tensor] = None,
                          row_mask: Optional[torch.Tensor] = None):
        T, N = x.shape[-2], w.shape[-1]
        if not self.active:
            pre = x @ w
            y = _act(pre + (residual if residual is not None else 0.0),
                     activation)
            return y, None, _dense_stats(
                x.device, shadow=self.mode in ("shadow", "scored"))
        mor = self.mor
        if self.mode in ("shadow", "scored"):
            return self._shadow_relu_matmul(x, w, activation=activation,
                                            residual=residual,
                                            row_mask=row_mask)
        if self.mode == "exact":
            pre = (x @ w).float()
            pre_bn = pre * cols(mor["bn_scale"]) + cols(mor["bn_bias"])
            if residual is not None:
                pre_bn = pre_bn + residual
            pred = self.predict(x, w, preact_full=pre, residual=residual,
                                row_mask=row_mask)
            y = torch.where(pred.computed, _act(pre_bn, activation),
                            0.0).to(x.dtype)
            truly_nonzero = pre_bn > 0
            if row_mask is not None:
                truly_nonzero = truly_nonzero & row_mask[..., None]
            stats = pred.stats()
            stats["frac_mispredicted_zero"] = (
                ~pred.computed & truly_nonzero).float().mean((-2, -1))
            return y, pred, stats

        # tiled / kernel: one predictor pass -> tile mask -> masked matmul
        pred = self.predict(x, w, residual=residual, row_mask=row_mask)
        pre = self.masked_matmul(x, w, pred)
        pre_bn = pre * cols(mor["bn_scale"]) + cols(mor["bn_bias"])
        if residual is not None:
            pre_bn = pre_bn + residual
        keep = pred.keep_mask(T, N, self.tile_m, self.tile_n)
        y = torch.where(keep, _act(pre_bn, activation), 0.0).to(x.dtype)
        return y, pred, pred.stats()

    def _shadow_relu_matmul(self, x, w, *, activation: str,
                            residual: Optional[torch.Tensor] = None,
                            row_mask: Optional[torch.Tensor] = None):
        """The dense-oracle scoring pass (modes "shadow" / "scored"):
        the dense pre-activations, the predictor run as the tiled /
        kernel plan would run it (plain, same capacity clip), and its
        tile decisions scored against the dense truth.  "shadow"
        propagates the dense activations, "scored" the tile-masked ones
        (bitwise the tiled path's: the same elementwise chain on the
        same dense product inside a kept tile, exact zeros outside)."""
        mor = self.mor
        T, N = x.shape[-2], w.shape[-1]
        pre = (x @ w).float()
        pre_bn = pre * cols(mor["bn_scale"]) + cols(mor["bn_bias"])
        if residual is not None:
            pre_bn = pre_bn + residual
        pred = self.predict(x, w, residual=residual, row_mask=row_mask)
        truth = pre_bn > 0
        if row_mask is not None:
            truth = truth & row_mask[..., None]
        truth_tiles = tile_mask_from_neuron_mask(truth, self.tile_m,
                                                 self.tile_n)
        stats = pred.stats()
        lead = truth_tiles.shape[:-2]
        n_tiles = truth_tiles.shape[-2] * truth_tiles.shape[-1]
        # exact tile counts: a false skip zeroes a truly-live tile, a
        # false keep spends compute on a dead one
        stats["shadow_tiles"] = torch.full(lead, n_tiles, dtype=torch.int32,
                                           device=x.device)
        stats["shadow_false_skip"] = (truth_tiles & ~pred.kept).sum(
            (-2, -1), dtype=torch.int32)
        stats["shadow_false_keep"] = (pred.kept & ~truth_tiles).sum(
            (-2, -1), dtype=torch.int32)
        stats["shadow_truth_live"] = truth_tiles.sum((-2, -1),
                                                     dtype=torch.int32)
        stats["shadow_sign_agree"] = (pred.computed == truth).float().mean(
            (-2, -1))
        y = _act(pre_bn, activation)
        # relative output-error norm the plan's skips would cause on this
        # dispatch (<= 1: the masked output is a subset of the dense one)
        y_mor = torch.where(pred.keep_mask(T, N, self.tile_m, self.tile_n),
                            y, 0.0)
        norm = torch.sqrt(torch.square(y).sum((-2, -1)))
        stats["shadow_err"] = (torch.sqrt(torch.square(y_mor - y).sum(
            (-2, -1))) / (norm + 1e-6))
        out = y_mor if self.mode == "scored" else y
        return out.to(x.dtype), pred, stats

    def ffn(self, x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
            *, activation: str, w_gate: Optional[torch.Tensor] = None,
            row_mask: Optional[torch.Tensor] = None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full FFN with MoR on the ReLU pre-activation.  GLU case: the
        SINGLE gate prediction gates the up matmul and the down matmul
        (dead hidden rows skipped along the contraction)."""
        if w_gate is not None:
            g, pred, stats = self._relu_matmul_pred(x, w_gate,
                                                    activation=activation,
                                                    row_mask=row_mask)
            if pred is not None and self.mode in ("tiled", "kernel",
                                                  "scored"):
                u = self.masked_matmul(x, w_up, pred).to(x.dtype)
            else:
                u = x @ w_up
            h = (g * u).to(x.dtype)
        else:
            h, pred, stats = self._relu_matmul_pred(x, w_up,
                                                    activation=activation,
                                                    row_mask=row_mask)
        return self.down_matmul(h, w_down, pred), stats


    def expert_ffn(self, eb: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor, *, activation: str,
                   w_gate: Optional[torch.Tensor] = None,
                   row_mask: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``ffn`` over a stack of experts: eb (E, C, d), weights (E, d, f)
        / (E, f, d), ``self.mor`` an (E,)-stacked MoRLayer and
        ``self.cap_live`` None or an (E,) float32 device tensor.

        The JAX package runs the per-expert plan under ``jax.vmap``; here
        the expert axis is written out: every step of ``ffn`` carries the
        leading E dim, and kernel mode launches each kernel ONCE for all
        experts (the expert grid), with per-expert budgets and counters
        and no host loop.  One predictor evaluation per call, as JAX
        counts one per trace of the vmapped body.  ``row_mask`` (E, C)
        marks the rows of each expert's capacity buffer that hold routed
        tokens.  -> (out (E, C, d), stats with (E,)-shaped leaves)."""
        assert self.active, "expert_ffn() on an inactive plan"
        return self.ffn(eb, w_up, w_down, activation=activation,
                        w_gate=w_gate, row_mask=row_mask)


def as_plan(mor, *, mode: str = "dense", tile_m: int = 8, tile_n: int = 128,
            capacity_frac: float = 1.0) -> MoRExecutionPlan:
    """Coerce ``mor`` (a plan, a MoRLayer dict, or None) into a plan; an
    existing plan's own mode and tiling win."""
    if isinstance(mor, MoRExecutionPlan):
        return mor
    if mor is not None and not _looks_like_mor_layer(mor):
        mor = None
    return MoRExecutionPlan(mor, mode=mode if mor is not None else "dense",
                            tile_m=tile_m, tile_n=tile_n,
                            capacity_frac=capacity_frac)


def attach_draft_caps(mor, draft_cap):
    """Store a draft budget on every calibrated plan of an attached MoR
    tree: ``draft_cap`` (a fraction, or anything that broadcasts to a
    plan's stacked leading dims) lands as an (L,) float32 host array on
    a layer stack, a float on a hybrid's one shared layer (the worst
    call site's, as ``deploy.attach_plans`` takes for ``cap_live``), an
    (L, E) float32 device tensor on an expert plan.  It stays dormant
    until ``as_draft()`` turns the plan into the drafter."""
    def one(p):
        if p.mor is None:
            return p
        lead = tuple(p.mor["m"].shape[:-1])
        c = np.broadcast_to(np.asarray(draft_cap, np.float32), lead)
        if p.mor["m"].ndim == 3:
            dc = torch.tensor(np.array(c), device=p.mor["m"].device)
        elif not lead:
            dc = float(c)
        else:
            dc = np.array(c)
        return p._replace(draft_cap=dc)
    return map_plans(mor, one)


def map_plans(mor, fn):
    """Apply ``fn`` to every MoRExecutionPlan of an attached MoR tree
    ({group -> plan}, a moe model's {"experts": plan}); anything else
    passes through.  The serving engine derives the shadow twin of its
    plans with it."""
    if isinstance(mor, MoRExecutionPlan):
        return fn(mor)
    if isinstance(mor, dict):
        return {k: map_plans(v, fn) for k, v in mor.items()}
    return mor


def _looks_like_mor_layer(mor) -> bool:
    return isinstance(mor, dict) and "enable" in mor and "bn_scale" in mor


def as_expert_plan(em, *, mode: str = "dense", tile_m: int = 8,
                   tile_n: int = 128, capacity_frac: float = 1.0
                   ) -> MoRExecutionPlan:
    """Coerce an expert-MoR entry (``mor["experts"]``: an attached plan,
    an (E,)-stacked MoRLayer, or None) into a plan for ``expert_ffn``;
    an attached plan's own mode, tiling and budget win, and
    ``mode="dense"`` turns the predictor off, as ``as_plan`` does."""
    if isinstance(em, MoRExecutionPlan):
        return em
    if em is None or not _looks_like_mor_layer(em):
        return MoRExecutionPlan(None)
    return MoRExecutionPlan(em, mode=mode, tile_m=tile_m, tile_n=tile_n,
                            capacity_frac=capacity_frac)
