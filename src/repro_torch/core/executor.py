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

On a mesh (``distributed.sharding_rules.activation_context``) a dense
FFN's plan runs on the rank's own d_ff columns where its layer left the
FFN split over ``model`` (``models.layers.mlp.tp_keep``: every mode,
the GLU FFNs, hubert's ReLU FFN, zamba2's shared MLP and RWKV6's
channel mix).  ``for_rank`` gives the rank's plan: its column block of
the per-neuron tables, ``proxy_slot`` keeping its global values.  Two
exchanges make its masks, kept tiles and counters one device's column
block, bit for bit:

  * the proxies' ReLU inputs: the proxies sit in the leading columns
    ``[0, n_proxy)`` (``policy.build_permutation``), so the rank that
    holds a proxy column computes its float32 input and one all-gather
    over ``model`` ("mor_proxy", ``_proxy_block``) hands every rank the
    (T, n_proxy) block its members look their proxies up in;
  * the capacity clip, where a budget can bite: one device keeps the
    first ``capacity`` live tiles of the whole (T / tile_m, N / tile_n)
    grid, row-major over the global batch, so each rank's live-tile
    count of each tile row is all-gathered over the data ranks and the
    column blocks ("mor_rows", ``_clip``) and each rank ranks its
    own tiles in that order.  The same clip runs on a data axis where
    the FFN is gathered whole.  It equals one device's where each data
    rank's rows fill whole ``tile_m``-row tiles.

The stats of a split plan are the column blocks' counts summed over
``model`` ("mor_stats"), so the telemetry reads one device's numbers.
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
from repro_torch.distributed import collectives as co
from repro_torch.distributed import sharding_rules as sr

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
    (E,)-shaped.  A split plan's are the rank's column blocks and
    counters, with its ``model`` ``group``; ``capacity`` is the budget
    of a clip taken over the mesh's global grid (None where the kernel
    clips alone)."""

    __slots__ = ("computed", "tiles", "kept", "kernel_counts", "group",
                 "capacity")

    def __init__(self, computed: Optional[torch.Tensor],
                 tiles: torch.Tensor, kept: Optional[torch.Tensor] = None,
                 group=None, capacity: Optional[int] = None):
        self.computed = computed
        self.tiles = tiles
        self.kept = tiles if kept is None else kept
        self.kernel_counts = None
        self.group = group
        self.capacity = capacity

    def keep_mask(self, T: int, N: int, tile_m: int, tile_n: int):
        return expand_tile_mask(self.kept, tile_m, tile_n, T, N)

    def stats(self) -> Dict[str, torch.Tensor]:
        """The FFN's (each expert's) tile and neuron fractions: a split
        plan's counts summed over its ``group`` (``global_sums``)."""
        lead = self.tiles.shape[:-2]
        dev = self.tiles.device
        mp = self.group.size if self.group is not None else 1
        n_tiles = self.tiles.shape[-2] * self.tiles.shape[-1] * mp
        live, comp = self.kernel_counts or (self.tiles.sum((-2, -1)),
                                            self.kept.sum((-2, -1)))
        local = {"live": live, "comp": comp}
        if self.computed is not None:
            local["computed"] = self.computed.sum((-2, -1))
        tot = global_sums(self.group, local)
        tiles_live = tot["live"].float() / n_tiles
        n_computed = tot["comp"].to(torch.int32)
        if self.computed is not None:
            frac_computed = tot["computed"].float() / (
                self.computed.shape[-2] * self.computed.shape[-1] * mp)
        else:
            # kernel mode: the neuron mask never exists; report the
            # tile-level compute fraction (its tight upper bound)
            frac_computed = tiles_live
        n_tiles_i = torch.full(lead, n_tiles, dtype=torch.int32, device=dev)
        return {"frac_computed": frac_computed,
                "frac_tiles_live": tiles_live,
                "frac_tiles_computed": n_computed.float() / n_tiles,
                "frac_mispredicted_zero": torch.zeros(
                    lead, dtype=torch.float32, device=dev),
                "n_tiles": n_tiles_i,
                "tiles_skipped": n_tiles_i - n_computed}


def global_sums(group, local: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
    """{name: this rank's sum} -> their sums over ``group``, float64
    (exact for counts), by ONE all-reduce ("mor_stats") of the 0-dim
    sums a split plan has; the local sums as they are where ``group`` is
    None."""
    if group is None:
        return local
    names = list(local)
    tot = co.all_reduce(torch.stack([local[k].double() for k in names]),
                        group, "mor_stats")
    return dict(zip(names, tot.unbind()))


def proxy_count(mor: MoRLayer):
    """The proxy block's width of a MoRLayer, on the host: max
    ``proxy_slot`` + 1 (0 where it has none), an int for one layer, an
    (L,) int array for a stack.  Reads the leaf back: ``attach_plans``
    calls it once, where the plan is built."""
    n = (mor["proxy_slot"].amax(-1).long() + 1).clamp(min=0)
    a = n.cpu().numpy()
    return int(a) if a.ndim == 0 else a


class MoRExecutionPlan:
    """Per-layer MoR execution plan.

    ``capacity_frac`` (static) provisions the gather_matmul slot list;
    ``cap_live`` (host float, or an (L,) array for a layer-stacked plan;
    for an expert plan an (E,) or (L, E) float32 device tensor) is the
    telemetry-calibrated budget clamped under it.  ``draft_cap`` (the
    same kinds) is the speculative drafter's budget, in force instead of
    ``cap_live`` when ``draft`` is set.  ``n_proxy`` (a host int, or an
    (L,) array) is the proxy block's width (``proxy_count``), which a
    plan split over a mesh's ``model`` ranks exchanges; ``group`` is
    that ``model`` group on the rank's plan (``for_rank``)."""

    def __init__(self, mor: Optional[MoRLayer], *, mode: str = "dense",
                 tile_m: int = 8, tile_n: int = 128,
                 capacity_frac: float = 1.0, cap_live=None,
                 draft_cap=None, draft: bool = False, n_proxy=None,
                 group=None):
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
        self.n_proxy = n_proxy
        self.group = group

    def __repr__(self):
        return (f"MoRExecutionPlan(mode={self.mode!r}, tile_m={self.tile_m},"
                f" tile_n={self.tile_n}, capacity_frac={self.capacity_frac},"
                f" calibrated={self.mor is not None},"
                f" per_layer_capacity={self.cap_live is not None},"
                f" draft={self.draft})")

    def _replace(self, **kw) -> "MoRExecutionPlan":
        args = dict(mode=self.mode, tile_m=self.tile_m, tile_n=self.tile_n,
                    capacity_frac=self.capacity_frac, cap_live=self.cap_live,
                    draft_cap=self.draft_cap, draft=self.draft,
                    n_proxy=self.n_proxy, group=self.group)
        mor = kw.pop("mor", self.mor)
        args.update(kw)
        return MoRExecutionPlan(mor, **args)

    def for_rank(self, group) -> "MoRExecutionPlan":
        """This rank's plan of one FFN whose d_ff columns are split over
        ``group`` (``model``) in whole tiles: its block of every
        per-neuron leaf (``sharding_rules.neuron_block``), ``proxy_slot``
        keeping its global values, with the group.  The plan carries the
        proxy block's width (``n_proxy``), which ``deploy.attach_plans``
        reads once where it builds the plan: a split FFN never reads it
        back from the device."""
        n = self.mor["m"].shape[-1]
        assert self.mor["m"].ndim == 1 and n % (group.size * self.tile_n) \
            == 0, (tuple(self.mor["m"].shape), group.size, self.tile_n)
        assert self.n_proxy is not None, \
            "a plan split over model needs n_proxy: attach it (attach_plans)"
        return self._replace(
            mor={k: sr.neuron_block(v, group) for k, v in self.mor.items()},
            n_proxy=int(self.n_proxy), group=group)

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

        n_proxy = self.n_proxy
        if n_proxy is not None and np.ndim(n_proxy):
            n_proxy = int(n_proxy[l])
        return self._replace(mor=mor, cap_live=at(self.cap_live),
                             draft_cap=at(self.draft_cap), n_proxy=n_proxy)

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
        block = None
        if self.group is not None:
            assert residual is None and row_mask is None
            block = self._proxy_block(x, w, preact_full)
        if self.mode == "kernel" and preact_full is None:
            from repro_torch.kernels import ops as kops
            # proxy rookie at base precision through a plain matmul over
            # a gathered float32 copy of the proxy columns
            proxy_neg = (proxy_relu_in(x, w, mor, residual=residual,
                                       proxy_block=block) < 0.0
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
            return self._prediction(None, tiles, True)
        computed = hybrid_predict(x, w, mor, preact_full=preact_full,
                                  residual=residual, proxy_block=block)
        if row_mask is not None:
            computed = computed & row_mask[..., None]
        tiles = tile_mask_from_neuron_mask(computed, self.tile_m,
                                           self.tile_n)
        # shadow / scored clip as the plan they shadow would (identity
        # when uncapped), so that the scored ``kept`` is its decision
        return self._prediction(computed, tiles,
                                self.mode in ("kernel", "shadow", "scored")
                                or self.active_cap is not None)

    def _prediction(self, computed, tiles: torch.Tensor,
                    clip: bool) -> MoRPrediction:
        """The prediction of ``tiles``, clipped (``clip``) under the
        budget in force: an expert stack's (a device budget's) by
        ``_expert_clip``, a dense FFN's by ``_clip`` over one device's
        grid."""
        kept, capacity = None, None
        if clip and not (self.capacity_frac >= 1.0
                         and self.active_cap is None):
            if tiles.ndim != 2 or torch.is_tensor(self.active_cap):
                kept = self._expert_clip(tiles)
            else:
                kept, capacity = self._clip(tiles)
        return MoRPrediction(computed, tiles, kept=kept, group=self.group,
                             capacity=capacity)

    def _capacity(self, n_tiles: int) -> int:
        """The host budget of a grid of ``n_tiles`` tiles: the static
        ``capacity_frac`` clamped by a host ``cap_live`` / ``draft_cap``
        (float32 ceil(frac x n_tiles), never below one tile)."""
        capacity = max(1, int(self.capacity_frac * n_tiles))
        cap_live = self.active_cap
        if cap_live is not None:
            f = np.float32(cap_live) * np.float32(n_tiles)
            capacity = min(capacity, max(1, int(np.ceil(f))))
        return capacity

    def _expert_clip(self, tiles: torch.Tensor) -> torch.Tensor:
        """Capacity truncation mirroring gather_matmul's slot list: only
        the first ``capacity`` live tiles (row-major) of each expert are
        computed, the budget a host int or a per-expert float32 device
        tensor."""
        n_tiles = tiles.shape[-2] * tiles.shape[-1]
        cap_live = self.active_cap
        if torch.is_tensor(cap_live):
            # per expert, float32 on the device: ceil(frac * n_tiles)
            capacity = max(1, int(self.capacity_frac * n_tiles))
            f = torch.ceil(cap_live.float() * n_tiles)
            capacity = torch.clamp(f, min=1, max=capacity)[..., None]
        else:
            capacity = self._capacity(n_tiles)
        flat = tiles.flatten(-2)
        live_rank = torch.cumsum(flat, -1) - 1
        return (flat & (live_rank < capacity)).reshape(tiles.shape)

    def _clip(self, tiles: torch.Tensor):
        """A dense FFN's capacity clip, as gather_matmul's slot list
        takes it: the first ``capacity`` live tiles, row-major, of one
        device's grid over the global batch, taken by this rank on its
        own (Tm, Nt) tiles -> (kept, the capacity where a mesh's ranks
        share the grid, else None: the kernel then clips alone).

        On a mesh the global grid is the data ranks' row tiles in rank
        order (each data rank's rows one block of one device's rows),
        each row the column blocks of the ``model`` ranks in rank order
        where the plan is split.  Each rank's live-tile count of each of
        its tile rows is all-gathered over the data ranks and the column
        blocks ("mor_rows": the world group where both count).  A tile's
        rank is the live tiles of every earlier global row, of the
        earlier column blocks in its own row and of its own earlier
        columns; with no mesh, those of this grid alone."""
        ctx = sr.current()
        dp = sr.dp_group(ctx.mesh) if ctx is not None and ctx.rows_split \
            else None
        D = dp.size if dp is not None else 1
        M = self.group.size if self.group is not None else 1
        Tm, Nt = tiles.shape
        rows = tiles.sum(-1, dtype=torch.int32)
        if D * M > 1:
            group = (ctx.mesh.group("world") if D > 1 and M > 1
                     else dp if D > 1 else self.group)
            rows = co.all_gather(rows, 0, group, "mor_rows")
        rows = rows.reshape(D, M, Tm).long()
        capacity = self._capacity(D * Tm * M * Nt)
        di = dp.rank if D > 1 else 0
        mi = self.group.rank if M > 1 else 0
        tot = rows.sum(1).reshape(-1)
        before = ((torch.cumsum(tot, 0) - tot).reshape(D, Tm)[di]
                  + rows[di, :mi].sum(0))
        rank = before[:, None] + torch.cumsum(tiles, -1) - 1
        return tiles & (rank < capacity), (capacity if D * M > 1
                                           else None)

    def _proxy_block(self, x: torch.Tensor, w: torch.Tensor,
                     preact: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
        """The (T, n_proxy) float32 ReLU inputs of the proxy columns [0,
        n_proxy) of a split plan, the same on every rank: each rank
        computes those of its own columns (``predictor.proxy_relu_in``'s
        float32 product, from ``preact``, the full product exact mode
        has, where given), and one all-gather over ``model``
        ("mor_proxy") of min(n, n_proxy) columns a rank puts them side by
        side.  None where the plan has no proxy."""
        P = self.n_proxy
        if not P:
            return None
        g, n = self.group, w.shape[-1]
        k = max(0, min(P - g.rank * n, n))
        pre = (preact[..., :k].float() if preact is not None
               else x.float() @ w[:, :k].float())
        mor = self.mor
        mine = pre * mor["bn_scale"][:k] + mor["bn_bias"][:k]
        mine = F.pad(mine, (0, min(n, P) - k))
        return co.all_gather(mine.contiguous(), -1, g, "mor_proxy")[..., :P]

    # -- mask-consuming matmuls --------------------------------------------
    def masked_matmul(self, x: torch.Tensor, w: torch.Tensor,
                      pred: MoRPrediction) -> torch.Tensor:
        """x @ w with ``pred``'s tile mask applied — dead tiles are exact
        zeros.  Returns float32 pre-activations; in kernel mode the
        kernel's output is in x.dtype first (as in the JAX package)."""
        T, N = x.shape[-2], w.shape[-1]
        if self.mode == "kernel" and (pred.group is not None
                                      or pred.capacity is not None):
            # a split plan, or a clip over the mesh's global grid: the
            # kernel computes the kept tiles as they are (its slot list
            # provisioned for them, no clip of its own); n_live counts
            # the live tiles
            from repro_torch.kernels import ops as kops
            n_tiles = pred.kept.numel()
            pre, _, n_comp = kops.gather_matmul(
                x, w, pred.kept, capacity=min(pred.capacity or n_tiles,
                                              n_tiles),
                tile_m=self.tile_m, tile_n=self.tile_n, with_counts=True)
            pred.kernel_counts = (pred.tiles.sum(dtype=torch.int32), n_comp)
            return pre.float()
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
            missed = ~pred.computed & truly_nonzero
            mp = self.group.size if self.group is not None else 1
            tot = global_sums(self.group, {"missed": missed.sum((-2, -1))})
            stats["frac_mispredicted_zero"] = tot["missed"].float() / (
                T * N * mp)
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
        y = _act(pre_bn, activation)
        # relative output-error norm the plan's skips would cause on this
        # dispatch (<= 1: the masked output is a subset of the dense one)
        y_mor = torch.where(pred.keep_mask(T, N, self.tile_m, self.tile_n),
                            y, 0.0)
        # exact tile counts: a false skip zeroes a truly-live tile, a
        # false keep spends compute on a dead one
        counts = {"shadow_false_skip": (truth_tiles & ~pred.kept).sum(
                      (-2, -1), dtype=torch.int32),
                  "shadow_false_keep": (pred.kept & ~truth_tiles).sum(
                      (-2, -1), dtype=torch.int32),
                  "shadow_truth_live": truth_tiles.sum((-2, -1),
                                                       dtype=torch.int32)}
        # the whole FFN's: a split plan's column blocks summed over
        # ``model``
        mp = self.group.size if self.group is not None else 1
        n_tiles *= mp
        tot = global_sums(self.group, dict(
            counts, agree=(pred.computed == truth).sum((-2, -1)),
            sq=torch.square(y).sum((-2, -1)),
            sq_err=torch.square(y_mor - y).sum((-2, -1))))
        stats.update({k: tot[k].to(torch.int32) for k in counts})
        stats["shadow_sign_agree"] = tot["agree"].float() / (T * N * mp)
        norm = torch.sqrt(tot["sq"].float())
        err = torch.sqrt(tot["sq_err"].float())
        stats["shadow_tiles"] = torch.full(lead, n_tiles, dtype=torch.int32,
                                           device=x.device)
        stats["shadow_err"] = err / (norm + 1e-6)
        for k in SHADOW_STAT_KEYS:              # the leaves' stated order
            stats[k] = stats.pop(k)
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
