"""Offline MoR deployment (``repro.core.deploy``): calibrate a model,
cluster its ReLU layers, fold the tile permutation into the weights, and
emit the layer-stacked MoRLayer dict the runtime consumes (for the
paper's CNNs and TDS, a per-layer MoRLayer list, the permutation kept in
the MoRLayer and applied by the model's forward).

  taps -> per-neuron (m, b, c) regression   [calibration.py]
  weights -> angle clusters -> proxies       [clustering.py]
  -> column permutation folded into w_gate/w_up (cols) + w_down (rows)
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibration import (finalize_regression,
                                          init_accumulator,
                                          update_accumulator)
from repro_torch.core.clustering import cluster_layer
from repro_torch.core.executor import MoRExecutionPlan
from repro_torch.core.policy import build_mor_layer

# calibrate_moe's dead-column injection, in observed pre-activation
# sigmas (the JAX package's default ``inject_scale``)
INJECT_SCALE = 4.0


def attach_plans(mor, cfg: ModelConfig, mode: str,
                 capacities: Optional[Dict] = None):
    """Wrap calibrated layer-stacked MoR groups ({group -> stacked
    MoRLayer}, or for a MoE model's expert group {"experts": (L, E)-
    stacked MoRLayer}) in execution plans carrying the mode, tile
    geometry and capacity from ``cfg.mor``.  ``capacities`` ({group ->
    (L,) or (L, E) fractions, or a scalar}) attaches the calibrated
    budgets as ``cap_live``: host floats for a dense group, and for the
    expert group one (L, E) float32 tensor on the MoR tree's device,
    uploaded here once so that no dispatch uploads a budget."""
    if mor is None or mode == "dense":
        return mor
    caps = capacities or {}

    def plan(layer, cap_live):
        return MoRExecutionPlan(layer, mode=mode, tile_m=cfg.mor.tile_m,
                                tile_n=cfg.mor.tile_n,
                                capacity_frac=cfg.mor.capacity,
                                cap_live=cap_live)

    def wrap(layer, cap):
        if layer is None:
            return None
        if "experts" in layer:
            inner = layer["experts"]
            if isinstance(inner, MoRExecutionPlan):
                inner = inner.mor
            if inner is None:
                return {"experts": None}
            cap_live = None
            if cap is not None:
                lead = tuple(inner["m"].shape[:-1])          # (L, E)
                c = np.asarray(cap, np.float32)
                c = np.broadcast_to(c.reshape(lead) if c.ndim else c, lead)
                cap_live = torch.tensor(np.array(c),
                                        device=inner["m"].device)
            return {"experts": plan(inner, cap_live)}
        cap_live = None
        if cap is not None:
            c = np.asarray(cap, np.float32)
            if layer["m"].ndim == 1:
                # one shared layer (hybrid) observed at several call
                # sites: provision for the worst of them
                cap_live = float(c.max())
            else:
                cap_live = np.broadcast_to(c, tuple(layer["m"].shape[:1]))
        return plan(layer, cap_live)

    return {k: wrap(v, caps.get(k)) for k, v in mor.items()}


def calibrate_lm(params: Dict, cfg: ModelConfig, forward: Callable,
                 batches: Iterator[Dict], n_batches: int,
                 layer_key: str = "layers") -> Tuple[Dict, Dict, Dict]:
    """Calibrate a layer-stacked LM (the dense, vlm, audio and ssm
    families): ``batches`` yield what ``forward`` takes, {"tokens"} or,
    for the audio stub, {"frames"}; a non-GLU FFN (hubert's native ReLU)
    is predicted on its up projection, and RWKV's ReLU^2 channel mix on
    ``cm.w_up`` (its ``cm.w_down`` rows permuted to match).

    -> (params with permuted FFN weights, mor {layer_key: stacked
        MoRLayer}, report dict with Pearson stats).  ``params`` itself
    is left as it was."""
    L = cfg.n_layers
    lp = params[layer_key]
    ffn = "mlp" if "mlp" in lp else "cm"
    w_stack = lp[ffn].get("w_gate", lp[ffn]["w_up"])
    N = w_stack.shape[-1]
    device = w_stack.device

    acc = init_accumulator((L, N), device)
    seen = 0
    with torch.no_grad():
        for batch in batches:
            taps = forward(params, cfg, batch, with_taps=True)[1]["taps"]
            acc = update_accumulator(acc, taps["p_bin"], taps["p_base"])
            del taps
            seen += 1
            if seen >= n_batches:
                break
    m, b, c = (t.cpu().numpy() for t in finalize_regression(acc))

    layers = []
    for l in range(L):
        cl = cluster_layer(w_stack[l], cfg.mor.max_cluster_angle)
        layers.append(build_mor_layer(m[l], b[l], c[l], cl, cfg.mor,
                                      device))
    mor_stack = {k: torch.stack([ml[k] for ml in layers])
                 for k in layers[0]}

    # fold the permutations into the weights (offline, zero runtime cost)
    perm = mor_stack["perm"].long()                       # (L, N)

    def permute_stack(w, axis):
        return torch.stack([w[l].index_select(axis, perm[l])
                            for l in range(L)])

    mlp = dict(lp[ffn])
    if "w_gate" in mlp:
        mlp["w_gate"] = permute_stack(mlp["w_gate"], 1)
    mlp["w_up"] = permute_stack(mlp["w_up"], 1)
    mlp["w_down"] = permute_stack(mlp["w_down"], 0)
    new_params = dict(params)
    new_params[layer_key] = dict(lp, **{ffn: mlp})

    report = {
        "pearson_mean": float(c.mean()),
        "pearson_frac_above_T": float((c > cfg.mor.corr_threshold).mean()),
        "n_proxies_mean": float(np.mean([
            len(np.unique(ml["proxy_slot"].cpu().numpy()))
            for ml in layers])),
        "enabled_frac": float(mor_stack["enable"].float().mean()),
    }
    return new_params, {layer_key: mor_stack}, report


def calibrate_hybrid(params: Dict, cfg: ModelConfig, forward: Callable,
                     batches: Iterator[Dict], n_batches: int
                     ) -> Tuple[Dict, Dict, Dict]:
    """Calibrate a hybrid (mamba + shared attention) model
    (``repro.core.deploy.calibrate_hybrid``).  The ONE shared block's MLP
    is the only ReLU-family FFN; it is observed at every segment
    boundary, so its taps come back (n_seg, ...)-stacked and the segment
    axis folds into the batch: one regression, one clustering pass, one
    MoRLayer under the ``"shared"`` key (where the hybrid model and the
    telemetry's ``mor_group_map`` look for it).

    -> (params with the shared MLP's weights permuted, {"shared":
        MoRLayer}, report).  ``params`` itself is left as it was."""
    mlp = params["shared"]["mlp"]
    w = mlp["w_gate"] if "w_gate" in mlp else mlp["w_up"]
    N = w.shape[-1]
    acc = init_accumulator((N,), w.device)
    seen = 0
    with torch.no_grad():
        for batch in batches:
            taps = forward(params, cfg, batch, with_taps=True)[1]["taps"]
            acc = update_accumulator(acc, taps["p_bin"].reshape(-1, N),
                                     taps["p_base"].reshape(-1, N))
            del taps
            seen += 1
            if seen >= n_batches:
                break
    m, b, c = (t.cpu().numpy() for t in finalize_regression(acc))
    cl = cluster_layer(w, cfg.mor.max_cluster_angle)
    ml = build_mor_layer(m, b, c, cl, cfg.mor, w.device)

    # fold the permutation into the shared MLP's weights (offline)
    perm = ml["perm"].long()
    mlp2 = dict(mlp)
    if "w_gate" in mlp2:
        mlp2["w_gate"] = mlp2["w_gate"].index_select(1, perm)
    mlp2["w_up"] = mlp2["w_up"].index_select(1, perm)
    mlp2["w_down"] = mlp2["w_down"].index_select(0, perm)
    new_params = dict(params)
    new_params["shared"] = dict(params["shared"], mlp=mlp2)

    report = {
        "pearson_mean": float(c.mean()),
        "pearson_frac_above_T": float((c > cfg.mor.corr_threshold).mean()),
        "n_proxies_mean": float(len(np.unique(
            ml["proxy_slot"].cpu().numpy()))),
        "enabled_frac": float(ml["enable"].float().mean()),
    }
    return new_params, {"shared": ml}, report


def calibrate_moe(params: Dict, cfg: ModelConfig, forward: Callable,
                  batches: Iterator[Dict], n_batches: int, *,
                  cluster_experts: bool = True,
                  inject_dead_frac: float = 0.0) -> Tuple[Dict, Dict, Dict]:
    """Calibrate a layer-stacked MoE LM (``repro.core.deploy.
    calibrate_moe``).

    The leading dense layers get the ``calibrate_lm`` treatment; every
    (layer, expert) FFN gets its own hybrid predictor fitted from
    routing-independent taps (``moe_taps``: each expert is evaluated
    over the full token stream its dispatch subsamples).
    ``cluster_experts=False`` builds binary-rookie-only expert layers
    (identity permutation, no proxies).  ``inject_dead_frac`` > 0 folds
    a bias of -``INJECT_SCALE`` observed pre-activation sigmas into the
    trailing fraction of each expert's (permuted) columns, emulating a
    trained model's column-skewed ReLU sparsity on random weights.

    The permutations are applied on the weights' device, one expert at
    a time: a host float32 copy of one full-width MoE layer's experts
    would be 15 GB.  ``params`` itself is left as it was.

    -> (params with permuted weights, {"dense_layers"?: stacked MoRLayer,
        "moe_layers": {"experts": (L_moe, E)-stacked MoRLayer}}, report).
    """
    if cfg.family != "moe":
        raise ValueError(f"calibrate_moe needs a moe config, got "
                         f"{cfg.family!r}")
    L_d = cfg.first_k_dense
    L_m = cfg.n_layers - L_d
    E = cfg.n_experts
    f = cfg.moe_d_ff or cfg.d_ff
    moe_p = params["moe_layers"]["moe"]
    w_stack = moe_p.get("w_gate", moe_p["w_up"])           # (L_m, E, d, f)
    device = w_stack.device

    acc_e = init_accumulator((L_m, E, f), device)
    acc_d = None
    if L_d:
        mlp_d = params["dense_layers"]["mlp"]
        N_d = mlp_d.get("w_gate", mlp_d["w_up"]).shape[-1]
        acc_d = init_accumulator((L_d, N_d), device)
    seen = 0
    with torch.no_grad():
        for batch in batches:
            aux = forward(params, cfg, batch, with_taps=True)[1]
            taps = aux.pop("taps")                    # (L_m, E, T, f)
            acc_e = update_accumulator(acc_e, taps["p_bin"],
                                       taps["p_base"])
            del taps
            if L_d:
                dt_ = aux["dense_taps"]
                acc_d = update_accumulator(acc_d, dt_["p_bin"],
                                           dt_["p_base"])
            del aux
            seen += 1
            if seen >= n_batches:
                break
    m, b, c = (t.cpu().numpy() for t in finalize_regression(acc_e))
    # observed per-column base pre-activation sigma (for the injection)
    n = np.maximum(acc_e["count"].cpu().numpy(), 1.0)[..., None]
    sig = np.sqrt(np.maximum(acc_e["syy"].cpu().numpy() / n
                             - (acc_e["sy"].cpu().numpy() / n) ** 2, 0.0))

    tn = min(cfg.mor.tile_n, f)
    n_dead = 0
    if inject_dead_frac > 0:
        # whole trailing column tiles, so that deadness is tile-resolvable
        n_dead = max(int(inject_dead_frac * f) // tn * tn, tn)
        n_dead = min(n_dead, f - tn)              # keep a live leading tile

    moe_new = dict(moe_p)
    if cluster_experts:
        for key in ("w_gate", "w_up", "w_down"):
            if key in moe_p:
                moe_new[key] = moe_p[key].clone()
    layer_stacks = []
    for l in range(L_m):
        per_expert = []
        for e in range(E):
            cl = (cluster_layer(w_stack[l, e], cfg.mor.max_cluster_angle)
                  if cluster_experts else None)
            ml = build_mor_layer(m[l, e], b[l, e], c[l, e], cl, cfg.mor,
                                 device)
            if cluster_experts:
                perm = ml["perm"].long()
                for key in ("w_gate", "w_up"):
                    if key in moe_new:
                        moe_new[key][l, e] = moe_new[key][l, e].index_select(
                            1, perm)
                moe_new["w_down"][l, e] = moe_new["w_down"][l, e
                                                           ].index_select(
                    0, perm)
            if n_dead:
                perm_np = ml["perm"].cpu().numpy()
                bias = ml["bn_bias"].cpu().numpy().copy()
                bias[f - n_dead:] -= INJECT_SCALE * sig[l, e][perm_np][
                    f - n_dead:]
                ml["bn_bias"] = torch.as_tensor(bias.astype(np.float32),
                                                device=device)
                # a column whose folded bias exceeds its dynamic range is
                # statically dead: enabling its rookie is always safe
                en = ml["enable"].clone()
                en[f - n_dead:] = True
                ml["enable"] = en
            per_expert.append(ml)
        layer_stacks.append({k: torch.stack([ml[k] for ml in per_expert])
                             for k in per_expert[0]})
    experts = {k: torch.stack([ls[k] for ls in layer_stacks])
               for k in layer_stacks[0]}                  # (L_m, E, ...)
    new_params = dict(params)
    new_params["moe_layers"] = dict(params["moe_layers"], moe=moe_new)

    mor: Dict = {"moe_layers": {"experts": experts}}
    report = {
        "pearson_mean": float(c.mean()),
        "pearson_frac_above_T": float((c > cfg.mor.corr_threshold).mean()),
        "enabled_frac": float(experts["enable"].float().mean()),
        "injected_dead_cols": int(n_dead),
    }

    if L_d:
        md, bd, cd = (t.cpu().numpy() for t in finalize_regression(acc_d))
        lp = params["dense_layers"]
        wd = lp["mlp"].get("w_gate", lp["mlp"]["w_up"])
        dense_layers = [build_mor_layer(
            md[l], bd[l], cd[l],
            cluster_layer(wd[l], cfg.mor.max_cluster_angle), cfg.mor,
            device) for l in range(L_d)]
        dense_stack = {k: torch.stack([ml[k] for ml in dense_layers])
                       for k in dense_layers[0]}
        perm = dense_stack["perm"].long()

        def permute_stack(w, axis):
            return torch.stack([w[l].index_select(axis, perm[l])
                                for l in range(L_d)])

        mlp = dict(lp["mlp"])
        if "w_gate" in mlp:
            mlp["w_gate"] = permute_stack(mlp["w_gate"], 1)
        mlp["w_up"] = permute_stack(mlp["w_up"], 1)
        mlp["w_down"] = permute_stack(mlp["w_down"], 0)
        new_params["dense_layers"] = dict(lp, mlp=mlp)
        mor["dense_layers"] = dense_stack
        report["dense_pearson_mean"] = float(cd.mean())
    return new_params, mor, report


def _fit_layers(accs: List, batches: Iterator[Dict], n_batches: int,
                taps_of: Callable) -> List[Tuple]:
    """Stream ``n_batches`` of ``batches`` through ``taps_of`` (batch ->
    one tap per layer) into the per-layer accumulators -> per layer the
    host (m, b, c)."""
    seen = 0
    with torch.no_grad():
        for batch in batches:
            for i, tap in enumerate(taps_of(batch)):
                accs[i] = update_accumulator(accs[i], tap["p_bin"],
                                             tap["p_base"])
            seen += 1
            if seen >= n_batches:
                break
    return [tuple(t.cpu().numpy() for t in finalize_regression(a))
            for a in accs]


def _list_report(mors: List, cs: List) -> Dict:
    return {"pearson_mean": float(np.mean([c.mean() for c in cs])),
            "pearson_per_layer": [float(c.mean()) for c in cs],
            "enabled_frac": float(np.mean(
                [float(ml["enable"].float().mean()) for ml in mors]))}


def calibrate_cnn(params: Dict, state: Dict, cfg: ModelConfig,
                  forward: Callable, batches: Iterator[Dict],
                  n_batches: int) -> Tuple[List, Dict]:
    """Calibrate the paper's CNNs: one MoRLayer per conv layer, its BN
    folded into ``bn_scale`` / ``bn_bias``.  ``batches`` yield
    {"images": NHWC (numpy or tensor)}.  -> (MoRLayer list aligned with
    the conv layers, report)."""
    from repro_torch.models.cnn import bn_fold, layer_weight_matrices
    device = params["head"].device
    fits = _fit_layers(
        [init_accumulator(lp["w"].shape[-1], device)
         for lp in params["layers"]], batches, n_batches,
        lambda b: forward(params, state, cfg, torch.as_tensor(
            b["images"], device=device), with_taps=True)[2]["taps"])
    mors = []
    for i, (w, (m, b, c)) in enumerate(zip(layer_weight_matrices(params),
                                           fits)):
        bn_s = bn_b = None
        if cfg.batchnorm:
            bn_s, bn_b = (t.cpu().numpy() for t in bn_fold(
                params["layers"][i]["bn"], state["bn"][i]))
        mors.append(build_mor_layer(
            m, b, c, cluster_layer(w, cfg.mor.max_cluster_angle), cfg.mor,
            device, bn_scale=bn_s, bn_bias=bn_b))
    return mors, _list_report(mors, [f[2] for f in fits])


def calibrate_tds(params: Dict, cfg: ModelConfig, forward: Callable,
                  batches: Iterator[Dict], n_batches: int
                  ) -> Tuple[List, Dict]:
    """Calibrate the TDS FC1 layers (the taps alternate conv and FC, so
    the FC taps are the odd ones); the FC1 bias folds into the
    predictor's affine term as ``bn_bias``.  ``batches`` yield
    {"frames": (B, T, d) (numpy or tensor)}.  -> (MoRLayer list, one per
    block, report)."""
    device = params["head"].device
    fits = _fit_layers(
        [init_accumulator(cfg.d_ff, device) for _ in params["layers"]],
        batches, n_batches,
        lambda b: forward(params, cfg, {"frames": torch.as_tensor(
            b["frames"], device=device)}, with_taps=True)[1]["taps"][1::2])
    mors = [build_mor_layer(m, b, c, cluster_layer(
        lp["fc1"], cfg.mor.max_cluster_angle), cfg.mor, device,
        bn_bias=lp["fc1_b"].cpu().numpy())
        for lp, (m, b, c) in zip(params["layers"], fits)]
    return mors, _list_report(mors, [f[2] for f in fits])
