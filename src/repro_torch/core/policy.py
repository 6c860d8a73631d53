"""Tile policy: fold calibration + clustering into a MoRLayer.

The column permutation (a) packs each cluster's members into the same
output tile and (b) places proxies in the leading tiles, which are
always computed.  It is folded into the adjacent weight matrices
offline, so the runtime never gathers (``repro.core.policy``).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoRConfig
from repro_torch.core.predictor import MoRLayer


def build_permutation(proxy_of: np.ndarray, is_proxy: np.ndarray
                      ) -> np.ndarray:
    """perm[new_pos] = old_index.  Proxies first (by descending cluster
    size), then members grouped by their proxy."""
    n = len(proxy_of)
    sizes = np.bincount(proxy_of, minlength=n)
    proxies = np.where(is_proxy)[0]
    proxies = proxies[np.argsort(-sizes[proxies], kind="stable")]
    members_of = {int(p): [] for p in proxies}
    for j in range(n):
        if not is_proxy[j]:
            members_of[int(proxy_of[j])].append(j)
    order = list(proxies)
    for p in proxies:
        order.extend(members_of[int(p)])
    perm = np.asarray(order, np.int32)
    assert len(np.unique(perm)) == n
    return perm


def build_mor_layer(m: np.ndarray, b: np.ndarray, c: np.ndarray,
                    cluster: Optional[Dict], cfg: MoRConfig, device,
                    bn_scale: Optional[np.ndarray] = None,
                    bn_bias: Optional[np.ndarray] = None) -> MoRLayer:
    """Assemble the MoRLayer in permuted column order on ``device``.
    ``cluster=None`` builds a binary-rookie-only layer (identity
    permutation, proxy_slot = -1 sentinel)."""
    n = len(m)
    bn_scale = np.ones(n) if bn_scale is None else bn_scale
    bn_bias = np.zeros(n) if bn_bias is None else bn_bias
    if cluster is None:
        perm = np.arange(n, dtype=np.int32)
        inv_perm = perm
        proxy_slot = np.full(n, -1, np.int32)
        is_proxy = np.zeros(n, bool)
    else:
        perm = build_permutation(cluster["proxy_of"], cluster["is_proxy"])
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(n, dtype=np.int32)
        proxy_slot = inv_perm[cluster["proxy_of"][perm]]
        is_proxy = cluster["is_proxy"][perm]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return {
        "m": f32(m[perm]),
        "b": f32(b[perm]),
        "enable": torch.as_tensor(c[perm] > cfg.corr_threshold,
                                  device=device),
        "proxy_slot": i32(proxy_slot),
        "is_proxy": torch.as_tensor(np.asarray(is_proxy, bool),
                                    device=device),
        "perm": i32(perm),
        "inv_perm": i32(inv_perm),
        "bn_scale": f32(np.asarray(bn_scale)[perm]),
        "bn_bias": f32(np.asarray(bn_bias)[perm]),
    }


def tile_mask_from_neuron_mask(computed: torch.Tensor, tile_m: int,
                               tile_n: int) -> torch.Tensor:
    """(..., M, N) bool 'must compute' mask -> (..., ceil(M/tile_m),
    ceil(N/tile_n)) bool tile mask: live iff ANY neuron of the tile must
    be computed for ANY row of the block (a leading expert dim is kept)."""
    M, N = computed.shape[-2:]
    pm, pn = (-M) % tile_m, (-N) % tile_n
    padded = F.pad(computed, (0, pn, 0, pm))
    t = padded.reshape(*computed.shape[:-2], (M + pm) // tile_m, tile_m,
                       (N + pn) // tile_n, tile_n)
    return t.any(dim=-1).any(dim=-2)


def expand_tile_mask(tile_mask: torch.Tensor, tile_m: int, tile_n: int,
                     M: int, N: int) -> torch.Tensor:
    """Inverse of tile_mask_from_neuron_mask: broadcast back to (..., M,
    N)."""
    big = tile_mask.repeat_interleave(tile_m, -2).repeat_interleave(tile_n,
                                                                    -1)
    return big[..., :M, :N]
