"""Offline angle-based clustering (paper §3.2.2).

Neurons whose weight vectors subtend a small angle share one *proxy*
evaluation.  The closest-neighbour graph is O(N^2 K) per layer (8192 x
8192 x 2048 for granite-3-2b, over 40 layers), so its cosine slabs run
as ``torch.matmul`` on the weights' device; the indegree-greedy proxy
election stays host numpy (a copy of ``repro.core.clustering``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def closest_neighbor_graph(w: torch.Tensor, max_angle_deg: float = 90.0,
                           block: int = 2048
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """w: (K, N) — one weight vector per output neuron (column).
    -> (nn_idx, nn_angle) host arrays: each neuron's closest other
    neuron by angle, and that angle in degrees.  Neurons whose closest
    angle is at least ``max_angle_deg`` point at themselves.  The
    cosines are float32 and the argmax keeps numpy's first-max
    tie-break (``torch.argmax`` returns the first maximal index)."""
    w = w.float()
    wn = w / torch.clamp(torch.linalg.vector_norm(w, dim=0, keepdim=True),
                         min=1e-12)
    n = wn.shape[1]
    nn_idx = torch.empty((n,), dtype=torch.int64, device=w.device)
    best_cos = torch.empty((n,), dtype=torch.float32, device=w.device)
    for i in range(0, n, block):
        cols = torch.arange(i, min(i + block, n), device=w.device)
        cos = wn[:, i:i + block].T @ wn                       # (b, N)
        rows = torch.arange(len(cols), device=w.device)
        cos[rows, cols] = -2.0                                # exclude self
        nn_idx[cols] = torch.argmax(cos, dim=1)
        best_cos[cols] = cos[rows, nn_idx[cols]]
    nn_idx = nn_idx.cpu().numpy()
    best_cos = best_cos.cpu().numpy()
    nn_angle = np.degrees(np.arccos(np.clip(best_cos, -1.0, 1.0)))
    too_far = nn_angle >= max_angle_deg
    nn_idx[too_far] = np.where(too_far)[0]            # self-loop = unclustered
    return nn_idx, nn_angle


def greedy_proxy_clustering(nn_idx: np.ndarray) -> Tuple[np.ndarray,
                                                         np.ndarray]:
    """Paper's indegree-greedy proxy election.

    -> (proxy_of, is_proxy): proxy_of[j] = the proxy neuron for j (itself
    if j is a proxy or unclustered)."""
    n = len(nn_idx)
    indegree = np.bincount(nn_idx, minlength=n)
    # self-loops mark unclustered nodes; don't let them inflate indegree
    self_loop = nn_idx == np.arange(n)
    indegree[self_loop] = np.maximum(indegree[self_loop] - 1, 0)

    alive = np.ones(n, bool)
    proxy_of = np.arange(n)
    is_proxy = np.zeros(n, bool)
    order = np.argsort(-indegree, kind="stable")
    rev_sorted = np.argsort(nn_idx, kind="stable")
    starts = np.searchsorted(nn_idx[rev_sorted], np.arange(n))
    ends = np.searchsorted(nn_idx[rev_sorted], np.arange(n), side="right")
    for node in order:
        if not alive[node]:
            continue
        alive[node] = False
        is_proxy[node] = True
        members = rev_sorted[starts[node]:ends[node]]
        members = members[alive[members] & (members != node)]
        proxy_of[members] = node
        alive[members] = False
    is_proxy[alive] = True
    return proxy_of, is_proxy


def cluster_layer(w: torch.Tensor, max_angle_deg: float = 90.0) -> Dict:
    """Full offline clustering for one layer's (K, N) weight matrix."""
    nn_idx, nn_angle = closest_neighbor_graph(w, max_angle_deg)
    proxy_of, is_proxy = greedy_proxy_clustering(nn_idx)
    return {
        "nn_idx": nn_idx,
        "nn_angle": nn_angle,
        "proxy_of": proxy_of,
        "is_proxy": is_proxy,
        "n_proxies": int(is_proxy.sum()),
    }
