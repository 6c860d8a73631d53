"""Offline calibration (paper §3.2.1): streaming per-neuron linear
regression between binarised and base-precision pre-activations, from
first and second moments accumulated in O(N) memory per layer.  Every
function takes an optional leading layer dim (the JAX package vmaps)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

CalibAccumulator = Dict[str, torch.Tensor]


def init_accumulator(shape, device, dtype=torch.float32
                     ) -> CalibAccumulator:
    """``shape``: (N,) or (L, N)."""
    shape = tuple(shape) if not isinstance(shape, int) else (shape,)
    z = torch.zeros(shape, dtype=dtype, device=device)
    return {"count": torch.zeros(shape[:-1], dtype=dtype, device=device),
            "sx": z, "sy": z.clone(), "sxx": z.clone(), "syy": z.clone(),
            "sxy": z.clone()}


def update_accumulator(acc: CalibAccumulator, p_bin: torch.Tensor,
                       p_base: torch.Tensor) -> CalibAccumulator:
    """p_bin/p_base: (..., T, N) samples; the leading dims match the
    accumulator's own, and T rows are summed."""
    dt = acc["sx"].dtype
    x = p_bin.to(dt)
    y = p_base.to(dt)
    return {
        "count": acc["count"] + x.shape[-2],
        "sx": acc["sx"] + x.sum(-2),
        "sy": acc["sy"] + y.sum(-2),
        "sxx": acc["sxx"] + (x * x).sum(-2),
        "syy": acc["syy"] + (y * y).sum(-2),
        "sxy": acc["sxy"] + (x * y).sum(-2),
    }


def finalize_regression(acc: CalibAccumulator, eps: float = 1e-12
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """-> (m, b, c): slope, intercept, Pearson correlation per neuron.
    Degenerate neurons (zero variance on either side) get c = 0."""
    n = torch.clamp(acc["count"], min=1.0)[..., None]
    mx, my = acc["sx"] / n, acc["sy"] / n
    vx = acc["sxx"] / n - mx * mx
    vy = acc["syy"] / n - my * my
    cov = acc["sxy"] / n - mx * my
    m = cov / torch.clamp(vx, min=eps)
    b = my - m * mx
    denom = torch.sqrt(torch.clamp(vx, min=eps) * torch.clamp(vy, min=eps))
    c = torch.where((vx > eps) & (vy > eps), cov / denom,
                    torch.zeros((), dtype=cov.dtype, device=cov.device))
    return m.float(), b.float(), c.float()
