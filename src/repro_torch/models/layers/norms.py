"""RMSNorm / LayerNorm (fp32 statistics, cast back to input dtype)."""
from __future__ import annotations

import torch


def norm_init(kind: str, d: int, device) -> dict:
    out = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind != "rmsnorm":
        out["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return out


def stacked_norm_init(kind: str, d: int, n_layers: int, device) -> dict:
    """``norm_init`` with a leading layer dim of ``n_layers``."""
    return {k: v[None].repeat(n_layers, *([1] * v.ndim))
            for k, v in norm_init(kind, d, device).items()}


def apply_norm(kind: str, params, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.reciprocal(torch.sqrt(
            torch.mean(xf * xf, -1, keepdim=True) + eps))
        y = y * params["scale"]
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), -1, keepdim=True)
        y = (xf - mu) * torch.reciprocal(torch.sqrt(var + eps))
        y = y * params["scale"] + params["bias"]
    return y.to(x.dtype)
