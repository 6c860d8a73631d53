"""Rotary position embeddings, computed on the fly from positions."""
from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions: (..., S) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions.float()[..., None] * inv             # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)
