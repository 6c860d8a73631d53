"""Shared initialisation + activation helpers (params are plain dicts of
tensors; every random draw takes an explicit ``torch.Generator``, whose
device decides where the weights are made)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.float32, scale=None) -> torch.Tensor:
    """Normal(0, d_in^-1/2) weights of ``shape`` (..., d_in, d_out), in the
    JAX package's (d_in, d_out) ``x @ w`` layout."""
    scale = scale if scale is not None else shape[-2] ** -0.5
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def activation_fn(name: str):
    if name in ("relu", "relu_glu"):
        return F.relu
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name in ("silu", "swiglu"):
        return F.silu
    raise ValueError(f"unknown activation {name!r}")


def is_glu(name: str) -> bool:
    return name in ("swiglu", "relu_glu")
