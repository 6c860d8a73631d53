"""Shared initialisation + activation helpers (params are plain dicts of
tensors; every random draw takes an explicit ``torch.Generator``, whose
device decides where the weights are made).  ``META`` stands in for a
generator on the meta device, which PyTorch does not have: an init
given it makes every leaf's shape and dtype and draws nothing
(``models.param_shapes``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


class MetaGenerator:
    """The one thing an init reads of its generator besides the draws:
    the device.  ``randn`` draws nothing from it."""
    device = torch.device("meta")


META = MetaGenerator()


def randn(gen, shape: Tuple[int, ...]) -> torch.Tensor:
    """Standard normal float32 draws of ``shape`` from ``gen`` on its
    device; an uninitialised meta tensor for ``META``."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               dtype=torch.float32, scale=None) -> torch.Tensor:
    """Normal(0, d_in^-1/2) weights of ``shape`` (..., d_in, d_out), in the
    JAX package's (d_in, d_out) ``x @ w`` layout."""
    scale = scale if scale is not None else shape[-2] ** -0.5
    return (randn(gen, shape) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    return (randn(gen, (vocab, d)) * 0.02).to(dtype)


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
