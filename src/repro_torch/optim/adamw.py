"""AdamW with dtype-configurable moments, a float32 master copy,
decoupled weight decay and global-norm clipping (``repro.optim.adamw``).

The optimizer state mirrors the param tree: {"step": int32 (), "mu",
"nu"} and, where the params are not in ``master_dtype``, "master".  The
JAX package returns new trees and donates the old ones; here
``adamw_update`` writes the new values into the same tensors, under
``torch.no_grad()``, and reads nothing back to the host: the clip
factor, the bias corrections and the learning rate stay device tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "bfloat16"   # bf16 moments: 4 bytes/param saved
    master_dtype: str = "float32"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _needs_master(params, cfg: OptConfig) -> bool:
    """The reference's test: the first leaf's dtype (in its leaf order)
    differs from ``master_dtype``."""
    flat = leaves(params)
    return bool(flat) and flat[0].dtype != _dtype(cfg.master_dtype)


def adamw_init(params, cfg: OptConfig) -> Dict[str, Any]:
    mdt = _dtype(cfg.moment_dtype)
    dev = leaves(params)[0].device
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
        "nu": tree_map(lambda p: torch.zeros_like(p, dtype=mdt), params),
    }
    if _needs_master(params, cfg):
        # the float32 master copy; the params stay in their compute dtype
        state["master"] = tree_map(
            lambda p: p.detach().to(_dtype(cfg.master_dtype), copy=True),
            params)
    return state


def global_norm(tree, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32.  On a
    ``mesh`` whose ranks hold their blocks of ``tree`` (``specs``, its
    spec tree): each rank sums the squares of its blocks, a leaf
    replicated over an axis counted on that axis' first rank only, and
    one all-reduce over the world adds them; the same value on every
    rank."""
    if mesh is None or getattr(mesh, "groups", None) is None or \
            mesh.group("world").size == 1:
        norms = [torch.linalg.vector_norm(l, dtype=torch.float32)
                 for l in leaves(tree)]
        return torch.linalg.vector_norm(torch.stack(norms))
    from repro_torch.distributed import collectives as co
    from repro_torch.distributed.sharding_rules import spec_paths
    sq = []
    for l, spec in zip(leaves(tree), spec_paths(specs).values()):
        split = {a for ax in spec if ax is not None
                 for a in ((ax,) if isinstance(ax, str) else ax)}
        if all(mesh.index(a) == 0 for a in mesh.axis_names
               if a not in split):
            sq.append(torch.linalg.vector_norm(l, dtype=torch.float32)
                      .square())
    dev = leaves(tree)[0].device
    total = torch.stack(sq).sum() if sq else torch.zeros((), device=dev)
    return torch.sqrt(co.all_reduce(total, mesh.group("world"),
                                    "global_norm"))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig,
                 lr_scale: torch.Tensor | float = 1.0, mesh=None,
                 specs=None,
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """-> (params, state, metrics), params and state updated IN PLACE.

    Decoupled weight decay applies to leaves with ``ndim >= 2``, as in
    the reference.  The params keep the layer-stacked layout, so a
    stacked norm scale (L, d) is a 2-D leaf and is decayed too, as the
    reference's is.  ``grads`` may be in any float dtype; they are read
    in float32.  metrics: "grad_norm" (before clipping) and "lr", float32
    device tensors.  On a ``mesh`` the trees are this rank's blocks of
    ``specs``'s layout and the norm is ``global_norm``'s over the mesh
    (the single-device clip); the update itself is elementwise."""
    step = state["step"]
    step.add_(1)
    gnorm = global_norm(grads, mesh, specs)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, step_f)
    bc2 = 1.0 - torch.pow(b2, step_f)
    lr = torch.as_tensor(cfg.lr * lr_scale, dtype=torch.float32,
                         device=step.device)
    decay = 1.0 - lr * cfg.weight_decay
    has_master = "master" in state
    flat_p = leaves(params)
    flat_ma = leaves(state["master"]) if has_master else [None] * len(flat_p)
    for p, g, mu, nu, master in zip(flat_p, leaves(grads),
                                    leaves(state["mu"]), leaves(state["nu"]),
                                    flat_ma):
        g = g.to(torch.float32) * clip
        # a float32 moment is updated in place; another dtype in a
        # float32 copy that is rounded back below
        mu_f = mu.to(torch.float32).mul_(b1).add_(g, alpha=1 - b1)
        nu_f = nu.to(torch.float32).mul_(b2).addcmul_(g, g, value=1 - b2)
        del g
        delta = (mu_f / bc1).div_((nu_f / bc2).sqrt_().add_(cfg.eps))
        p_f = master if master is not None else p.to(torch.float32)
        if p.ndim >= 2:                  # decoupled weight decay
            p_f.mul_(decay)
        p_f.sub_(delta.mul_(lr))
        del delta
        for dst, src in ((p, p_f), (mu, mu_f), (nu, nu_f)):
            if dst is not src:
                dst.copy_(src)
    return params, state, {"grad_norm": gnorm, "lr": lr}
