"""Int8 error-feedback gradient compression for the thin inter-pod link
(``repro.optim.compression``).

``error_feedback_allreduce`` quantises each gradient leaf to int8 with a
per-leaf scale, dequantises, mean-reduces the dequantised values over
the group (the reference's ``pmean``: a float32 all-reduce sum divided by
the group's size) and keeps the quantisation residual locally, adding
it back into the next step's gradient so that the error is fed back,
not lost (Seide et al. / the 1-bit Adam lineage).  The train step does
not call it, as the reference's does not: it is a library.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 payload, float32 scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def error_feedback_allreduce(grads: Any, residuals: Any, group=None
                             ) -> Tuple[Any, Any]:
    """Quantise (grads + residuals), mean-reduce over ``group`` (a
    ``launch.mesh.PageGroup``; None: no reduction), -> (reduced float32 grads, new
    residuals).  The residual tree matches ``grads`` (zeros on step 0:
    ``init_residuals``)."""
    from repro_torch.distributed import collectives as co
    red, res = [], []
    for g, r in zip(leaves(grads), leaves(residuals)):
        g_comp = g.float() + r
        q, scale = compress_int8(g_comp)
        deq = decompress_int8(q, scale)
        res.append(g_comp - deq)                 # local error feedback
        if group is not None and group.size > 1:
            deq = co.all_reduce(deq, group, "error_feedback") / group.size
        red.append(deq)
    return unflatten(grads, red), unflatten(grads, res)


def init_residuals(grads_or_params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), grads_or_params)
