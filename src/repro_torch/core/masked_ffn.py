"""The long-standing FFN entry points over
:class:`repro_torch.core.executor.MoRExecutionPlan`
(``repro.core.masked_ffn``): each wraps its MoRLayer in a plan and
calls it, so that the predictor runs once per FFN in every mode:

  dense  - plain matmul, predictor off;
  exact  - full compute, then the predicted-dead neurons zeroed;
  tiled  - tile-granular skipping in plain PyTorch (the kernels' oracle);
  kernel - ``mor_tile_mask``, ``gather_matmul`` and
           ``masked_matmul_kdim``.

Every mode works in the permuted column space; the permutation is
folded into the surrounding weights offline (``core.deploy``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.executor import MoRExecutionPlan, as_plan
from repro_torch.core.predictor import MoRLayer


def mor_relu_matmul(x: torch.Tensor, w: torch.Tensor,
                    mor: Optional[MoRLayer], *, activation: str = "relu",
                    mode: str = "dense", tile_m: int = 8, tile_n: int = 128,
                    residual: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """y = act(x @ w) with MoR skipping; x (T, K), w (K, N) permuted.
    ``mor`` is a bare MoRLayer (planned with ``mode`` and the tiling) or
    an attached plan (its own settings win).  -> (y, skip stats as
    0-dim device tensors)."""
    plan = as_plan(mor, mode=mode, tile_m=tile_m, tile_n=tile_n)
    return plan.relu_matmul(x, w, activation=activation, residual=residual)


def mor_ffn_apply(x: torch.Tensor, w_up: torch.Tensor,
                  w_down: torch.Tensor, mor: Optional[MoRLayer], *,
                  activation: str, mode: str,
                  w_gate: Optional[torch.Tensor] = None, tile_m: int = 8,
                  tile_n: int = 128,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The whole FFN with MoR on its ReLU pre-activation.  With
    ``w_gate`` (a relufied GLU, h = relu(x w_gate) * (x w_up)) the one
    gate prediction also skips the up column and the down row of every
    dead neuron."""
    plan = as_plan(mor, mode=mode, tile_m=tile_m, tile_n=tile_n)
    return plan.ffn(x, w_up, w_down, activation=activation, w_gate=w_gate)


__all__ = ["mor_relu_matmul", "mor_ffn_apply", "MoRExecutionPlan",
           "as_plan"]
