"""The hybrid predictor itself (paper §3.2): binary rookie + proxy rookie.

A ``MoRLayer`` is a dict of per-output-neuron tensors, all length N and
in *permuted* (tile-packed) column order, exactly as in
``repro.core.predictor``:
  m, b        : fitted line  p_hat = m * p_bin + b
  enable      : binary rookie enabled (pearson c > T)
  proxy_slot  : permuted column index of this neuron's proxy (-1 = none)
  is_proxy    : proxies are always evaluated at base precision
  perm        : permuted -> original column index
  inv_perm    : original -> permuted column index
  bn_scale/bn_bias : folded batch-norm; identity (1, 0) without BN.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

MoRLayer = Dict[str, torch.Tensor]

# Predictor-evaluation counter: incremented once per ``hybrid_predict``
# call and once per ``kernels.ops.mor_tile_mask`` call.  The
# MoRExecutionPlan contract is ONE evaluation per FFN forward.
_PREDICTOR_EVALS = [0]


def note_predictor_eval() -> None:
    _PREDICTOR_EVALS[0] += 1


def predictor_eval_count() -> int:
    return _PREDICTOR_EVALS[0]


def reset_predictor_eval_count() -> None:
    _PREDICTOR_EVALS[0] = 0


def binarize(x: torch.Tensor) -> torch.Tensor:
    """Weight binarisation from the sign bit: zero maps to +1."""
    return torch.where(x >= 0, 1.0, -1.0)


def binarize_act(x: torch.Tensor) -> torch.Tensor:
    """Activation binarisation: strictly-positive -> +1, else -1."""
    return torch.where(x > 0, 1.0, -1.0)


def binary_preact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sign_act(x) . sign(w) -> (..., N) float32.

    The +-1 products are summed as float32, which is exact while the
    contraction is shorter than 2^24 (and stays exact under TF32, whose
    inputs +-1 are representable): the same integers the JAX int8/int32
    dot gives."""
    return binarize_act(x.float()) @ binarize(w.float())


def estimate_preact(p_bin: torch.Tensor, mor: MoRLayer,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fitted line + BN fold (+ residual) -> estimated ReLU input."""
    p_hat = mor["m"] * p_bin + mor["b"]
    p_hat = p_hat * mor["bn_scale"] + mor["bn_bias"]
    if residual is not None:
        p_hat = p_hat + residual.to(p_hat.dtype)
    return p_hat


def hybrid_predict(x: torch.Tensor, w_perm: torch.Tensor, mor: MoRLayer,
                   preact_full: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean mask (..., N): True where the neuron MUST be computed,
    False where both rookies agree the ReLU output is zero."""
    note_predictor_eval()
    slot = torch.clamp(mor["proxy_slot"], min=0).long()
    if preact_full is None:
        proxy_cols = w_perm.index_select(1, slot)
        # preferred_element_type=f32: f32 operands give the f32 sum of
        # the (exact) products
        proxy_pre = x.float() @ proxy_cols.float()
    else:
        proxy_pre = preact_full.float().index_select(-1, slot)
    proxy_relu_in = proxy_pre * mor["bn_scale"][slot] + mor["bn_bias"][slot]
    if residual is not None:
        proxy_relu_in = proxy_relu_in + residual.float().index_select(-1,
                                                                      slot)
    proxy_says_zero = (proxy_relu_in < 0.0) | (mor["proxy_slot"] < 0)

    p_bin = binary_preact(x, w_perm)
    p_hat = estimate_preact(p_bin, mor, residual)
    binary_says_zero = p_hat < 0.0

    skip = proxy_says_zero & binary_says_zero & mor["enable"] \
        & ~mor["is_proxy"]
    return ~skip
