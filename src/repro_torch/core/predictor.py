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


def make_identity_layer(n: int, device="cpu") -> MoRLayer:
    """A no-op MoRLayer: nothing enabled, every column its own proxy,
    the identity permutation."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    return {"m": ones, "b": torch.zeros_like(ones),
            "enable": torch.zeros((n,), dtype=torch.bool, device=device),
            "proxy_slot": idx, "is_proxy": torch.ones_like(ones).bool(),
            "perm": idx.clone(), "inv_perm": idx.clone(),
            "bn_scale": ones.clone(), "bn_bias": torch.zeros_like(ones)}


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
    return binarize_act(x) @ binarize(w)


def cols(v: torch.Tensor) -> torch.Tensor:
    """A per-column leaf (..., N) as (..., 1, N): it broadcasts over the
    rows of ``x @ w`` for one FFN (N,) and for an expert stack (E, N)."""
    return v.unsqueeze(-2)


def take_cols(a: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """a[..., slot] with a per-expert ``slot`` (..., N): the columns of a
    (..., K, N) weight, or the entries of a (..., N) leaf."""
    if a.ndim == slot.ndim:
        return torch.gather(a, -1, slot)
    return torch.gather(a, -1, cols(slot).expand(a.shape))


def estimate_preact(p_bin: torch.Tensor, mor: MoRLayer,
                    residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fitted line + BN fold (+ residual) -> estimated ReLU input."""
    p_hat = cols(mor["m"]) * p_bin + cols(mor["b"])
    p_hat = p_hat * cols(mor["bn_scale"]) + cols(mor["bn_bias"])
    if residual is not None:
        p_hat = p_hat + residual.to(p_hat.dtype)
    return p_hat


def proxy_relu_in(x: torch.Tensor, w_perm: torch.Tensor, mor: MoRLayer,
                  preact_full: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  proxy_block: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """The proxy rookie's ReLU input for every column: its proxy's
    base-precision pre-activation (+ BN fold, + residual), float32.
    ``proxy_block`` (T, P): those inputs of the proxy columns [0, P),
    already folded, gathered from the ranks that hold them where the
    FFN is split by column (``executor.MoRExecutionPlan.for_rank``);
    ``w_perm`` and ``mor`` are then the rank's blocks, ``proxy_slot``
    global."""
    slot = torch.clamp(mor["proxy_slot"], min=0).long()
    if proxy_block is not None:
        return proxy_block[..., slot]
    if preact_full is None:
        # preferred_element_type=f32: f32 operands give the f32 sum of
        # the (exact) products
        proxy_pre = x.float() @ take_cols(w_perm, slot).float()
    else:
        proxy_pre = take_cols(preact_full.float(), slot)
    out = (proxy_pre * cols(take_cols(mor["bn_scale"], slot))
           + cols(take_cols(mor["bn_bias"], slot)))
    if residual is not None:
        out = out + take_cols(residual.float(), slot)
    return out


def hybrid_predict(x: torch.Tensor, w_perm: torch.Tensor, mor: MoRLayer,
                   preact_full: Optional[torch.Tensor] = None,
                   residual: Optional[torch.Tensor] = None,
                   proxy_block: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Boolean mask (..., T, N): True where the neuron MUST be computed,
    False where both rookies agree the ReLU output is zero.  Every
    operand may carry a leading expert dim.  ``proxy_block``: the
    gathered proxy inputs of a column-split FFN (``proxy_relu_in``)."""
    note_predictor_eval()
    proxy_says_zero = (proxy_relu_in(x, w_perm, mor, preact_full, residual,
                                     proxy_block) < 0.0
                       ) | cols(mor["proxy_slot"] < 0)
    p_bin = binary_preact(x, w_perm)
    p_hat = estimate_preact(p_bin, mor, residual)
    binary_says_zero = p_hat < 0.0

    skip = proxy_says_zero & binary_says_zero & cols(mor["enable"]) \
        & ~cols(mor["is_proxy"])
    return ~skip


def prediction_breakdown(true_preact: torch.Tensor,
                         computed_mask: torch.Tensor
                         ) -> Dict[str, torch.Tensor]:
    """Paper Fig. 12 categories, as fractions of all outputs.

    true_preact: the real ReLU inputs (after BN / residual);
    computed_mask: the hybrid predictor's decision (True = evaluated at
    base precision)."""
    truly_zero = true_preact <= 0.0
    pred_zero = ~computed_mask
    n = true_preact.numel()

    def frac(m):
        return m.sum(dtype=torch.float32) / n

    return {"correct_zero": frac(pred_zero & truly_zero),
            "incorrect_zero": frac(pred_zero & ~truly_zero),
            "correct_nonzero": frac(computed_mask & ~truly_zero),
            "incorrect_nonzero": frac(computed_mask & truly_zero)}
