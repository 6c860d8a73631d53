"""The binary rookie's sign matmul: the CUDA kernel
(``csrc/binary_dot.cu``), its plain PyTorch version, and the launch
counter.

Replaces ``repro/kernels/binary_dot.py`` ``binary_dot`` (Pallas):
sign_act(x) @ sign(w) -> float32, x > 0 -> +1 else -1, w >= 0 -> +1
else -1.  The result is integers, so kernel and plain version are
bit-equal.  Bound on the H100: bytes (the weight is read for its signs);
see the source.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import check
from repro_torch.kernels.launch import cuda_stream, dtype_code, lib, ptr

launches = 0


def binary_dot_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version (the port of ``ref.binary_dot_ref``): a float32
    product of +-1 signs, exact while K < 2^24."""
    xs = torch.where(x > 0, 1.0, -1.0).float()
    ws = torch.where(w >= 0, 1.0, -1.0).float()
    return xs @ ws


def binary_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K), w (K, N) float32 or bfloat16 -> (M, N) float32: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor, an
    error for anything else."""
    if x.device.type == "cpu":
        return binary_dot_plain(x, w)
    return _launch(x, w)


def _launch(x, w):
    global launches
    stream = cuda_stream(x.device)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    code = dtype_code(x, w)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = lib().binary_dot(ptr(x, x.device), ptr(w, x.device),
                           ptr(out, x.device), M, K, N, code, stream)
    launches += 1
    check(err, "binary_dot")
    return out
