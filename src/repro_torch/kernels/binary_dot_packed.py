"""The binary rookie's sign matmul from bit-packed weight signs: the
CUDA kernel (``csrc/binary_dot_packed.cu`` on ``csrc/sign_mma.cuh``),
its plain PyTorch version, the plain ``pack_signs`` / ``unpack_signs``,
and the launch counter.

Replaces ``repro/kernels/binary_dot_packed.py`` ``binary_dot_packed``
(Pallas).  Layout, as the JAX package packs it: bit b of
``packed[k8, n]`` is the sign bit (1 = negative) of ``w[8 * k8 + b, n]``.
The result equals ``binary_dot``'s on the same operands, bit for bit.
Bound on the H100: bytes (x, and K * N / 8 of weight); see the source.
The tile and split are ``binary_dot.plan(..., packed=True)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import binary_dot, split_k
from repro_torch.kernels.build import check
from repro_torch.kernels.launch import (counted, cuda_stream, dense16, lib,
                                        ptr)

launches = 0

_SHIFTS = tuple(range(8))
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pack_signs(w: torch.Tensor) -> torch.Tensor:
    """(K, N) float -> (ceil(K / 8), N) uint8 sign bitmap (1 = negative;
    padded rows are positive)."""
    K, N = w.shape
    bits = F.pad((w < 0).to(torch.uint8), (0, 0, 0, (-K) % 8))
    bits = bits.reshape(-1, 8, N)
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8,
                          device=w.device)[None, :, None]
    return (bits << shifts).sum(1, dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor, K: int) -> torch.Tensor:
    """Inverse of ``pack_signs`` -> (K, N) int8 in {+1, -1}."""
    k8, N = packed.shape
    shifts = torch.tensor(_SHIFTS, dtype=torch.uint8,
                          device=packed.device)[None, :, None]
    bits = (packed[:, None, :] >> shifts) & 1
    return (1 - 2 * bits.to(torch.int8)).reshape(k8 * 8, N)[:K]


def binary_dot_packed_plain(x: torch.Tensor, w_packed: torch.Tensor
                            ) -> torch.Tensor:
    """Plain version: sign_act(x) @ unpack_signs(w_packed) in float32."""
    ws = unpack_signs(w_packed, x.shape[1]).float()
    return torch.where(x > 0, 1.0, -1.0).float() @ ws


def work(x: torch.Tensor, w_packed: torch.Tensor):
    """-> (bytes, operations, kind) of one call: x, the packed signs
    (K N / 8 bytes) and the float32 output once; a sign product of K an
    output, on the int8 tensor cores."""
    M, K = x.shape
    N = w_packed.shape[1]
    return (M * K * x.element_size() + w_packed.numel() + M * N * 4,
            2 * M * K * N, "int8")


@counted("binary_dot_packed", work)
def binary_dot_packed(x: torch.Tensor, w_packed: torch.Tensor
                      ) -> torch.Tensor:
    """x (M, K) float32 or bfloat16, w_packed (K/8, N) uint8 -> (M, N)
    float32.  K must be a multiple of 8, as in the JAX package (no
    padding wrapper).  The CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor, an error for anything else."""
    M, K = x.shape
    k8, N = w_packed.shape
    if k8 * 8 != K:
        raise ValueError(f"K = {K} must be 8 x the packed rows ({k8})")
    if x.device.type == "cpu":
        return binary_dot_packed_plain(x, w_packed)
    return _launch(x, w_packed)


def _launch(x, w_packed):
    global launches
    stream = cuda_stream(x.device)
    if x.dtype not in _CODES or w_packed.dtype != torch.uint8:
        raise TypeError(f"binary_dot_packed takes float32 or bfloat16 x and "
                        f"uint8 signs, got {x.dtype} and {w_packed.dtype}")
    M, K = x.shape
    N = w_packed.shape[1]
    x = dense16(x)                       # the kernel loads 16-byte chunks
    bm, bn, split, kb_per = binary_dot.plan(
        M, K, N, sms=split_k.sm_count(x.device), packed=True)
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = lib().binary_dot_packed(ptr(x, x.device), ptr(w_packed, x.device),
                                  ptr(out, x.device), M, K, N, bm, bn, split,
                                  kb_per, _CODES[x.dtype], stream)
    launches += 1
    check(err, "binary_dot_packed")
    return out
