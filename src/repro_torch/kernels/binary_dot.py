"""The binary rookie's sign matmul: the CUDA kernel
(``csrc/binary_dot.cu`` on ``csrc/sign_mma.cuh``), its plain PyTorch
version, the tile and split-K plan, and the launch counter.

Replaces ``repro/kernels/binary_dot.py`` ``binary_dot`` (Pallas):
sign_act(x) @ sign(w) -> float32, x > 0 -> +1 else -1, w >= 0 -> +1
else -1.  The result is integers, so kernel and plain version are
bit-equal.  The kernel takes any M, K, N (an index past K adds
nothing).  Bound on the H100: bytes (x and w are read for one sign an
element); see the source.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import split_k
from repro_torch.kernels.build import check
from repro_torch.kernels.launch import cuda_stream, dtype_code, lib, ptr

launches = 0

# blocks of the kernel an SM holds at once (registers and shared memory
# allow two for every tile the plan picks)
RESIDENT = 2


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


def plan(M: int, K: int, N: int, *, sms: int) -> Tuple[int, int, int, int]:
    """-> (bm, bn, split, kb_per): the kernel's output tile and its
    split-K over a cluster.  A decode dispatch (M <= 16) takes 16 x 128
    tiles; other shapes 64 columns, and 128 rows where 64-row tiles
    would outnumber the SMs (x's re-reads are once per column tile, w's
    once per row tile, both from L2), else 64.
    ``split_k.split_over`` then splits K until the tiles fill that wave.
    Pure Python on host ints."""
    if M <= 16:
        bm, bn = 16, 128
    else:
        bn = 64
        bm = 128 if -(-M // 64) * -(-N // bn) > sms else 64
    tiles = -(-M // bm) * -(-N // bn)
    split, kb_per = split_k.split_over(tiles, K, sms=RESIDENT * sms)
    return bm, bn, split, kb_per


def _launch(x, w):
    global launches
    stream = cuda_stream(x.device)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    code = dtype_code(x, w)
    M, K = x.shape
    N = w.shape[1]
    bm, bn, split, kb_per = plan(M, K, N, sms=split_k.sm_count(x.device))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    err = lib().binary_dot(ptr(x, x.device), ptr(w, x.device),
                           ptr(out, x.device), M, K, N, bm, bn, split,
                           kb_per, code, stream)
    launches += 1
    check(err, "binary_dot")
    return out
