"""What every CUDA launch wrapper checks before it hands pointers to
the C interface: device, dtype and contiguity, and the current stream."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

_CODES = {torch.float32: 0, torch.bfloat16: 1}


def lib():
    return build.load()


def dtype_code(x: torch.Tensor, w: torch.Tensor) -> int:
    """The C interface's dtype code; x and w must share it."""
    if x.dtype != w.dtype or x.dtype not in _CODES:
        raise TypeError(f"kernels take float32 or bfloat16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    return _CODES[x.dtype]


def ptr(t: Optional[torch.Tensor], device: torch.device) -> Optional[int]:
    """Device pointer of a contiguous tensor on ``device`` (None -> null)."""
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, kernel runs on {device}")
    if not t.is_contiguous():
        raise ValueError("kernels take contiguous tensors")
    return t.data_ptr()


def dense16(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, for kernels that copy
    16-byte chunks (a copy only where it is neither)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check16(*ts: torch.Tensor) -> None:
    """Raise unless every tensor starts on a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("kernels that copy 16-byte chunks take 16-byte "
                         "aligned tensors")


def require_cuda(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA device."""
    if device.type != "cuda":
        raise ValueError(f"no CUDA kernel for tensors on {device}")


def cuda_stream(device: torch.device) -> int:
    """Handle of PyTorch's current stream on ``device``."""
    require_cuda(device)
    return torch.cuda.current_stream(device).cuda_stream


def mask_bytes(m: torch.Tensor) -> torch.Tensor:
    """A tile mask as one contiguous byte a tile, non-zero where live
    (a bool or uint8 mask as it is)."""
    if m.dtype in (torch.bool, torch.uint8) and m.is_contiguous():
        return m
    return (m != 0).contiguous()
