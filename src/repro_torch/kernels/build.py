"""Build and load the CUDA kernels of ``csrc/``.

Each ``.cu`` file compiles with its own ``nvcc`` process (all started
together) for ``sm_90a``, and the objects link into one shared library
with a plain C interface, loaded through ``ctypes``.  The library goes
to ``build/repro_torch_kernels/`` at the root of the checkout, named by
a hash of the sources and flags, on first use.  Nothing here runs at
import time: the CPU tests import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("mor_predict.cu", "gather_matmul.cu", "masked_matmul.cu",
           "paged_attention.cu", "mla_attention.cu", "binary_dot.cu",
           "binary_dot_packed.cu")
HEADERS = ("common.cuh", "mma_tile.cuh", "sign_mma.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes (pointers and the stream as void*, sizes as int)
SIGNATURES = {
    "mor_tile_mask": [_P] * 6 + [_I] * 8 + [_P],
    "gather_matmul": [_P] * 7 + [_I] * 8 + [_P],
    "masked_matmul_kdim": [_P] * 4 + [_I] * 7 + [_P],
    "gqa_paged_flash": [_P] * 7 + [_I] * 12 + [_F, _I, _P],
    "mla_paged_flash": [_P] * 8 + [_I] * 10 + [_F, _I, _P],
    "masked_matmul": [_P] * 4 + [_I] * 6 + [_P],
    "binary_dot": [_P] * 3 + [_I] * 8 + [_P],
    "binary_dot_packed": [_P] * 3 + [_I] * 8 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None
LAST_BUILD: Dict = {}


def build_dir() -> Path:
    """``build/repro_torch_kernels`` under the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (in parallel) and link the library; returns
    its path.  ``LAST_BUILD`` keeps the wall seconds and the compiler's
    ``-Xptxas -v`` lines (registers, shared memory, spills)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    lib = out_dir / f"libmor_kernels_{tag}.so"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = out_dir / f"{Path(name).stem}_{tag}.o"
        cmd = [nvcc, *CFLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for name, obj, p in procs:
        out, _ = p.communicate()
        log.append(out)
        if p.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(log))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                           *(str(o) for _, o, _ in procs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, lib)
    LAST_BUILD.update(seconds=time.perf_counter() - t0, path=str(lib),
                      log="".join(log) + link.stdout)
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = build_dir() / f"libmor_kernels_{_digest()}.so"
        if not lib.exists():
            lib = build()
        dll = ctypes.CDLL(str(lib))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = dll
    return _LIB


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
