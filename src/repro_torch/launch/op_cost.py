"""Op-level cost of a step: FLOPs, bytes and peak live bytes, from the
aten ops it runs (the port's counterpart of ``repro.launch.hlo_cost``,
which reads them off compiled HLO).

``OpCounter`` is a ``TorchDispatchMode``: every aten op a step runs
passes through it once per execution, so a Python loop's body is
counted once per trip by construction (the reference needs
``_trip_count`` for its while loops), and the recomputation that
``torch.utils.checkpoint`` runs in the backward is counted where it
runs, as the recomputed dots are in the reference's HLO.  It works on
meta, CPU and CUDA tensors alike.

- **FLOPs**: matrix products and convolutions only, as the reference
  counts dots and convolutions: 2 x result elements x contracted size
  for ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``dot``, ``mv`` and
  ``addmv`` (what ``matmul`` and ``einsum`` decompose to), and for
  ``convolution`` and each input of ``convolution_backward``; the
  two products of scaled-dot-product attention wherever it is reached
  (twice that in its backward).  Elementwise ops count 0.
- **Bytes**: operand plus result bytes of every op that moves data.
  Views and metadata ops move nothing (every op whose schema makes it
  a view: ``view``, ``expand``, ``permute``, ``t``, ``slice``,
  ``select``, ``as_strided``, ``detach``, ``alias``, ... and
  ``_unsafe_view``), nor do allocations (``empty``); a copy or fill
  writes its destination without reading it.  Copies, casts and in-place
  ops count.
- **Peak live bytes**: the bytes of every storage an op allocates
  (a result the schema does not alias to an input), held until Python
  frees it, and their peak: the counterpart of XLA's
  ``temp_size_in_bytes``.  Tensors that exist before the step (params,
  optimizer state, inputs, cache) are not in it.
- **Kernels**: a CUDA kernel called through ctypes is opaque to a
  dispatch mode.  Each kernel entry (``kernels.launch.counted``)
  charges its ``work()`` (bytes, operations, kind) here as one call, and
  the aten ops inside it are not counted again; the storages allocated
  inside still count as live (on the card its result and any padded
  operand; on the CPU the plain version's temporaries too).
- **Collectives**: the bytes ``distributed.collectives`` records by kind
  while the step runs (``coll_bytes_by_type``), and the part of them
  whose group spans nodes (``coll_ib_bytes_by_type``: InfiniBand).
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels import launch as kernel_launch

aten = torch.ops.aten

# ops that move no data: metadata, allocation, a scalar read
_NO_BYTES = {aten._unsafe_view, aten.empty, aten.empty_strided,
             aten.empty_like, aten.new_empty, aten.new_empty_strided,
             aten.lift_fresh, aten._local_scalar_dense}
# results that share their input's storage though the schema does not
# say so
_NO_ALLOC = {aten._unsafe_view, aten.lift_fresh}
# in-place ops that write their first operand without reading it
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
               aten.uniform_}


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def _mm_flops(a, b, out) -> int:
    """2 x result elements x contracted size (a's last dim)."""
    return 2 * out.numel() * a.shape[-1]


def _conv_flops(x, w, out, transposed: bool) -> int:
    """2 x result elements x (input channels / groups x kernel size);
    for a transposed conv the roles of input and result swap."""
    per = _prod(w.shape[1:])                  # C_in / groups x kernel
    if transposed:
        return 2 * x.numel() * per
    return 2 * out.numel() * per


def _sdpa_flops(q, k, v) -> int:
    """q k^T and p v over the (B, H, Sq, Sk) scores."""
    B_H = _prod(q.shape[:-2])
    Sq, D = q.shape[-2:]
    Sk, Dv = k.shape[-2], v.shape[-1]
    return 2 * B_H * Sq * Sk * (D + Dv)


_SDPA_FWD = ("_scaled_dot_product_flash_attention",
             "_scaled_dot_product_flash_attention_for_cpu",
             "_scaled_dot_product_efficient_attention",
             "_scaled_dot_product_cudnn_attention")


def flops_of(func, args, kwargs, out) -> int:
    """The products' FLOPs of one aten op (0 for every other op)."""
    p = func.overloadpacket
    if p in (aten.mm, aten.bmm, aten.dot, aten.mv):
        return _mm_flops(args[0], args[1], out)
    if p in (aten.addmm, aten.baddbmm, aten.addmv):
        return _mm_flops(args[1], args[2], out)
    if p in (aten.convolution, aten._convolution):
        return _conv_flops(args[0], args[1], out, bool(args[6]))
    if p is aten.convolution_backward:
        grad, x, w = args[0], args[1], args[2]
        mask = args[-1]
        one = _conv_flops(x, w, grad, bool(args[7]))
        return one * (int(bool(mask[0])) + int(bool(mask[1])))
    name = p.__name__
    if name in _SDPA_FWD:
        return _sdpa_flops(args[0], args[1], args[2])
    if name.startswith("_scaled_dot_product") and name.endswith("backward"):
        return 2 * _sdpa_flops(args[1], args[2], args[3])
    return 0


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it (see the module's docstring).

    After the ``with`` block: ``flops``, ``bytes``, ``peak_live_bytes``,
    ``by_op`` {op: {"calls", "flops", "bytes"}}, ``kernels`` {name:
    {"calls", "bytes", "ops", "kind"}}, ``coll_bytes_by_type`` {kind:
    bytes}, ``coll_ib_bytes_by_type`` (those that crossed a node).
    ``result()`` gathers them."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"calls": 0, "flops": 0, "bytes": 0})
        self.kernels: Dict[str, Dict[str, Any]] = {}
        self.live = 0
        self.peak_live_bytes = 0
        self.coll_bytes_by_type: Dict[str, int] = {}
        self.coll_ib_bytes_by_type: Dict[str, int] = {}
        self._tracked: Dict[int, Any] = {}
        self._hidden = 0
        self._coll0: Dict[str, int] = {}
        self._ib0: Dict[str, int] = {}

    # -- the storages an op allocates ---------------------------------
    def _release(self, key: int, nbytes: int) -> None:
        if self._tracked.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = weakref.ref(
            st, lambda _, key=key, n=n: self._release(key, n))
        self.live += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live)

    def _track_results(self, func, out) -> None:
        if func.overloadpacket in _NO_ALLOC:
            return
        rets = func._schema.returns
        outs = out if len(rets) > 1 else (out,)
        for ret, o in zip(rets, outs):
            if ret.alias_info is None:
                for t in _tensors(o):
                    self._track(t)

    # -- the dispatch mode --------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track_results(func, out)
        if self._hidden:
            return out
        fl = flops_of(func, args, kwargs, out)
        if func.is_view or func.overloadpacket in _NO_BYTES:
            nb = 0
        else:
            ins = _tensors((args, kwargs))
            if func.overloadpacket in _WRITE_ONLY:
                ins = ins[1:]
            nb = sum(_nbytes(t) for t in ins) + sum(
                _nbytes(t) for t in _tensors(out))
        rec = self.by_op[func.overloadpacket.__name__]
        rec["calls"] += 1
        rec["flops"] += fl
        rec["bytes"] += nb
        self.flops += fl
        self.bytes += nb
        return out

    # -- kernels (``kernels.launch.counted``) --------------------------
    def kernel(self, name: str, work: Callable, fn: Callable, args, kw):
        """Run kernel entry ``fn`` with its aten ops hidden, and charge
        ``work(*args, **kw)`` as one call of ``name``."""
        with self.hidden():
            nbytes, ops, kind = work(*args, **kw)
            out = fn(*args, **kw)
        rec = self.kernels.setdefault(
            name, {"calls": 0, "bytes": 0, "ops": 0, "kind": kind})
        rec["calls"] += 1
        rec["bytes"] += int(nbytes)
        rec["ops"] += int(ops)
        self.flops += int(ops)
        self.bytes += int(nbytes)
        return out

    @contextlib.contextmanager
    def hidden(self):
        """Ops run inside are executed and their storages tracked, but
        their FLOPs and bytes are not counted."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    def __enter__(self):
        from repro_torch.distributed import collectives
        self._coll0 = dict(collectives.nbytes)
        self._ib0 = dict(collectives.ib_nbytes)
        kernel_launch.cost_counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.distributed import collectives
        kernel_launch.cost_counters.remove(self)
        self.coll_bytes_by_type = _since(collectives.nbytes, self._coll0)
        self.coll_ib_bytes_by_type = _since(collectives.ib_nbytes,
                                            self._ib0)
        return super().__exit__(*exc)

    def result(self, top: int = 20) -> Dict[str, Any]:
        ranked = sorted(self.by_op.items(),
                        key=lambda kv: (-kv[1]["bytes"], -kv[1]["flops"]))
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll_bytes_by_type": dict(self.coll_bytes_by_type),
                "coll_bytes": float(sum(self.coll_bytes_by_type.values())),
                "coll_ib_bytes_by_type": dict(self.coll_ib_bytes_by_type),
                "peak_live_bytes": int(self.peak_live_bytes),
                "by_op": {k: dict(v) for k, v in ranked[:top]},
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


def _since(now: Dict[str, int], then: Dict[str, int]) -> Dict[str, int]:
    return {k: v - then.get(k, 0) for k, v in now.items()
            if v != then.get(k, 0)}


def analyze(fn: Callable, *args, top: int = 20, **kwargs) -> Dict[str, Any]:
    """-> {flops, bytes, coll_bytes_by_type, coll_bytes, peak_live_bytes,
    by_op (the ``top`` ops by bytes), kernels} of ``fn(*args,
    **kwargs)``, run once under an ``OpCounter``."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.result(top)
