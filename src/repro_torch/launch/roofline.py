"""Roofline terms of a step on the NVIDIA H100 SXM (the port's
``repro.launch.roofline``), and a kernel's bound.

Three terms a step, in seconds a step a card:
  compute    = FLOPs / PEAK_FLOPS (the dense bf16 tensor-core rate)
  memory     = bytes / HBM_BW
  collective = wire bytes inside a node / NVLINK_BW
               + wire bytes that cross nodes / IB_BW

The FLOPs and bytes come from ``launch.op_cost`` (the aten ops a step
runs, loops counted per trip), the wire bytes from the collectives the
step ran (``distributed.collectives.nbytes``) times the reference's
ring factors (``collective_wire_bytes``); a collective whose group's
ranks lie on more than one 8-card node is charged whole at the
InfiniBand rate (``collectives.ib_nbytes``: the reference charges a
collective whose replica group spans pods at its DCI rate the same
way), the others at NVLink's.  Those bytes are the eager op
stream's (every op's operands and results, unfused), so the memory term
and ``bound_time_s`` read the program as it runs: fusing ops lowers
them with its time.  ``summarize(..., floor_bytes=)`` adds a floor that
no implementation of the step can beat: ``floor_bytes`` (the arguments
read once and the results written once) at HBM_BW against the model
FLOPs at PEAK_FLOPS, ``floor_time_s`` the larger; a measured step time
is held against that.  Rates are the H100 SXM data
sheet's (NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense:
without sparsity); a card whose power limit is below 700 W runs slower
under load, so a measured time is read beside ``nvidia-smi``'s limit.
"""
from __future__ import annotations

from typing import Dict, Tuple

# H100 SXM5 data sheet: dense tensor-core rates (bf16 989 TFLOP/s, int8
# 1,979 TOPS) and float32 on the CUDA cores (67 TFLOP/s)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
PEAK_FLOPS = PEAK_OPS["bf16"]      # a bf16 model's products
HBM_BW = 3.35e12                   # bytes/s: HBM3, H100 SXM5 data sheet
NVLINK_BW = 450e9                  # bytes/s a direction: NVLink 4, 900
                                   # GB/s bidirectional (data sheet)
# bytes/s a card between nodes: one NDR InfiniBand port of 400 Gb/s a
# card (NVIDIA DGX H100 data sheet: 8 single-port ConnectX-7 VPI
# adapters, up to 400 Gb/s InfiniBand each, for the compute fabric)
IB_BW = 400e9 / 8

# ring-wire factors (the reference's ``_FACTORS``): an all-reduce moves
# its buffer about twice, the others about once
_FACTORS = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
            "all-to-all": 1.0, "collective-permute": 1.0}


def bound_ms(nbytes: float, ops: float, kind: str) -> Tuple[float, str]:
    """-> (ms, "bytes" or "operations"): the least time the card could
    take for work that moves ``nbytes`` and does ``ops`` operations of
    ``kind`` ("bf16", "int8", "fp32"): the larger of the two times."""
    t_bytes = nbytes / HBM_BW
    t_ops = ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def collective_wire_bytes(nbytes_by_kind: Dict[str, float],
                          ib_by_kind: Dict[str, float] = None) -> Dict:
    """Buffer bytes by collective kind (and the part of them whose group
    spans nodes, ``ib_by_kind``) -> {kind: wire bytes,
    "total_wire_bytes", and given ``ib_by_kind`` "ib_wire_bytes"}, with the reference's ring
    factors; ``ib_wire_bytes`` is the port's counterpart of the
    reference's ``dci_bytes``."""
    out = {k: _FACTORS[k] * float(v) for k, v in nbytes_by_kind.items()}
    out["total_wire_bytes"] = sum(out.values())
    if ib_by_kind is not None:
        out["ib_wire_bytes"] = sum(_FACTORS[k] * float(v)
                                   for k, v in ib_by_kind.items())
    return out


def roofline_terms(cost: Dict, collectives: Dict) -> Dict:
    """``cost`` {"flops", "bytes accessed"} and ``collective_wire_bytes``'
    result -> the three terms, the dominant one and the bound (loops are
    counted per trip already: no trip multiplier)."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    wire = float(collectives.get("total_wire_bytes", 0.0))
    ib = float(collectives.get("ib_wire_bytes", 0.0))
    t_compute = flops / PEAK_FLOPS
    t_memory = hbm / HBM_BW
    t_nvlink = (wire - ib) / NVLINK_BW
    t_ib = ib / IB_BW
    t_coll = t_nvlink + t_ib
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return {
        "flops_per_chip": flops,
        "bytes_per_chip": hbm,
        "wire_bytes_per_chip": wire,
        "ib_wire_bytes_per_chip": ib,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "t_collective_nvlink_s": t_nvlink,
        "t_collective_ib_s": t_ib,
        "dominant": dominant,
        "bound_time_s": max(t_compute, t_memory, t_coll),
    }


def model_flops(cfg, shape, n_chips: int) -> Dict:
    """Analytic MODEL_FLOPS: 6 N D for training, 2 N D for inference
    (a decode step: one token a sequence), N the active params, per
    card."""
    from repro_torch.configs.base import param_count
    total, active = param_count(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mf = 6.0 * active * tokens
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mf = 2.0 * active * tokens
    else:
        tokens = shape.global_batch
        mf = 2.0 * active * tokens
    return {"params_total": total, "params_active": active,
            "model_flops_per_chip": mf / n_chips}


def floor_terms(floor_bytes: float, model_flops_per_chip: float) -> Dict:
    """The step's floor, whatever implements it: ``floor_bytes`` (each
    argument read once, each result written once) at HBM_BW and the
    model FLOPs at PEAK_FLOPS; ``floor_time_s`` the larger."""
    t_mem = float(floor_bytes) / HBM_BW
    t_comp = float(model_flops_per_chip) / PEAK_FLOPS
    return {"floor_bytes": float(floor_bytes), "t_floor_memory_s": t_mem,
            "t_floor_compute_s": t_comp,
            "floor_dominant": "compute" if t_comp > t_mem else "memory",
            "floor_time_s": max(t_mem, t_comp)}


def summarize(cost: Dict, cfg, shape, n_chips: int = 1,
              floor_bytes: float = None) -> Dict:
    """``cost``: ``op_cost.analyze``'s result for one step on one card
    -> the roofline terms over the eager op stream's bytes
    (``bytes_counted``), the model FLOPs, the share of counted FLOPs
    the model needs (``useful_flop_ratio``), the model FLOPs' time at
    peak over the bound (``roofline_fraction``) and, given
    ``floor_bytes``, the step's floor (``floor_terms``)."""
    colls = collective_wire_bytes(cost.get("coll_bytes_by_type", {}),
                                  cost.get("coll_ib_bytes_by_type", {}))
    terms = roofline_terms({"flops": cost["flops"],
                            "bytes accessed": cost["bytes"]}, colls)
    mf = model_flops(cfg, shape, n_chips)
    useful = (mf["model_flops_per_chip"] / terms["flops_per_chip"]
              if terms["flops_per_chip"] else 0.0)
    frac = (mf["model_flops_per_chip"] / PEAK_FLOPS / terms["bound_time_s"]
            if terms["bound_time_s"] else 0.0)
    out = {**terms, **mf, "bytes_counted": "eager op stream",
           "collective_breakdown": colls, "useful_flop_ratio": useful,
           "roofline_fraction": frac}
    if floor_bytes is not None:
        out.update(floor_terms(floor_bytes, mf["model_flops_per_chip"]))
    return out
