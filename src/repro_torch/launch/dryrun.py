"""Dry run of one (arch x shape) cell on one H100 without the card: run
the step on the meta device under ``launch.op_cost``, prove that it fits
in memory, and take its roofline terms (``repro.launch.dryrun``).

The reference lowers and compiles each cell against a 512-chip
placeholder mesh and reads XLA's memory and cost analyses.  Here the
params, optimizer state, inputs and cache are meta tensors
(``models.param_shapes`` / ``cache_shapes``, ``configs.input_specs``):
the step (``launch.steps``' ``make_train_step``, ``make_prefill`` or
``make_serve_step``) runs for real on shapes alone, every aten op
counted once per execution, and no memory is allocated.  Memory splits
into ``argument_bytes`` (exact: the meta trees) and ``peak_temp_bytes``
(the peak of the storages the step allocates, ``op_cost``), against one
80 GB card.  The roofline holds two memory terms: ``t_memory_s`` reads
the eager op stream's bytes (every aten op's operands and results,
unfused: it falls when ops are fused), and ``floor_time_s`` the
implementation's floor (the arguments read once, the results written
once, the model FLOPs at peak: ``roofline.summarize``).
``measure_cell(device="cuda")`` then runs the same cell on the card
with random weights and adds the measured peak (``max_memory_allocated``
over what was allocated before), the CUDA-event time and the FLOPs
counted there.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape decode_32k [--mor-mode dense|tiled] [--remat ...]
      [--grad-accum N] [--flash-threshold N] [--out file.json]
The reference's mesh flags (``--mesh pod|multipod``, ``--no-seq-parallel``,
``--param-layout``, ``--moe-sharding tp|ep_shmap``) need a device mesh
and raise: ROADMAP queue A 7.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch import op_cost, roofline
from repro_torch.launch.steps import (make_prefill, make_serve_step,
                                      make_train_step)
from repro_torch.models import (cache_shapes, get_model, param_shapes,
                                supports_long_context)
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.tree import leaves

MESH = "1xh100"                    # the one layout this port runs
SEED = 0                           # the card's random weights and inputs
CARD_BYTES = 80 * 2 ** 30          # one H100 80GB
MESH_QUEUE = ("needs a device mesh: ROADMAP queue A 7 of the port (the "
              "dry run models one H100)")


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> str:
    """'run' or a skip reason."""
    if shape.kind == "decode" and cfg.family == "audio":
        return "skip: encoder-only arch has no decode step"
    if shape.name == "long_500k" and not supports_long_context(cfg):
        return ("skip: full-attention arch is quadratic/unbounded-KV at "
                "500k (sub-quadratic archs only)")
    return "run"


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _random_inputs(specs: Dict[str, torch.Tensor], cfg: ModelConfig,
                   gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Real tensors of ``input_specs``' shapes: token ids and labels
    below the vocabulary, frame and patch embeddings from a normal."""
    out = {}
    for k, s in specs.items():
        if s.dtype.is_floating_point:
            out[k] = torch.randn(s.shape, generator=gen, device=device
                                 ).to(s.dtype)
        else:
            out[k] = torch.randint(0, cfg.vocab_size, s.shape,
                                   generator=gen, device=device,
                                   dtype=s.dtype)
    return out


def _cell(cfg: ModelConfig, shape: ShapeSpec, mor_mode: str,
          opt_cfg: OptConfig, device, gen=None):
    """-> (step thunk, argument trees) of the cell on ``device``: meta
    trees, or real ones on the card (random weights from ``gen``)."""
    api = get_model(cfg)
    meta = torch.device(device).type == "meta"
    params = param_shapes(cfg) if meta else api.init(gen, cfg)
    specs = input_specs(cfg, shape, device="meta")
    data = specs if meta else _random_inputs(specs, cfg, gen, device)
    if shape.kind == "train":
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        return (lambda: step(params, opt, data)), {
            "params": params, "opt": opt, "inputs": data}
    if shape.kind == "prefill":
        fn = make_prefill(cfg, mor_mode=mor_mode)

        def prefill():
            with torch.no_grad():
                return fn(params, data)
        return prefill, {"params": params, "inputs": data}
    cache = (cache_shapes(cfg, shape.global_batch, shape.seq_len) if meta
             else api.cache_init(cfg, shape.global_batch, shape.seq_len,
                                 cfg.tdtype, device))
    step = make_serve_step(cfg, mor_mode=mor_mode)

    def serve():
        with torch.no_grad():
            return step(params, cache, data["tokens"])
    return serve, {"params": params, "cache": cache, "inputs": data}


class Counted(NamedTuple):
    """``count_cell``'s result: the ``OpCounter`` of one step, argument
    bytes by tree, the bytes of the step's results (``result_bytes``),
    the step thunk, and on the card the allocator's view (``card``:
    ``argument_bytes`` allocated for the trees, ``peak_bytes`` over
    what was allocated before them), else None."""
    counter: op_cost.OpCounter
    args: Dict[str, int]
    results: int
    step: Any
    card: Optional[Dict[str, int]]


def result_bytes(out, cache=None) -> int:
    """Bytes the step must write, each storage once: its returned
    tensors (a train step's params and optimizer state, rewritten in
    place, and its metrics; a forward's tokens), less a decode's
    ``cache``, of which a step writes one position a row."""
    skip = {id(t.untyped_storage()) for t in leaves(cache)} if cache else ()
    seen, n = set(), 0
    for t in tree_flatten(out)[0]:
        if not isinstance(t, torch.Tensor):
            continue
        key = id(t.untyped_storage())
        if key not in skip and key not in seen:
            seen.add(key)
            n += t.untyped_storage().nbytes()
    return n


def count_cell(cfg: ModelConfig, shape: ShapeSpec, *,
               mor_mode: str = "dense", opt_cfg: Optional[OptConfig] = None,
               device="meta") -> Counted:
    """Build the cell's arguments on ``device`` (meta trees, or random
    weights from ``SEED`` elsewhere) and run its step once under an
    ``OpCounter``."""
    opt_cfg = opt_cfg or OptConfig()
    on_card = torch.device(device).type == "cuda"
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(SEED))
    if on_card:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    step, trees = _cell(cfg, shape, mor_mode, opt_cfg, device, gen)
    args = {k: tree_bytes(v) for k, v in trees.items()}
    card = None
    if on_card:
        # the card's peak from here on: the arguments and what the step
        # allocates (the init's float32 draws are not the cell's)
        torch.cuda.synchronize(device)
        card = {"argument_bytes": torch.cuda.memory_allocated(device) - base}
        torch.cuda.reset_peak_memory_stats(device)
    with op_cost.OpCounter() as counter:
        out = step()
    if on_card:
        torch.cuda.synchronize(device)
        card["peak_bytes"] = torch.cuda.max_memory_allocated(device) - base
    return Counted(counter, args, result_bytes(out, trees.get("cache")),
                   step, card)


def measure_cell(cfg: ModelConfig, shape: ShapeSpec, *,
                 mor_mode: str = "dense", opt_cfg: Optional[OptConfig] = None,
                 device="meta", flush=None,
                 time_iters: int = 10) -> Dict[str, Any]:
    """The cell's record: memory (``argument_bytes`` by tree,
    ``peak_temp_bytes``, ``per_device_bytes``, ``fits_80gb``), the
    op-level cost and its roofline summary with the implementation's
    floor (``result_bytes``), all from a run on the meta device; with
    ``device="cuda"`` also the same cell on the card (``card``: the
    arguments' and the peak bytes allocated over what was allocated
    before, the step's own peak, FLOPs and bytes counted there, mean ms
    of a step over ``time_iters`` calls timed by ``timing.device_ms``
    with the L2 ``flush`` buffer)."""
    t0 = time.perf_counter()
    counted = count_cell(cfg, shape, mor_mode=mor_mode, opt_cfg=opt_cfg)
    cost = counted.counter.result()
    arg_bytes = sum(counted.args.values())
    per_dev = arg_bytes + cost["peak_live_bytes"]
    rec = {"argument_bytes": arg_bytes,
           "argument_bytes_by_tree": counted.args,
           "result_bytes": counted.results,
           "peak_temp_bytes": cost["peak_live_bytes"],
           "per_device_bytes": per_dev,
           "per_device_gib": round(per_dev / 2 ** 30, 3),
           "fits_80gb": per_dev < CARD_BYTES,
           "cost": cost,
           "roofline": roofline.summarize(
               cost, cfg, shape, 1,
               floor_bytes=arg_bytes + counted.results),
           "meta_s": round(time.perf_counter() - t0, 3)}
    if torch.device(device).type == "cuda":
        rec["card"] = _on_card(cfg, shape, mor_mode, opt_cfg, device,
                               flush, time_iters)
    return rec


def _on_card(cfg, shape, mor_mode, opt_cfg, device, flush,
             time_iters) -> Dict[str, Any]:
    """The cell on the card: one step counted, then ``time_iters``
    timed."""
    from repro_torch.launch import timing
    counted = count_cell(cfg, shape, mor_mode=mor_mode, opt_cfg=opt_cfg,
                         device=device)
    card, counter, step = counted.card, counted.counter, counted.step
    if flush is None:
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    ms = timing.device_ms(step, flush, iters=time_iters)
    del step, counted
    torch.cuda.empty_cache()
    return {**card,
            "step_peak_bytes": card["peak_bytes"] - card["argument_bytes"],
            "flops": float(counter.flops), "bytes": float(counter.bytes),
            "ms": ms, "time_iters": time_iters}


def _check_mesh(mesh_kind, seq_parallel, layout, moe_sharding) -> None:
    if mesh_kind != MESH or not seq_parallel or layout is not None \
            or moe_sharding not in (None, "ep"):
        raise NotImplementedError(
            f"mesh {mesh_kind!r}, seq_parallel {seq_parallel}, "
            f"param_layout {layout!r}, moe_sharding {moe_sharding!r}: "
            f"{MESH_QUEUE}")


def run_cell(arch: str, shape_name: str, mesh_kind: str = MESH, *,
             seq_parallel: bool = True, mor_mode: str = "dense",
             remat: str = None, grad_accum: int = None,
             moe_sharding: str = None, out_path: str = None,
             layout: str = None, flash_threshold: int = None) -> dict:
    """The reference's ``run_cell`` on one H100, on the meta device: the
    cell's record (``status`` "ok", a skip reason or "error: ..."),
    written to ``out_path`` when given.  ``flash_threshold`` overrides
    the config's (the attention layers read it from the config, as the
    train and serve paths do).  A mesh argument raises (queue A 7); "ep"
    expert sharding is what one card holds (every expert local)."""
    _check_mesh(mesh_kind, seq_parallel, layout, moe_sharding)
    cfg = get_config(arch)
    if remat:
        cfg = cfg.replace(remat=remat)
    if grad_accum:
        cfg = cfg.replace(grad_accum=grad_accum)
    if flash_threshold is not None:
        cfg = cfg.replace(flash_threshold=flash_threshold)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mor_mode": mor_mode, "remat": cfg.remat,
           "grad_accum": cfg.grad_accum, "moe_sharding": moe_sharding,
           "flash_threshold": cfg.flash_threshold, "device": "meta"}
    status = cell_status(cfg, shape)
    if status != "run":
        rec["status"] = status
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {status}")
        _write(rec, out_path)
        return rec
    try:
        rec.update(measure_cell(cfg, shape, mor_mode=mor_mode))
        rec["status"] = "ok"
        rl = rec["roofline"]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
              f"({rec['meta_s']:.1f}s on meta, {rec['per_device_gib']} "
              f"GiB/dev, fits_80gb={rec['fits_80gb']}, "
              f"dominant={rl['dominant']}, "
              f"roofline_frac={rl['roofline_fraction']:.3f}, floor "
              f"{rl['floor_dominant']} {rl['floor_time_s'] * 1e3:.3f} ms)")
    except Exception as e:  # noqa: BLE001 -- record the failure, go on
        rec["status"] = f"error: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: FAILED {e}",
              file=sys.stderr)
    _write(rec, out_path)
    return rec


def _write(rec: dict, out_path: Optional[str]) -> None:
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default=MESH,
                    choices=(MESH, "pod", "multipod"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--no-seq-parallel", action="store_true")
    ap.add_argument("--mor-mode", default="dense", choices=("dense", "tiled"))
    ap.add_argument("--remat", default=None,
                    choices=(None, "none", "dots_saveable",
                             "nothing_saveable"))
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--moe-sharding", default=None,
                    choices=(None, "ep", "tp", "ep_shmap"))
    ap.add_argument("--flash-threshold", type=int, default=None)
    ap.add_argument("--param-layout", default=None,
                    choices=(None, "fsdp_tp", "contract_tp"))
    args = ap.parse_args(argv)
    rec = run_cell(args.arch, args.shape, args.mesh,
                   seq_parallel=not args.no_seq_parallel,
                   layout=args.param_layout,
                   mor_mode=args.mor_mode, remat=args.remat,
                   grad_accum=args.grad_accum,
                   moe_sharding=args.moe_sharding, out_path=args.out,
                   flash_threshold=args.flash_threshold)
    if rec["status"].startswith("error"):
        sys.exit(1)


if __name__ == "__main__":
    main()
