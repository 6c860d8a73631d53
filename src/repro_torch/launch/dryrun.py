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

With ``--mesh pod`` (16 x 16 = 256 ranks) or ``--mesh multipod`` (2 x
16 x 16 = 512) the dry run is rank 0's: this process joins torch's fake
process group as rank 0 of the production mesh (``launch.mesh.
dry_mesh``, NCCL's collectives modelled), builds that rank's blocks on
the meta device (the params and optimizer state under
``param_sharding`` in ``--param-layout``, by default the config's, with
``--moe-sharding`` as the expert mode; its rows of the batch under
``batch_sharding``; the port's own decode cache under the mesh) and runs
the step under ``op_cost`` inside ``activation_context(mesh,
sequence_parallel=not --no-seq-parallel)``, every collective called for
real on meta tensors and counted (``collectives.nbytes``, the bytes of
groups that span nodes apart: ``ib_nbytes``).  Under "contract_tp" those
include each layer's moves of its splits onto the dims its forms
consume (all-to-all bytes: ``sharding_rules.use``), and
``model_gathered`` names the leaves still gathered whole over
``model``.  The record holds the
reference's keys per rank (``n_chips``, ``memory_analysis``' argument
and temp bytes, ``per_device_gib``, ``fits_80gb`` a rank, the roofline
with its collective term split between NVLink and InfiniBand,
``floor_time_s``) and names the cache leaves whose rank block differs
from the reference's heuristic ``_cache_sharding``
(``cache_layout_vs_reference``).  As the reference's, a mesh run needs a
process of its own (the fake group is the process's one group).

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape decode_32k [--mesh 1xh100|pod|multipod] [--no-seq-parallel]
      [--param-layout fsdp_tp|contract_tp] [--moe-sharding ep|tp|ep_shmap]
      [--mor-mode dense|tiled] [--remat ...] [--grad-accum N]
      [--flash-threshold N] [--out file.json]
On one H100 (``1xh100``) the mesh flags change nothing (one card holds
every block whole) and are recorded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.configs import SHAPES, get_config, input_specs
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding_rules as sr
from repro_torch.launch import op_cost, roofline, steps
from repro_torch.launch.mesh import dry_mesh, make_production_mesh
from repro_torch.launch.steps import (make_prefill, make_serve_step,
                                      make_train_step)
from repro_torch.models import (cache_shapes, get_model, param_shapes,
                                supports_long_context)
from repro_torch.models.layers.common import is_glu
from repro_torch.models.layers.mlp import effective_activation
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.tree import leaves

MESH = "1xh100"                    # the default: one card, no mesh
MESH_KINDS = (MESH, "pod", "multipod")
SEED = 0                           # the card's random weights and inputs
CARD_BYTES = 80 * 2 ** 30          # one H100 80GB


def mesh_shape(mesh_kind: str) -> Optional[Dict[str, int]]:
    """The production mesh's axis sizes for ``--mesh pod|multipod``,
    None for one card."""
    if mesh_kind == MESH:
        return None
    return dict(make_production_mesh(
        multi_pod=mesh_kind == "multipod").shape)


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


class MeshArgs(NamedTuple):
    """A cell's place on a mesh: this rank's ``mesh`` (a
    ``launch.mesh.HostMesh``: ``dry_mesh``'s on meta, or a real one),
    the sequence-parallel flag and the param layout."""
    mesh: Any
    sequence_parallel: bool = True
    layout: str = "fsdp_tp"


def rank_trees(cfg: ModelConfig, mesh, layout: str, params,
               data) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """-> (this rank's blocks of ``params`` under ``param_sharding`` in
    ``layout`` with the config's expert mode, its ``batch_sharding``
    rows of the global batch ``data``)."""
    params = sr.shard_tree(params, steps.mesh_specs(cfg, mesh, layout),
                           mesh)
    return params, {k: steps.local_rows(v, mesh) for k, v in data.items()}


def _cell(cfg: ModelConfig, shape: ShapeSpec, mor_mode: str,
          opt_cfg: OptConfig, device, gen=None, on: MeshArgs = None):
    """-> (step thunk, argument trees) of the cell on ``device``: meta
    trees, or real ones on the card (random weights from ``gen``); on a
    mesh (``on``) this rank's blocks of them (the step is handed the
    global batch and takes its rows)."""
    api = get_model(cfg)
    meta = torch.device(device).type == "meta"
    params = param_shapes(cfg) if meta else api.init(gen, cfg)
    specs = input_specs(cfg, shape, device="meta")
    data = specs if meta else _random_inputs(specs, cfg, gen, device)
    local, kw = data, {}
    if on is not None:
        params, local = rank_trees(cfg, on.mesh, on.layout, params, data)
        kw = dict(mesh=on.mesh, sequence_parallel=on.sequence_parallel,
                  param_layout=on.layout)
    if shape.kind == "train":
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(cfg, opt_cfg, **kw)
        return (lambda: step(params, opt, data)), {
            "params": params, "opt": opt, "inputs": local}
    if shape.kind == "prefill":
        fn = make_prefill(cfg, mor_mode=mor_mode, **kw)

        def prefill():
            with torch.no_grad():
                return fn(params, data)
        return prefill, {"params": params, "inputs": local}
    if on is not None:
        cache = steps.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device, mesh=on.mesh)
    elif meta:
        cache = cache_shapes(cfg, shape.global_batch, shape.seq_len)
    else:
        cache = api.cache_init(cfg, shape.global_batch, shape.seq_len,
                               cfg.tdtype, device)
    step = make_serve_step(cfg, mor_mode=mor_mode, **kw)

    def serve():
        with torch.no_grad():
            return step(params, cache, data["tokens"])
    return serve, {"params": params, "cache": cache, "inputs": local}


def _reference_cache_spec(shape: Tuple[int, ...], mesh) -> Tuple:
    """The reference's heuristic ``_cache_sharding`` of one cache leaf
    (``repro.launch.dryrun._cache_sharding``): dim 1 over the
    data-parallel axes where they divide it, the largest later dim
    that ``model`` divides over ``model``."""
    dp_axes = sr._dp_axes(mesh)
    dp = sr._dp_size(mesh)
    mp = mesh.shape.get("model", 1)
    spec = [None] * len(shape)
    if len(shape) >= 2 and shape[1] % dp == 0 and shape[1] >= dp:
        spec[1] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    best, best_dim = 0, -1
    for i in range(2, len(shape)):
        if shape[i] % mp == 0 and shape[i] > best:
            best, best_dim = shape[i], i
    if best_dim >= 0 and mp > 1:
        spec[best_dim] = "model"
    return tuple(spec)


def cache_layout_vs_reference(cfg: ModelConfig, shape: ShapeSpec,
                              local_cache, mesh) -> Dict[str, Dict]:
    """{cache leaf: {"port", "reference_heuristic"} block shapes} of the
    leaves whose rank block under the port's own cache layout (the
    sequence-sharded GQA ring, the data rank's rows) differs from the
    reference's heuristic ``_cache_sharding`` block."""
    from repro_torch.tree import paths
    whole = paths(cache_shapes(cfg, shape.global_batch, shape.seq_len))
    mine = paths(local_cache)
    out = {}
    for k in sorted(set(whole) | set(mine)):
        ref = None
        if k in whole:
            full = tuple(whole[k].shape)
            spec = _reference_cache_spec(full, mesh)
            ref = tuple(n // (sr._axes_size(mesh, ax) if ax else 1)
                        for n, ax in zip(full, spec))
        got = tuple(mine[k].shape) if k in mine else None
        if got != ref:
            out[k] = {"port": got, "reference_heuristic": ref}
    return out


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
               device="meta", on: MeshArgs = None) -> Counted:
    """Build the cell's arguments on ``device`` (meta trees, or random
    weights from ``SEED`` elsewhere; this rank's blocks on a mesh,
    ``on``) and run its step once under an ``OpCounter``."""
    opt_cfg = opt_cfg or OptConfig()
    on_card = torch.device(device).type == "cuda"
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(SEED))
    if on_card:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
    step, trees = _cell(cfg, shape, mor_mode, opt_cfg, device, gen, on)
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
                 device="meta", flush=None, time_iters: int = 10,
                 on: MeshArgs = None) -> Dict[str, Any]:
    """The cell's record: memory (``argument_bytes`` by tree,
    ``peak_temp_bytes``, ``per_device_bytes``, ``fits_80gb``), the
    op-level cost and its roofline summary with the implementation's
    floor (``result_bytes``), all from a run on the meta device; with
    ``device="cuda"`` also the same cell on the card (``card``: the
    arguments' and the peak bytes allocated over what was allocated
    before, the step's own peak, FLOPs and bytes counted there, mean ms
    of a step over ``time_iters`` calls timed by ``timing.device_ms``
    with the L2 ``flush`` buffer).  On a mesh (``on``) every number is
    this rank's, and the record adds ``n_chips``, the collectives run
    (``collectives``: counts, bytes by kind, the bytes of groups that
    span nodes), the leaves gathered over ``model`` (``model_gathered``:
    the splits no tensor-parallel form consumed, rwkv6-3b's time mix on
    the pod's model 16, whose 40 heads do not divide) and, for a decode,
    ``cache_layout_vs_reference``; a dense model's decode under
    ``"contract_tp"`` also ``contract_decode_bytes``: the weights' moves'
    all-to-all bytes counted, beside ``activation_form_bytes``."""
    from repro_torch.distributed import collectives as co
    t0 = time.perf_counter()
    co.reset_counts()
    sr.model_gathers.clear()
    counted = count_cell(cfg, shape, mor_mode=mor_mode, opt_cfg=opt_cfg,
                         on=on)
    cost = counted.counter.result()
    arg_bytes = sum(counted.args.values())
    per_dev = arg_bytes + cost["peak_live_bytes"]
    n_chips = 1 if on is None else on.mesh.size
    rec = {"n_chips": n_chips,
           "memory_analysis": {
               "argument_size_in_bytes": arg_bytes,
               "temp_size_in_bytes": cost["peak_live_bytes"],
               "output_size_in_bytes": counted.results},
           "argument_bytes": arg_bytes,
           "argument_bytes_by_tree": counted.args,
           "result_bytes": counted.results,
           "peak_temp_bytes": cost["peak_live_bytes"],
           "per_device_bytes": per_dev,
           "per_device_gib": round(per_dev / 2 ** 30, 3),
           "fits_80gb": per_dev < CARD_BYTES,
           "cost": cost,
           "roofline": roofline.summarize(
               cost, cfg, shape, n_chips,
               floor_bytes=arg_bytes + counted.results),
           "meta_s": round(time.perf_counter() - t0, 3)}
    if on is not None:
        rec["collectives"] = {"counts": dict(co.counts),
                              "bytes_by_kind": dict(co.nbytes),
                              "ib_bytes_by_kind": dict(co.ib_nbytes)}
        # the layers' leaves no tensor-parallel form consumed
        rec["model_gathered"] = sorted(sr.model_gathers)
        if shape.kind == "decode":
            cache = steps.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     "meta", mesh=on.mesh)
            rec["cache_layout_vs_reference"] = cache_layout_vs_reference(
                cfg, shape, cache, on.mesh)
            if on.layout == "contract_tp" and cfg.family == "dense":
                rec["contract_decode_bytes"] = {
                    "move": co.nbytes.get("all-to-all", 0),
                    "activation_form": activation_form_bytes(
                        cfg, shape.global_batch // sr.dp_group(on.mesh).size)}
    if torch.device(device).type == "cuda":
        rec["card"] = _on_card(cfg, shape, mor_mode, opt_cfg, device,
                               flush, time_iters)
    return rec


def activation_form_bytes(cfg: ModelConfig, tokens: int) -> int:
    """The bytes a decode step of a dense model would move a rank under
    ``"contract_tp"`` had its layers kept the weights where the layout
    puts them and moved the activations instead (Megatron's form for
    those splits), reckoned from the shapes for ``tokens`` rows a rank:
    a layer's input projections split on their contraction dim each
    sum a (tokens, width) partial product over ``model`` (q, k, v, gate
    and up), and its output projections split on their output dim each
    take their whole (tokens, width) input (the heads' output, the FFN's
    hidden), in the compute dtype; an untied head sums its (tokens,
    vocab) partial logits.  The weights' move (``sharding_rules.use``)
    is what the dry run counts beside it."""
    hd, f = cfg.head_dim, cfg.d_ff
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    up = 2 * f if is_glu(effective_activation(cfg)) else f
    width = cfg.n_layers * (q + 2 * kv + up + q + f)
    if not cfg.tie_embeddings:
        width += cfg.vocab_size
    return tokens * width * cfg.tdtype.itemsize


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


def run_cell(arch: str, shape_name: str, mesh_kind: str = MESH, *,
             seq_parallel: bool = True, mor_mode: str = "dense",
             remat: str = None, grad_accum: int = None,
             moe_sharding: str = None, out_path: str = None,
             layout: str = None, flash_threshold: int = None) -> dict:
    """The reference's ``run_cell`` on the meta device: the cell's record
    (``status`` "ok", a skip reason or "error: ..."), written to
    ``out_path`` when given.  ``mesh_kind`` "pod" / "multipod" runs rank
    0 of the production mesh on the fake process group (``dry_mesh``:
    this process must hold no other process group), "1xh100" one card.
    ``layout`` (default: the config's ``param_layout``) and
    ``moe_sharding`` (the config's ``expert_sharding``) place the
    params, ``seq_parallel`` S-shards the residual stream; on one card
    they change nothing.  ``flash_threshold`` overrides the config's
    (the attention layers read it from the config, as the train and
    serve paths do)."""
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"mesh {mesh_kind!r}: one of {MESH_KINDS}")
    cfg = get_config(arch)
    layout = layout or cfg.param_layout
    if moe_sharding:
        cfg = cfg.replace(expert_sharding=moe_sharding)
    if remat:
        cfg = cfg.replace(remat=remat)
    if grad_accum:
        cfg = cfg.replace(grad_accum=grad_accum)
    if flash_threshold is not None:
        cfg = cfg.replace(flash_threshold=flash_threshold)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "seq_parallel": seq_parallel, "layout": layout,
           "mor_mode": mor_mode, "remat": cfg.remat,
           "grad_accum": cfg.grad_accum, "moe_sharding": moe_sharding,
           "expert_sharding": cfg.expert_sharding,
           "flash_threshold": cfg.flash_threshold, "device": "meta"}
    status = cell_status(cfg, shape)
    if status != "run":
        rec["status"] = status
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {status}")
        _write(rec, out_path)
        return rec
    try:
        mshape = mesh_shape(mesh_kind)
        if mshape is None:
            rec.update(measure_cell(cfg, shape, mor_mode=mor_mode))
        else:
            with dry_mesh(mshape, backend="nccl") as mesh:
                rec.update(measure_cell(cfg, shape, mor_mode=mor_mode,
                                        on=MeshArgs(mesh, seq_parallel,
                                                    layout)))
            rec["mesh_shape"] = mshape
        rec["status"] = "ok"
        rl = rec["roofline"]
        coll = ""
        if "n_chips" in rec and rec["n_chips"] > 1:
            coll = (f"collective {rl['t_collective_s'] * 1e3:.3f} ms "
                    f"(InfiniBand {rl['t_collective_ib_s'] * 1e3:.3f} ms), ")
        print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: OK "
              f"({rec['meta_s']:.1f}s on meta, {rec['per_device_gib']} "
              f"GiB/dev, fits_80gb={rec['fits_80gb']}, "
              f"dominant={rl['dominant']}, "
              f"roofline_frac={rl['roofline_fraction']:.3f}, {coll}floor "
              f"{rl['floor_dominant']} {rl['floor_time_s'] * 1e3:.3f} ms)")
        if rec.get("model_gathered"):
            print(f"[dryrun] gathered whole over model: "
                  f"{' '.join(rec['model_gathered'])}")
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
    ap.add_argument("--mesh", default=MESH, choices=MESH_KINDS)
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
