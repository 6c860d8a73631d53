"""Serving CLI: the continuous-batching MoR engine under a mixed
prompt-length trace (``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --requests 8 --prompt-min 8 --prompt-max 64 --gen-len 16 \
      --shared-prefix 128 --mor kernel --compare
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch deepseek-v2-236b --layers 3 --mor kernel --compare
  PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \
      --arch mixtral-8x7b --layers 8 --mor kernel --compare
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --reduced --arch zamba2-7b --shared-prefix 8 --mor kernel --compare

Initialises the model from a seed (random weights; ``--layers N`` cuts
the depth to N layers, keeping every width), calibrates the MoR
predictor on synthetic batches when ``--mor`` is not dense
(``calibrate_lm`` for a dense model and for rwkv6-3b's channel mix,
``calibrate_moe`` for a moe model, whose dense leading layers and
(layer, expert) FFNs get their own predictors, ``calibrate_hybrid`` for
zamba2-7b's one shared MLP), serves the
trace through the engine (``--layout paged`` by default, with prefix
caching; ``slotted`` for the contiguous baseline) and reports tokens/s,
the per-layer skip fractions from the serving telemetry, the prefix
counters and, with ``--compare``, the token agreement against the dense
engine on the same layout.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import make_batch, synthetic_lm_batch
from repro_torch.models import get_model
from repro_torch.serving import Engine
from repro_torch.serving.telemetry import mor_group_map

SEED = 0
CALIB_STEPS = 4
CALIB_SEQ = 128
# the transformer zoo and the recurrent families; hubert-xlarge is
# refused as encoder-only
ARCHS = ("granite-3-2b", "granite-20b", "qwen2-7b", "qwen1.5-110b",
         "deepseek-v2-236b", "mixtral-8x7b", "phi-3-vision-4.2b",
         "hubert-xlarge", "rwkv6-3b", "zamba2-7b")


def make_trace(cfg, n_requests, pmin, pmax, gmin, gmax, seed,
               shared_prefix: int = 0):
    """Mixed trace: log-uniform prompt lengths in [pmin, pmax] and
    generation lengths in [gmin, gmax] (``repro.launch.serve._trace``,
    so both packages serve the same requests from one seed).
    ``shared_prefix`` > 0 prepends the SAME ``shared_prefix``-token
    prefix to every request (system-prompt traffic, which the prefix
    cache dedups)."""
    rng = np.random.default_rng(seed)
    prefix = np.zeros((0,), np.int32)
    if shared_prefix:
        prefix = np.asarray(
            synthetic_lm_batch(cfg, 1, shared_prefix, seed=seed, step=999)
            ["tokens"][0], np.int32)
    reqs = []
    for i in range(n_requests):
        plen = (int(np.exp(rng.uniform(np.log(pmin), np.log(pmax))))
                if pmax > pmin else pmin)
        glen = (int(np.exp(rng.uniform(np.log(gmin), np.log(gmax))))
                if gmax > gmin else gmax)
        prompt = np.asarray(
            synthetic_lm_batch(cfg, 1, plen, seed=seed, step=1000 + i)
            ["tokens"][0], np.int32)
        reqs.append((np.concatenate([prefix, prompt]), glen))
    return reqs


def calib_batches(cfg, batch: int, device, seed: int = SEED,
                  seq: int = CALIB_SEQ):
    """Calibration batches on ``device``: {"tokens"} for a decoder,
    {"frames"} for the audio encoder (``make_batch``'s choice)."""
    key = "frames" if cfg.frontend == "audio_stub" else "tokens"
    s = 0
    while True:
        b = make_batch(cfg, batch, seq, seed=seed, step=s)
        yield {key: torch.as_tensor(b[key], device=device)}
        s += 1


def run_engine(cfg, params, reqs, *, mor, mor_mode, n_slots, max_len,
               capacities=None, timed_passes: int = 3, **engine_kw):
    """Serve ``reqs``: one warm-up pass, then the best of
    ``timed_passes`` timed passes (each ends in a flush that waits for
    the device).  ``engine_kw`` (layout, page, prefix_cache) go to the
    engine.  -> (engine, {request index: tokens}, report)."""
    eng = Engine(cfg, params, mor=mor, mor_mode=mor_mode, n_slots=n_slots,
                 max_len=max_len, capacities=capacities, **engine_kw)
    eng.run(list(reqs))
    wall = float("inf")
    for _ in range(timed_passes):
        eng.reset_counters()
        t0 = time.perf_counter()
        results = eng.run(list(reqs))
        wall = min(wall, max(time.perf_counter() - t0, 1e-9))
    base = min(results)
    results = {rid - base: toks for rid, toks in results.items()}
    rep = eng.report()
    rep["requests_finished"] = len(results)
    total = rep["prefill_tokens"] + rep["decode_tokens"]
    rep["tokens_per_s"] = total / wall
    rep["decode_tokens_per_s"] = rep["decode_tokens"] / wall
    rep["wall_s"] = wall
    tel = rep.pop("telemetry", None) or {}
    for group in ("mor_stats", "dense_mor_stats", "moe_mor_stats"):
        # "mor_stats" of a dense model -> per_layer_*; a moe model's
        # groups -> per_layer_dense_* and the (L, E) per_layer_moe_*
        tag = group[:-len("mor_stats")]
        for name, vals in tel.get(group, {}).items():
            if name in ("frac_computed", "frac_tiles_live",
                        "frac_tiles_computed"):
                rep["per_layer_" + tag + name] = np.round(
                    np.asarray(vals), 4).tolist()
    return eng, results, rep


def token_agreement(a, b) -> float:
    return float(np.mean([np.mean(np.asarray(a[r]) == np.asarray(b[r]))
                          for r in b]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut: serve the first N layers (0 = all)")
    ap.add_argument("--batch", type=int, default=8,
                    help="slot-pool size (n_slots)")
    ap.add_argument("--requests", type=int, default=0,
                    help="trace length (default: one per slot)")
    ap.add_argument("--prompt-min", type=int, default=16)
    ap.add_argument("--prompt-max", type=int, default=0,
                    help="default: --prompt-min (uniform prompts)")
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--layout", default="paged",
                    choices=("paged", "slotted"),
                    help="KV cache layout (slotted = contiguous baseline)")
    ap.add_argument("--page", type=int, default=0,
                    help="tokens per KV page (default cfg.serve_page)")
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="prefix caching across requests (default on; "
                         "paged layout only)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a shared N-token prefix to every "
                         "request (shared-prompt trace)")
    ap.add_argument("--mor", default="dense",
                    choices=("dense", "exact", "tiled", "kernel"))
    ap.add_argument("--capacity", type=float, default=0.0,
                    help="static gather_matmul capacity fraction for every "
                         "MoR layer (0 = cfg.mor.capacity)")
    ap.add_argument("--compare", action="store_true",
                    help="also run the dense engine; report token agreement")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to run the plain versions)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    api = get_model(cfg)
    if not api.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: nothing to serve")
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = api.init(gen, cfg)

    mor = None
    report = {"arch": cfg.name, "mor_mode": args.mor, "device": str(device)}
    if args.mor != "dense":
        from repro_torch.core import deploy
        calibrate = {"moe": deploy.calibrate_moe,
                     "hybrid": deploy.calibrate_hybrid}.get(
                         cfg.family, deploy.calibrate_lm)
        params, mor, cal = calibrate(
            params, cfg, api.forward, calib_batches(cfg, args.batch, device),
            CALIB_STEPS)
        report["calibration"] = cal

    pmin = args.prompt_min
    pmax = args.prompt_max or pmin
    reqs = make_trace(cfg, args.requests or args.batch, pmin, pmax,
                      args.gen_len, args.gen_len, SEED,
                      shared_prefix=args.shared_prefix)
    max_len = args.shared_prefix + pmax + args.gen_len + 2
    engine_kw = {"layout": args.layout}
    if args.layout == "paged":
        engine_kw.update(page=args.page, prefix_cache=args.prefix_cache)
    capacities = None
    if args.capacity > 0 and args.mor != "dense":
        capacities = {k: args.capacity for k in mor_group_map(cfg)}
        report["static_capacity"] = args.capacity

    _, results, rep = run_engine(cfg, params, reqs, mor=mor,
                                 mor_mode=args.mor, n_slots=args.batch,
                                 max_len=max_len, capacities=capacities,
                                 **engine_kw)
    report.update(rep)
    print(f"[serve] {cfg.name} mor={args.mor} layout={args.layout} "
          f"device={device}: {rep['tokens_per_s']:.1f} tok/s over "
          f"{len(reqs)} requests ({rep['dispatches']} dispatches, prompts "
          f"{pmin}-{pmax})")
    if "prefix_cache" in rep:
        pc = rep["prefix_cache"]
        print(f"[serve] prefix cache: hit rate {pc['hit_rate']:.2f} "
              f"({pc['prefix_hits']}/{pc['prefix_queries']} requests), "
              f"{pc['pages_shared']} pages shared, "
              f"{pc['chunks_skipped']} prefill chunks skipped, "
              f"{pc['pages_cowed']} pages copy-on-written")
    if args.compare and args.mor != "dense":
        _, results_d, rep_d = run_engine(cfg, params, reqs, mor=None,
                                         mor_mode="dense",
                                         n_slots=args.batch,
                                         max_len=max_len, **engine_kw)
        agree = token_agreement(results, results_d)
        report["dense_tokens_per_s"] = rep_d["tokens_per_s"]
        report["token_agreement_vs_dense"] = agree
        print(f"[serve] dense baseline: {rep_d['tokens_per_s']:.1f} tok/s; "
              f"token agreement {agree:.3f}")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
