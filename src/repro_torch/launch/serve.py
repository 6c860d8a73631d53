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
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --reduced --layout paged-sharded --shards 2 --mor kernel --compare
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --reduced --baseline --mor kernel

Initialises the model from a seed (random weights; ``--layers N`` cuts
the depth to N layers, keeping every width) or restores the params of
``--ckpt-dir``'s newest checkpoint (``launch.train``'s), calibrates the MoR
predictor on synthetic batches when ``--mor`` is not dense
(``calibrate_lm`` for a dense model and for rwkv6-3b's channel mix,
``calibrate_moe`` for a moe model, whose dense leading layers and
(layer, expert) FFNs get their own predictors, ``calibrate_hybrid`` for
zamba2-7b's one shared MLP), serves the
trace through the engine (``--layout paged`` by default, with prefix
caching; ``slotted`` for the contiguous baseline; ``paged-sharded
--shards N`` spawns N rank processes, one page shard each, on which rank
0 calibrates and hands its MoR tree to the others) and reports tokens/s,
the per-layer skip fractions from the serving telemetry, the prefix
counters and, with ``--compare``, the token agreement against the dense
engine on the same layout.  ``--calibrate-capacity Q`` serves the trace
again under per-layer budgets at the Q quantile of the observed tile
liveness (``Engine.calibrate_capacities``); ``--baseline`` also times
the static-batch path on the same trace (``generate`` on groups of
``--batch`` prompts left-padded to the trace maximum: one batched
prefill, then every slot decodes until its group's longest request is
done) and reports the engine's speedup over it.

``--temperature`` / ``--top-k`` / ``--sample-seed`` sample instead of
taking the argmax (the port's seeded noise, not ``jax.random``'s),
``--spec-k K`` decodes self-speculatively (drafts under ``--draft-cap``
at ``--spec-draft-temperature``, one verify pass at full capacity),
``--policy`` / ``--prefill-budget`` pick the admission and preemption
policy and the cap on a mixed dispatch's prompt tokens, and ``--stream``
serves request 0 once more through ``Engine.stream``.

``--obs`` / ``--metrics-json`` / ``--trace-out`` / ``--metrics-port``
attach the ``repro_torch.obs`` stack to the primary engine: a metrics
registry (JSON / Prometheus), the metrics block on the device (counted
in every dispatch, read at flushes only) and the span tracer, whose
timeline loads in Perfetto or chrome://tracing.  ``--shadow-rate R``
scores the MoR predictor against the dense oracle on 1 in round(1 / R)
dispatches (tokens stay those of ``--shadow-rate 0``) and runs the drift
detector over the scores (``--drift-threshold``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import make_batch, synthetic_lm_batch
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import get_model
from repro_torch.serving import Engine, kv_pool, mesh
from repro_torch.serving.telemetry import STAT_KEYS, mor_group_map

SEED = 0
CALIB_STEPS = 4
CALIB_SEQ = 128
# the transformer zoo and the recurrent families; hubert-xlarge is
# refused as encoder-only
ARCHS = ("granite-3-2b", "granite-20b", "qwen2-7b", "qwen1.5-110b",
         "deepseek-v2-236b", "mixtral-8x7b", "phi-3-vision-4.2b",
         "hubert-xlarge", "rwkv6-3b", "zamba2-7b")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, api, params, prompts: torch.Tensor, gen_len: int,
             mor=None, mor_mode: str = "dense", layer_stats: bool = True):
    """The static-batch generate (``repro.launch.serve.generate``, the
    serving path before the engine, kept as the baseline): prompts (B,
    P) on the weights' device -> (tokens (B, gen_len) numpy, stats).

    The prompt goes through ``make_prefill_step`` (one batched dispatch,
    or chunks for the recurrent families and prompts past the window),
    then a width-1 chunk step a token, as in the JAX package: the
    prefill's token (``stats["first_token"]``, (B,) numpy) is fed back,
    the ``gen_len`` decode steps' tokens are returned.  The first decode
    step runs outside the timed window; nothing is read back to the host
    before the last step.  stats: decode and prefill throughput and,
    with ``layer_stats``, the per-layer skip fractions averaged over the
    timed steps."""
    device = params["embed"].device
    B, P = prompts.shape
    cache = kv_pool.init(cfg, B, P + gen_len + 1, device=device)
    prefill = make_prefill_step(cfg, mor=mor, mor_mode=mor_mode)
    step = make_decode_step(cfg, mor=mor, mor_mode=mor_mode)

    _sync(device)
    t0 = time.perf_counter()
    nxt, cache = prefill(params, cache, prompts)
    _sync(device)
    prefill_dt = time.perf_counter() - t0

    out = [nxt]
    nxt, cache, _ = step(params, cache, nxt[:, None])
    out.append(nxt)
    aux_list = []
    _sync(device)
    timed = max(gen_len - 1, 1)
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        nxt, cache, aux = step(params, cache, nxt[:, None])
        out.append(nxt)
        if aux:
            aux_list.append(aux)
    _sync(device)
    dt = max(time.perf_counter() - t0, 1e-9)
    toks = torch.stack(out, 1).cpu().numpy()
    stats = {"decode_tokens_per_s": B * timed / dt,
             "decode_ms_per_step": dt / timed * 1e3,
             "prefill_tokens_per_s": B * P / max(prefill_dt, 1e-9),
             "prefill_ms": prefill_dt * 1e3,
             "first_token": toks[:, 0]}
    if layer_stats:
        stats.update(mean_layer_stats(aux_list))
    return toks[:, 1:], stats


# report-key prefix of each stat group: a dense stack's per_layer_*, a
# moe model's dense layers per_layer_dense_* and its (L, E) expert
# stats per_layer_moe_* (the JAX package's per_expert_*)
STAT_PREFIX = {"mor_stats": "per_layer_",
               "dense_mor_stats": "per_layer_dense_",
               "moe_mor_stats": "per_layer_moe_"}
FRAC_NAMES = ("frac_computed", "frac_tiles_live", "frac_tiles_computed")


def mean_layer_stats(aux_list):
    """The per-layer skip fractions of ``aux_list`` (one aux a
    dispatch, device tensors) averaged over the dispatches, rounded to 4
    places -> report lists ((L, E) nested for the expert group)."""
    out = {}
    for key in STAT_KEYS:
        rows = [a[key] for a in aux_list if a.get(key)]
        for name in FRAC_NAMES if rows else ():
            vals = [r[name] for r in rows if name in r]
            if vals:
                mean = torch.stack(vals).double().cpu().numpy().mean(0)
                out[STAT_PREFIX[key] + name] = mean.round(4).tolist()
    return out


def left_pad(prompts, n_rows: int, width: int) -> np.ndarray:
    """(n_rows, width) int32: each prompt right-aligned behind token 0
    (the padding is attended, as in the JAX package's baseline)."""
    out = np.zeros((n_rows, width), np.int32)
    for j, p in enumerate(prompts):
        out[j, width - len(p):] = p
    return out


def static_batch(cfg, params, reqs, *, n_slots: int, mor=None,
                 mor_mode: str = "dense", timed_passes: int = 3):
    """The static-batch baseline on ``reqs`` (``repro.launch.serve``'s
    ``--baseline``): ``generate`` on groups of ``n_slots`` requests,
    every prompt left-padded to the TRACE maximum, decoding until the
    group's longest request is done (the convoy).  One warm-up group
    runs untimed, then the best of ``timed_passes`` passes over all
    groups.  -> (tokens/s of prompt and requested tokens, {request
    index: its greedy tokens (the prefill's, then the decode steps'),
    up to its length}, wall s)."""
    device = params["embed"].device
    Pmax = max(len(p) for p, _ in reqs)

    def run_group(group):
        prompts = left_pad([p for p, _ in group], n_slots, Pmax)
        toks, stats = generate(cfg, None, params,
                               torch.as_tensor(prompts, device=device),
                               max(g for _, g in group), mor=mor,
                               mor_mode=mor_mode, layer_stats=False)
        return np.concatenate([stats["first_token"][:, None], toks], 1)

    groups = [reqs[i:i + n_slots] for i in range(0, len(reqs), n_slots)]
    run_group(groups[0])                        # warm-up, untimed
    wall = float("inf")
    for _ in range(timed_passes):
        t0 = time.perf_counter()
        outs = [run_group(group) for group in groups]
        wall = min(wall, max(time.perf_counter() - t0, 1e-9))
    tokens = {}
    for gi, (group, toks) in enumerate(zip(groups, outs)):
        for j, (_, g) in enumerate(group):
            tokens[gi * n_slots + j] = toks[j, :g].tolist()
    n_tok = sum(len(p) + g for p, g in reqs)
    return n_tok / wall, tokens, wall


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
    the device).  ``engine_kw`` (layout, page, prefix_cache, sampling,
    policy, speculation) go to the
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
    for group in STAT_KEYS:
        for name, vals in tel.get(group, {}).items():
            if name in FRAC_NAMES:
                rep[STAT_PREFIX[group] + name] = np.round(
                    np.asarray(vals), 4).tolist()
    return eng, results, rep


def token_agreement(a, b) -> float:
    return float(np.mean([np.mean(np.asarray(a[r]) == np.asarray(b[r]))
                          for r in b]))


def calibrate(params, cfg, api, device, batch: int, group=None,
              seed: int = SEED, steps: int = CALIB_STEPS):
    """-> (params, mor, report) of the family's calibration
    (``calibrate_lm`` / ``_moe`` / ``_hybrid``).  In a page group rank 0
    calibrates and broadcasts its MoR tree; every other rank folds the
    tree's permutations into its own copy of the same weights, so that
    all serve the same plan bit for bit."""
    from repro_torch.core import deploy
    fn = {"moe": deploy.calibrate_moe,
          "hybrid": deploy.calibrate_hybrid}.get(cfg.family,
                                                 deploy.calibrate_lm)
    cal = mor = None
    if group is None or group.rank == 0:
        new, mor, cal = fn(params, cfg, api.forward,
                           calib_batches(cfg, batch, device, seed), steps)
    if group is None:
        return new, mor, cal
    mor, cal = mesh.broadcast((mor, cal), group, device=device)
    if group.rank:
        new = deploy.fold_permutations(params, mor)
    return new, mor, cal


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dims", default=None,
                    help="override the widths and depth: d_model,d_ff,"
                         "n_layers")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the newest committed "
                         "checkpoint there (launch.train's)")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut: serve the first N layers (0 = all)")
    ap.add_argument("--batch", type=int, default=8,
                    help="slot-pool size (n_slots)")
    ap.add_argument("--requests", type=int, default=0,
                    help="trace length (default: one per slot)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--prompt-min", type=int, default=0,
                    help="mixed trace: min prompt length (default "
                         "--prompt-len)")
    ap.add_argument("--prompt-max", type=int, default=0,
                    help="mixed trace: max prompt length (default "
                         "--prompt-len, at least --prompt-min)")
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--gen-min", type=int, default=0,
                    help="mixed trace: min generation length (default "
                         "--gen-len: uniform)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="prefill chunk length (default cfg.serve_chunk)")
    ap.add_argument("--layout", default="paged",
                    choices=("paged", "paged-sharded", "slotted"),
                    help="KV cache layout (paged-sharded = the page pool "
                         "split over --shards rank processes; slotted = "
                         "contiguous baseline)")
    ap.add_argument("--shards", type=int, default=2,
                    help="paged-sharded: rank processes, one page shard "
                         "each")
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
    ap.add_argument("--stream", action="store_true",
                    help="serve request 0 once more through Engine.stream() "
                         "and report the tokens it streamed")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation for temperature sampling (0 = "
                         "the full distribution)")
    ap.add_argument("--sample-seed", type=int, default=0)
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative decoding: draft up to k tokens "
                         "a slot a round and verify them in one target "
                         "pass (0 = off; paged layout only; greedy output "
                         "is the target's own)")
    ap.add_argument("--draft-cap", type=float, default=0.0,
                    help="MoR capacity fraction of the DRAFT pass (0 = "
                         "draft at the target's capacity)")
    ap.add_argument("--spec-draft-temperature", type=float, default=None,
                    help="the draft pass's sampling temperature (default: "
                         "--temperature)")
    ap.add_argument("--policy", default="fcfs",
                    choices=("fcfs", "priority", "sjf"),
                    help="admission / preemption policy (priority may "
                         "spill lower classes; sjf = shortest remaining "
                         "prefill first)")
    ap.add_argument("--prefill-budget", type=int, default=0,
                    help="cap on the prompt tokens of a mixed dispatch "
                         "(0 = unlimited)")
    ap.add_argument("--mor", default="dense",
                    choices=("dense", "exact", "tiled", "kernel"))
    ap.add_argument("--calib-steps", type=int, default=CALIB_STEPS)
    ap.add_argument("--capacity", type=float, default=0.0,
                    help="static gather_matmul capacity fraction for every "
                         "MoR layer (0 = cfg.mor.capacity)")
    ap.add_argument("--calibrate-capacity", type=float, default=0.0,
                    help="liveness quantile for per-layer gather capacity "
                         "(0 = static cfg.mor.capacity)")
    ap.add_argument("--obs", action="store_true",
                    help="attach the obs stack (metrics registry, device "
                         "metrics block, request tracer) to the primary "
                         "engine; implied by the four flags below")
    ap.add_argument("--metrics-json", default=None,
                    help="write the obs metrics-registry snapshot "
                         "(counters, gauges, histogram summaries) to "
                         "this path as JSON")
    ap.add_argument("--trace-out", default=None,
                    help="write the request tracer's timeline to this "
                         "path as Chrome-trace JSON (load in Perfetto "
                         "or chrome://tracing)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics (Prometheus text) and GET "
                         "/metrics.json on 127.0.0.1 at this port for the "
                         "run's duration (0 = an ephemeral port, printed "
                         "at start-up)")
    ap.add_argument("--shadow-rate", type=float, default=0.0,
                    help="score 1 in round(1/RATE) dispatches against the "
                         "dense oracle (false skips / false keeps into the "
                         "device metrics block); tokens stay those of "
                         "--shadow-rate 0 (needs --mor != dense)")
    ap.add_argument("--drift-threshold", type=float, default=0.25,
                    help="per-(layer, expert) EWMA false-skip-rate "
                         "threshold above which the drift detector flags "
                         "the series")
    ap.add_argument("--compare", action="store_true",
                    help="also run the dense engine; report token agreement")
    ap.add_argument("--baseline", action="store_true",
                    help="also run the static-batch path on the same trace")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to run the plain versions)")
    if args.layout != "paged-sharded":
        return serve(args, device)
    from repro_torch.launch.mesh import page_backend, run_ranks
    if args.shards < 1:
        raise SystemExit("--shards takes at least one rank")
    if device.type == "cuda":
        from repro_torch.kernels import build
        build.load()                     # built once, before the ranks
    print(f"[serve] page mesh: spawning {args.shards} ranks on {device} "
          f"({page_backend(device, args.shards)})", flush=True)
    return run_ranks(_serve_rank, args.shards, device, args)[0]


def _serve_rank(group, args):
    return serve(args, group.device, group)


def serve(args, device, group=None):
    """Serve the trace ``args`` describe on ``device`` (as rank ``group``
    of the paged-sharded layout, where rank 0 prints)."""
    say = print if group is None or group.rank == 0 else \
        (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.dims:
        d, ff, L = (int(v) for v in args.dims.split(","))
        cfg = cfg.replace(d_model=d, d_ff=ff, n_layers=L)
    if args.layers:
        cfg = cfg.replace(n_layers=args.layers)
    api = get_model(cfg)
    if not api.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: nothing to serve")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = api.init(gen, cfg)
    if args.ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        state, _ = CheckpointManager(args.ckpt_dir).restore(
            {"params": params})
        params = state["params"]

    mor = None
    report = {"arch": cfg.name, "mor_mode": args.mor, "device": str(device)}
    if args.mor != "dense":
        params, mor, report["calibration"] = calibrate(
            params, cfg, api, device, args.batch, group, seed=args.seed,
            steps=args.calib_steps)

    pmin = args.prompt_min or args.prompt_len
    pmax = max(args.prompt_max or args.prompt_len, pmin)
    gmin = args.gen_min or args.gen_len
    reqs = make_trace(cfg, args.requests or args.batch, pmin, pmax,
                      gmin, args.gen_len, args.seed,
                      shared_prefix=args.shared_prefix)
    max_len = args.shared_prefix + pmax + args.gen_len + 2
    from repro_torch.serving.policy import get_policy
    engine_kw = {"layout": args.layout, "chunk": args.chunk,
                 "temperature": args.temperature, "top_k": args.top_k,
                 "sample_seed": args.sample_seed,
                 "policy": get_policy(args.policy, args.prefill_budget),
                 "spec_k": args.spec_k, "draft_cap": args.draft_cap,
                 "spec_draft_temperature": args.spec_draft_temperature}
    if args.layout != "slotted":
        engine_kw.update(page=args.page, prefix_cache=args.prefix_cache)
    if group is not None:
        engine_kw["group"] = group
    capacities = None
    if args.capacity > 0 and args.mor != "dense":
        capacities = {k: args.capacity for k in mor_group_map(cfg)}
        report["static_capacity"] = args.capacity

    if args.shadow_rate > 0 and args.mor == "dense":
        raise SystemExit("--shadow-rate scores the MoR predictor: pick "
                         "--mor exact / tiled / kernel")
    obs = server = None
    if args.obs or args.metrics_json or args.trace_out or \
            args.shadow_rate > 0 or args.metrics_port is not None:
        from repro_torch.obs import Observability
        obs = Observability()
    if args.metrics_port is not None and (group is None or group.rank == 0):
        from repro_torch.obs import MetricsServer
        server = MetricsServer(obs, port=args.metrics_port)
        say(f"[serve] metrics endpoint: {server.url}/metrics "
            f"(+ /metrics.json)")

    try:
        eng, results, rep = run_engine(cfg, params, reqs, mor=mor,
                                       mor_mode=args.mor, n_slots=args.batch,
                                       max_len=max_len, capacities=capacities,
                                       obs=obs, shadow_rate=args.shadow_rate,
                                       drift_threshold=args.drift_threshold,
                                       **engine_kw)
        report.update(rep)
        report["policy"] = args.policy
        if args.prefill_budget:
            report["prefill_budget"] = args.prefill_budget
        say(f"[serve] {cfg.name} mor={args.mor} layout={args.layout} "
              f"device={device}: {rep['tokens_per_s']:.1f} tok/s over "
              f"{len(reqs)} requests ({rep['dispatches']} dispatches, prompts "
              f"{pmin}-{pmax})")
        if "quality" in rep:
            q = rep["quality"]
            dr = q.get("drift", {})
            say(f"[serve] shadow oracle: rate {q['shadow_rate']:.4f} "
                f"(1 in {q['shadow_every']}), "
                f"{q.get('shadow_dispatches', 0)} dispatches scored, "
                f"{dr.get('n_drifted', 0)}/{dr.get('n_series', 0)} "
                f"series drifted")
        if "spec" in rep:
            sp = rep["spec"]
            say(f"[serve] spec: k={sp['k']} draft_cap={sp['draft_cap']} "
                f"acceptance {sp['acceptance_rate']:.2f} "
                f"({sp['tokens_accepted']}/{sp['tokens_drafted']} drafts "
                f"over {sp['rounds']} rounds, {sp['replays']} replays, "
                f"{sp['aborts']} aborts)")
        if args.stream:
            p0, g0 = reqs[0]
            streamed = list(eng.stream(p0, g0, interval=1))
            report["stream"] = {"tokens": len(streamed), "interval": 1}
            say(f"[serve] --stream: request 0 served again, {len(streamed)} "
                f"tokens streamed: {streamed}")
        if "prefix_cache" in rep:
            pc = rep["prefix_cache"]
            say(f"[serve] prefix cache: hit rate {pc['hit_rate']:.2f} "
                  f"({pc['prefix_hits']}/{pc['prefix_queries']} requests), "
                  f"{pc['pages_shared']} pages shared, "
                  f"{pc['chunks_skipped']} prefill chunks skipped, "
                  f"{pc['pages_cowed']} pages copy-on-written")
        if "sharding" in rep:
            sh = rep["sharding"]
            hiwater = sh.get('kv_pages_hiwater_per_shard',
                             sh.get('state_pages_hiwater_per_shard'))
            say(f"[serve] page mesh: {sh['n_shards']} shards "
                f"({sh['backend']}), kv pages hiwater/shard {hiwater}")
        if args.calibrate_capacity > 0 and args.mor != "dense":
            caps = eng.calibrate_capacities(quantile=args.calibrate_capacity)
            _, results_cal, rep_cal = run_engine(
                cfg, params, reqs, mor=mor, mor_mode=args.mor,
                n_slots=args.batch, max_len=max_len, capacities=caps,
                **engine_kw)
            report["per_layer_capacity"] = {
                k: np.asarray(v).round(4).tolist() for k, v in caps.items()}
            report["calibrated_tokens_per_s"] = rep_cal["tokens_per_s"]
            # the clamp drops live tiles past the chosen quantile: its
            # accuracy cost against the unclamped run, reported apart
            report["calibrated_token_agreement"] = token_agreement(results_cal,
                                                                   results)
            say(f"[serve] capacity-calibrated (q={args.calibrate_capacity}): "
                f"{rep_cal['tokens_per_s']:.1f} tok/s; per-layer capacity "
                f"{report['per_layer_capacity']}")
        if args.compare and args.mor != "dense":
            _, results_d, rep_d = run_engine(cfg, params, reqs, mor=None,
                                             mor_mode="dense",
                                             n_slots=args.batch,
                                             max_len=max_len, **engine_kw)
            agree = token_agreement(results, results_d)
            report["dense_tokens_per_s"] = rep_d["tokens_per_s"]
            report["token_agreement_vs_dense"] = agree
            say(f"[serve] dense baseline: {rep_d['tokens_per_s']:.1f} tok/s; "
                  f"token agreement {agree:.3f}")
        if args.baseline:
            tok_s, _, _ = static_batch(cfg, params, reqs, n_slots=args.batch,
                                       mor=mor, mor_mode=args.mor)
            report["static_batch_tokens_per_s"] = tok_s
            report["engine_speedup_vs_static"] = report["tokens_per_s"] / tok_s
            say(f"[serve] static-batch baseline: {tok_s:.1f} tok/s (engine "
                f"speedup {report['engine_speedup_vs_static']:.2f}x)")
        if obs is not None and (group is None or group.rank == 0):
            # written last, so that the files hold the final flush
            if args.metrics_json:
                obs.write_metrics_json(args.metrics_json)
            if args.trace_out:
                obs.write_trace(args.trace_out)
            tr = obs.tracer.summary()
            ttft = (tr.get("ttft") or {}).get("p50")
            itl = (tr.get("itl") or {}).get("p50")
            say(f"[serve] obs: {len(obs.registry.snapshot())} metric families"
                + (f", ttft p50 {ttft * 1e3:.1f} ms" if ttft else "")
                + (f", itl p50 {itl * 1e3:.2f} ms" if itl else "")
                + (f"; metrics -> {args.metrics_json}"
                   if args.metrics_json else "")
                + (f"; trace -> {args.trace_out}" if args.trace_out else ""))
    finally:
        if server is not None:
            server.close()
    if args.out_json and (group is None or group.rank == 0):
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
