"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU:

  python3 chip_smoke.py

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: the three MoR kernels compiled for sm_90a from
   ``src/repro_torch/kernels/csrc`` (seconds, ``-Xptxas -v`` lines);
3. each kernel against its plain PyTorch version at the slice's shapes
   (granite-3-2b gate/up: K=2048, N=8192; down: K=8192, N=2048; M=8 rows
   for a decode dispatch of 8 slots, M=256 for 8 slots x chunk 32), in
   bf16: masks and counters bit-equal, products within the tolerance
   below, each timed (CUDA events, L2 flushed between launches) beside
   its plain version, a one-call library yardstick and its bound;
4. the slice: a reduced float32 model served on the card in kernel mode
   must give the CPU plain versions' tokens; then granite-3-2b at full
   width (all 40 layers, bf16, random weights from a seed) is
   calibrated and serves a mixed trace of 8 requests through
   ``Engine(layout="slotted", mor_mode="kernel")`` — the launch counters
   are zeroed just before and read just after, and must equal 40 x
   dispatches (x 2 for gather_matmul) — then the same trace in tiled and
   dense mode, and once more in kernel mode at capacity 0.5;
5. the JSON kernels line, then the last line
   ``{"ok": true, "device": {...}}``.

It exits non-zero without a CUDA device, and no phase catches its own
failure.  It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
# bf16 product tolerance: kernel and plain version both sum bf16
# products (exact in float32) in float32, in different orders, then round
# to bf16.  Reassociation moves the float32 sum by far less than one bf16
# step, so the two results are the same bf16 value or neighbours: at
# most 2^-8 relative apart (RTOL doubles it), plus an absolute floor of
# 1e-3 x max|out| for outputs near zero where the relative bound is
# vacuous.
RTOL, ATOL_REL = 2.0 ** -7, 1e-3
# greedy-token agreement bar between the full-width kernel run and the
# tiled / dense runs.  Kernel and tiled differ only in summation order
# (bf16 rounding noise), dense also in skipping nothing; a near-tie in
# the random-weight logits can still flip one token and the rest of that
# request with it.  A broken kernel gives tokens unrelated to the other
# path's (agreement near 1/49155), so 0.25 separates the two.
AGREE_MIN = 0.25


def log(phase: str, **kw) -> None:
    print(f"[smoke] {phase}: " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("card", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())
    return smi


def phase_build():
    from repro_torch.kernels import build
    lib = build.build()
    lines = [ln.strip() for ln in build.LAST_BUILD["log"].splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    for ln in lines:
        print(f"[smoke] ptxas: {ln}", flush=True)
    log("build", seconds=round(build.LAST_BUILD["seconds"], 2),
        library=Path(lib).name)
    build.load()


# -- phase 3: kernels against their plain versions ---------------------------

def _timer(fn, flush, iters=10):
    """Mean device ms of ``fn`` over ``iters`` launches, each timed by
    its own CUDA event pair with the L2 cache flushed before it."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def _bound(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _close(got, want):
    import torch
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    lim = RTOL * w.abs() + ATOL_REL * float(w.abs().max())
    assert bool(torch.all((g - w).abs() <= lim)), \
        f"kernel disagrees with its plain version: max abs err {err}"
    return err


def kernel_case_mor(M, gen, flush):
    import torch
    from repro_torch.kernels import mor_predict as mp
    K, N = 2048, 8192
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    w = (torch.randn((K, N), generator=gen, device=dev)
         * K ** -0.5).bfloat16()
    dead = (torch.arange(N, device=dev) // 128) % 2 == 1
    coef = torch.stack([
        torch.rand(N, generator=gen, device=dev) * 0.04 + 0.01,
        torch.where(dead, -1e3, torch.randn(N, generator=gen, device=dev)),
        torch.rand(N, generator=gen, device=dev) + 0.5,
        torch.randn(N, generator=gen, device=dev) * 0.1,
        (dead | (torch.rand(N, generator=gen, device=dev) < 0.8)).float(),
        torch.zeros(N, device=dev)]).contiguous()
    pn = torch.where(dead[None, :], 1,
                     (torch.rand((M, N), generator=gen, device=dev) < 0.7
                      ).int()).to(torch.int8)
    pn[:, :3] = 2                                     # forced-skip sentinel
    pn = pn.contiguous()
    got = mp.mor_tile_mask(x, w, coef, pn)
    want = mp.mor_tile_mask_plain(x, w, coef, pn)
    torch.cuda.synchronize()
    diff = int((got != want).sum())
    assert diff == 0, f"mor_tile_mask: {diff} mask bits differ"
    live = float(want.float().mean())
    assert 0.0 < live < 1.0, live
    ms = _timer(lambda: mp.mor_tile_mask(x, w, coef, pn), flush)
    plain_ms = _timer(lambda: mp.mor_tile_mask_plain(x, w, coef, pn), flush)
    nbytes = (M * K * 2 + K * N * 2 + 6 * N * 4 + M * N
              + (M // 8) * (N // 128) * 4)
    bound_ms, by = _bound(nbytes, 2 * M * K * N, "int8")
    return {"max_abs_err": float(diff), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "frac_live": live}


def kernel_case_gather(M, gen, flush):
    import torch
    from repro_torch.kernels import gather_matmul as gm
    K, N = 2048, 8192
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    w = (torch.randn((K, N), generator=gen, device=dev)
         * K ** -0.5).bfloat16()
    nm, nn = M // 8, N // 128
    mask = torch.rand((nm, nn), generator=gen, device=dev) < 0.7
    cap = max(1, int(0.5 * nm * nn))
    got, gl, gc = gm.gather_matmul(x, w, mask, capacity=cap)
    want, wl, wc = gm.gather_matmul_plain(x, w, mask, capacity=cap)
    torch.cuda.synchronize()
    assert int(gl) == int(wl) and int(gc) == int(wc), "counters differ"
    err = _close(got, want)
    ms = _timer(lambda: gm.gather_matmul(x, w, mask, capacity=cap), flush)
    plain_ms = _timer(lambda: gm.gather_matmul_plain(x, w, mask,
                                                     capacity=cap), flush)
    lib_ms = _timer(lambda: torch.matmul(x, w), flush)
    flat = mask.reshape(-1)
    kept = (flat & (torch.cumsum(flat, 0) - 1 < cap)).reshape(nm, nn)
    n_comp = int(kept.sum())
    cols = int(kept.any(0).sum())
    rows = int(kept.any(1).sum())
    nbytes = cols * K * 128 * 2 + rows * 8 * K * 2 + M * N * 2
    bound_ms, by = _bound(nbytes, n_comp * 2 * 8 * 128 * K, "bf16")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms,
            "tiles_computed": n_comp, "tiles_live": int(wl)}


def kernel_case_kdim(M, gen, flush):
    import torch
    from repro_torch.kernels import masked_matmul as mm
    K, N = 8192, 2048
    dev = "cuda"
    mask = torch.rand((M // 8, K // 128), generator=gen, device=dev) < 0.6
    keep = mask.repeat_interleave(8, 0).repeat_interleave(128, 1)
    # the MoR contract: dead hidden blocks are exact zeros
    x = torch.where(keep, torch.randn((M, K), generator=gen, device=dev),
                    0.0).bfloat16()
    w = (torch.randn((K, N), generator=gen, device=dev)
         * K ** -0.5).bfloat16()
    got = mm.masked_matmul_kdim(x, w, mask)
    want = mm.masked_matmul_kdim_plain(x, w, mask)
    torch.cuda.synchronize()
    err = _close(got, want)
    ms = _timer(lambda: mm.masked_matmul_kdim(x, w, mask), flush)
    plain_ms = _timer(lambda: mm.masked_matmul_kdim_plain(x, w, mask),
                      flush)
    lib_ms = _timer(lambda: torch.matmul(x, w), flush)
    n_pairs = int(mask.sum())
    k_live = int(mask.any(0).sum())
    nbytes = n_pairs * 8 * 128 * 2 + k_live * 128 * N * 2 + M * N * 2
    bound_ms, by = _bound(nbytes, n_pairs * 2 * 8 * 128 * N, "bf16")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": lib_ms}


KERNELS = [
    ("mor_tile_mask", "src/repro_torch/kernels/csrc/mor_predict.cu",
     "src/repro/kernels/mor_predict.py:76", kernel_case_mor),
    ("gather_matmul", "src/repro_torch/kernels/csrc/gather_matmul.cu",
     "src/repro/kernels/gather_matmul.py:58", kernel_case_gather),
    ("masked_matmul_kdim", "src/repro_torch/kernels/csrc/masked_matmul.cu",
     "src/repro/kernels/masked_matmul.py:104", kernel_case_kdim),
]


def phase_kernels():
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for name, source, replaces, case in KERNELS:
        per_m = {}
        for M in (8, 256):
            r = case(M, gen, flush)
            per_m[M] = r
            log("kernel", name=name, M=M,
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, **_fields(per_m[8]),
                      "at_m256": _fields(per_m[256])}
    if torch.cuda.get_device_name(0).find("H100") < 0:
        log("kernel", note="bounds use the H100 SXM's published rates")
    return rows


def _fields(r):
    return {k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}


# -- phase 4: the slice ------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_reference():
    """Reduced float32 granite served in kernel mode on the card (CUDA
    kernels) and on the CPU (their plain versions): the same tokens and
    the same per-layer tile fractions."""
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.deploy import calibrate_lm
    from repro_torch.launch.serve import calib_batches, make_trace
    from repro_torch.models import get_model
    from repro_torch.serving import Engine
    cfg = reduce_config(get_config("granite-3-2b"))
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(SEED), cfg)
    params, mor, _ = calibrate_lm(params, cfg, api.forward,
                                  calib_batches(cfg, 4, "cpu"), 2)
    reqs = make_trace(cfg, 6, 4, 24, 6, 6, SEED)
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, _to(params, dev), mor=_to(mor, dev),
                     mor_mode="kernel", n_slots=4, max_len=32,
                     capacities={"mor_stats": 0.5})
        out[dev] = (eng.run(list(reqs)), eng.telemetry.summary())
    assert out["cuda"][0] == out["cpu"][0], "card and CPU tokens differ"
    assert out["cuda"][1] == out["cpu"][1], "card and CPU telemetry differ"
    log("reference", model="granite-3-2b reduced f32", requests=len(reqs),
        tokens_equal=True,
        frac_tiles_computed=out["cuda"][1]["mor_stats"][
            "frac_tiles_computed"])


def _serve(cfg, params, mor, mode, reqs, capacities=None):
    """One counted pass, then one timed pass; -> (tokens, report, engine)."""
    import torch
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, mor=mor, mor_mode=mode, n_slots=8,
                 max_len=max(len(p) for p, _ in reqs) + 18,
                 capacities=capacities)
    first = eng.run(list(reqs))
    dispatches = eng.counters["dispatches"]
    eng.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = eng.run(list(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    base = min(again)
    again = {rid - base: t for rid, t in again.items()}
    rep = eng.report()
    # not asserted: cuBLAS may pick another reduction order between
    # passes, and on random weights one near-tie flips a greedy token
    rep["repeat_agreement"] = _agree(again, first)
    rep["tokens_per_s"] = (rep["prefill_tokens"] + rep["decode_tokens"]) \
        / wall
    rep["first_pass_dispatches"] = dispatches
    return first, rep, eng


def _profile(eng, reqs):
    """One more pass under ``torch.profiler``, tracing the device only
    (recording host ops would slow the host loop it measures): device
    time by kernel, and the device's idle share of the pass's wall
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    eng.reset_counters()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(list(reqs))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    log("profile", mode=eng.mor_mode, dispatches=eng.counters["dispatches"],
        wall_ms=round(wall_us / 1e3, 2), device_busy_ms=round(busy / 1e3, 2),
        idle_share=round(1 - busy / wall_us, 4) if busy else "not measured")
    for key, us, n in rows[:12]:
        log("profile", mode=eng.mor_mode, kernel=repr(key[:60]), ms=round(us / 1e3, 3),
            calls=n, share=round(us / busy, 4))


def _agree(a, b):
    import numpy as np
    return float(np.mean([np.mean(np.asarray(a[r]) == np.asarray(b[r]))
                          for r in b]))


def phase_slice():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import calibrate_lm
    from repro_torch.kernels import gather_matmul as gm
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import mor_predict as mp
    from repro_torch.launch.serve import calib_batches, make_trace
    from repro_torch.models import get_model
    cfg = get_config("granite-3-2b")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(params))
    log("slice", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        d_ff=cfg.d_ff, dtype=cfg.dtype, params=n_params,
        init_s=round(time.perf_counter() - t0, 2))
    t0 = time.perf_counter()
    params, mor, cal = calibrate_lm(params, cfg, api.forward,
                                    calib_batches(cfg, 8, "cuda"), 4)
    torch.cuda.synchronize()
    log("slice", calibrate_s=round(time.perf_counter() - t0, 2),
        **{k: round(v, 4) for k, v in cal.items()})
    reqs = make_trace(cfg, 8, 8, 64, 16, 16, SEED)

    # the main path: counts zeroed just before, read just after
    mp.launches = gm.launches = mm.launches = 0
    tok_k, rep_k, eng_k = _serve(cfg, params, mor, "kernel", reqs)
    counted = rep_k["first_pass_dispatches"] + rep_k["dispatches"]
    launches = {"mor_tile_mask": mp.launches, "gather_matmul": gm.launches,
                "masked_matmul_kdim": mm.launches}
    want = {"mor_tile_mask": cfg.n_layers * counted,
            "gather_matmul": 2 * cfg.n_layers * counted,
            "masked_matmul_kdim": cfg.n_layers * counted}
    assert launches == want, (launches, want)
    assert all(v > 0 for v in launches.values())
    assert len(tok_k) == len(reqs)
    assert all(len(tok_k[i]) == g for i, (_, g) in enumerate(reqs))
    assert all(0 <= t < cfg.vocab_size for v in tok_k.values() for t in v)
    tel = rep_k["telemetry"]["mor_stats"]
    assert all(np.isfinite(tel["frac_tiles_live"]))
    log("slice", mode="kernel", tok_s=round(rep_k["tokens_per_s"], 2),
        repeat_agreement=round(rep_k["repeat_agreement"], 4),
        dispatches=rep_k["dispatches"], launches=json.dumps(launches),
        skip_frac_per_layer=[round(1 - v, 4)
                             for v in tel["frac_tiles_computed"]])

    tok_t, rep_t, _ = _serve(cfg, params, mor, "tiled", reqs)
    tok_d, rep_d, eng_d = _serve(cfg, params, None, "dense", reqs)
    agree_t, agree_d = _agree(tok_k, tok_t), _agree(tok_k, tok_d)
    first_t = float(np.mean([tok_k[r][0] == tok_t[r][0] for r in tok_t]))
    log("slice", mode="tiled", tok_s=round(rep_t["tokens_per_s"], 2),
        repeat_agreement=round(rep_t["repeat_agreement"], 4),
        agreement_kernel_vs_tiled=round(agree_t, 4),
        first_token_agreement=round(first_t, 4))
    log("slice", mode="dense", tok_s=round(rep_d["tokens_per_s"], 2),
        repeat_agreement=round(rep_d["repeat_agreement"], 4),
        agreement_kernel_vs_dense=round(agree_d, 4))
    assert agree_t >= AGREE_MIN and agree_d >= AGREE_MIN, (agree_t, agree_d)

    tok_c, rep_c, _ = _serve(cfg, params, mor, "kernel", reqs,
                          capacities={"mor_stats": 0.5})
    tel_c = rep_c["telemetry"]["mor_stats"]
    assert max(tel_c["frac_tiles_computed"]) <= 0.5 + 1e-6
    log("slice", mode="kernel", capacity=0.5,
        tok_s=round(rep_c["tokens_per_s"], 2),
        agreement_vs_capacity_1=round(_agree(tok_c, tok_k), 4),
        frac_tiles_computed_mean=round(
            float(np.mean(tel_c["frac_tiles_computed"])), 4))
    # profiled last, so that the profiler cannot touch the timings above
    _profile(eng_k, reqs)
    _profile(eng_d, reqs)
    log("slice", peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9,
                                   2))
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # a float32 reference is full float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_card()
    phase_build()
    rows = phase_kernels()
    phase_reference()
    launches = phase_slice()
    for name, n in launches.items():
        rows[name]["launches"] = n
    log("done", seconds=round(time.perf_counter() - t0, 1))
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
