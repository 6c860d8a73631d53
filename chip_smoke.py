"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU:

  python3 chip_smoke.py

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: the seven kernel sources compiled for sm_90a from
   ``src/repro_torch/kernels/csrc`` (seconds, one ``-Xptxas -v`` line per
   entry function: registers, shared memory, spills, and any warning);
3. each kernel against its plain PyTorch version at the slices' shapes,
   in bf16, each timed on the device (``launch/timing.py``: CUDA events,
   L2 flushed before each launch, the host's enqueue hidden behind a
   device spin) beside its plain version, a one-call library yardstick
   and its bound (``launch/roofline.py`` ``bound_ms`` of the kernel's
   ``work()`` on the case's inputs): the
   MoR kernels at granite-3-2b gate/up (K=2048, N=8192) and down
   (K=8192, N=2048) widths and at one model rank's half of them (N
   4,096 gate / up columns, K 4,096 down rows: the mesh's split FFN),
   M=8 rows for a decode dispatch of 8 slots,
   M=256 for 8 slots x chunk 32, M=512 and 2,048 for the static batch's
   prefill (8 prompts of 64 and of 256 tokens), the static cells' own
   prefills (``static_prefill_shapes``: granite's M = 8 x 53 = 424, a
   ragged last 64-row tile; deepseek's layer 0 at M = 8 x 183 = 1,464,
   d 5120, f 12288; its expert grid at the 68-row capacity of those
   1,464 tokens, padded to C = 72), and M=16,384 at
   qwen2-7b's FFN widths (d 3584, f 18944: a 16,384-token prompt's
   gate, up and down products, 3.1e8 output elements), and on the
   expert grid at
   deepseek-v2-236b's widths (E=160 experts, d=5120, f=1536, capacity
   C=8 and C=256, rows past each expert's count of a top-6 routing
   forced dead) and mixtral-8x7b's (E=8, d=4096, f=14336, top-2) (masks
   and counters bit-equal, products within the tolerance below); the two tensor-core matmuls (``gather_matmul``,
   ``masked_matmul_kdim``) also with garbage, not zeros, in every dead
   (row block, k block) pair of the down product's input, at ragged
   shapes (M = 24 and 72; a float32 gather at K = 144, N = 384; a down
   product with N = 300), twice on the same inputs (bit-equal: the
   split-K partials meet in a fixed order), and timed alone with the
   split plan built beforehand (``bare_ms``) and for the host's enqueue
   (``host_ms``); ``mor_tile_mask`` also bit-equal through
   ``ops.mor_tile_mask`` at a ragged M 24, K 104 / 100, N 130 in both
   dtypes and at TDS's float32 shape with a residual, beside
   ``binary_dot``'s time on its gate operands; ``gqa_paged_flash`` at a
   decode dispatch (8 slots x 1 row over ragged contexts up to 4,096
   tokens, 512 pages of 8, null entries, a page shared by two slots, a
   column-sliced table; also timed at every split of 1-8), a mixed
   dispatch (8 x 32 rows, contexts up to 96), the same 8 x 32 rows over
   the decode case's table (timed at every split of 1-8) and a small
   sliding-window case, then at the zoo's head geometries on the same tensor-core body
   over columns padded to 128 (qwen2-7b 28 / 4 heads at head dim 128,
   granite-20b's MQA 48 / 1, mixtral 32 / 8 under its 4,096 window over
   contexts up to 6,000, phi-3-vision 32 / 32 at head dim 96, zamba2-7b's
   shared attention 32 / 32 at head dim 112 under its 4,096 window; qwen2,
   granite-20b and zamba2 decode also at every split of 1-8, and qwen2's
   and zamba2's 8 x 32 rows over their decode tables; the split's edges
   at qwen2's and zamba2's geometry; the ptxas line of every
   tensor-core instantiation),
   and ``mla_paged_flash`` at the
   same decode and mixed table
   layouts with 128 heads, latent rank 512 and rope width 64, both on
   the rows that see a key, twice (bit-equal: the context split merges
   in rank order), with their split plans (and GQA's body), and at the
   split's edges (a rank whose range is wholly null, one whose keys are
   all masked, a one-page slot, an idle slot: exact zeros; GQA also
   under a window that masks whole ranks); the kernel API's
   ``binary_dot``, ``binary_dot_packed`` (bit-equal, also at a ragged
   M = 24, K = 104, N = 130) and ``masked_matmul`` (twice,
   bit-equal) at the granite gate widths, M = 8 and 256, with
   ``torch._int_mm`` on int8 signs (at M = 8 padded to 32 rows) and
   ``torch.matmul`` as yardsticks, each kernel timed alone (``ms``) and
   through its ``ops`` wrapper (``wrapper_ms``); ``binary_dot`` also
   bit-equal at its sign edges (-0.0 weights, NaN in x and w, a ragged
   K of 100); then the speculative path's shapes (``kernel_spec``):
   ``mor_tile_mask`` at a verify's M 40 (8 slots x k + 1 = 5 rows),
   ``gather_matmul`` at M 8 and 40 under a draft budget of ceil(cap x
   tiles) at caps 0.5 and 0.25 and ``masked_matmul_kdim`` on the input
   that clamped gather leaves, ``gqa_paged_flash`` and
   ``mla_paged_flash`` at a verify of 5 rows a slot over the decode
   table (GQA's pages also holding stale draft rows past the committed
   position, which must change no bit);
4. the references: reduced float32 models served on the card must give
   the CPU plain versions' tokens, telemetry and prefix counters:
   granite on the slotted layout and on the paged layout (sliding
   window 16, so that prompts wrap the ring over shared pages: prefix
   hits, skipped chunks and copy-on-write), and deepseek-v2 (MLA + MoE)
   on the paged layout with per-expert budgets, qwen2-7b, granite-20b,
   mixtral (window 16) and phi-3-vision with their published head
   geometry on the paged layout, all in kernel mode; rwkv6-3b (state
   pages only) and zamba2-7b (state pages and its shared attention's
   kv pages, 32 / 32 heads at D 112 under a shared window of 16) paged
   and slotted in kernel mode, state snapshots taken and restored;
   hubert-xlarge's forward logits on frames, dense and kernel, within
   LOGIT_RTOL; the
   four paper DNNs (TDS, CNN10, ResNet18, Darknet19) in exact, tiled and
   kernel mode with every binary rookie enabled: logits within
   LOGIT_RTOL, predictor masks equal except where the CPU's proxy
   pre-activation or p_hat lies within MARGIN_EPS of 0; self-speculative
   decoding (``reference_spec``, k 3) on reduced granite, rwkv6 and
   zamba2: greedy drafts in dense mode and kernel mode at draft_cap 0.5
   (tokens and spec counters equal the CPU's; dense also vanilla's),
   temperature-1.0 drafts in dense mode (vanilla's greedy tokens) and,
   on granite and rwkv6, a spill forced mid-speculation; deepseek's one
   spec pass (``mla_paged_flash`` at 4 rows a slot);
3b. the shard-window, partial forms of both paged kernels in bf16: each
   pool split into 4 windows (``lo = i n_local``), every window's
   partial launch against its plain version (m bit-equal at the -1e30
   sentinel, l exact there, m / l / acc within the bf16 bar elsewhere),
   the 4 windows merged (``collectives.merge_stacked``) against the
   single-pass kernel and plain version: granite's decode (timed, one
   window: device ms, plain, bound, SDPA on the window's pre-gathered
   K/V as a yardstick that computes no statistics) and mixed dispatch,
   qwen2-7b's G 7 at D 128 and zamba2-7b's D 112 under its 4,096 window
   (timed too), and deepseek's MLA (timed at decode);
4b. the train step's reference (``reference_train``): reduced float32
   granite, three steps of ``make_train_step`` at grad_accum 2 on the
   card, each from the CPU's state before it, held to the CPU's step
   (loss, grad norm, lr, moments, params) within the CPU tests'
   tolerances, then three free-running steps (loss differences logged);
5. the granite slice: granite-3-2b at full width (4 of its 40 layers,
   bf16, random weights from a seed) is calibrated, then serves
   - 8 mixed requests through ``Engine(layout="slotted",
     mor_mode="kernel")``, then tiled, dense and kernel at capacity 0.5;
   - 12 requests of a 128-token shared prefix plus 8-64 unique tokens
     (two identical, of page-aligned length) through
     ``Engine(layout="paged", mor_mode="kernel")``, then paged dense and
     slotted kernel on the same trace;
   - the 8 mixed requests through the static batch (``launch.serve.
     static_batch``, the serve CLI's ``--baseline``: left-padded to the
     longest prompt, one batched ``prefill``, 1-row decode steps) in
     kernel (counted: 4 / 8 / 4 launches of mor_tile_mask /
     gather_matmul / masked_matmul_kdim a dispatch), tiled and dense
     mode, tokens/s beside the slotted engine's; ``launch.steps.
     make_serve_step`` (``prefill`` then 16 ``decode_step``s over
     ``cache_init``'s cache) in kernel (counted) and dense mode against
     ``generate``'s dense tokens; one profiled kernel-mode static decode
     pass (idle share, host ms a step);
5b. speculation and SLO scheduling on that granite-3-2b (paged, kernel
   mode; ``phase_spec`` / ``phase_slo``): the mixed trace with 32 new
   tokens each, vanilla then spec_k 4 at draft_cap 0 / 0.5 / 0.25
   (acceptance, tokens a round, pass s, host ms a dispatch, agreement
   with vanilla, launches over every draft and verify dispatch, a
   decode's, a draft's and a verify's device ms profiled apart, one
   profiled warm pass); the
   same trace on a kv pool 4 pages short (spills, restores, bytes, ms
   each, agreement with the unpressured run); a ~10 s open-loop Poisson
   trace at 1.5x the sustained rate under ``policy="priority"`` (TTFT
   p50 / p99 per class, preemptions, rejections, requests lost: 0);
5c. training (``phase_train``): granite-3-2b at 4 layers (bf16,
   remat nothing_saveable, its grad_accum of 4) trained 8 steps on 8 x
   512 tokens through ``launch.steps.make_train_step`` (AdamW: bf16
   moments, float32 master): step ms, tokens/s, the model-FLOPs share
   (6 N T over the step and 989 TFLOP/s), AdamW's device ms, peak
   memory, losses, grad norm, one profiled step; a resume check at
   full width cut to 2 layers (4 straight steps against 2, a save of
   the 2.2 GB state to a temporary directory, a restore into another
   seed's tree, 2 more: losses within RESUME_TOL); then the train CLI's
   calibration step (``launch.train.calibrate``: ``calibrate_lm`` on 8
   batches of 8 x 512 from step 10,000) and the mixed trace served on
   the trained weights, slotted, in kernel mode (counted: 4 / 8 / 4
   a dispatch) held to tiled at AGREE_MIN, skip fractions beside the
   granite phase's random-init ones;
5d. the dry run (``phase_dryrun``, ``launch/dryrun.py``): granite-3-2b
   at 4 layers, the train phase's cell (8 x 512 tokens, grad_accum 4,
   remat) and a ``make_serve_step`` decode at B 8 over 4,096 positions, each
   predicted on the meta device (argument bytes and the peak of the
   storages the step allocates, ``launch/op_cost.py``; FLOPs; the
   roofline bound at the H100 SXM's data-sheet rates) and then run on
   the card: the predicted peak within 10% of ``max_memory_allocated``
   over what was allocated before, the FLOPs counted on the card equal
   to meta's, the bound beside the CUDA-event ms; then the 40-cell meta
   grid, one line a cell (``DRYRUN_GRID_CELLS`` run here, the rest
   named: they take minutes of the host's CPU);
5e. the production mesh's dry run (``phase_dryrun_mesh``), each in a
   process of its own on torch's fake process group: rank 0 of the
   256-rank pod for granite-3-2b train_4k and deepseek-v2-236b
   decode_32k (GiB a rank, fits, the roofline with its collective
   term split between NVLink and InfiniBand: reckoned, not measured),
   and the prediction of 7d's (1, 2) granite (under "fsdp_tp" and
   "contract_tp"), rwkv6-3b and zamba2-7b steps, held there;
6. the deepseek slice: deepseek-v2-236b at its published widths,
   cut to 3 layers, calibrated with ``calibrate_moe``, serves the same
   shared-prefix trace through ``Engine(layout="paged")`` in kernel,
   tiled and dense mode, then a profiled pass of each;
   then the static batch on that trace in kernel (counted: 3 / 6 / 3 a
   dispatch, the MoE layers' on the expert grid) and dense mode and
   ``make_serve_step`` through ``mla_prefill`` / ``mla_decode``;
   every paged pass is timed a second time on its warm prefix cache
   and run a third time with the cache cleared (``repeat_agreement`` /
   ``cold_repeat_agreement`` against the first pass's greedy tokens);
   each counted path has its launch counters zeroed just before and
   read just after: per dispatch one launch per layer of the predictor,
   the down product and the layer's paged attention, two of
   gather_matmul (an MoE layer launches each once for all its experts);
7. the zoo: mixtral-8x7b at its published widths, cut to 2 layers,
   calibrated with ``calibrate_moe``, serves the shared-prefix trace
   plus one 4,160-token prompt (past its 4,096 window) through the
   paged engine in kernel (counted), tiled and dense mode, then a
   profiled pass of each, after one layer's attention at S 8,192 under
   the 4,096 window through ``_banded`` against the full (S, S) mask
   (each row's error over its scale against float32, beside the full
   bf16 path's; ms, peak memory); qwen2-7b (4 of 28 layers) the same trace
   in kernel (counted) and dense mode, then one 16,384-token prompt
   through ``make_prefill_step``'s batched ``prefill`` (every layer's
   attention through the chunked softmax ``_flash``; kernel mode
   counted: 4 / 8 / 4) in kernel and dense mode: seconds and peak
   memory, after one layer's attention at S 4,608 through ``_flash``
   against the full mask; and hubert-xlarge whole (48 layers)
   calibrated on frames, one 8 x 512 frame forward in dense and kernel
   mode (counted): ms and argmax agreement;
7b. the recurrent families: rwkv6-3b (2 of 32
   layers, d 2560, bf16), calibrated with ``calibrate_lm`` on its
   channel mix, serves the shared-prefix trace paged in kernel
   (counted: 2 mor_tile_mask and 2 gather_matmul a dispatch), tiled
   and dense mode and slotted in kernel mode; zamba2-7b (7 of 81
   layers, d 3584, 32 / 32 heads at D 112, bf16), calibrated with
   ``calibrate_hybrid``, serves the shared-prefix trace plus one
   4,160-token prompt (its shared attention's ring wraps past the 4,096
   window) paged in kernel (counted: 1 gqa_paged_flash, 1
   mor_tile_mask, 2 gather_matmul, 1 masked_matmul_kdim a dispatch)
   and dense mode; the warm and cold repeats run on state snapshots;
   one profiled pass each;
7c. this slice's main path, the paged-sharded layout on 2 rank
   processes sharing the card (gloo): reduced float32 granite,
   deepseek, rwkv6 and zamba2, card against CPU in the same page group
   (tokens, telemetry, prefix counters equal; partial launches and
   merges counted), then granite-3-2b at 4 layers in kernel mode on
   the shared-prefix trace (ranks' tokens equal, agreement with the
   single-rank paged tokens >= AGREE_MIN, 4 partial gqa_paged_flash
   launches and 4 merges a dispatch, no other collective, pages on
   both shards, each rank's pool half the single-rank one's); the
   page-sharded shadow step (the dense twin at 1 in 4) on reduced
   float32 granite and rwkv6 and on granite at 4 layers: tokens equal
   shadow-off's, the metrics block's counters equal to one device's
   paged engine with the twin on (the float32 references: every lane),
   the twin's partial launches and merges counted;
7d. the (data, model) mesh on 2 gloo rank processes sharing the card:
   granite-3-2b at full width cut to 2 layers, two train steps on (1,
   2) and (2, 1) against one device (loss, the clip norm beside a fault
   planted in it, params after each step) and their float32 twin on
   (1, 2), its decode on (1, 2) and a reduced float32 granite's tokens
   equal; deepseek-v2-236b cut to 2 layers, calibrated, expert slicing
   at 80 experts a rank (per-expert masks and counters bit-equal on a
   shared input, the whole forward's expert-grid launches on both
   ranks); the (1, 2) granite step as 5e predicted it (collectives,
   bytes by kind, FLOPs and argument bytes equal; the step's peak
   within 10%); this slice's tensor-parallel families at their
   published widths (``MESH_FAMILIES``): deepseek-v2-236b cut to 2
   layers and 8 routed experts (head-parallel MLA), rwkv6-3b cut to 2
   layers and zamba2-7b to 7 (one shared block), each a (1, 2) train
   step against one device, a first step from the seed's weights on
   each of two batches (loss and norm at granite's bf16 bound, deepseek's
   float32 twin at 1e-5, rwkv6's and zamba2's params within one bf16
   step), its kernel-mode forward on (1, 2) after a
   calibration (rwkv6's channel mix with every odd tile dead and
   zamba2's shared MLP split by column under the plan: MoR launches
   counted on both ranks, each rank's tile masks, kept tiles and
   summed counters held to its column block of one device's
   (``_check_mor_masks``), tokens equal on the ranks, agreement with
   one device's) and its step as 5e predicted it;
   every family's step ms and peak GB a rank beside the same step with
   its splits gathered (``_splits_gathered``); rwkv6's and zamba2's
   float32 twins at 1e-5 (``MESH_F32_CUTS``: rwkv6 2 layers, zamba2
   one mamba layer and the shared block), the planted fault past the
   bound; "contract_tp" (``sharding_rules.use`` moving the contraction
   splits onto the forms' dims): granite's 2-layer train step on (1, 2)
   in bf16 (1e-3, params held) and float32 (1e-5) against one device,
   its ms and peak GB beside the same step with the moves off
   (``_moves_off``), its float32 twin's greedy tokens equal to one
   device's, its step as 5e predicted it, and granite's MoR-active
   FFN split by column (``_mesh_mor_granite``: calibrated in float32,
   every odd tile dead, ``cap_live`` 0.34 biting mid-row): the bf16
   kernel-mode forward's tile masks, kept tiles and summed counters
   against each rank's column block of one device's (a differing tile
   only where a proxy's ReLU input lies within float32 rounding of
   zero), 2 / 4 / 2 launches of rows 1-3 a rank, the exchanges' counts
   and bytes by name, ms and peak GB beside the same forward with the
   FFN gathered whole, the float32 twin's greedy decode under the plan
   equal to one device's and the bf16 one's at AGREE_MIN, and the
   calibrated plan's live and proxy tiles by column block at model 2
   and 16; zamba2 cut as its float32 twin, its
   bf16 step at 1e-3; where 4 cards are visible, the (2, 2) mesh over
   them on NCCL (granite at 8 layers, held the same way);
8. the paper's slice: the four DNNs at full width (random init, BN
   stats from train-mode forwards, calibrated), 128 images
   (TDS 32 x 256 frames) in dense, exact, tiled and kernel mode:
   Pearson, enabled fraction, the Fig. 12 breakdown, frac_computed,
   argmax agreement with dense and forward ms; counted: TDS's
   kernel-mode forward (one mor_tile_mask and gather_matmul a layer)
   and the kernel API on every conv layer with K % 8 == 0, fed the
   live im2col patches, permuted weights and predicted tiles
   (``binary_dot`` bit-equal to ``binary_preact``, the packed form to
   ``binary_dot``, ``masked_matmul`` within tolerance and its count the
   mask's sum), timed at Darknet19's layer 13 (M = 128, K = 9 x 512, N
   = 1024) and ResNet18's layer 1 (M = 131072, K = 9 x 64, N = 64);
9. the card line again, the JSON kernels line, then the last line
   ``{"ok": true, "device": {...}}``.  Each phase logs its seconds.

It exits non-zero without a CUDA device, and no phase catches its own
failure.  It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
# the port's timing and roofline modules (CUDA-event timing; the H100
# SXM's data-sheet rates and each kernel's bound), imported by main()
# once the checkout's src/ is on the path
timing = roofline = None
# bf16 product tolerance: kernel and plain version both sum bf16
# products (exact in float32) in float32, in different orders, then round
# to bf16.  Reassociation moves the float32 sum by far less than one bf16
# step, so the two results are the same bf16 value or neighbours: at
# most 2^-8 relative apart (RTOL doubles it), plus an absolute floor of
# 1e-3 x max|out| for outputs near zero where the relative bound is
# vacuous.
RTOL, ATOL_REL = 2.0 ** -7, 1e-3
# float32 product tolerance (the paper DNNs' operands): kernel and plain
# version both sum float32 products in float32, in different orders (no
# TF32 anywhere): a few float32 steps apart, far inside 1e-5 relative
RTOL_F32, ATOL_REL_F32 = 1e-5, 1e-5
# greedy-token agreement bar between the full-width kernel run and the
# tiled / dense / slotted runs.  Kernel and tiled differ only in
# summation order (bf16 rounding noise), dense also in skipping nothing,
# slotted in the attention's summation order; a near-tie in
# the random-weight logits can still flip one token and the rest of that
# request with it.  A broken kernel gives tokens unrelated to the other
# path's (agreement near 1/49155), so 0.25 separates the two.
AGREE_MIN = 0.25
# Depth of each model served or trained at its published widths (of 40,
# 28, 32, 32 and 81 layers).  Every check holds at any depth, and the
# host's enqueue, which takes most of a dispatch, grows with it: at
# these depths the whole run, the kernels' build included, ends in
# about half of the 1,200 s it is given.
DEPTH = {"granite-3-2b": 4, "qwen2-7b": 4, "mixtral-8x7b": 2,
         "rwkv6-3b": 2, "zamba2-7b": 7}


def _cut_config(arch):
    """``arch``'s published config cut to ``DEPTH[arch]`` layers."""
    from repro_torch.configs import get_config
    return get_config(arch).replace(n_layers=DEPTH[arch])


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
    """Build the kernels; one line per compiled entry function with what
    ``-Xptxas -v`` says of it (registers, shared memory, spills)."""
    import re
    from repro_torch.kernels import build
    lib = build.build()
    entry, spill, lines = None, "", {}
    for ln in build.LAST_BUILD["log"].splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry, spill = m.group(1), ""
        elif entry and "spill" in ln:
            spill = ln.split(",", 1)[-1].strip()
        elif entry and "registers" in ln:
            lines[entry] = f"{ln.split(':', 1)[-1].strip()}; {spill}"
            print(f"[smoke] ptxas: {entry[:72]}: {lines[entry]}",
                  flush=True)
        elif "warning" in ln.lower():
            print(f"[smoke] ptxas: {ln.strip()[:200]}", flush=True)
    log("build", seconds=round(build.LAST_BUILD["seconds"], 2),
        library=Path(lib).name)
    build.load()
    return lines


# -- phase 3: kernels against their plain versions ---------------------------

def _close(got, want, f32=False):
    """Max abs err of ``got`` against ``want``, asserted within the
    tolerance of the operands' type: bfloat16 (RTOL, ATOL_REL), or
    float32 (RTOL_F32, ATOL_REL_F32) when ``f32``."""
    import torch
    g, w = got.float(), want.float()
    rtol, atol_rel = (RTOL_F32, ATOL_REL_F32) if f32 else (RTOL, ATOL_REL)
    err = float((g - w).abs().max())
    lim = rtol * w.abs() + atol_rel * float(w.abs().max())
    assert bool(torch.all((g - w).abs() <= lim)), \
        f"kernel disagrees with its plain version: max abs err {err}"
    return err


def kernel_case_mor(M, gen, flush, K=2048, N=8192):
    import torch
    from repro_torch.kernels import binary_dot as bd
    from repro_torch.kernels import mor_predict as mp
    from repro_torch.kernels import split_k
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
    _repeat_equal(lambda: mp.mor_tile_mask(x, w, coef, pn), "mor_tile_mask")
    ms = timing.device_ms(lambda: mp.mor_tile_mask(x, w, coef, pn), flush)
    plain_ms = timing.device_ms(
        lambda: mp.mor_tile_mask_plain(x, w, coef, pn), flush)
    # the yardstick of the product part: binary_dot's sign product of the
    # same x and w (no one PyTorch call computes the mask: library null)
    bd_ms = timing.device_ms(lambda: bd.binary_dot(x, w), flush)
    bound_ms, by = roofline.bound_ms(*mp.work(x, w, coef, pn))
    return {"max_abs_err": float(diff), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "binary_dot_ms": bd_ms, "frac_live": live,
            "plan": list(mp.plan(1, M, K, N, sms=split_k.sm_count(x.device)))}


def _mor_coefs(gen, N, dev="cuda"):
    """A MoRLayer's coef fields over N columns: every odd 128-column tile
    gets an intercept far below zero (dead where the proxy agrees), the
    rest sit around zero."""
    import torch
    dead = (torch.arange(N, device=dev) // 128) % 2 == 1
    return {"m": torch.rand(N, generator=gen, device=dev) * 0.04 + 0.01,
            "b": torch.where(dead, -1e3, torch.randn(N, generator=gen,
                                                     device=dev)),
            "bn_scale": torch.rand(N, generator=gen, device=dev) + 0.5,
            "bn_bias": torch.randn(N, generator=gen, device=dev) * 0.1,
            "enable": dead | (torch.rand(N, generator=gen, device=dev)
                              < 0.8)}


def mor_edges(gen, flush):
    """``mor_tile_mask`` bit-equal to its plain version off granite's
    shapes: through ``ops.mor_tile_mask`` (its padding: forced-skip rows
    and columns, the compensated intercept) at a ragged M 24, N 130 with
    K 104 (16-byte chunks) and K 100 (element loads), in both dtypes,
    with and without a residual, against the same call on the CPU; and
    at TDS's float32 shape (8192 rows, K 144, N 288 padded to 384) with
    a residual, against the plain version on the card, timed.  -> {case:
    result} (mask bits differing: 0, asserted)."""
    import torch
    from repro_torch.kernels import mor_predict as mp
    from repro_torch.kernels import ops
    from repro_torch.kernels import split_k
    dev = "cuda"
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        for K in (104, 100):
            M, N = 24, 130
            x = torch.randn((M, K), generator=gen, device=dev).to(dt)
            w = (torch.randn((K, N), generator=gen, device=dev)
                 * K ** -0.5).to(dt)
            mor = _mor_coefs(gen, N)
            pn = (mor["b"] < -10)[None, :] | (torch.rand(
                (M, N), generator=gen, device=dev) < 0.7)
            res = torch.randn((M, N), generator=gen, device=dev) * 2.0
            d = 0
            for r in (None, res):
                got = ops.mor_tile_mask(x, w, mor, pn, residual=r)
                want = ops.mor_tile_mask(
                    x.cpu(), w.cpu(), {k: v.cpu() for k, v in mor.items()},
                    pn.cpu(), residual=None if r is None else r.cpu())
                d += int((got.cpu() != want).sum())
            tag = f"m{M}_k{K}_n{N}_{str(dt)[6:]}"
            assert d == 0, f"mor_tile_mask {tag}: {d} mask bits differ"
            out[tag] = {"mask_bits_differing": d}
    # TDS's FC1 predictor: float32, K 144, N 288 padded to 384 (coef 0,
    # proxy 2 past 288), 32 x 256 frames, the residual row on
    M, K, N, Nr = 8192, 144, 384, 288
    x = torch.randn((M, K), generator=gen, device=dev)
    w = torch.randn((K, N), generator=gen, device=dev) * K ** -0.5
    mor = _mor_coefs(gen, N)
    coef = torch.stack([mor["m"], mor["b"], mor["bn_scale"],
                        mor["bn_bias"], mor["enable"].float(),
                        torch.ones(N, device=dev)])
    coef[:, Nr:] = 0.0
    # the proxy agrees on the dead tiles (so they stay dead), and is
    # random elsewhere
    dead = mor["b"] < -10
    pn = torch.where(dead[None, :], 1, (torch.rand(
        (M, N), generator=gen, device=dev) < 0.7).int()).to(torch.int8)
    pn[:, Nr:] = 2
    res = torch.randn((M, N), generator=gen, device=dev) * 2.0
    got = mp.mor_tile_mask(x, w, coef, pn, res)
    want = mp.mor_tile_mask_plain(x, w, coef, pn, res)
    torch.cuda.synchronize()
    d = int((got != want).sum())
    assert d == 0, f"mor_tile_mask (TDS): {d} mask bits differ"
    live = float(want.float().mean())
    assert 0.0 < live < 1.0, live
    bound_ms, by = roofline.bound_ms(*mp.work(x, w, coef, pn, res))
    out["tds_f32_residual"] = {
        "mask_bits_differing": d, "frac_live": live,
        "ms": timing.device_ms(
            lambda: mp.mor_tile_mask(x, w, coef, pn, res), flush),
        "plain_ms": timing.device_ms(
            lambda: mp.mor_tile_mask_plain(x, w, coef, pn, res), flush),
        "bound_ms": bound_ms, "bound_by": by,
        "plan": list(mp.plan(1, M, K, N, sms=split_k.sm_count(x.device)))}
    for tag, r in out.items():
        log("kernel", name="mor_tile_mask", case=tag,
            **{k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in r.items()})
    return out


def _repeat_equal(fn, what):
    """Two launches on the same inputs give the same bits (the split-K
    partials meet in a fixed order)."""
    import torch
    a, b = fn(), fn()
    assert torch.equal(a, b), f"{what}: two launches differ"


def _gather_checks(x, w, mask, cap, cap_live=None):
    """gather_matmul against its plain version (counters equal, products
    within the operands' tolerance) and against itself -> max abs err."""
    import torch
    from repro_torch.kernels import gather_matmul as gm
    got, gl, gc = gm.gather_matmul(x, w, mask, capacity=cap,
                                   cap_live=cap_live)
    want, wl, wc = gm.gather_matmul_plain(x, w, mask, capacity=cap,
                                          cap_live=cap_live)
    torch.cuda.synchronize()
    assert torch.equal(gl, wl) and torch.equal(gc, wc), "counters differ"
    assert gl.dtype == gc.dtype == torch.int32
    err = _close(got, want, f32=x.dtype == torch.float32)
    _repeat_equal(lambda: gm.gather_matmul(x, w, mask, capacity=cap,
                                           cap_live=cap_live)[0],
                  "gather_matmul")
    return err


def _gather_bare_ms(x, w, mask, cap, flush, cap_live=None):
    """The kernel alone: the split plan built beforehand (the kernel
    ranks the live tiles itself)."""
    from repro_torch.kernels import gather_matmul as gm
    plan = gm.plan(x, w, cap)
    return timing.device_ms(lambda: gm.launch(x, w, mask, capacity=cap,
                                    cap_live=cap_live, split_plan=plan),
                  flush)


def kernel_case_gather(M, gen, flush, K=2048, N=8192, draft_cap=None):
    """``draft_cap`` sets the budget as a draft plan's clamp does: the
    first ceil(draft_cap x tiles) live tiles (row-major); the case then
    also returns the kept tile mask under ``"_kept"``."""
    import math
    import torch
    from repro_torch.kernels import gather_matmul as gm
    dev = "cuda"
    x = torch.randn((M, K), generator=gen, device=dev).bfloat16()
    w = (torch.randn((K, N), generator=gen, device=dev)
         * K ** -0.5).bfloat16()
    nm, nn = M // 8, N // 128
    mask = torch.rand((nm, nn), generator=gen, device=dev) < 0.7
    cap = (max(1, int(0.5 * nm * nn)) if draft_cap is None
           else max(1, math.ceil(draft_cap * nm * nn)))
    err = _gather_checks(x, w, mask, cap)
    call = functools.partial(gm.gather_matmul, x, w, mask, capacity=cap)
    ms, host_ms = timing.device_ms(call, flush), timing.host_ms(call)
    bare_ms = _gather_bare_ms(x, w, mask, cap, flush)
    plain_ms = timing.device_ms(lambda: gm.gather_matmul_plain(x, w, mask,
                                                     capacity=cap), flush)
    lib_ms = timing.device_ms(lambda: torch.matmul(x, w), flush)
    lib_host_ms = timing.host_ms(lambda: torch.matmul(x, w))
    flat = mask.reshape(-1)
    kept = (flat & (torch.cumsum(flat, 0) - 1 < cap)).reshape(nm, nn)
    n_comp = int(kept.sum())
    bound_ms, by = roofline.bound_ms(*gm.work(x, w, mask, capacity=cap))
    r = {"max_abs_err": err, "ms": ms, "bare_ms": bare_ms,
         "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
         "library_ms": lib_ms, "host_ms": host_ms,
         "library_host_ms": lib_host_ms, "tiles_computed": n_comp,
         "plan": list(gm.plan(x, w, cap))}
    if draft_cap is not None:
        r.update(capacity=cap, tiles_live=int(mask.sum()), _kept=kept)
    return r


def _kdim_checks(x, w, mask):
    """masked_matmul_kdim against its plain version, then again with
    garbage (not zeros) in every dead (row block, k block) pair of x:
    the kernel must give the zeroed input's bits, as the Pallas kernel
    skips those pairs; two launches bit-equal -> max abs err."""
    import torch
    from repro_torch.kernels import masked_matmul as mm
    f32 = x.dtype == torch.float32
    got = mm.masked_matmul_kdim(x, w, mask)
    err = _close(got, mm.masked_matmul_kdim_plain(x, w, mask), f32=f32)
    keep = mask.repeat_interleave(8, -2).repeat_interleave(128, -1)
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    noise = (torch.randn(x.shape, generator=gen, device=x.device)
             + 3.0).to(x.dtype)
    xg = torch.where(keep, x, noise)
    assert bool(torch.all(xg[~keep] != 0)), "garbage must not be zero"
    got_g = mm.masked_matmul_kdim(xg, w, mask)
    torch.cuda.synchronize()
    assert torch.equal(got_g, got), "garbage in a dead pair leaked"
    err = max(err, _close(got_g, mm.masked_matmul_kdim_plain(xg, w, mask),
                          f32=f32))
    _repeat_equal(lambda: mm.masked_matmul_kdim(xg, w, mask),
                  "masked_matmul_kdim")
    return err


def kernel_case_kdim(M, gen, flush, K=8192, N=2048, mask=None):
    """``mask`` (M / 8, K / 128): the live (row block, k block) pairs, by
    default 60% at random."""
    import torch
    from repro_torch.kernels import masked_matmul as mm
    dev = "cuda"
    if mask is None:
        mask = torch.rand((M // 8, K // 128), generator=gen, device=dev) \
            < 0.6
    keep = mask.repeat_interleave(8, 0).repeat_interleave(128, 1)
    # the MoR contract: dead hidden blocks are exact zeros (the garbage
    # check in _kdim_checks fills them)
    x = torch.where(keep, torch.randn((M, K), generator=gen, device=dev),
                    0.0).bfloat16()
    w = (torch.randn((K, N), generator=gen, device=dev)
         * K ** -0.5).bfloat16()
    err = _kdim_checks(x, w, mask)
    call = functools.partial(mm.masked_matmul_kdim, x, w, mask)
    ms, host_ms = timing.device_ms(call, flush), timing.host_ms(call)
    plan = mm.plan(x, w)
    bare_ms = timing.device_ms(lambda: mm.launch_kdim(x, w, mask, plan), flush)
    plain_ms = timing.device_ms(
        lambda: mm.masked_matmul_kdim_plain(x, w, mask), flush)
    lib_ms = timing.device_ms(lambda: torch.matmul(x, w), flush)
    lib_host_ms = timing.host_ms(lambda: torch.matmul(x, w))
    bound_ms, by = roofline.bound_ms(*mm.work_kdim(x, w, mask))
    return {"max_abs_err": err, "ms": ms, "bare_ms": bare_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms, "host_ms": host_ms,
            "library_host_ms": lib_host_ms, "plan": list(plan)}


def kernel_ragged(gen):
    """The two redesigned kernels where the last 64-row group is partial
    (M = 24 and 72): gather_matmul in bf16 at granite's gate width and in
    float32 at TDS's FC1 contraction (K = 144, N = 384), and
    masked_matmul_kdim with a column tail (N = 300) and garbage in its
    dead pairs; each within tolerance of its plain version, two launches
    bit-equal.  -> {case: max abs err}."""
    import torch
    dev = "cuda"
    errs = {}
    for M in (24, 72):
        for dt, K, N in ((torch.bfloat16, 2048, 8192),
                         (torch.float32, 144, 384)):
            x = torch.randn((M, K), generator=gen, device=dev).to(dt)
            w = (torch.randn((K, N), generator=gen, device=dev)
                 * K ** -0.5).to(dt)
            nm, nn = M // 8, N // 128
            mask = torch.rand((nm, nn), generator=gen, device=dev) < 0.7
            cap = max(1, (3 * nm * nn) // 4)
            tag = f"gather_m{M}_k{K}_n{N}_{str(dt)[6:]}"
            errs[tag] = _gather_checks(x, w, mask, cap)
        K, N = 1024, 300
        mask = torch.rand((M // 8, K // 128), generator=gen, device=dev) < 0.6
        keep = mask.repeat_interleave(8, 0).repeat_interleave(128, 1)
        x = torch.where(keep, torch.randn((M, K), generator=gen, device=dev),
                        0.0).bfloat16()
        w = (torch.randn((K, N), generator=gen, device=dev)
             * K ** -0.5).bfloat16()
        errs[f"kdim_m{M}_k{K}_n{N}_bfloat16"] = _kdim_checks(x, w, mask)
    for tag, err in errs.items():
        log("kernel", ragged=tag, max_abs_err=err)
    return errs


def _paged_inputs(gen, ctx, C, W, extra_cols=8, n_null=0, page=8, hkv=8,
                  G=4, D=64, stale=0):
    """A paged pool holding slot b's first ``ctx[b]`` positions (its last
    page partly written), the C query rows ending at position ctx[b] - 1,
    a table that is a column slice of a wider one, ``n_null`` null
    entries inside the written range of every slot but the first (never
    its block 0, so that every query row sees position 0), and slot 1's
    block 0 pointing at slot 0's (a shared page).  ``stale`` > 0 also
    tags the rows of positions ctx[b] .. ctx[b] + stale - 1 that the
    slot's last page holds: the stale drafts a rolled-back speculative
    round leaves past the committed position."""
    import torch
    B, dev = len(ctx), "cuda"
    n_live = [-(-c // page) for c in ctx]
    n_pages = 1 + sum(n_live)
    kp = torch.randn((n_pages, page, hkv, D), generator=gen,
                     device=dev).bfloat16()
    vp = torch.randn((n_pages, page, hkv, D), generator=gen,
                     device=dev).bfloat16()
    pp = torch.full((n_pages, page), -1, dtype=torch.int32, device=dev)
    wide = torch.zeros((B, W + extra_cols), dtype=torch.int32, device=dev)
    nxt = 1
    for b, (c, n) in enumerate(zip(ctx, n_live)):
        ids = torch.arange(nxt, nxt + n, dtype=torch.int32, device=dev)
        wide[b, :n] = ids
        rows = torch.arange(n * page, device=dev).reshape(n, page)
        pp[ids.long()] = torch.where(rows < c + stale, rows, -1).int()
        nxt += n
    wide[1, 0] = wide[0, 0]
    for b in range(1, B):
        cols = 1 + torch.randperm(n_live[b] - 1, generator=gen,
                                  device=dev)[:n_null]
        wide[b, cols] = 0
    qpos = (torch.tensor(ctx, device=dev)[:, None] - C
            + torch.arange(C, device=dev)[None, :]).int()
    q = torch.randn((B, C, hkv * G, D), generator=gen, device=dev
                    ).bfloat16()
    return q, kp, vp, pp, wide[:, :W], qpos


def _gqa_seen(pp, tbl, qpos, window):
    """(B, C, keys) bool: which of the ring view's keys each query row
    sees (live page, written tag, causal, inside the window)."""
    import torch
    B = tbl.shape[0]
    live = tbl > 0
    gp = torch.where(live[..., None], pp[tbl.long()], -1).reshape(B, -1)
    rel = qpos[:, :, None] - gp[:, None, :]
    ok = (gp[:, None, :] >= 0) & (rel >= 0)
    if window > 0:
        ok = ok & (rel < window)
    return ok


def _gqa_plan(q, kp, tbl):
    """(split, body) of a gqa_paged_flash call, as its wrapper plans."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import split_k
    B, C, H, D = q.shape
    body = pa.gqa_body(q.dtype, D)
    split = pa.gqa_plan(B, C, H, kp.shape[2], tbl.shape[1], kp.shape[1],
                        sms=split_k.sm_count(q.device), D=D) \
        if body == "tensor_cores" else 1
    return split, body


def paged_case(gen, flush, ctx, C, W, window=0, n_null=0, time_it=True,
               sweep=False, hkv=8, G=4, D=64, stale=0):
    """``stale`` > 0 (a verify dispatch after a rollback): the pages also
    hold stale rows past the queries (``_paged_inputs``), and the kernel
    must give, bit for bit, what it gives with those rows unwritten."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, pp, tbl, qpos = _paged_inputs(gen, ctx, C, W, n_null=n_null,
                                             hkv=hkv, G=G, D=D, stale=stale)
    assert not tbl.is_contiguous()
    args = (q, kp, vp, pp, tbl, qpos)
    got = pa.gqa_paged_flash(*args, window=window)
    want = pa.gqa_paged_flash_plain(*args, window=window)
    stale_rows = 0
    if stale:
        clean = pp.clone()
        for b, c in enumerate(ctx):
            ids = tbl[b][tbl[b] > 0].long()
            stale_rows += int((pp[ids] >= c).sum())
            clean[ids] = torch.where(pp[ids] >= c, -1, pp[ids])
        assert stale_rows > 0, "no stale row landed in a live page"
        got_clean = pa.gqa_paged_flash(q, kp, vp, clean, tbl, qpos,
                                       window=window)
        assert torch.equal(got, got_clean), \
            "stale rows past the committed position leaked"
    torch.cuda.synchronize()
    B, _, H, D = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    live = tbl > 0
    ok = _gqa_seen(pp, tbl, qpos, window)
    seen = ok.any(-1)
    assert bool(seen.all()), "every query row sees a key here"
    err = _close(got[seen], want[seen])
    # the split's ranks merge in a fixed order: a repeat is bit-equal
    _repeat_equal(lambda: pa.gqa_paged_flash(*args, window=window),
                  "gqa_paged_flash")
    split, body = _gqa_plan(q, kp, tbl)
    r = {"max_abs_err": err, "B": B, "C": C, "W": W, "window": window,
         "split": split, "body": body, "repeat_bit_equal": True}
    if stale:
        r["stale_rows"], r["stale_bit_equal_clean"] = stale_rows, True
    if body == "cuda_cores":
        r["rows_heads"] = list(pa.gqa_heads_plan(H // hkv, D))
    if not time_it:
        return r
    # library yardstick: one SDPA call over the pre-gathered K/V (heads
    # expanded to H) with the same boolean mask; the gather is set-up
    gk = torch.where(live[..., None, None, None], kp[tbl.long()], 0)
    gv = torch.where(live[..., None, None, None], vp[tbl.long()], 0)
    gk, gv = (t.reshape(B, -1, hkv, D).repeat_interleave(H // hkv, 2)
              .transpose(1, 2).contiguous() for t in (gk, gv))
    qt = q.transpose(1, 2).contiguous()
    mask = ok[:, None]
    r["ms"] = timing.device_ms(
        lambda: pa.gqa_paged_flash(*args, window=window), flush)
    r["plain_ms"] = timing.device_ms(lambda: pa.gqa_paged_flash_plain(
        *args, window=window), flush)
    r["library_ms"] = timing.device_ms(lambda: F.scaled_dot_product_attention(
        qt, gk, gv, attn_mask=mask), flush)
    # the live pages, and those holding a key some query row admits (a
    # page wholly outside every row's window is never needed); the bound
    # is ``gqa_work``'s
    admitted = ok.any(1).reshape(B, -1, page).any(-1)
    n_pages = int(torch.unique(tbl[live]).numel())
    n_kv = int(torch.unique(tbl[live & admitted]).numel())
    r["bound_ms"], r["bound_by"] = roofline.bound_ms(
        *pa.gqa_work(*args, window=window))
    r["live_pages"], r["kv_pages"] = n_pages, n_kv
    if sweep:
        # the kernel at every split a cluster can take (the plan's rule,
        # PERF.md): device ms by split
        r["split_sweep_ms"] = {s: round(timing.device_ms(lambda s=s: pa.launch(
            *args, window, split=s), flush), 5) for s in range(1, 9)}
    return r


def gqa_split_edges(gen, hkv=8, G=4, D=64, window=0, split=None):
    """``gqa_paged_flash`` at a decode dispatch (8 slots x 1 row, hkv KV
    heads of G query heads at head dim D; granite's 32 / 8 at D 64 by
    default) over a table of 96 entries, split by the plan (6 ranks of
    16 entries at granite's geometry on 132 SMs, 8 at qwen2's) or by
    ``split`` forced through ``launch`` (zamba2's plan splits its 256
    pair tiles only 2 ways, which leaves no third range): slot 0 fills
    its table; slot 1 holds one page; slot 2's
    second range is wholly null; slot 3's third range holds live pages
    whose rows are all unwritten (tag -1: every key masked); slot 4 is
    idle (its whole table null, as the engine leaves a free slot); slots
    5-7 are ragged.  Then the same inputs under a window of 200
    positions, which masks every rank of the full slots but their last
    one or two (and first under ``window``, the model's own).  Within
    tolerance of the plain version on the rows that see a key, the idle
    slot exact zeros, a repeat bit-equal.  -> result."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    ctx = [768, 5, 768, 768, 8, 300, 77, 441]
    q, kp, vp, pp, tbl, qpos = _paged_inputs(gen, ctx, 1, 96, hkv=hkv, G=G,
                                             D=D)
    planned, body = _gqa_plan(q, kp, tbl)
    split = split or planned
    ranges = pa.split_ranges(tbl.shape[1], split)
    assert body == "tensor_cores" and split >= 3, (split, body)
    tbl[2, ranges[1][0]:ranges[1][1]] = 0  # slot 2: range 1 wholly null
    pp[tbl[3, ranges[2][0]:ranges[2][1]].long()] = -1  # slot 3: range 2
    tbl[4] = 0                             # slot 4: idle
    args = (q, kp, vp, pp, tbl, qpos)
    err = 0.0
    windows = [0, 200] if not window else [window, 200]
    for w in windows:
        run = lambda w=w: pa.launch(*args, w, split=split)
        got = run()
        want = pa.gqa_paged_flash_plain(*args, window=w)
        torch.cuda.synchronize()
        seen = _gqa_seen(pp, tbl, qpos, w).any(-1)
        assert bool(seen[[0, 1, 2, 3, 5, 6, 7]].all()) and \
            not bool(seen[4].any())
        err = max(err, _close(got[seen], want[seen]))
        assert bool(torch.all(got[4] == 0)), "the idle slot is not zeros"
        _repeat_equal(run, "gqa_paged_flash (split edges)")
    return {"max_abs_err": err, "split": split, "planned_split": planned,
            "body": body, "ranges": ranges, "windows": windows,
            "idle_slot_exact_zeros": True, "repeat_bit_equal": True}


def kernel_paged(gen, flush):
    """-> the gqa_paged_flash row: decode and mixed dispatches timed, a
    sliding-window case and the split's edge cases held for correctness
    only."""
    import torch
    g = torch.Generator().manual_seed(SEED)
    decode_ctx = [4096, 3001, 2048, 1500, 777, 300, 64, 4095]
    mixed_ctx = [int(c) for c in torch.randint(32, 97, (8,), generator=g)]
    cases = {
        "decode": paged_case(gen, flush, decode_ctx, 1, 512, n_null=5,
                             sweep=True),
        "mixed": paged_case(gen, flush, mixed_ctx, 32, 12, n_null=1),
        # a chunk of 8 x 32 rows over the decode case's long table (the
        # plan splits it 3 ways): its split sweep
        "mixed_long": paged_case(gen, flush, decode_ctx, 32, 512, n_null=5,
                                 sweep=True),
        "window": paged_case(gen, flush, [40, 70, 100, 128], 4, 16,
                             window=40, n_null=1, time_it=False),
        "split_edges": gqa_split_edges(gen),
    }
    for name, r in cases.items():
        log("kernel", name="gqa_paged_flash", case=name,
            **{k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in r.items()})
    row = {"name": "gqa_paged_flash", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
           "replaces": "src/repro/kernels/paged_attention.py:178",
           **_fields(cases["decode"]), "at_mixed": _fields(cases["mixed"]),
           "at_mixed_long": _fields(cases["mixed_long"]),
           "window_max_abs_err": cases["window"]["max_abs_err"],
           "split_edges_max_abs_err": cases["split_edges"]["max_abs_err"],
           "split": {k: cases[k]["split"] for k in cases},
           "body": {k: cases[k]["body"] for k in cases},
           "decode_split_sweep_ms": cases["decode"]["split_sweep_ms"],
           "mixed_long_split_sweep_ms":
               cases["mixed_long"]["split_sweep_ms"]}
    return row


# (H, hkv, D, window) of gqa_paged_flash at the zoo's shapes, and the
# decode contexts a windowed model walks past its window
ZOO_GQA = ("qwen2-7b", "granite-20b", "mixtral-8x7b", "phi-3-vision-4.2b")
# ... and zamba2-7b's shared attention (32 / 32 heads, D 112, its shared
# window of 4,096)
GQA_GEOMETRIES = ZOO_GQA + ("zamba2-7b",)
WINDOW_DECODE_CTX = [6000, 4500, 4097, 3001, 1500, 777, 300, 64]


# the zoo geometries whose decode case also sweeps the split (1-8)
ZOO_SWEEP = ("qwen2-7b", "granite-20b", "zamba2-7b")
# ... and that sweep a mixed chunk (8 x 32 rows) over the decode case's
# long table too, the shape of a long prompt's prefill chunks
ZOO_MIXED_LONG = ("qwen2-7b", "zamba2-7b")
# ... and whose split edges run (zamba2's with a forced split: its plan
# does not split)
ZOO_EDGES = {"qwen2-7b": None, "zamba2-7b": 6}


def _tc_ptxas(ptxas):
    """{head dim: ptxas line} of the tensor-core GQA instantiations
    (``paged::tc::gqa_paged_kernel<D>``)."""
    import re
    out = {}
    for entry, line in (ptxas or {}).items():
        m = re.search(r"2tc16gqa_paged_kernelILi(\d+)E", entry)
        if m:
            out[int(m.group(1))] = line
    return out


def kernel_zoo_paged(gen, flush, ptxas=None):
    """``gqa_paged_flash`` in bf16 at the zoo's head geometries, on the
    tensor-core body at each head dim (columns padded to 128 at D 96 /
    112 / 128): qwen2-7b (28 / 4 heads, D 128: G 7), granite-20b (48 /
    1, D 128: MQA, all 48 heads in one 64-pair tile), mixtral-8x7b (32 /
    8, D 128, window 4096 over contexts up to 6,000), phi-3-vision (32 /
    32, D 96) and zamba2-7b's shared attention (32 / 32, D 112, its
    shared window of 4,096 over contexts up to 6,000), each at decode (8
    x 1) and mixed (8 x 32), within the bar of the plain version on the
    rows that see a key, a repeat bit-equal, timed beside its bound and
    SDPA, logging its split and body; qwen2's, granite-20b's and
    zamba2's decode also at every split of 1-8, and qwen2's and zamba2's
    mixed chunk over the decode case's long table ("mixed_long"); the
    split's edges at qwen2's geometry and zamba2's (under its window);
    the ptxas line of every tensor-core instantiation (``ptxas``).  ->
    {arch: {"decode": r, "mixed": r, ["mixed_long": r],
    ["split_edges": r]}}."""
    import torch
    from repro_torch.configs import get_config
    g = torch.Generator().manual_seed(SEED + 1)
    mixed_ctx = [int(c) for c in torch.randint(32, 97, (8,), generator=g)]
    out = {}
    for arch in GQA_GEOMETRIES:
        cfg = get_config(arch)
        hkv, D = cfg.n_kv_heads, cfg.head_dim
        window = cfg.sliding_window or cfg.shared_attn_window
        geom = dict(hkv=hkv, G=cfg.n_heads // hkv, D=D)
        ctx = WINDOW_DECODE_CTX if window else \
            [4096, 3001, 2048, 1500, 777, 300, 64, 4095]
        out[arch] = {
            "decode": paged_case(gen, flush, ctx, 1, -(-max(ctx) // 8),
                                 window=window, n_null=5,
                                 sweep=arch in ZOO_SWEEP, **geom),
            "mixed": paged_case(gen, flush, mixed_ctx, 32, 12,
                                window=window, n_null=1, **geom)}
        if arch in ZOO_MIXED_LONG:
            out[arch]["mixed_long"] = paged_case(
                gen, flush, ctx, 32, -(-max(ctx) // 8), window=window,
                n_null=5, sweep=True, **geom)
        if arch in ZOO_EDGES:
            out[arch]["split_edges"] = gqa_split_edges(
                gen, window=window, split=ZOO_EDGES[arch], **geom)
        for case, r in out[arch].items():
            assert r["body"] == "tensor_cores", (arch, case, r["body"])
            log("kernel", name="gqa_paged_flash", arch=arch, case=case,
                H=cfg.n_heads, hkv=hkv, D=D,
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
        torch.cuda.empty_cache()
    for D, line in sorted(_tc_ptxas(ptxas).items()):
        log("kernel", name="gqa_paged_flash", body="tensor_cores", D=D,
            ptxas=repr(line))
    return out


def _routing_rows(gen, C, E=160, k=6, T=None, cap=None):
    """(E,) routed-token counts, at most ``cap``, and the (E, C) real-row
    mask of a top-k routing of T tokens into buffers of C rows.  By
    default T = cap = C (the serving capacity C = T); the static
    prefill's routing (``moe_apply`` without a token mask) keeps each
    expert's first ``cap`` tokens in a buffer the ops wrappers pad to
    the 8-row tile."""
    import torch
    dev = "cuda"
    T = T or C
    scores = torch.rand((T, E), generator=gen, device=dev)
    top = torch.topk(scores, k, dim=-1).indices
    counts = torch.clamp(torch.bincount(top.reshape(-1), minlength=E),
                         max=cap or C)
    rows = torch.arange(C, device=dev)[None, :] < counts[:, None]
    return counts, rows


def expert_case_mor(C, gen, flush, E=160, d=5120, f=1536, k=6,
                    T=None, cap=None):
    import torch
    from repro_torch.kernels import mor_predict as mp
    from repro_torch.kernels import split_k
    dev = "cuda"
    counts, rows = _routing_rows(gen, C, E, k, T, cap)
    x = torch.where(rows[..., None], torch.randn(
        (E, C, d), generator=gen, device=dev), 0.0).bfloat16()
    w = (torch.randn((E, d, f), generator=gen, device=dev)
         * d ** -0.5).bfloat16()
    dead = (torch.arange(f, device=dev) // 128) % 2 == 1
    coef = torch.stack([
        torch.rand((E, f), generator=gen, device=dev) * 0.04 + 0.01,
        torch.where(dead, -1e3, torch.randn((E, f), generator=gen,
                                            device=dev)),
        torch.rand((E, f), generator=gen, device=dev) + 0.5,
        torch.randn((E, f), generator=gen, device=dev) * 0.1,
        (dead | (torch.rand((E, f), generator=gen, device=dev) < 0.8)
         ).float(),
        torch.zeros((E, f), device=dev)], 1).contiguous()
    pn = (torch.rand((E, C, f), generator=gen, device=dev) < 0.7).to(
        torch.int8)
    pn = torch.where(dead, torch.ones_like(pn), pn)
    pn = torch.where(rows[..., None], pn, torch.full_like(pn, 2)).contiguous()
    got = mp.mor_tile_mask(x, w, coef, pn)
    want = mp.mor_tile_mask_plain(x, w, coef, pn)
    torch.cuda.synchronize()
    diff = int((got != want).sum())
    assert diff == 0, f"mor_tile_mask (experts): {diff} mask bits differ"
    _repeat_equal(lambda: mp.mor_tile_mask(x, w, coef, pn),
                  "mor_tile_mask (experts)")
    live = float(want.float().mean())
    assert 0.0 < live < 1.0, live
    ms = timing.device_ms(lambda: mp.mor_tile_mask(x, w, coef, pn), flush)
    plain_ms = timing.device_ms(
        lambda: mp.mor_tile_mask_plain(x, w, coef, pn), flush)
    # what these inputs need (``mor_predict.work``): every proxy state
    # (the early exit reads them), and for each expert holding a token
    # its rows of x, its whole gate weight and its coef table; the tile
    # bits out
    busy = int((counts > 0).sum())
    bound_ms, by = roofline.bound_ms(*mp.work(x, w, coef, pn))
    return {"max_abs_err": float(diff), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "E": E, "C": C, "d": d, "f": f, "top_k": k,
            "experts_with_tokens": busy, "frac_live": live,
            "plan": list(mp.plan(E, C, d, f, sms=split_k.sm_count(x.device)))}


def expert_case_gather(C, gen, flush, E=160, d=5120, f=1536, k=6,
                    T=None, cap=None):
    import torch
    from repro_torch.kernels import gather_matmul as gm
    dev = "cuda"
    counts, rows = _routing_rows(gen, C, E, k, T, cap)
    x = torch.where(rows[..., None], torch.randn(
        (E, C, d), generator=gen, device=dev), 0.0).bfloat16()
    w = (torch.randn((E, d, f), generator=gen, device=dev)
         * d ** -0.5).bfloat16()
    nm, nn = C // 8, f // 128
    rb_live = rows.reshape(E, nm, 8).any(-1)
    mask = rb_live[..., None] & (torch.rand((E, nm, nn), generator=gen,
                                            device=dev) < 0.7)
    cap = nm * nn
    # per-expert calibrated budgets: half of the experts at 0.5
    cap_live = torch.where(torch.arange(E, device=dev) % 2 == 1,
                           max(1, nm * nn // 2), cap).int()
    err = _gather_checks(x, w, mask, cap, cap_live)
    ms = timing.device_ms(lambda: gm.gather_matmul(x, w, mask, capacity=cap,
                                         cap_live=cap_live), flush)
    bare_ms = _gather_bare_ms(x, w, mask, cap, flush, cap_live)
    plain_ms = timing.device_ms(lambda: gm.gather_matmul_plain(
        x, w, mask, capacity=cap, cap_live=cap_live), flush)
    lib_ms = timing.device_ms(lambda: torch.bmm(x, w), flush)
    flat = mask.reshape(E, -1)
    lim = torch.clamp(cap_live, min=1, max=cap)[:, None]
    kept = (flat & (torch.cumsum(flat, -1) - 1 < lim)).reshape(E, nm, nn)
    n_comp = int(kept.sum())
    bound_ms, by = roofline.bound_ms(*gm.work(x, w, mask, capacity=cap,
                                              cap_live=cap_live))
    return {"max_abs_err": err, "ms": ms, "bare_ms": bare_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms, "E": E, "C": C, "d": d, "f": f,
            "top_k": k, "tiles_computed": n_comp,
            "plan": list(gm.plan(x, w, cap))}


def expert_case_kdim(C, gen, flush, E=160, d=5120, f=1536, k=6,
                    T=None, cap=None):
    import torch
    from repro_torch.kernels import masked_matmul as mm
    dev = "cuda"
    counts, rows = _routing_rows(gen, C, E, k, T, cap)
    nm, nk = C // 8, f // 128
    rb_live = rows.reshape(E, nm, 8).any(-1)
    mask = rb_live[..., None] & (torch.rand((E, nm, nk), generator=gen,
                                            device=dev) < 0.6)
    keep = mask.repeat_interleave(8, 1).repeat_interleave(128, 2)
    keep = keep & rows[..., None]
    h = torch.where(keep, torch.randn((E, C, f), generator=gen, device=dev),
                    0.0).bfloat16()
    w = (torch.randn((E, f, d), generator=gen, device=dev)
         * f ** -0.5).bfloat16()
    err = _kdim_checks(h, w, mask)
    ms = timing.device_ms(lambda: mm.masked_matmul_kdim(h, w, mask), flush)
    plan = mm.plan(h, w)
    bare_ms = timing.device_ms(lambda: mm.launch_kdim(h, w, mask, plan), flush)
    plain_ms = timing.device_ms(
        lambda: mm.masked_matmul_kdim_plain(h, w, mask), flush)
    lib_ms = timing.device_ms(lambda: torch.bmm(h, w), flush)
    bound_ms, by = roofline.bound_ms(*mm.work_kdim(h, w, mask))
    return {"max_abs_err": err, "ms": ms, "bare_ms": bare_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": lib_ms, "E": E, "C": C, "d": d, "f": f,
            "top_k": k, "plan": list(plan)}


def _mla_inputs(gen, ctx, C, W, extra_cols=8, n_null=0, page=8, h=128,
                kr=512, rd=64):
    """The latent pools holding slot b's first ``ctx[b]`` positions, with
    the table layout of ``_paged_inputs`` (null entries, a shared page,
    a column-sliced table)."""
    import torch
    B, dev = len(ctx), "cuda"
    n_live = [-(-c // page) for c in ctx]
    n_pages = 1 + sum(n_live)
    ck = torch.randn((n_pages, page, kr), generator=gen,
                     device=dev).bfloat16()
    cpe = torch.randn((n_pages, page, rd), generator=gen,
                      device=dev).bfloat16()
    pp = torch.full((n_pages, page), -1, dtype=torch.int32, device=dev)
    wide = torch.zeros((B, W + extra_cols), dtype=torch.int32, device=dev)
    nxt = 1
    for b, (c, n) in enumerate(zip(ctx, n_live)):
        ids = torch.arange(nxt, nxt + n, dtype=torch.int32, device=dev)
        wide[b, :n] = ids
        rows = torch.arange(n * page, device=dev).reshape(n, page)
        pp[ids.long()] = torch.where(rows < c, rows, -1).int()
        nxt += n
    wide[1, 0] = wide[0, 0]
    for b in range(1, B):
        cols = torch.randperm(n_live[b], generator=gen, device=dev)[:n_null]
        wide[b, cols] = 0
    qpos = (torch.tensor(ctx, device=dev)[:, None] - C
            + torch.arange(C, device=dev)[None, :]).int()
    # latent queries of the magnitude W_uk gives: unit rows / sqrt(kr)
    q_lat = (torch.randn((B, C, h, kr), generator=gen, device=dev)
             * kr ** -0.25).bfloat16()
    q_pe = torch.randn((B, C, h, rd), generator=gen, device=dev).bfloat16()
    return q_lat, q_pe, ck, cpe, pp, wide[:, :W], qpos


def mla_case(gen, flush, ctx, C, W, n_null=0, time_it=True):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import split_k
    q_lat, q_pe, ck, cpe, pp, tbl, qpos = _mla_inputs(gen, ctx, C, W,
                                                      n_null=n_null)
    assert not tbl.is_contiguous()
    B, _, h, kr = q_lat.shape
    rd, page = q_pe.shape[-1], ck.shape[1]
    scale = (128 + rd) ** -0.5                 # (qk_nope + qk_rope)^-1/2
    args = (q_lat, q_pe, ck, cpe, pp, tbl, qpos)
    got = pa.mla_paged_flash(*args, scale=scale)
    want = pa.mla_paged_flash_plain(*args, scale=scale)
    torch.cuda.synchronize()
    live = tbl > 0
    gp = torch.where(live[..., None], pp[tbl.long()], -1).reshape(B, -1)
    ok = (gp[:, None, :] >= 0) & (gp[:, None, :] <= qpos[:, :, None])
    seen = ok.any(-1)
    assert bool(seen.all()), "every query row sees a key here"
    err = _close(got[seen], want[seen])
    # the split's ranks merge in a fixed order: a repeat is bit-equal
    _repeat_equal(lambda: pa.mla_paged_flash(*args, scale=scale),
                  "mla_paged_flash")
    split = pa.mla_plan(B, C, h, W, page, sms=split_k.sm_count(q_lat.device))
    r = {"max_abs_err": err, "B": B, "C": C, "W": W, "split": split,
         "repeat_bit_equal": True}
    if not time_it:
        return r
    # library yardstick: one SDPA call over the pre-gathered latents,
    # q = [q_lat, q_pe], k = [c_kv, k_pe] and v = c_kv, the one latent
    # "head" broadcast to the h query heads, the same boolean mask
    gk = torch.where(live[..., None, None], ck[tbl.long()], 0).reshape(
        B, 1, -1, kr)
    ge = torch.where(live[..., None, None], cpe[tbl.long()], 0).reshape(
        B, 1, -1, rd)
    kk = torch.cat([gk, ge], -1).expand(B, h, -1, kr + rd)
    vv = gk.expand(B, h, -1, kr)
    qq = torch.cat([q_lat, q_pe], -1).transpose(1, 2).contiguous()
    mask = ok[:, None]
    r["ms"] = timing.device_ms(
        lambda: pa.mla_paged_flash(*args, scale=scale), flush)
    r["plain_ms"] = timing.device_ms(lambda: pa.mla_paged_flash_plain(
        *args, scale=scale), flush)
    r["library_ms"] = timing.device_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, scale=scale), flush)
    n_pages = int(torch.unique(tbl[live]).numel())
    r["bound_ms"], r["bound_by"] = roofline.bound_ms(
        *pa.mla_work(*args, scale=scale))
    r["live_pages"] = n_pages
    return r


def mla_split_edges(gen):
    """``mla_paged_flash`` at a decode dispatch (8 slots x 1 row, 128
    heads) over a table of 64 entries, which the plan splits 8 ways into
    ranges of 8 entries: slot 0 fills its table; slot 1 holds one page;
    slot 2's second range is wholly null; slot 3's third range holds
    live pages whose rows are all unwritten (tag -1: every key masked);
    slot 4 is idle (its whole table null, as the engine leaves a free
    slot); slots 5-7 are ragged.  Within tolerance of the plain version
    on the rows that see a key, the idle slot exact zeros, a repeat
    bit-equal.  -> result."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import split_k
    ctx = [512, 5, 512, 512, 8, 300, 77, 441]
    q_lat, q_pe, ck, cpe, pp, tbl, qpos = _mla_inputs(gen, ctx, 1, 64)
    B, _, h, kr = q_lat.shape
    page, W = ck.shape[1], tbl.shape[1]
    split = pa.mla_plan(B, 1, h, W, page, sms=split_k.sm_count(q_lat.device))
    ranges = pa.split_ranges(W, split)
    assert split == 8 and ranges[1] == (8, 16), (split, ranges)
    tbl[2, 8:16] = 0                       # slot 2: range 1 wholly null
    pp[tbl[3, 16:24].long()] = -1          # slot 3: range 2 all masked
    tbl[4] = 0                             # slot 4: idle
    scale = (128 + q_pe.shape[-1]) ** -0.5
    args = (q_lat, q_pe, ck, cpe, pp, tbl, qpos)
    got = pa.mla_paged_flash(*args, scale=scale)
    want = pa.mla_paged_flash_plain(*args, scale=scale)
    torch.cuda.synchronize()
    live = tbl > 0
    gp = torch.where(live[..., None], pp[tbl.long()], -1).reshape(B, -1)
    seen = ((gp[:, None, :] >= 0)
            & (gp[:, None, :] <= qpos[:, :, None])).any(-1)
    assert bool(seen[[0, 1, 2, 3, 5, 6, 7]].all()) and not bool(seen[4].any())
    err = _close(got[seen], want[seen])
    assert bool(torch.all(got[4] == 0)), "the idle slot is not exact zeros"
    _repeat_equal(lambda: pa.mla_paged_flash(*args, scale=scale),
                  "mla_paged_flash (split edges)")
    return {"max_abs_err": err, "split": split, "ranges": ranges,
            "idle_slot_exact_zeros": True, "repeat_bit_equal": True}


def kernel_mla(gen, flush):
    """-> the mla_paged_flash row: decode and mixed dispatches at
    deepseek-v2-236b's widths, timed, and the split's edge cases."""
    import torch
    g = torch.Generator().manual_seed(SEED + 1)
    decode_ctx = [4096, 3001, 2048, 1500, 777, 300, 64, 4095]
    mixed_ctx = [int(c) for c in torch.randint(32, 97, (8,), generator=g)]
    cases = {"decode": mla_case(gen, flush, decode_ctx, 1, 512, n_null=5),
             "mixed": mla_case(gen, flush, mixed_ctx, 32, 12, n_null=1),
             "split_edges": mla_split_edges(gen)}
    for name, r in cases.items():
        log("kernel", name="mla_paged_flash", case=name,
            **{k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in r.items()})
    return {"name": "mla_paged_flash", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mla_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:302",
            **_fields(cases["decode"]), "at_mixed": _fields(cases["mixed"]),
            "split": {k: cases[k]["split"] for k in cases},
            "split_edges_max_abs_err": cases["split_edges"]["max_abs_err"]}


# -- the shard-window, partial forms (the paged-sharded layout's) -----------

N_WINDOWS = 4                     # the page windows each pool is split into


def _windows(n_pages):
    """-> (n_local, lo of each window): a pool of ``n_pages`` split into
    N_WINDOWS windows of whole pages (the last padded)."""
    n_local = -(-n_pages // N_WINDOWS)
    return n_local, [i * n_local for i in range(N_WINDOWS)]


def _window_pool(pool, lo, n_local, fill):
    """Window [lo, lo + n_local) of a global pool as a rank holds it: its
    pages (past the pool: ``fill``) and a trailing scratch page."""
    import torch
    out = torch.full((n_local + 1,) + tuple(pool.shape[1:]), fill,
                     dtype=pool.dtype, device=pool.device)
    part = pool[lo:lo + n_local]
    out[:len(part)] = part
    return out


def _same_partial(got, want):
    """A bf16 partial launch against its plain version: m bit-equal
    wherever either is the sentinel (and l there, a count, exact), m, l
    and acc within the bf16 bar elsewhere (``_close``).  -> (max abs
    err, sentinel rows, rows of windows with no live page)."""
    import torch
    from repro_torch.kernels.paged_attention import NEG_INF
    (m, l, acc), (wm, wl, wacc) = got, want
    sent = (m == NEG_INF) | (wm == NEG_INF)
    assert bool(torch.equal(m[sent], wm[sent])), "sentinel m differs"
    assert bool(torch.equal(l[sent], wl[sent])), "sentinel l differs"
    real = ~sent
    err = 0.0
    for g, w in ((m[real], wm[real]), (l[real], wl[real]), (acc, wacc)):
        if g.numel():
            err = max(err, _close(g, w))
    return err, int(sent.sum()), int((sent & (l == 0)).sum())


def window_case_gqa(gen, flush, ctx, C, W, hkv=8, G=4, D=64, window=0,
                    n_null=0, time_it=False):
    """``gqa_paged_flash``'s shard-window, partial form: the pool of
    ``_paged_inputs`` split into N_WINDOWS windows (``lo = i n_local``);
    each window's table holds null pages, pages of other windows and
    slots with no page in it.  Every window's partial launch against its
    plain version (``_same_partial``); the windows merged
    (``collectives.merge_stacked``) against the single-pass kernel and
    plain version on the rows that see a key; with ``time_it`` the
    window with the most live pages timed (device ms, L2 flushed) beside
    its plain version, its bound (that window's live pages, q, the
    statistics) and SDPA over its pre-gathered K/V (a yardstick that
    computes the normalised output, not the statistics)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.distributed.collectives import merge_stacked
    from repro_torch.kernels import paged_attention as pa
    q, kp, vp, pp, tbl, qpos = _paged_inputs(gen, ctx, C, W, n_null=n_null,
                                             hkv=hkv, G=G, D=D)
    B, _, H, _ = q.shape
    n_local, los = _windows(kp.shape[0])
    parts, err, n_sent, n_empty, wholly_foreign = [], 0.0, 0, 0, 0
    for lo in los:
        args = (q, _window_pool(kp, lo, n_local, 0),
                _window_pool(vp, lo, n_local, 0),
                _window_pool(pp, lo, n_local, -1), tbl, qpos)
        kw = dict(window=window, lo=lo, n_local=n_local, partial=True)
        got = pa.gqa_paged_flash(*args, **kw)
        want = pa.gqa_paged_flash_plain(*args, **kw)
        torch.cuda.synchronize()
        e, s, z = _same_partial(got, want)
        err, n_sent, n_empty = max(err, e), n_sent + s, n_empty + z
        live = (tbl > 0) & (tbl >= lo) & (tbl < lo + n_local)
        wholly_foreign += int((~live.any(1)).sum())
        parts.append(got)
    assert n_empty > 0 and wholly_foreign > 0, "no wholly-foreign slot"
    merged = merge_stacked(*(torch.stack(t) for t in zip(*parts)))
    merged = merged.permute(0, 3, 1, 2, 4).reshape(B, C, H, D)
    seen = _gqa_seen(pp, tbl, qpos, window).any(-1)
    single = pa.gqa_paged_flash(q, kp, vp, pp, tbl, qpos, window=window)
    plain = pa.gqa_paged_flash_plain(q, kp, vp, pp, tbl, qpos,
                                     window=window)
    merge_err = max(_close(merged[seen], single[seen]),
                    _close(merged[seen], plain[seen]))
    split, body = _gqa_plan(q, kp, tbl)
    r = {"max_abs_err": err, "merge_max_abs_err": merge_err, "B": B,
         "C": C, "W": W, "window": window, "n_local": n_local,
         "windows": N_WINDOWS, "sentinel_rows": n_sent,
         "empty_window_rows": n_empty, "wholly_foreign_slots":
         wholly_foreign, "body": body}
    if not time_it:
        return r
    # the window with the most live pages, timed alone
    counts = [int(((tbl >= lo) & (tbl < lo + n_local) & (tbl > 0)).sum())
              for lo in los]
    lo = los[max(range(N_WINDOWS), key=counts.__getitem__)]
    args = (q, _window_pool(kp, lo, n_local, 0),
            _window_pool(vp, lo, n_local, 0),
            _window_pool(pp, lo, n_local, -1), tbl, qpos)
    kw = dict(window=window, lo=lo, n_local=n_local, partial=True)
    r["ms"] = timing.device_ms(lambda: pa.gqa_paged_flash(*args, **kw), flush)
    r["plain_ms"] = timing.device_ms(
        lambda: pa.gqa_paged_flash_plain(*args, **kw), flush)
    live = (tbl > 0) & (tbl >= lo) & (tbl < lo + n_local)
    ok = _gqa_seen(pp, torch.where(live, tbl, 0), qpos, window)
    gk = torch.where(live[..., None, None, None], kp[tbl.long()], 0)
    gv = torch.where(live[..., None, None, None], vp[tbl.long()], 0)
    gk, gv = (t.reshape(B, -1, hkv, D).repeat_interleave(G, 2)
              .transpose(1, 2).contiguous() for t in (gk, gv))
    qt, mask = q.transpose(1, 2).contiguous(), ok[:, None]
    r["library_ms"] = timing.device_ms(lambda: F.scaled_dot_product_attention(
        qt, gk, gv, attn_mask=mask), flush)
    r["library_computes"] = "the normalised output, not the statistics"
    n_pages = int(torch.unique(tbl[live]).numel())
    # that window's live pages, q, the statistics (``gqa_work``)
    r["bound_ms"], r["bound_by"] = roofline.bound_ms(
        *pa.gqa_work(*args, **kw))
    r["timed_window"], r["timed_live_pages"] = lo // n_local, n_pages
    return r


def window_case_mla(gen, flush, ctx, C, W, n_null=0, time_it=False):
    """``mla_paged_flash``'s shard-window, partial form at deepseek's
    widths (128 heads, kr 512, rd 64), as ``window_case_gqa``: every
    window against its plain version, the windows merged against the
    single pass; with ``time_it`` the fullest window timed beside its
    plain version, bound and SDPA on its pre-gathered latents."""
    import torch
    import torch.nn.functional as F
    from repro_torch.distributed.collectives import merge_stacked
    from repro_torch.kernels import paged_attention as pa
    q_lat, q_pe, ck, cpe, pp, tbl, qpos = _mla_inputs(gen, ctx, C, W,
                                                      n_null=n_null)
    B, _, h, kr = q_lat.shape
    rd, page = q_pe.shape[-1], ck.shape[1]
    scale = (128 + rd) ** -0.5
    n_local, los = _windows(ck.shape[0])
    parts, err, n_sent, n_empty = [], 0.0, 0, 0

    def window_args(lo):
        return (q_lat, q_pe, _window_pool(ck, lo, n_local, 0),
                _window_pool(cpe, lo, n_local, 0),
                _window_pool(pp, lo, n_local, -1), tbl, qpos)

    for lo in los:
        kw = dict(scale=scale, lo=lo, n_local=n_local, partial=True)
        got = pa.mla_paged_flash(*window_args(lo), **kw)
        want = pa.mla_paged_flash_plain(*window_args(lo), **kw)
        torch.cuda.synchronize()
        e, s, z = _same_partial(got, want)
        err, n_sent, n_empty = max(err, e), n_sent + s, n_empty + z
        parts.append(got)
    assert n_empty > 0, "no window without a live page"
    merged = merge_stacked(*(torch.stack(t) for t in zip(*parts)))
    merged = merged.permute(0, 2, 1, 3)
    live_all = tbl > 0
    gp = torch.where(live_all[..., None], pp[tbl.long()], -1).reshape(B, -1)
    seen = ((gp[:, None, :] >= 0)
            & (gp[:, None, :] <= qpos[:, :, None])).any(-1)
    args = (q_lat, q_pe, ck, cpe, pp, tbl, qpos)
    single = pa.mla_paged_flash(*args, scale=scale)
    plain = pa.mla_paged_flash_plain(*args, scale=scale)
    merge_err = max(_close(merged[seen], single[seen]),
                    _close(merged[seen], plain[seen]))
    r = {"max_abs_err": err, "merge_max_abs_err": merge_err, "B": B,
         "C": C, "W": W, "n_local": n_local, "windows": N_WINDOWS,
         "sentinel_rows": n_sent, "empty_window_rows": n_empty}
    if not time_it:
        return r
    counts = [int(((tbl >= lo) & (tbl < lo + n_local) & (tbl > 0)).sum())
              for lo in los]
    lo = los[max(range(N_WINDOWS), key=counts.__getitem__)]
    kw = dict(scale=scale, lo=lo, n_local=n_local, partial=True)
    wa = window_args(lo)
    r["ms"] = timing.device_ms(lambda: pa.mla_paged_flash(*wa, **kw), flush)
    r["plain_ms"] = timing.device_ms(
        lambda: pa.mla_paged_flash_plain(*wa, **kw), flush)
    live = (tbl > 0) & (tbl >= lo) & (tbl < lo + n_local)
    gpw = torch.where(live[..., None], pp[tbl.long()], -1).reshape(B, -1)
    ok = (gpw[:, None, :] >= 0) & (gpw[:, None, :] <= qpos[:, :, None])
    gk = torch.where(live[..., None, None], ck[tbl.long()], 0).reshape(
        B, 1, -1, kr)
    ge = torch.where(live[..., None, None], cpe[tbl.long()], 0).reshape(
        B, 1, -1, rd)
    kk = torch.cat([gk, ge], -1).expand(B, h, -1, kr + rd)
    vv = gk.expand(B, h, -1, kr)
    qq = torch.cat([q_lat, q_pe], -1).transpose(1, 2).contiguous()
    mask = ok[:, None]
    r["library_ms"] = timing.device_ms(lambda: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mask, scale=scale), flush)
    r["library_computes"] = "the normalised output, not the statistics"
    n_pages = int(torch.unique(tbl[live]).numel())
    r["bound_ms"], r["bound_by"] = roofline.bound_ms(
        *pa.mla_work(*wa, **kw))
    r["timed_window"], r["timed_live_pages"] = lo // n_local, n_pages
    return r


def kernel_windows(gen, flush, ptxas=None):
    """The shard-window, partial forms at the sharded layout's shapes, in
    bf16: granite's decode (8 x 1 over contexts to 4,096; 32 / 8 heads
    at D 64) and mixed dispatch (8 x 32), qwen2's G 7 at D 128 and
    zamba2's D 112 under its window of 4,096 (timed: the tensor-core body
    at every head dim), and deepseek's MLA (128 heads, kr 512, rd 64).
    -> {"gqa": {case: r}, "mla": {case: r}}."""
    import torch
    from repro_torch.configs import get_config
    g = torch.Generator().manual_seed(SEED + 2)
    decode_ctx = [4096, 3001, 2048, 1500, 777, 300, 64, 4095]
    mixed_ctx = [int(c) for c in torch.randint(32, 97, (8,), generator=g)]
    gqa = {"granite_decode": window_case_gqa(gen, flush, decode_ctx, 1, 512,
                                             n_null=5, time_it=True),
           "granite_mixed": window_case_gqa(gen, flush, mixed_ctx, 32, 12,
                                            n_null=1, time_it=True)}
    for arch in ("qwen2-7b", "zamba2-7b"):
        cfg = get_config(arch)
        window = cfg.sliding_window or cfg.shared_attn_window
        ctx = WINDOW_DECODE_CTX if window else decode_ctx
        gqa[arch] = window_case_gqa(
            gen, flush, ctx, 1, -(-max(ctx) // 8), hkv=cfg.n_kv_heads,
            G=cfg.n_heads // cfg.n_kv_heads, D=cfg.head_dim, window=window,
            n_null=5, time_it=True)
    mla = {"deepseek_decode": window_case_mla(gen, flush, decode_ctx, 1, 512,
                                              n_null=5, time_it=True),
           "deepseek_mixed": window_case_mla(gen, flush, mixed_ctx, 32, 12,
                                             n_null=1)}
    for name, per in (("gqa_paged_flash[partial]", gqa),
                      ("mla_paged_flash[partial]", mla)):
        for case, r in per.items():
            log("kernel", name=name, case=case,
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
    for entry, line in (ptxas or {}).items():
        if "paged_kernel" in entry:
            log("kernel", name="paged (window / partial forms)",
                ptxas_entry=entry, ptxas=repr(line))
    torch.cuda.empty_cache()
    return {"gqa": gqa, "mla": mla}


# -- the kernel API: binary_dot, binary_dot_packed, masked_matmul ------------

INT_MM_RULE = ("torch._int_mm needs M > 16 (and cuBLASLt refused M = N = "
               "40, K = 96): timed where M, K, N are multiples of 32, M "
               "<= 16 on the signs padded to 32 rows")
# the rows ``torch._int_mm`` is given at a decode dispatch (M <= 16): the
# signs padded with zero rows, which it then also multiplies
INT_MM_ROWS = 32


def _int_mm_ms(xs, ws, flush):
    """One ``torch._int_mm`` over int8 signs binarised beforehand, where
    its shape rules allow (INT_MM_RULE), else None; at M <= 16 over the
    signs padded to INT_MM_ROWS rows."""
    import torch
    M, K = xs.shape
    if M <= 16:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, INT_MM_ROWS - M))
        M = INT_MM_ROWS
    if M % 32 or K % 32 or ws.shape[1] % 32:
        return None
    return timing.device_ms(lambda: torch._int_mm(xs, ws), flush)


def binary_cases(x, w, flush, tiles=None):
    """The three kernel-API kernels on one (x, w), each held against its
    plain version and timed beside it, its library yardstick and its
    bound: ``binary_dot`` (bit-equal to ``binary_preact``),
    ``binary_dot_packed`` on ``pack_signs(w)`` (bit-equal to
    ``binary_dot``) and ``masked_matmul`` under ``tiles`` (8 x 128; a
    70%-live random mask when None), within tolerance, dead tiles exact
    zeros, its count the mask's sum and two launches bit-equal.  ``ms``
    is the kernel module's call on the operands as they are,
    ``wrapper_ms`` the ``ops`` wrapper's (its padding included).  ->
    {kernel: result}."""
    import torch
    from repro_torch.core.predictor import binary_preact
    from repro_torch.kernels import binary_dot as bd
    from repro_torch.kernels import binary_dot_packed as bdp
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import ops
    M, K = x.shape
    N = w.shape[1]
    elt = x.element_size()
    want = binary_preact(x, w)
    got = ops.binary_dot(x, w)
    packed = bdp.pack_signs(w)
    got_p = bdp.binary_dot_packed(x, packed)
    if tiles is None:
        g = torch.Generator(device=x.device).manual_seed(SEED + M)
        tiles = torch.rand((-(-M // 8), -(-N // 128)), generator=g,
                           device=x.device) < 0.7
    got_m, n_live = ops.masked_matmul(x, w, tiles, with_counts=True)
    want_m = mm.masked_matmul_plain(x, w, tiles)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    assert n_diff == 0, f"binary_dot: {n_diff} entries differ"
    n_diff_p = int((got_p != got).sum())
    assert n_diff_p == 0, f"binary_dot_packed: {n_diff_p} entries differ"
    assert int(n_live) == int(tiles.sum()), (int(n_live), int(tiles.sum()))
    keep = tiles.repeat_interleave(8, 0).repeat_interleave(128, 1)[:M, :N]
    assert bool(torch.all(got_m[~keep] == 0)), "dead tiles are not zero"
    err_m = _close(got_m, want_m, f32=x.dtype == torch.float32)
    _repeat_equal(lambda: ops.masked_matmul(x, w, tiles), "masked_matmul")
    xs = torch.where(x > 0, 1, -1).to(torch.int8)
    ws = torch.where(w >= 0, 1, -1).to(torch.int8)
    lib_ms = _int_mm_ms(xs, ws, flush)
    lib_note = ({"library_null": INT_MM_RULE} if lib_ms is None else
                {"library_padded_rows": INT_MM_ROWS} if M <= 16 else {})
    out = {}
    b_ms, b_by = roofline.bound_ms(*bd.work(x, w))
    out["binary_dot"] = {
        "max_abs_err": float(n_diff),
        "ms": timing.device_ms(lambda: bd.binary_dot(x, w), flush),
        "wrapper_ms": timing.device_ms(lambda: ops.binary_dot(x, w), flush),
        "plain_ms": timing.device_ms(lambda: bd.binary_dot_plain(x, w), flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        **lib_note, "M": M, "K": K, "N": N}
    b_ms, b_by = roofline.bound_ms(*bdp.work(x, packed))
    out["binary_dot_packed"] = {
        "max_abs_err": float(n_diff_p),
        "ms": timing.device_ms(lambda: bdp.binary_dot_packed(x, packed),
                               flush),
        "plain_ms": timing.device_ms(
            lambda: bdp.binary_dot_packed_plain(x, packed), flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        **lib_note, "M": M, "K": K, "N": N,
        "weight_bytes": K * N // 8, "unpacked_weight_bytes": K * N * elt}
    b_ms, b_by = roofline.bound_ms(*mm.work_masked(x, w, tiles))
    out["masked_matmul"] = {
        "max_abs_err": err_m,
        "ms": timing.device_ms(lambda: mm.masked_matmul(x, w, tiles), flush),
        "wrapper_ms": timing.device_ms(
            lambda: ops.masked_matmul(x, w, tiles), flush),
        "plain_ms": timing.device_ms(
            lambda: mm.masked_matmul_plain(x, w, tiles), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timing.device_ms(lambda: torch.matmul(x, w), flush),
        "M": M, "K": K, "N": N, "frac_live": float(tiles.float().mean())}
    return out


def binary_edges(gen):
    """``binary_dot`` bit-equal to ``binary_preact`` at the sign
    conventions' edges, in both dtypes, at a decode dispatch and at 64
    rows: zero activations (-1), -0.0 weights (+1), NaN in x and in w
    (-1), and a ragged K of 100 (no padding: an index past K adds
    nothing) with N = 130 (16-byte chunks straddle the edge, so the
    kernel loads element by element).  -> number of differing entries
    (0, asserted)."""
    import torch
    from repro_torch.core.predictor import binary_preact
    from repro_torch.kernels import ops
    n = 0
    for dt in (torch.bfloat16, torch.float32):
        for M, K, N in ((8, 100, 256), (64, 100, 128), (64, 100, 130)):
            x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
            w = torch.randn((K, N), generator=gen, device="cuda").to(dt)
            x[:, ::5] = 0.0
            w[::3] = -0.0
            x[0, 1] = w[2, 3] = float("nan")
            got = ops.binary_dot(x, w)
            d = int((got != binary_preact(x, w)).sum())
            assert d == 0, f"binary_dot {M}x{K}x{N} {dt}: {d} entries differ"
            n += d
    return n


def kernel_api(gen, flush):
    """-> {kernel: {case: result}}: the three kernel-API kernels at
    granite-3-2b's gate widths (K = 2048, N = 8192) in bf16, M = 8 and
    256 rows; ``binary_dot``'s sign edges (``binary_edges``)."""
    import torch
    K, N = 2048, 8192
    per = {}
    for M in (8, 256):
        x = torch.randn((M, K), generator=gen, device="cuda").bfloat16()
        w = (torch.randn((K, N), generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        for name, r in binary_cases(x, w, flush).items():
            per.setdefault(name, {})[f"m{M}"] = r
            log("kernel", name=name,
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
    per["binary_dot"]["edges_entries_differing"] = binary_edges(gen)
    log("kernel", name="binary_dot", edges="-0.0 w, NaN x and w, K = 100",
        entries_differing=per["binary_dot"]["edges_entries_differing"])
    per["binary_dot_packed"]["ragged_entries_differing"] = packed_ragged(gen)
    log("kernel", name="binary_dot_packed", ragged="M 24, K 104, N 130",
        entries_differing=per["binary_dot_packed"][
            "ragged_entries_differing"])
    return per


def packed_ragged(gen):
    """``binary_dot_packed`` bit-equal to ``binary_dot`` and to its plain
    version at a ragged shape, in both dtypes: M = 24, K = 104 (13
    packed rows: the second k step is part-filled), N = 130 (the byte
    path of the weight stage: a last chunk of 2 columns).  -> number of
    differing entries (0, asserted)."""
    import torch
    from repro_torch.kernels import binary_dot_packed as bdp
    from repro_torch.kernels import ops
    n = 0
    for dt in (torch.bfloat16, torch.float32):
        x = torch.randn((24, 104), generator=gen, device="cuda").to(dt)
        w = torch.randn((104, 130), generator=gen, device="cuda").to(dt)
        x[:, ::5] = 0.0
        packed = bdp.pack_signs(w)
        got = bdp.binary_dot_packed(x, packed)
        d = int((got != ops.binary_dot(x, w)).sum()) + int(
            (got != bdp.binary_dot_packed_plain(x, packed)).sum())
        assert d == 0, f"binary_dot_packed 24x104x130 {dt}: {d} differ"
        n += d
    return n


API_KERNELS = {
    "binary_dot": ("src/repro_torch/kernels/csrc/binary_dot.cu",
                   "src/repro/kernels/binary_dot.py:40"),
    "binary_dot_packed": ("src/repro_torch/kernels/csrc/binary_dot_packed.cu",
                          "src/repro/kernels/binary_dot_packed.py:71"),
    "masked_matmul": ("src/repro_torch/kernels/csrc/masked_matmul.cu",
                      "src/repro/kernels/masked_matmul.py:44"),
}


KERNELS = [
    ("mor_tile_mask", "src/repro_torch/kernels/csrc/mor_predict.cu",
     "src/repro/kernels/mor_predict.py:76", kernel_case_mor,
     expert_case_mor),
    ("gather_matmul", "src/repro_torch/kernels/csrc/gather_matmul.cu",
     "src/repro/kernels/gather_matmul.py:58", kernel_case_gather,
     expert_case_gather),
    ("masked_matmul_kdim", "src/repro_torch/kernels/csrc/masked_matmul.cu",
     "src/repro/kernels/masked_matmul.py:104", kernel_case_kdim,
     expert_case_kdim),
]


# the speculative path (phase_spec): k = 4 drafts a round over 8 slots,
# so a draft dispatch has M = 8 rows and a verify 8 x (k + 1) = 40; the
# drafts run at these capacity fractions of the tile grid
SPEC_K = 4
SPEC_M = 8 * (SPEC_K + 1)
DRAFT_CAPS = (0.5, 0.25)


def kernel_spec(gen, flush):
    """-> {kernel: {case: result}}: the serving kernels at the shapes the
    speculative path gives them.  mor_tile_mask at the verify's M 40
    (the draft's M 8 is the m8 row); gather_matmul at M 8 and 40 under a
    draft budget of ceil(cap x tiles) at each of DRAFT_CAPS, and
    masked_matmul_kdim on the down product's input as that clamped
    gather leaves it (its kept tiles); gqa_paged_flash at a verify of
    k + 1 = 5 rows a slot over the decode case's table (granite's G 4:
    20 of a 64-pair tile), its pages also holding stale draft rows past
    the committed position, which must change no bit; mla_paged_flash at
    the same 5 rows a slot."""
    decode_ctx = [4096, 3001, 2048, 1500, 777, 300, 64, 4095]
    out = {"mor_tile_mask": {f"spec_verify_m{SPEC_M}": kernel_case_mor(
        SPEC_M, gen, flush)}, "gather_matmul": {}, "masked_matmul_kdim": {}}
    for M in (8, SPEC_M):
        for cap in DRAFT_CAPS:
            r = kernel_case_gather(M, gen, flush, draft_cap=cap)
            kept = r.pop("_kept")
            tag = f"spec_m{M}_draft_cap{cap}"
            out["gather_matmul"][tag] = r
            out["masked_matmul_kdim"][tag] = kernel_case_kdim(
                M, gen, flush, mask=kept)
    out["gqa_paged_flash"] = {"spec_verify": paged_case(
        gen, flush, decode_ctx, SPEC_K + 1, 512, n_null=5, stale=SPEC_K)}
    out["mla_paged_flash"] = {"spec_verify": mla_case(
        gen, flush, decode_ctx, SPEC_K + 1, 512, n_null=5)}
    for name, per in out.items():
        for case, r in per.items():
            log("kernel", name=name, case=case,
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
    return out


# qwen2-7b's FFN (d 3584, f 18944) at a 16,384-token prompt's rows: the
# gate / up product (K d, N f) and the down product (K f, N d)
QWEN2_LONG_WIDTHS = {"mor_tile_mask": dict(K=3584, N=18944),
                     "gather_matmul": dict(K=3584, N=18944),
                     "masked_matmul_kdim": dict(K=18944, N=3584)}


# one model rank's half of granite-3-2b's FFN at model 2 (the mesh's
# MoR-active tensor-parallel FFN): N 4,096 gate / up columns, K 4,096
# down rows
HALF_WIDTHS = {"mor_tile_mask": dict(N=4096), "gather_matmul": dict(N=4096),
               "masked_matmul_kdim": dict(K=4096)}
# the expert grid at mixtral-8x7b's widths: 8 experts, top-2
MIXTRAL_GRID = dict(E=8, d=4096, f=14336, k=2)
# deepseek-v2-236b's dense FFN (layer 0: d 5120, f 12288)
DEEPSEEK_DENSE_WIDTHS = {"mor_tile_mask": dict(K=5120, N=12288),
                         "gather_matmul": dict(K=5120, N=12288),
                         "masked_matmul_kdim": dict(K=12288, N=5120)}


def static_prefill_shapes():
    """-> (granite M, deepseek M, deepseek expert grid {C, T, cap}): the
    rows the static cells' batched prefills hand the MoR kernels.  Each
    group is 8 slots x the trace's longest prompt: granite's mixed
    trace at granite's widths, deepseek's shared-prefix trace in layer
    0's dense FFN and, through ``moe_apply`` without a token mask, each
    expert's capacity int(capacity_factor x T x top_k / E) of those T
    tokens, padded by the ops wrappers to the 8-row tile."""
    from repro_torch.configs import get_config
    granite = get_config("granite-3-2b")
    deepseek = get_config("deepseek-v2-236b")
    m_g, m_d = (STATIC_SLOTS * max(len(p) for p, _ in reqs) for reqs in (
        _mixed_trace(granite), _shared_prefix_trace(deepseek)))
    cap = max(int(deepseek.capacity_factor * m_d * deepseek.top_k
                  / deepseek.n_experts), 1)
    tile = deepseek.mor.tile_m
    return m_g, m_d, dict(C=-(-cap // tile) * tile, T=m_d, cap=cap)


def phase_kernels(ptxas=None):
    """-> {kernel: row}: each MoR kernel at granite's widths (M = 8 and
    256) and on the expert grid at deepseek-v2-236b's (E = 160, C = 8
    and 256) and mixtral-8x7b's (E = 8, C = 8 and 256), then the two
    paged attentions, GQA also at the zoo's head geometries and
    zamba2-7b's (``ptxas``: the build's lines by entry)."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    rows, cases = {}, {}
    m_granite, m_deepseek, grid_deepseek = static_prefill_shapes()
    for name, source, replaces, case, expert_case in KERNELS:
        per = cases[name] = {}
        # M 424: the granite static cell's prefill, its last 64-row tile
        # ragged
        for M in (8, 256, m_granite, 512, 2048):
            per[f"m{M}"] = r = case(M, gen, flush)
            log("kernel", name=name, M=M,
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
        for M in (8, 256):
            per[f"half_m{M}"] = r = case(M, gen, flush, **HALF_WIDTHS[name])
            log("kernel", name=name, M=M, widths="granite-3-2b, one rank "
                "of model 2", **{k: (round(v, 5) if isinstance(v, float)
                                     else v) for k, v in r.items()})
        per[f"deepseek_m{m_deepseek}"] = r = case(
            m_deepseek, gen, flush, **DEEPSEEK_DENSE_WIDTHS[name])
        log("kernel", name=name, M=m_deepseek, widths="deepseek-v2-236b",
            **{k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in r.items()})
        # the long prompt's FFN: M x N = 3.1e8 elements, past 2^28
        per["qwen2_m16384"] = r = case(16384, gen, flush,
                                       **QWEN2_LONG_WIDTHS[name])
        log("kernel", name=name, M=16384, widths="qwen2-7b",
            **{k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in r.items()})
        torch.cuda.empty_cache()
        for C in (8, 256):
            per[f"experts_c{C}"] = r = expert_case(C, gen, flush)
            log("kernel", name=name, grid="experts",
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
            torch.cuda.empty_cache()
        # the deepseek static cell's prefill on the expert grid
        per[f"experts_static_c{grid_deepseek['C']}"] = r = expert_case(
            gen=gen, flush=flush, **grid_deepseek)
        log("kernel", name=name, grid="experts", static_prefill_tokens=
            grid_deepseek["T"], capacity=grid_deepseek["cap"],
            **{k: (round(v, 5) if isinstance(v, float) else v)
               for k, v in r.items()})
        torch.cuda.empty_cache()
        for C in (8, 256):
            per[f"mixtral_experts_c{C}"] = r = expert_case(
                C, gen, flush, **MIXTRAL_GRID)
            log("kernel", name=name, grid="mixtral experts",
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
            torch.cuda.empty_cache()
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, **_fields(per["m8"]),
                      **{f"at_{k}": _fields(v) for k, v in per.items()
                         if k != "m8"}}
    mor = rows["mor_tile_mask"]
    mor["binary_dot_ms"] = {k: cases["mor_tile_mask"][k]["binary_dot_ms"]
                            for k in ("m8", "m256")}
    edges = mor_edges(gen, flush)
    mor["at_tds_f32_residual"] = _fields(edges.pop("tds_f32_residual"))
    mor["ragged_mask_bits_differing"] = {
        k: v["mask_bits_differing"] for k, v in edges.items()}
    for tag, err in kernel_ragged(gen).items():
        name = "gather_matmul" if tag.startswith("gather") else \
            "masked_matmul_kdim"
        rows[name].setdefault("ragged_max_abs_err", {})[tag] = err
    rows["gqa_paged_flash"] = kernel_paged(gen, flush)
    gqa = rows["gqa_paged_flash"]
    for arch, per in kernel_zoo_paged(gen, flush, ptxas).items():
        for case, r in per.items():
            gqa[f"at_{arch}_{case}"] = _fields(r)
            gqa["split"][f"{arch}_{case}"] = r["split"]
            gqa["body"][f"{arch}_{case}"] = r["body"]
            if "split_sweep_ms" in r:
                gqa[f"{arch}_{case}_split_sweep_ms"] = r["split_sweep_ms"]
    gqa["tc_ptxas"] = {str(D): line for D, line in
                       _tc_ptxas(ptxas).items()}
    rows["mla_paged_flash"] = kernel_mla(gen, flush)
    for name, per in kernel_spec(gen, flush).items():
        for case, r in per.items():
            rows[name][f"at_{case}"] = _fields(r)
    torch.cuda.empty_cache()
    windows = kernel_windows(gen, flush, ptxas)
    for (name, kind, source, replaces, timed) in (
            ("gqa_paged_flash[partial]", "gqa",
             "src/repro_torch/kernels/csrc/paged_attention.cu",
             "src/repro/kernels/paged_attention.py:178", "granite_decode"),
            ("mla_paged_flash[partial]", "mla",
             "src/repro_torch/kernels/csrc/mla_attention.cu",
             "src/repro/kernels/paged_attention.py:302", "deepseek_decode")):
        per = windows[kind]
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, **_fields(per[timed]),
                      **{f"at_{k}": _fields(v) for k, v in per.items()
                         if k != timed},
                      "merge_max_abs_err": {k: v["merge_max_abs_err"]
                                            for k, v in per.items()},
                      "library_computes": per[timed]["library_computes"]}
    for name, per in kernel_api(gen, flush).items():
        source, replaces = API_KERNELS[name]
        rows[name] = {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, **_fields(per["m8"]),
                      "at_m256": _fields(per["m256"])}
        for k in ("library_null", "library_padded_rows"):
            if k in per["m8"]:
                rows[name][f"{k}_at_m8"] = per["m8"][k]
        for k in ("edges_entries_differing", "ragged_entries_differing"):
            if k in per:
                rows[name][k] = per[k]
    if torch.cuda.get_device_name(0).find("H100") < 0:
        log("kernel", note="bounds use the H100 SXM's published rates")
    return rows


def _fields(r):
    """The JSON line's keys of one case (and ``bare_ms``, the kernel
    alone, ``wrapper_ms``, the ``ops`` wrapper, and the host's enqueue
    times, where the case measured them)."""
    return {k: r[k] for k in ("max_abs_err", "ms", "bare_ms", "wrapper_ms",
                              "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "host_ms", "library_host_ms")
            if k in r}


# -- phase 4: the slice ------------------------------------------------------

def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if tree is None:
        return None
    return tree.to(device)


def phase_reference():
    """Reduced float32 granite served in kernel mode on the card (CUDA
    kernels) and on the CPU (their plain versions): the same tokens, the
    same per-layer tile fractions and, on the paged layout, the same
    prefix counters.  The paged run keeps a sliding window of 16 (a
    ring of 24 rows): its prompts of 20-32 tokens wrap the ring over
    pages they share with the prefix cache, which is what makes the pool
    copy on write (without a window no slot writes a shared page
    again)."""
    import numpy as np
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
    wcfg = cfg.replace(sliding_window=16)
    wreqs = make_trace(wcfg, 6, 4, 16, 6, 6, SEED, shared_prefix=16)
    longest = max((p for p, _ in wreqs), key=len)
    assert len(longest) >= 24
    wreqs += [(longest[:24].copy(), 6), (longest[:24].copy(), 6)]
    runs = {"slotted": (cfg, reqs, dict(layout="slotted", max_len=32)),
            "paged": (wcfg, wreqs, dict(layout="paged", max_len=40))}
    for layout, (c, rq, kw) in runs.items():
        out = {}
        for dev in ("cpu", "cuda"):
            eng = Engine(c, _to(params, dev), mor=_to(mor, dev),
                         mor_mode="kernel", n_slots=4,
                         capacities={"mor_stats": 0.5}, **kw)
            out[dev] = (eng.run(list(rq)), eng.telemetry.summary())
        assert out["cuda"][0] == out["cpu"][0], \
            f"{layout}: card and CPU tokens differ"
        assert out["cuda"][1] == out["cpu"][1], \
            f"{layout}: card and CPU telemetry differ"
        pc = out["cuda"][1].get("prefix_cache", {})
        if layout == "paged":
            assert pc["prefix_hits"] > 0 and pc["chunks_skipped"] > 0 \
                and pc["pages_cowed"] > 0, pc
        log("reference", model=f"granite-3-2b reduced f32 {layout}",
            window=c.sliding_window, requests=len(rq), tokens_equal=True,
            telemetry_equal=True,
            frac_tiles_computed=np.round(out["cuda"][1]["mor_stats"][
                "frac_tiles_computed"], 4).tolist(),
            **{k: pc[k] for k in ("prefix_hits", "chunks_skipped",
                                  "pages_cowed") if k in pc})


def reference_deepseek():
    """Reduced float32 deepseek-v2 (MLA + MoE; its experts widened to
    moe_d_ff 256, two column tiles, of which ``calibrate_moe``'s
    injection makes the trailing one dead) served in kernel mode through
    the paged engine with prefix caching and per-expert budgets, on the
    card (CUDA kernels, the expert grid) and on the CPU (the plain
    versions): the same tokens, the same (L, E) tile fractions and the
    same prefix counters."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.deploy import calibrate_moe
    from repro_torch.launch.serve import calib_batches, make_trace
    from repro_torch.models import get_model
    from repro_torch.serving import Engine
    cfg = reduce_config(get_config("deepseek-v2-236b")).replace(moe_d_ff=256)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(SEED), cfg)
    params, mor, _ = calibrate_moe(params, cfg, api.forward,
                                   calib_batches(cfg, 4, "cpu"), 2,
                                   inject_dead_frac=0.5)
    reqs = make_trace(cfg, 6, 4, 16, 6, 6, SEED, shared_prefix=16)
    reqs.append((reqs[0][0].copy(), 6))
    E = cfg.n_experts
    caps = {"dense_mor_stats": 0.5,
            "moe_mor_stats": np.linspace(0.25, 1.0, E)[None]}
    out = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, _to(params, dev), mor=_to(mor, dev),
                     mor_mode="kernel", n_slots=4, max_len=48,
                     capacities=caps)
        out[dev] = (eng.run(list(reqs)), eng.telemetry.summary())
    assert out["cuda"][0] == out["cpu"][0], \
        "deepseek: card and CPU tokens differ"
    assert out["cuda"][1] == out["cpu"][1], \
        "deepseek: card and CPU telemetry differ"
    tel = out["cuda"][1]
    pc = tel["prefix_cache"]
    assert pc["prefix_hits"] > 0 and pc["chunks_skipped"] > 0, pc
    moe = np.asarray(tel["moe_mor_stats"]["frac_tiles_computed"])
    assert moe.shape == (cfg.n_layers - cfg.first_k_dense, E)
    assert float(moe.max()) < 1.0, moe
    log("reference", model="deepseek-v2-236b reduced f32 paged (moe_d_ff "
        "256)", requests=len(reqs), tokens_equal=True,
        telemetry_equal=True,
        moe_frac_tiles_computed=np.round(moe, 4).tolist(),
        dense_frac_tiles_computed=np.round(tel["dense_mor_stats"][
            "frac_tiles_computed"], 4).tolist(),
        **{k: pc[k] for k in ("prefix_hits", "chunks_skipped")})
    # one speculative pass (k = 3, drafts at half capacity):
    # mla_paged_flash verifies 4 rows a slot
    spec = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(cfg, _to(params, dev), mor=_to(mor, dev),
                     mor_mode="kernel", n_slots=4, max_len=48,
                     capacities=caps, spec_k=3, draft_cap=0.5)
        spec[dev] = (eng.run(list(reqs)), eng.spec.report())
    assert spec["cuda"] == spec["cpu"], \
        "deepseek spec: card and CPU differ"
    sp = spec["cuda"][1]
    assert sp["rounds"] > 0, sp
    log("reference", model="deepseek-v2-236b reduced f32 paged spec",
        mode="kernel", draft_cap=0.5, tokens_equal=True,
        spec_counters_equal=True,
        **{k: sp[k] for k in ("rounds", "tokens_drafted",
                              "tokens_accepted")})


def _clear_prefix(pool):
    """Drop every prefix-cache entry of an idle paged pool (no slot holds
    a page, so each drop frees its page): published kv pages, then state
    snapshots (their state page and the kv pages they retain)."""
    while (pg := pool.prefix.evict_lru_page()) is not None:
        pool.kv.drop(pg)
    while (e := pool.prefix.evict_lru_snap()) is not None:
        pool._drop_snap(e)


def _first_diff(a, b):
    """(request, index, token in a, token in b) of the first greedy
    token where a and b differ, in request order; None if none does."""
    for r in sorted(b):
        for i, (x, y) in enumerate(zip(a[r], b[r])):
            if x != y:
                return (r, i, int(x), int(y))
    return None


def _serve(cfg, params, mor, mode, reqs, capacities=None, **engine_kw):
    """One counted pass, then one timed pass; on a paged layout with a
    prefix cache, the timed pass again with the cache cleared first
    (``cold_repeat_agreement``: the first pass's prompts chunked the same
    way); -> (tokens, report, engine)."""
    import torch
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, mor=mor, mor_mode=mode, n_slots=8,
                 max_len=max(len(p) for p, _ in reqs) + 18,
                 capacities=capacities, **engine_kw)
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
    rep["pass_s"] = wall
    rep["cold_pass_dispatches"] = 0
    if eng.pool is not None and eng.pool.prefix is not None:
        _clear_prefix(eng.pool)
        before = eng.counters["dispatches"]
        cold = eng.run(list(reqs))
        base = min(cold)
        cold = {rid - base: t for rid, t in cold.items()}
        rep["cold_pass_dispatches"] = eng.counters["dispatches"] - before
        rep["cold_repeat_agreement"] = _agree(cold, first)
        rep["cold_first_diff"] = _first_diff(cold, first)
    return first, rep, eng


def _repeats(rep):
    """The log fields of a pass's repeat rates against the first pass."""
    out = {"repeat_agreement": round(rep["repeat_agreement"], 4)}
    if "cold_repeat_agreement" in rep:
        out["cold_repeat_agreement"] = round(rep["cold_repeat_agreement"], 4)
        out["cold_first_diff"] = json.dumps(rep["cold_first_diff"])
    return out


def _dispatches(rep):
    """Dispatches of every counted pass of ``_serve``."""
    return (rep["first_pass_dispatches"] + rep["dispatches"]
            + rep["cold_pass_dispatches"])


def _profile(eng, reqs):
    """One more pass under ``torch.profiler``, tracing the device only
    (recording host ops would slow the host loop it measures): device
    time by kernel, and the device's idle share of the pass's wall
    time."""
    eng.reset_counters()
    _profile_fn(f"{eng.cfg.name}-{eng.layout}-{eng.mor_mode}",
                lambda: eng.run(list(reqs)),
                lambda: {"dispatches": eng.counters["dispatches"],
                         "host_ms_per_dispatch": round(
                             eng.counters["wall_s"] * 1e3
                             / max(eng.counters["dispatches"], 1), 3)})


def _profile_fn(tag, fn, extra=lambda: {}, top=12):
    """``fn`` once under ``torch.profiler`` (device only): device busy ms,
    the idle share of the wall time, the paged attentions' share, and the
    ``top`` kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device time by kernel name, summed straight off the raw trace
    # events: the same sums as key_averages(), without the event tree
    # it builds (tens of host seconds for a pass of ~10^5 launches)
    cuda = torch._C._autograd.DeviceType.CUDA
    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and e.duration_ns() > 0:
            us, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    rows = [(key, us, n) for key, (us, n) in by_name.items()]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    paged = sum(us for key, us, _ in rows if "paged_kernel" in key)
    log("profile", path=tag, **extra(),
        wall_ms=round(wall_us / 1e3, 2), device_busy_ms=round(busy / 1e3, 2),
        idle_share=round(1 - busy / wall_us, 4) if busy else "not measured",
        paged_attention_share=round(paged / busy, 4) if busy else 0.0)
    for key, us, n in rows[:top]:
        log("profile", path=tag, kernel=repr(key[:60]),
            ms=round(us / 1e3, 3), calls=n, share=round(us / busy, 4))
    return busy / 1e3, wall_us / 1e3


def _agree(a, b):
    import numpy as np
    return float(np.mean([np.mean(np.asarray(a[r]) == np.asarray(b[r]))
                          for r in b]))


def _counted(fn):
    """Run ``fn`` with every launch counter zeroed just before and read
    just after -> (fn's result, {kernel: launches})."""
    from repro_torch.kernels import binary_dot as bd
    from repro_torch.kernels import binary_dot_packed as bdp
    from repro_torch.kernels import gather_matmul as gm
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import mor_predict as mp
    from repro_torch.kernels import paged_attention as pa
    counters = {"mor_tile_mask": (mp, "launches"),
                "gather_matmul": (gm, "launches"),
                "masked_matmul_kdim": (mm, "launches"),
                "gqa_paged_flash": (pa, "launches"),
                "mla_paged_flash": (pa, "mla_launches"),
                "binary_dot": (bd, "launches"),
                "binary_dot_packed": (bdp, "launches"),
                "masked_matmul": (mm, "masked_launches")}
    for m, attr in counters.values():
        setattr(m, attr, 0)
    out = fn()
    return out, {k: getattr(m, attr) for k, (m, attr) in counters.items()}


def _want_launches(L, dispatches, paged, mla=False, shadow=0):
    """Per dispatch: every layer's FFN launches the predictor, two
    compacted products (gate, up) and the down product once (a MoE
    layer once for all its experts: the expert grid), and its attention
    the paged kernel of its kind on the paged layout; each of ``shadow``
    dense twin dispatches launches the paged attention once a layer
    more (its MoR work is plain)."""
    attn = L * (dispatches + shadow) if paged else 0
    return {"mor_tile_mask": L * dispatches,
            "gather_matmul": 2 * L * dispatches,
            "masked_matmul_kdim": L * dispatches,
            "gqa_paged_flash": 0 if mla else attn,
            "mla_paged_flash": attn if mla else 0,
            "binary_dot": 0, "binary_dot_packed": 0, "masked_matmul": 0}


def _check_tokens(cfg, reqs, toks):
    assert len(toks) == len(reqs)
    assert all(len(toks[i]) == g for i, (_, g) in enumerate(reqs))
    assert all(0 <= t < cfg.vocab_size for v in toks.values() for t in v)


def slice_slotted(cfg, params, mor):
    """The slotted path: 8 mixed requests in kernel mode
    (counted), tiled, dense and kernel at capacity 0.5."""
    import numpy as np
    reqs = _mixed_trace(cfg)
    kw = dict(layout="slotted")
    (tok_k, rep_k, eng_k), launches = _counted(
        lambda: _serve(cfg, params, mor, "kernel", reqs, **kw))
    counted = _dispatches(rep_k)
    want = _want_launches(cfg.n_layers, counted, paged=False)
    assert launches == want, (launches, want)
    _check_tokens(cfg, reqs, tok_k)
    tel = rep_k["telemetry"]["mor_stats"]
    assert all(np.isfinite(tel["frac_tiles_live"]))
    log("slice", path="slotted", mode="kernel",
        tok_s=round(rep_k["tokens_per_s"], 2),
        repeat_agreement=round(rep_k["repeat_agreement"], 4),
        dispatches=rep_k["dispatches"], launches=json.dumps(launches),
        skip_frac_per_layer=[round(1 - v, 4)
                             for v in tel["frac_tiles_computed"]])
    tok_t, rep_t, _ = _serve(cfg, params, mor, "tiled", reqs, **kw)
    tok_d, rep_d, eng_d = _serve(cfg, params, None, "dense", reqs, **kw)
    agree_t, agree_d = _agree(tok_k, tok_t), _agree(tok_k, tok_d)
    first_t = float(np.mean([tok_k[r][0] == tok_t[r][0] for r in tok_t]))
    log("slice", path="slotted", mode="tiled",
        tok_s=round(rep_t["tokens_per_s"], 2),
        repeat_agreement=round(rep_t["repeat_agreement"], 4),
        agreement_kernel_vs_tiled=round(agree_t, 4),
        first_token_agreement=round(first_t, 4))
    log("slice", path="slotted", mode="dense",
        tok_s=round(rep_d["tokens_per_s"], 2),
        repeat_agreement=round(rep_d["repeat_agreement"], 4),
        agreement_kernel_vs_dense=round(agree_d, 4))
    assert agree_t >= AGREE_MIN and agree_d >= AGREE_MIN, (agree_t, agree_d)
    tok_c, rep_c, _ = _serve(cfg, params, mor, "kernel", reqs,
                             capacities={"mor_stats": 0.5}, **kw)
    tel_c = rep_c["telemetry"]["mor_stats"]
    assert max(tel_c["frac_tiles_computed"]) <= 0.5 + 1e-6
    log("slice", path="slotted", mode="kernel", capacity=0.5,
        tok_s=round(rep_c["tokens_per_s"], 2),
        agreement_vs_capacity_1=round(_agree(tok_c, tok_k), 4),
        frac_tiles_computed_mean=round(
            float(np.mean(tel_c["frac_tiles_computed"])), 4))
    engine = {m: (r["tokens_per_s"], r["pass_s"]) for m, r in
              (("kernel", rep_k), ("tiled", rep_t), ("dense", rep_d))}
    return eng_k, eng_d, reqs, engine


def slice_paged(cfg, params, mor):
    """The main path: a shared-prefix trace through the paged kernel-mode
    engine (counted), then paged dense and slotted kernel on the same
    trace, timed, and held to greedy agreement."""
    reqs = _shared_prefix_trace(cfg)
    (tok_k, rep_k, eng_k), launches = _counted(
        lambda: _serve(cfg, params, mor, "kernel", reqs))
    counted = _dispatches(rep_k)
    want = _want_launches(cfg.n_layers, counted, paged=True)
    assert launches == want, (launches, want)
    _check_tokens(cfg, reqs, tok_k)
    pc = rep_k["prefix_cache"]
    # the counters describe the timed (warm) pass; pages_cowed stays 0
    # on a windowless model (see phase_reference)
    assert pc["prefix_hits"] > 0 and pc["chunks_skipped"] > 0, pc
    pool = eng_k.pool
    page_bytes = (cfg.n_layers * pool.page * cfg.n_kv_heads * cfg.head_dim
                  * 2 * 2)
    log("slice", path="paged", mode="kernel",
        tok_s=round(rep_k["tokens_per_s"], 2), **_repeats(rep_k),
        dispatches=rep_k["dispatches"],
        first_pass_dispatches=rep_k["first_pass_dispatches"],
        launches=json.dumps(launches), n_pages=pool.n_pages,
        n_blocks=pool.n_blocks, page_kv_bytes=page_bytes,
        pool_gb=round((pool.n_pages + 1) * page_bytes / 1e9, 3),
        prefix=json.dumps({k: pc[k] for k in (
            "hit_rate", "prefix_hits", "prefix_queries", "pages_shared",
            "chunks_skipped", "tokens_skipped", "pages_cowed",
            "pages_evicted")}))
    tok_d, rep_d, _ = _serve(cfg, params, None, "dense", reqs)
    tok_s, rep_s, _ = _serve(cfg, params, mor, "kernel", reqs,
                             layout="slotted")
    agree_d, agree_s = _agree(tok_k, tok_d), _agree(tok_k, tok_s)
    for name, rep in (("paged kernel", rep_k), ("paged dense", rep_d),
                      ("slotted kernel", rep_s)):
        log("slice", trace="shared-prefix", path=name,
            tok_s=round(rep["tokens_per_s"], 2),
            decode_tok_s=round(rep["decode_tokens"] / rep["pass_s"], 2),
            pass_s=round(rep["pass_s"], 3), dispatches=rep["dispatches"],
            prefill_tokens=rep["prefill_tokens"], **_repeats(rep))
    log("slice", trace="shared-prefix",
        agreement_paged_kernel_vs_paged_dense=round(agree_d, 4),
        agreement_paged_kernel_vs_slotted_kernel=round(agree_s, 4))
    assert agree_d >= AGREE_MIN and agree_s >= AGREE_MIN, (agree_d, agree_s)
    return eng_k, reqs, launches, tok_k


# -- the static batch (launch.serve.static_batch, launch.steps) -------------

# launches a static dispatch of granite-3-2b (DEPTH layers): one
# predictor, two compacted products (gate, up) and one down product a
# layer
GRANITE_STATIC = {"mor_tile_mask": DEPTH["granite-3-2b"],
                  "gather_matmul": 2 * DEPTH["granite-3-2b"],
                  "masked_matmul_kdim": DEPTH["granite-3-2b"]}
# deepseek-v2-236b cut to 3 layers: layer 0's dense FFN and each MoE
# layer's expert grid (one launch for all 160 experts; the shared
# experts stay dense)
DEEPSEEK_STATIC = {"mor_tile_mask": 3, "gather_matmul": 6,
                   "masked_matmul_kdim": 3}
STATIC_SLOTS, STATIC_NEW = 8, 16


def _static_dispatches(reqs, passes):
    """Dispatches of ``static_batch``: a group's batched prefill and one
    decode step a token of its longest request, over the warm-up group
    and ``passes`` passes over every group."""
    per = [1 + max(g for _, g in reqs[i:i + STATIC_SLOTS])
           for i in range(0, len(reqs), STATIC_SLOTS)]
    return per[0] + passes * sum(per)


def _static_cell(cfg, params, mor, reqs, path, modes, engine,
                 per_dispatch, passes=3):
    """The static-batch path (``launch.serve.static_batch``, the serve
    CLI's ``--baseline``) on ``reqs``: groups of 8 left-padded to the
    trace's longest prompt, one batched prefill (M = 8 x that prompt in
    the FFN kernels), then 1-row decode steps until the group's longest
    request is done; a warm-up group, then the best of ``passes``.  In
    kernel mode counted (``per_dispatch`` launches a dispatch), then
    ``modes`` held to greedy agreement with it.  Each mode's tokens/s
    and pass seconds beside the engine's on the same trace (``engine``
    {mode: (tok/s, pass s)}): the engine counts the tokens it computed
    (prefix hits skip theirs), the static batch every prompt and
    requested token, as the JAX CLI's ``--baseline`` does, so the pass
    seconds are the like-for-like ratio.  -> kernel-mode launches."""
    from repro_torch.launch.serve import static_batch

    def run(mode):
        return static_batch(cfg, params, reqs, n_slots=STATIC_SLOTS,
                            mor=None if mode == "dense" else mor,
                            mor_mode=mode, timed_passes=passes)
    (tok_s, tok_k, wall), launches = _counted(lambda: run("kernel"))
    n = _static_dispatches(reqs, passes)
    want = {k: per_dispatch.get(k, 0) * n for k in launches}
    assert launches == want, (launches, want)
    _check_tokens(cfg, reqs, tok_k)
    Pmax = max(len(p) for p, _ in reqs)
    log("slice", path=path, mode="kernel", dispatches=n,
        prefill_rows=STATIC_SLOTS * Pmax, launches=json.dumps(launches),
        launches_per_dispatch=json.dumps(
            {k: v / n for k, v in launches.items() if v}))
    results = {"kernel": (tok_s, wall)}
    for mode in modes:
        t_s, tok, w = run(mode)
        results[mode] = (t_s, w)
        agree = _agree(tok_k, tok)
        log("slice", path=path, **{f"agreement_kernel_vs_{mode}":
                                   round(agree, 4)})
        assert agree >= AGREE_MIN, (mode, agree)
    for mode, (t_s, w) in results.items():
        e_tok, e_s = engine.get(mode, (None, None))
        log("slice", path=path, mode=mode, static_tok_s=round(t_s, 2),
            static_pass_s=round(w, 3),
            engine_tok_s=e_tok and round(e_tok, 2),
            engine_pass_s=e_s and round(e_s, 3),
            engine_speedup_vs_static=e_tok and round(e_tok / t_s, 3),
            static_over_engine_pass_s=e_s and round(w / e_s, 3))
    return launches


def _left_padded(reqs):
    import torch
    from repro_torch.launch.serve import left_pad
    group = reqs[:STATIC_SLOTS]
    Pmax = max(len(p) for p, _ in group)
    return torch.as_tensor(left_pad([p for p, _ in group], STATIC_SLOTS,
                                    Pmax), device="cuda")


def _serve_step_cell(cfg, params, mor, reqs, path, per_dispatch):
    """``make_serve_step`` over ``cache_init``'s shared-position cache:
    the first 8 requests left-padded, one ``api.prefill``, then 16
    ``decode_step``s, in kernel (counted) and dense mode, kernel held to
    greedy agreement with dense.  A model without experts is also held
    to ``generate``'s dense tokens on the slot pool (the same model, its
    attention summed in another order).  A MoE model only logs that
    agreement: its ``decode_step`` routes without a token mask, as the
    JAX package's does, so each expert takes at most capacity_factor x
    8 x top_k / E of the 8 rows and drops the others, where
    ``generate``'s chunk step provisions every row."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import get_model
    api = get_model(cfg)
    prompts = _left_padded(reqs)
    want, _ = generate(cfg, api, params, prompts, STATIC_NEW)

    def run(mode):
        m = None if mode == "dense" else mor
        cache = api.cache_init(cfg, STATIC_SLOTS,
                               prompts.shape[1] + STATIC_NEW + 1,
                               cfg.tdtype, "cuda")
        nxt = torch.argmax(api.prefill(params, cfg, prompts, cache, mor=m,
                                       mor_mode=mode), -1)
        step = make_serve_step(cfg, mor=m, mor_mode=mode)
        out = []
        for _ in range(STATIC_NEW):
            nxt, cache = step(params, cache, nxt[:, None])
            out.append(nxt)
        return torch.stack(out, 1).cpu().numpy()
    got_k, launches = _counted(lambda: run("kernel"))
    n = 1 + STATIC_NEW
    want_l = {k: per_dispatch.get(k, 0) * n for k in launches}
    assert launches == want_l, (launches, want_l)
    got_d = run("dense")
    agree = {"kernel_vs_dense": float(np.mean(got_k == got_d)),
             "kernel_vs_generate_dense": float(np.mean(got_k == want)),
             "dense_vs_generate_dense": float(np.mean(got_d == want))}
    log("slice", path=path, dispatches=n, launches=json.dumps(launches),
        **{f"agreement_{k}": round(v, 4) for k, v in agree.items()})
    held = [agree["kernel_vs_dense"]]
    if cfg.family != "moe":
        held += [agree["kernel_vs_generate_dense"],
                 agree["dense_vs_generate_dense"]]
    assert min(held) >= AGREE_MIN, agree
    return launches


def _static_profile(cfg, params, mor, reqs):
    """One kernel-mode static decode pass (16 steps of the first 8
    requests after their prefill) under the profiler: device busy, idle
    share and the host's ms a step, beside the engine's profiles."""
    import time as _t
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.serving import kv_pool
    prompts = _left_padded(reqs)
    cache = kv_pool.init(cfg, STATIC_SLOTS, prompts.shape[1] + STATIC_NEW
                         + 1, device="cuda")
    nxt, cache = make_prefill_step(cfg, mor, "kernel")(params, cache,
                                                        prompts)
    step = make_decode_step(cfg, mor, "kernel")
    host = []

    def loop():
        nonlocal nxt, cache
        t0 = _t.perf_counter()
        for _ in range(STATIC_NEW):
            nxt, cache, _ = step(params, cache, nxt[:, None])
        host.append(_t.perf_counter() - t0)
    _profile_fn(f"{cfg.name}-static-kernel", loop,
                lambda: {"dispatches": STATIC_NEW,
                         "host_ms_per_dispatch": round(
                             host[0] * 1e3 / STATIC_NEW, 3)})


def phase_slice():
    import torch
    from repro_torch.core.deploy import calibrate_lm
    from repro_torch.launch.serve import calib_batches
    from repro_torch.models import get_model
    cfg = _cut_config("granite-3-2b")
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
    eng_sk, eng_sd, reqs_s, engine = slice_slotted(cfg, params, mor)
    skip = [1 - v for v in
            eng_sk.report()["telemetry"]["mor_stats"]["frac_tiles_computed"]]
    eng_pk, reqs_p, launches, tokens = slice_paged(cfg, params, mor)
    static = _static_cell(cfg, params, mor, reqs_s, "granite static",
                          ("tiled", "dense"), engine, GRANITE_STATIC)
    _serve_step_cell(cfg, params, mor, reqs_s, "granite serve_step",
                     GRANITE_STATIC)
    # profiled last, so that the profiler cannot touch the timings above
    _profile(eng_pk, reqs_p)
    _profile(eng_sk, reqs_s)
    _profile(eng_sd, reqs_s)
    _static_profile(cfg, params, mor, reqs_s)
    log("slice", peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9,
                                   2))
    return launches, tokens, static, (cfg, params, mor), skip


# -- self-speculative decoding (serving.spec) --------------------------------

SPEC_NEW = 32                      # new tokens a request on the spec path


def _device_busy_ms(fn, n=3):
    """Mean device busy ms of one call of ``fn``: one warm call, then
    ``n`` calls under ``torch.profiler`` (device only), their kernels'
    durations summed off the raw trace events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    cuda = torch._C._autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6 / n


def _phase_device_ms(eng, reqs, n=3):
    """Device busy ms of one decode, one draft and one verify dispatch of
    ``eng`` (spec_k = k), once every slot of ``reqs`` decodes: each
    dispatch is called ``n`` times at the same positions (its kv rows
    rewritten, nothing advanced) under the profiler, so that its device
    time is measured apart from the host's enqueue (the host takes ~7x
    longer a dispatch; a spin cannot hide it: the launch queue fills).
    The decode is a 1-row dispatch under the target plans; the draft the
    same under the draft plans; the verify k + 1 rows a slot of random
    draft tokens.  -> {kind: ms}; the engine is left mid-trace."""
    import numpy as np
    import torch
    from repro_torch.serving import spec as sp
    for p, g in reqs:
        eng.submit(p, g)
    for _ in range(64):
        if eng.scheduler.peek_kind() == "decode":
            break
        eng.step()
    dec, pool = eng.spec, eng.pool
    B, K, e = eng.n_slots, dec.k, (eng.cfg, eng.api, eng.mor_mode)
    nv = np.ones((B,), np.int32)
    nvv = np.full((B,), K + 1, np.int32)
    pool.plan_writes(nvv)
    cache_v, nvv_t, _ = dec._prepare(nvv)
    cache_d, nv_t, _ = dec._prepare(nv)
    toks = torch.randint(0, eng.cfg.vocab_size, (B, K + 1),
                         device="cuda", dtype=torch.int32)
    pending = eng._pending.clone()
    return {
        "decode": _device_busy_ms(lambda: sp.draft_step_impl(
            *e, 0.0, 0, eng.params, eng.mor, cache_d, nv_t, pending), n),
        "draft": _device_busy_ms(lambda: sp.draft_step_impl(
            *e, 0.0, 0, eng.params, dec.mor_draft, cache_d, nv_t,
            pending), n),
        "verify": _device_busy_ms(lambda: sp.verify_step_impl(
            *e, 0.0, 0, eng.params, eng.mor, cache_v, toks.clone(), nvv_t,
            pending), n)}


def phase_spec(model):
    """Self-speculative decoding on granite-3-2b (DEPTH layers, bf16,
    paged, kernel mode): the slotted cell's 8 mixed requests with
    SPEC_NEW new tokens each, vanilla and then with spec_k = SPEC_K at
    draft_cap 0 (the draft plans are the target's), 0.5 and 0.25 (the
    drafts' gather budget cut to that fraction of the tile grid).  Each
    run is one counted pass (launches: ``_want_launches`` over every
    dispatch, draft and verify included: each launches 40 of each MoR
    kernel, 80 gather_matmul, and 40 gqa_paged_flash) on a fresh engine,
    timed: acceptance, tokens a round, rounds, aborts, pass s and decode
    tokens/s beside vanilla's, host ms a dispatch, greedy agreement with
    vanilla (AGREE_MIN) and the exact-equal fraction (bf16 near-ties
    flip between a 1-wide and a 5-wide dispatch: the live-tile mask of a
    verify is not a decode's); then each config's decode, draft and
    verify dispatch alone on the device (``_phase_device_ms``), and one
    profiled warm pass (the second) at draft_cap 0: device busy a
    round.  ->
    (launches of the draft_cap 0.5 run, vanilla tokens)."""
    import numpy as np
    import torch
    from repro_torch.serving import Engine
    cfg, params, mor = model
    L = cfg.n_layers
    reqs = [(p, SPEC_NEW) for p, _ in _mixed_trace(cfg)]
    max_len = max(len(p) for p, _ in reqs) + SPEC_NEW + SPEC_K + 2

    def engine(**kw):
        return Engine(cfg, params, mor=mor, mor_mode="kernel", n_slots=8,
                      max_len=max_len, **kw)

    def run(eng):
        emitted = [0]
        if eng.spec is not None:
            feed = eng.scheduler.feed_counts

            def counted(c):
                emitted[0] += int(np.sum(c))
                return feed(c)
            eng.scheduler.feed_counts = counted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = eng.run(list(reqs))
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0, emitted[0]

    runs, out = {}, {}
    for cap in (None, 0.0) + DRAFT_CAPS:
        kw = {} if cap is None else dict(spec_k=SPEC_K, draft_cap=cap)
        eng = engine(**kw)
        (toks, wall, emitted), launches = _counted(lambda: run(eng))
        n = eng.counters["dispatches"]
        want = _want_launches(L, n, paged=True)
        assert launches == want, (cap, launches, want)
        _check_tokens(cfg, reqs, toks)
        tag = "vanilla" if cap is None else f"draft_cap_{cap}"
        runs[tag] = toks
        row = {"pass_s": round(wall, 3),
               "decode_tok_s": round(eng.counters["decode_tokens"] / wall, 2),
               "dispatches": n,
               "dispatch_kinds": json.dumps(eng.scheduler.dispatch_kinds),
               "host_ms_per_dispatch": round(
                   eng.counters["wall_s"] * 1e3 / n, 3),
               "launches": json.dumps(launches)}
        if cap is not None:
            sp = eng.spec.report()
            agree = _agree(toks, runs["vanilla"])
            exact = float(np.mean([toks[r] == runs["vanilla"][r]
                                   for r in toks]))
            assert agree >= AGREE_MIN, (cap, agree)
            row.update(acceptance_rate=round(sp["acceptance_rate"], 4),
                       tokens_per_round=round(emitted / sp["rounds"], 3),
                       **{k: sp[k] for k in ("rounds", "tokens_drafted",
                                             "tokens_accepted", "aborts")},
                       agreement_vs_vanilla=round(agree, 4),
                       exact_equal_fraction=round(exact, 4),
                       speedup_vs_vanilla=round(
                           out["vanilla"]["pass_s"] / wall, 4))
        out[tag] = row
        if cap == 0.0:
            warm = eng
        if cap == DRAFT_CAPS[0]:
            spec_launches = launches
        log("spec", path="granite spec", config=tag, **row)
        del eng
    for cap in (0.0,) + DRAFT_CAPS:
        ms = _phase_device_ms(engine(spec_k=SPEC_K, draft_cap=cap), reqs)
        log("spec", path="granite spec", config=f"draft_cap_{cap}",
            **{f"{k}_device_ms": round(v, 3) for k, v in ms.items()},
            verify_over_decode=round(ms["verify"] / ms["decode"], 4),
            draft_over_decode=round(ms["draft"] / ms["decode"], 4))
    eng = warm
    eng.reset_counters()
    busy, _ = _profile_fn(
        f"{cfg.name}-spec-draft_cap_0.0",
        lambda: eng.run(list(reqs)),
        lambda: {"dispatches": eng.counters["dispatches"],
                 "host_ms_per_dispatch": round(
                     eng.counters["wall_s"] * 1e3
                     / max(eng.counters["dispatches"], 1), 3)})
    log("spec", path="granite spec", config="draft_cap_0.0",
        profiled_rounds=eng.spec.counters["rounds"],
        device_busy_ms_per_round=round(
            busy / max(eng.spec.counters["rounds"], 1), 3))
    return spec_launches, runs["vanilla"]


SLO_SHORT = 4


def _timed_calls(obj, name, into):
    """Wrap ``obj.name`` so that each call's host ms, a device sync
    included, lands in ``into``."""
    import torch
    real = getattr(obj, name)

    def call(*a, **kw):
        t0 = time.perf_counter()
        res = real(*a, **kw)
        torch.cuda.synchronize()
        into.append((time.perf_counter() - t0) * 1e3)
        return res
    setattr(obj, name, call)


def phase_slo(model, vanilla):
    """The SLO layer on granite-3-2b (paged, kernel mode): the spec
    phase's trace (8 requests, SPEC_NEW new tokens each) on a kv pool
    SLO_SHORT pages short of what the 8 requests hold at their end, so
    that the engine must spill victims to the host and restore them:
    spills, restores,
    bytes moved, ms a spill and a restore (a device sync included), and
    the tokens against the unpressured run (``vanilla``; exact-equal
    fraction, AGREE_MIN).  Then open-loop traffic: the rate the engine
    sustains, measured on a closed-loop pass over a seeded Poisson trace
    (prompts 8-64, 8-24 new tokens, a quarter at priority 5), and a
    ~10 s ``run_open_loop`` of a trace at 1.5x that rate, 2% of it
    oversize, under ``policy="priority"`` with the tracer on: TTFT p50 /
    p99 per class, preemptions, rejections and requests lost (0)."""
    import numpy as np
    import torch
    from repro_torch.obs import Observability
    from repro_torch.serving import Engine
    from repro_torch.serving.loadgen import (latency_stats, poisson_trace,
                                             run_open_loop)
    cfg, params, mor = model
    reqs = [(p, SPEC_NEW) for p, _ in _mixed_trace(cfg)]
    page = cfg.serve_page
    max_len = max(len(p) for p, _ in reqs) + SPEC_NEW + SPEC_K + 2
    need = [-(-(len(p) + g) // page) for p, g in reqs]
    n_blocks = -(-max_len // page)
    # SLO_SHORT pages short of what the 8 requests hold at the end: a
    # much tighter pool ends in PoolExhausted, the reference's own
    # behaviour (tests/test_torch_slo.py::test_pool_too_small_exhausts_as_jax)
    pages = sum(need) - SLO_SHORT
    eng = Engine(cfg, params, mor=mor, mor_mode="kernel", n_slots=8,
                 max_len=max_len, prefix_cache=False,
                 spare_pages=pages - 8 * n_blocks)
    assert eng.pool.n_pages - 1 == pages
    spill_ms, restore_ms = [], []
    _timed_calls(eng.pool, "spill", spill_ms)
    _timed_calls(eng.pool, "restore", restore_ms)
    t0 = time.perf_counter()
    toks = eng.run(list(reqs))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _check_tokens(cfg, reqs, toks)
    ev = eng.pool.spill_events
    assert ev["spills"] > 0 and ev["restores"] == ev["spills"], ev
    eng.pool.kv.check(eng.pool.external_refs("kv"))
    agree = _agree(toks, vanilla)
    assert agree >= AGREE_MIN, agree
    log("slo", path="granite pressured pool", kv_pages=pages,
        pages_needed=sum(need), pass_s=round(wall, 3),
        preemptions=eng.counters["preemptions"], **ev,
        spill_ms_mean=round(float(np.mean(spill_ms)), 3),
        restore_ms_mean=round(float(np.mean(restore_ms)), 3),
        agreement_vs_unpressured=round(agree, 4),
        exact_equal_fraction=round(float(np.mean(
            [toks[r] == vanilla[r] for r in toks])), 4))
    del eng
    shape = dict(vocab_size=cfg.vocab_size, prompt_len=(8, 64),
                 max_new=(8, 24), hi_pri_frac=0.25)
    calib = poisson_trace(2.0, 8.0, seed=SEED + 7, **shape)
    max_len = 64 + 24 + 2
    eng = Engine(cfg, params, mor=mor, mor_mode="kernel", n_slots=8,
                 max_len=max_len, policy="priority")
    eng.run([(a.prompt, a.max_new_tokens) for a in calib[:2]])  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run([(a.prompt, a.max_new_tokens) for a in calib])
    torch.cuda.synchronize()
    sustained = len(calib) / (time.perf_counter() - t0)
    rate = 1.5 * sustained
    trace = poisson_trace(rate, 10.0, seed=SEED + 8, oversize_frac=0.02,
                          max_len=max_len, **shape)
    obs = Observability(device_metrics=False)
    eng = Engine(cfg, params, mor=mor, mor_mode="kernel", n_slots=8,
                 max_len=max_len, policy="priority", obs=obs)
    res = run_open_loop(eng, trace)
    lost = [rid for rid, i in res.submitted.items()
            if len(eng.results.get(rid, [])) != trace[i].max_new_tokens]
    assert not lost, lost
    st = latency_stats(obs.tracer.request_spans(), res.submitted, trace)
    log("slo", path="granite open loop", policy="priority",
        closed_loop_requests=len(calib),
        sustained_req_s=round(sustained, 3), offered_req_s=round(rate, 3),
        arrivals=len(trace), submitted=res.n_submitted,
        rejected=len(res.rejected), wall_s=round(res.wall_s, 3),
        preemptions=eng.counters["preemptions"],
        spills=eng.pool.spill_events["spills"], requests_lost=len(lost),
        ttft=json.dumps({k: {q: round(v, 4) if isinstance(v, float) else v
                             for q, v in d.items()}
                         for k, d in st.items()}))


# -- training (launch.steps, optim, checkpoint, launch.train) ----------------

# the CPU tests' tolerances (tests/test_torch_train.py): the loss, the
# gradients and what is linear or quadratic in them (moments, the params
# after a step other than the first), Adam's first step entry by entry
TRAIN_LOSS_TOL, TRAIN_GRAD_RTOL, TRAIN_ADAM_TOL = 1e-5, 1e-4, 1e-6
# the full-width train phase: granite-3-2b's own grad_accum (4) over a
# global batch of 8 x 512 tokens (micro-batches of 2)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
RESUME_TOL = 1e-3


def _tree_np(tree):
    """{key path: float32 numpy copy} of a tree on any device."""
    from repro_torch.tree import paths
    return {k: v.detach().float().cpu().numpy().copy()
            for k, v in paths(tree).items()}


def _train_close(got, want, what, first_mu=None, lr=0.0):
    """Hold ``got`` to ``want`` leaf by leaf at the gradients' tolerance
    (rtol TRAIN_GRAD_RTOL, absolute floor TRAIN_GRAD_RTOL x the leaf's
    largest entry).  With ``first_mu`` (the first step's first moment),
    the params after Adam's first step: within TRAIN_ADAM_TOL where the
    gradient is above the floor, within 2 lr where it is at the noise
    level (there the update's sign may differ)."""
    import numpy as np
    assert got.keys() == want.keys(), what
    worst = 0.0
    for k in want:
        w, g = want[k], got[k]
        if first_mu is None:
            floor = TRAIN_GRAD_RTOL * max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=TRAIN_GRAD_RTOL,
                                       atol=floor, err_msg=f"{what} {k}")
        else:
            mu = first_mu[k]
            live = np.abs(mu) >= TRAIN_GRAD_RTOL * np.abs(mu).max()
            np.testing.assert_allclose(g[live], w[live], rtol=TRAIN_ADAM_TOL,
                                       atol=TRAIN_ADAM_TOL,
                                       err_msg=f"{what} {k}")
            assert np.abs(g - w)[~live].max(initial=0.0) <= \
                2 * lr + TRAIN_ADAM_TOL, (what, k)
        worst = max(worst, float(np.abs(g - w).max()))
    return worst


def reference_train():
    """Reduced float32 granite, three steps of ``make_train_step`` at
    grad_accum 2 on the card and on the CPU.  Each card step starts from
    the CPU's state before it (params, moments, step counter copied
    over), so that each step is held alone: loss, grad norm and lr, the
    moments and the params after it within the CPU tests' tolerances.
    Then three free-running card steps from the same init: their losses'
    largest difference from the CPU's is logged."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import steps
    from repro_torch.optim import OptConfig
    cfg = reduce_config(get_config("granite-3-2b")).replace(grad_accum=2)
    opt = OptConfig(lr=1e-3, moment_dtype="float32")
    params, state = steps.init_train_state(
        torch.Generator().manual_seed(SEED), cfg, opt)
    free = (_to(params, "cuda"), _to(state, "cuda"))
    step = steps.make_train_step(cfg, opt, total_steps=10, warmup=1)
    batches = [{k: torch.as_tensor(v) for k, v in
                make_batch(cfg, 4, 32, seed=SEED, step=s).items()}
               for s in range(3)]
    cpu_losses, worst = [], {}
    for i, b in enumerate(batches):
        cp, cs = _to(params, "cuda"), _to(state, "cuda")
        cp, cs, cm = step(cp, cs, _to(b, "cuda"))
        params, state, m = step(params, state, b)
        cpu_losses.append(float(m["loss"]))
        for name in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(
                float(cm[name]), float(m[name]),
                rtol=TRAIN_LOSS_TOL if name == "loss" else TRAIN_GRAD_RTOL,
                err_msg=f"step {i} {name}")
        mu = _tree_np(state["mu"])
        worst[f"mu_{i}"] = _train_close(_tree_np(cs["mu"]), mu, "mu")
        worst[f"nu_{i}"] = _train_close(_tree_np(cs["nu"]),
                                        _tree_np(state["nu"]), "nu")
        worst[f"params_{i}"] = _train_close(
            _tree_np(cp), _tree_np(params), "params",
            first_mu=mu if i == 0 else None, lr=float(m["lr"]))
        assert int(cs["step"]) == int(state["step"]) == i + 1
    fp, fs = free
    free_losses = []
    for b in batches:
        fp, fs, fm = step(fp, fs, _to(b, "cuda"))
        free_losses.append(float(fm["loss"]))
    assert np.all(np.isfinite(free_losses))
    log("reference", model="granite-3-2b reduced f32 train",
        grad_accum=cfg.grad_accum, steps=len(batches),
        losses_cpu=[round(x, 6) for x in cpu_losses],
        per_step_held=True,
        max_abs_diff=json.dumps({k: float(f"{v:.3g}")
                                 for k, v in worst.items()}),
        free_running_max_loss_diff=float(
            f"{max(abs(a - b) for a, b in zip(free_losses, cpu_losses)):.3g}"))


def _device_batches(cfg, n, start=0, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    import torch
    from repro_torch.data.pipeline import make_batch
    return [{k: torch.as_tensor(v, device="cuda") for k, v in
             make_batch(cfg, batch, seq, seed=SEED, step=s).items()}
            for s in range(start, start + n)]


def _resume_check(cfg, opt):
    """Full width cut to 2 layers: 4 straight steps against 2 steps, a
    blocking save into a temporary directory, a restore into a fresh
    tree from another seed, and 2 more steps; -> the log fields."""
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import steps
    c2 = cfg.replace(n_layers=2)
    step = steps.make_train_step(c2, opt, total_steps=4)
    batches = _device_batches(c2, 4)

    def run(p, s, lo, hi):
        out = []
        for b in batches[lo:hi]:
            p, s, m = step(p, s, b)
            out.append(m["loss"])
        return p, s, [float(x) for x in out]

    def init(seed):
        return steps.init_train_state(
            torch.Generator(device="cuda").manual_seed(seed), c2, opt)

    _, _, straight = run(*init(SEED), 0, 4)
    p, s, first = run(*init(SEED), 0, 2)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        t0 = time.perf_counter()
        mgr.save(2, {"params": p, "opt": s}, block=True)
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                   if f.is_file())
        del p, s
        t0 = time.perf_counter()
        p, s = init(SEED + 1)      # the restore must overwrite every leaf
        state, extra = mgr.restore({"params": p, "opt": s})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    assert extra["step"] == 2 and int(state["opt"]["step"]) == 2
    _, _, rest = run(state["params"], state["opt"], 2, 4)
    diff = max(abs(a - b) for a, b in zip(straight[2:], rest))
    assert diff <= RESUME_TOL, (straight, first, rest)
    return {"resume_layers": c2.n_layers, "resume_state_gb": round(
        disk / 1e9, 3), "save_s": round(save_s, 2),
        "restore_s": round(restore_s, 2),
        "straight_losses": [round(x, 5) for x in straight],
        "resumed_losses": [round(x, 5) for x in first + rest],
        "resume_max_loss_diff": float(f"{diff:.3g}")}


def phase_train(random_skip):
    """granite-3-2b at DEPTH layers (bf16 params, remat
    nothing_saveable, its grad_accum of 4) trained ``TRAIN_STEPS`` steps
    on a global batch of 8 x 512 tokens through ``init_train_state`` /
    ``make_train_step`` (AdamW with bf16 moments and a float32 master
    copy, as the train CLI sets them for a bf16 model): step ms,
    tokens/s, the model-FLOPs share (6 N T / step time over the bf16
    peak), peak memory, AdamW's device ms a step (CUDA events around
    ``adamw_update``), losses and grad norm; one more step profiled
    (device busy, idle share, top kernels).  Then the resume check at
    full width cut to 2 layers, the train CLI's calibration step
    (``launch.train.calibrate``) on the trained weights and a kernel-mode
    paged serve of them, the mixed trace's 8 requests (counted), held to
    tiled mode at AGREE_MIN.  -> the serve's launches."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.launch.train import calibrate
    from repro_torch.optim import OptConfig
    from repro_torch.tree import leaves
    cfg = _cut_config("granite-3-2b")
    assert cfg.grad_accum == 4 and cfg.remat == "nothing_saveable"
    opt = OptConfig(lr=1e-3, moment_dtype="bfloat16")
    resident_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params, state = steps.init_train_state(
        torch.Generator(device="cuda").manual_seed(SEED), cfg, opt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in leaves(params))
    state_gb = sum(t.numel() * t.element_size()
                   for t in leaves(params) + leaves(state)) / 1e9
    adam_events = []
    orig = steps.adamw_update

    def timed_adamw(*a, **k):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = orig(*a, **k)
        e1.record()
        adam_events.append((e0, e1))
        return out

    train_step = steps.make_train_step(cfg, opt, total_steps=TRAIN_STEPS)
    batches = _device_batches(cfg, TRAIN_STEPS)
    metrics, step_s = [], []
    steps.adamw_update = timed_adamw
    try:
        for b in batches:
            t0 = time.perf_counter()
            params, state, m = train_step(params, state, b)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            metrics.append(m)
    finally:
        steps.adamw_update = orig
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    assert np.all(np.isfinite(losses)) and np.all(np.isfinite(norms))
    adam_ms = [e0.elapsed_time(e1) for e0, e1 in adam_events]
    warm = float(np.median(step_s[1:]))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # 6 N T over the step at the bf16 peak: N the active params of
    # ``param_count`` (``roofline.model_flops``), and every leaf's numel
    # (the norm scales too), the share this phase printed before
    shape = ShapeSpec("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    mf = roofline.model_flops(cfg, shape, 1)
    log("train", path="granite train", model=cfg.name, layers=cfg.n_layers,
        params=n_params, dtype=cfg.dtype, remat=cfg.remat,
        grad_accum=cfg.grad_accum, micro_batch=TRAIN_BATCH // cfg.grad_accum,
        seq=TRAIN_SEQ, steps=TRAIN_STEPS, init_s=round(init_s, 2),
        resident_before_gb=round(resident_gb, 2),
        params_and_state_gb=round(state_gb, 2),
        first_step_s=round(step_s[0], 3),
        step_ms=round(warm * 1e3, 2),
        step_ms_all=[round(s * 1e3, 1) for s in step_s],
        tokens_per_s=round(tokens / warm, 1),
        model_flops_share=round(mf["model_flops_per_chip"] / warm
                                / roofline.PEAK_FLOPS, 4),
        model_flops_share_leaf_numel=round(
            6 * n_params * tokens / warm / roofline.PEAK_FLOPS, 4),
        params_active=mf["params_active"],
        adamw_ms=round(float(np.median(adam_ms[1:])), 2),
        adamw_ms_all=[round(x, 2) for x in adam_ms],
        peak_gb=round(peak_gb, 2), loss_first=round(losses[0], 5),
        loss_last=round(losses[-1], 5), losses=[round(x, 5) for x in losses],
        grad_norm_last=round(norms[-1], 4))
    # one more step under the profiler (the device's busy time and idle
    # share of a step, its top kernels); calibration takes its params
    _profile_fn(f"{cfg.name}-train-step", lambda: train_step(
        params, state, batches[0]), lambda: {"steps": 1})
    del state, metrics, batches, train_step
    torch.cuda.empty_cache()
    log("train", path="granite train resume", **_resume_check(cfg, opt))
    t0 = time.perf_counter()
    params, mor, cal = calibrate(params, cfg, TRAIN_BATCH, TRAIN_SEQ, SEED,
                                 "cuda")
    torch.cuda.synchronize()
    log("train", path="granite train calibrate",
        calibrate_s=round(time.perf_counter() - t0, 2),
        calib_batches=cfg.mor.calib_batches,
        **{k: round(v, 4) for k, v in cal.items()})
    reqs = _mixed_trace(cfg)
    kw = dict(layout="slotted")        # the granite phase's random-init cell
    (tok_k, rep_k, _), launches = _counted(
        lambda: _serve(cfg, params, mor, "kernel", reqs, **kw))
    want = _want_launches(cfg.n_layers, _dispatches(rep_k), paged=False)
    assert launches == want, (launches, want)
    _check_tokens(cfg, reqs, tok_k)
    tok_t, _, _ = _serve(cfg, params, mor, "tiled", reqs, **kw)
    agree = _agree(tok_k, tok_t)
    assert agree >= AGREE_MIN, agree
    skip = [1 - v for v in
            rep_k["telemetry"]["mor_stats"]["frac_tiles_computed"]]
    log("train", path="granite train serve", layout="slotted", mode="kernel",
        trace="mixed", tok_s=round(rep_k["tokens_per_s"], 2),
        dispatches=rep_k["dispatches"], launches=json.dumps(launches),
        agreement_kernel_vs_tiled=round(agree, 4),
        skip_frac_mean_after_training=round(float(np.mean(skip)), 4),
        skip_frac_mean_random_init=round(float(np.mean(random_skip)), 4),
        skip_frac_per_layer_after_training=[round(v, 4) for v in skip],
        note=f"{TRAIN_STEPS} steps at warm-up lr: not a trained model")
    return launches


# -- the dry run: meta predictions against the card ------------------------

# the meta grid's cells this phase runs, 1-4 s each on meta: the
# recurrent and windowed archs' one-token decodes (at 32,768 and 524,288
# positions of state or ring) and deepseek's decode_32k.  Each of the
# other run cells takes 6 s to 6 min of the host's CPU on meta (its
# kernels are Python; PERF.md, the dry run), past this phase's minute:
# ``python -m repro_torch.launch.dryrun_all`` runs them all.
DRYRUN_GRID_CELLS = (("rwkv6-3b", "decode_32k"), ("rwkv6-3b", "long_500k"),
                     ("zamba2-7b", "decode_32k"), ("zamba2-7b", "long_500k"),
                     ("mixtral-8x7b", "decode_32k"),
                     ("mixtral-8x7b", "long_500k"),
                     ("deepseek-v2-236b", "decode_32k"))
# the meta prediction of a cell's peak against the card's measured peak,
# whole (arguments and step) and the step's own (the peak over the
# arguments): a share of the measured, plus an absolute slack for what
# meta cannot see (the allocator's 512-byte rounding of every block)
DRYRUN_PEAK_TOL = 0.10
DRYRUN_PEAK_SLACK = 4 << 20


def _dryrun_cell(cfg, shape, opt, flush, iters):
    """One granite cell predicted on meta, then run on the card ->
    the log fields; the FLOPs counted on the card must equal meta's, and
    the predicted peak, whole and the step's own, lie within
    DRYRUN_PEAK_TOL (and DRYRUN_PEAK_SLACK) of the measured."""
    from repro_torch.launch import dryrun
    rec = dryrun.measure_cell(cfg, shape, opt_cfg=opt, device="cuda",
                              flush=flush, time_iters=iters)
    card = rec["card"]
    pred, meas = rec["per_device_bytes"], card["peak_bytes"]
    step_pred, step_meas = rec["peak_temp_bytes"], card["step_peak_bytes"]
    assert card["flops"] == rec["cost"]["flops"], (card["flops"],
                                                   rec["cost"]["flops"])
    assert abs(pred - meas) <= DRYRUN_PEAK_TOL * meas, (pred, meas)
    assert abs(step_pred - step_meas) <= \
        DRYRUN_PEAK_TOL * step_meas + DRYRUN_PEAK_SLACK, (step_pred,
                                                           step_meas)
    rl = rec["roofline"]
    return dict(
        B=shape.global_batch, seq=shape.seq_len,
        predicted_peak_gb=round(pred / 1e9, 3),
        measured_peak_gb=round(meas / 1e9, 3),
        peak_rel_err=round((pred - meas) / meas, 4),
        argument_gb=round(rec["argument_bytes"] / 1e9, 3),
        argument_gb_card=round(card["argument_bytes"] / 1e9, 3),
        predicted_step_peak_gb=round(step_pred / 1e9, 4),
        measured_step_peak_gb=round(step_meas / 1e9, 4),
        step_peak_rel_err=round((step_pred - step_meas) / step_meas, 4),
        bound_ms=round(rl["bound_time_s"] * 1e3, 3), bound_by=rl["dominant"],
        bytes_counted=rl["bytes_counted"],
        floor_ms=round(rl["floor_time_s"] * 1e3, 3),
        floor_by=rl["floor_dominant"],
        floor_gb=round(rl["floor_bytes"] / 1e9, 3),
        ms=round(card["ms"], 3), time_iters=iters,
        flops_meta=rec["cost"]["flops"], flops_card=card["flops"],
        bytes_meta=rec["cost"]["bytes"], bytes_card=card["bytes"],
        meta_s=rec["meta_s"])


def phase_dryrun():
    """The dry run (``launch/dryrun.py``) held to the card: granite-3-2b
    at DEPTH layers, the train phase's cell (8 x 512 tokens, grad_accum
    4, remat,
    AdamW with bf16 moments and the float32 master) and a decode step of
    ``make_serve_step`` at B 8 over ``cache_init``'s 4,096 positions,
    each predicted on the meta device, then run on the card: peak GB
    predicted against measured, bound ms against CUDA-event ms, FLOPs
    counted on meta against those counted on the card.  Then one line a
    cell of the 40-cell meta grid: its status, and the cells of
    DRYRUN_GRID_CELLS run on meta (reckoned from the H100 SXM's
    data-sheet rates, not measured)."""
    import torch
    from repro_torch.configs import SHAPES, ShapeSpec, get_config
    from repro_torch.launch import dryrun, dryrun_all
    from repro_torch.optim import OptConfig
    cfg = _cut_config("granite-3-2b")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    train = ShapeSpec("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train")
    log("dryrun", path="granite train cell", **_dryrun_cell(
        cfg, train, OptConfig(lr=1e-3, moment_dtype="bfloat16"), flush, 2))
    decode = ShapeSpec("decode_8x4096", 4096, STATIC_SLOTS, "decode")
    log("dryrun", path="granite decode cell", **_dryrun_cell(
        cfg, decode, None, flush, 10))
    del flush
    torch.cuda.empty_cache()
    for arch in dryrun_all.ARCHS:
        for name in dryrun_all.SHAPE_NAMES:
            status = dryrun.cell_status(get_config(arch), SHAPES[name])
            if status == "run" and (arch, name) in DRYRUN_GRID_CELLS:
                rec = dryrun.run_cell(arch, name)
                assert rec["status"] == "ok", (arch, name, rec["status"],
                                               rec.get("traceback"))
                log("dryrun", grid=f"{arch} {name}", meta_s=rec["meta_s"],
                    cell=dryrun_all.summary(rec), note="reckoned on meta")
            else:
                log("dryrun", grid=f"{arch} {name}", cell=status
                    if status != "run" else "not run here: seconds to "
                    "minutes of the host's CPU on meta (DRYRUN_GRID_CELLS)")


# -- the production mesh's dry run (launch/dryrun.py --mesh) ------------------

# rank 0 of the 256-rank pod on torch's fake process group, on meta (no
# card): a train cell and a decode cell of the reference's grid
MESH_DRYRUN_CELLS = (("granite-3-2b", "train_4k"),
                     ("deepseek-v2-236b", "decode_32k"))
MESH_DRYRUN_TIMEOUT = 300


def _mesh_step_cell(arch="granite-3-2b"):
    """(config, shape, optimizer) of a ``mesh`` phase train step: granite
    at full width cut to MESH_GRANITE_LAYERS, or a family of
    MESH_FAMILIES as ``_family_cfg`` cuts it; one micro-batch of
    TRAIN_BATCH x TRAIN_SEQ, bf16 moments."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.optim import OptConfig
    cfg = (get_config(arch).replace(n_layers=MESH_GRANITE_LAYERS,
                                    grad_accum=1)
           if arch == "granite-3-2b" else _family_cfg(arch))
    return (cfg, ShapeSpec("train_8x512", TRAIN_SEQ, TRAIN_BATCH, "train"),
            OptConfig(lr=1e-3, moment_dtype="bfloat16"))


# the prediction's key of granite's (1, 2) step under "contract_tp"
CONTRACT_PREDICTED = "granite-3-2b|contract_tp"


def predict_mesh_step(path):
    """The dry run's prediction of the ``mesh`` phase's (1, 2) train
    steps (granite's and MESH_FAMILY_PREDICTED's), rank by rank, on meta
    under torch's fake process group with gloo's collectives modelled
    (run in a process of its own by ``phase_dryrun_mesh``) -> JSON at
    ``path``, {arch: {rank: ...}}: collectives by name, their bytes by
    kind, FLOPs, argument bytes by tree, peak temp."""
    from repro_torch.distributed import collectives as co
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dry_mesh
    out = {}
    for key in ("granite-3-2b", CONTRACT_PREDICTED) + \
            MESH_FAMILY_PREDICTED:
        arch, _, layout = key.partition("|")
        cfg, shape, opt = _mesh_step_cell(arch)
        out[key] = {}
        for rank in range(MESH_RANKS):
            with dry_mesh({"data": 1, "model": MESH_RANKS}, rank=rank,
                          backend="gloo") as mesh:
                co.reset_counts()
                c = dryrun.count_cell(cfg, shape, opt_cfg=opt,
                                      on=dryrun.MeshArgs(
                                          mesh, False, layout or "fsdp_tp"))
                out[key][str(rank)] = {
                    "counts": dict(co.counts), "nbytes": dict(co.nbytes),
                    "args": c.args, "flops": c.counter.flops,
                    "peak_temp": c.counter.peak_live_bytes}
    with open(path, "w") as f:
        json.dump(out, f)


def phase_dryrun_mesh():
    """The dry run on the production mesh, each in a process of its own
    (the fake process group is a process's one group), side by side:
    ``python -m repro_torch.launch.dryrun --mesh pod`` for
    MESH_DRYRUN_CELLS (rank 0 of 256, reckoned on meta from the H100's
    data-sheet rates, the collective term split between NVLink and
    InfiniBand: not measured), and ``predict_mesh_step`` (the ``mesh``
    phase's own (1, 2) step predicted, held there to what the ranks
    count).  -> the prediction."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as tmp:
        cmds = {}
        for arch, shape in MESH_DRYRUN_CELLS:
            cmds[f"{arch} {shape}"] = [
                "-m", "repro_torch.launch.dryrun", "--arch", arch,
                "--shape", shape, "--mesh", "pod", "--out",
                os.path.join(tmp, f"{arch}_{shape}.json")]
        pred = os.path.join(tmp, "predict.json")
        cmds["predict"] = ["-c", f"import sys; sys.path[:0] = "
                           f"[{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
                           f"import chip_smoke; "
                           f"chip_smoke.predict_mesh_step({pred!r})"]
        procs = {}
        try:
            for name, argv in cmds.items():
                out = open(os.path.join(tmp, f"{len(procs)}.log"), "w")
                procs[name] = (subprocess.Popen(
                    [sys.executable] + argv, env=env, cwd=tmp, stdout=out,
                    stderr=subprocess.STDOUT), out)
            for name, (proc, out) in procs.items():
                rc = proc.wait(timeout=MESH_DRYRUN_TIMEOUT)
                out.close()
                with open(out.name) as f:
                    text = f.read()
                assert rc == 0, (name, rc, text[-3000:])
        finally:
            for proc, out in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
        for arch, shape in MESH_DRYRUN_CELLS:
            with open(os.path.join(tmp, f"{arch}_{shape}.json")) as f:
                rec = json.load(f)
            assert rec["status"] == "ok", rec.get("traceback")
            rl = rec["roofline"]
            log("dryrun_mesh", cell=f"{arch} {shape}", mesh="pod",
                n_chips=rec["n_chips"], layout=rec["layout"],
                seq_parallel=rec["seq_parallel"],
                argument_gib=round(rec["argument_bytes"] / 2 ** 30, 3),
                temp_gib=round(rec["peak_temp_bytes"] / 2 ** 30, 3),
                per_device_gib=rec["per_device_gib"],
                fits_80gb=rec["fits_80gb"], dominant=rl["dominant"],
                t_compute_ms=round(rl["t_compute_s"] * 1e3, 3),
                t_memory_ms=round(rl["t_memory_s"] * 1e3, 3),
                t_collective_ms=round(rl["t_collective_s"] * 1e3, 3),
                t_collective_nvlink_ms=round(
                    rl["t_collective_nvlink_s"] * 1e3, 3),
                t_collective_ib_ms=round(rl["t_collective_ib_s"] * 1e3, 3),
                floor_ms=round(rl["floor_time_s"] * 1e3, 3),
                floor_by=rl["floor_dominant"],
                collective_bytes=json.dumps(
                    rec["collectives"]["bytes_by_kind"]),
                ib_bytes=json.dumps(rec["collectives"]["ib_bytes_by_kind"]),
                cache_layout_vs_reference=json.dumps(
                    rec.get("cache_layout_vs_reference", {})),
                meta_s=rec["meta_s"],
                note="rank 0 of 16 x 16 on a fake process group, on "
                     "meta: reckoned from data-sheet rates, not measured")
        with open(pred) as f:
            return json.load(f)


# -- observability (obs/, the shadow twin) -----------------------------------

def _obs_engine(cfg, params, mor, reqs, obs=False, shadow_rate=0.0):
    """A fresh paged kernel-mode engine over ``reqs``, with the obs stack
    (and a shadow twin sampling 1 in round(1 / shadow_rate) dispatches)
    or without."""
    from repro_torch.obs import Observability
    from repro_torch.serving import Engine
    return Engine(cfg, params, mor=mor, mor_mode="kernel", n_slots=8,
                  max_len=max(len(p) for p, _ in reqs) + 18,
                  obs=Observability() if obs else None,
                  shadow_rate=shadow_rate)


def _obs_first_pass(eng, reqs, group="mor_stats"):
    """One pass, stepped by hand: -> (tokens by request index, the
    per-layer tiles_skipped that the kernels' counters give, summed over
    the pass's dispatches off the aux log before the flush)."""
    import torch
    for p, g in reqs:
        eng.submit(p, g)
    while eng.scheduler.has_work:
        eng.step()
    skipped = torch.stack([a[group]["tiles_skipped"]
                           for a in eng._aux_log]).sum(0)
    eng._flush_tokens()
    eng._flush_telemetry()
    eng._flush_obs()
    base = min(eng.results)
    return ({rid - base: t for rid, t in eng.results.items()},
            skipped.cpu().numpy())


def _shadow_sampled(dispatches, every):
    """Dispatches the shadow twin samples: 0, every, 2 every, ..."""
    return sum(1 for d in range(dispatches) if d % every == 0)


def _block_checks(eng, skipped):
    """The metrics block against the engine's host counters and the
    kernels' tile counters -> its read."""
    import numpy as np
    dm = eng._last_device_metrics
    for k in ("dispatches", "prefill_tokens", "decode_tokens"):
        assert dm[k] == eng.counters[k], (k, dm[k], eng.counters[k])
    grp = "moe_mor_stats" if eng.cfg.family == "moe" else "mor_stats"
    got = dm["groups"][grp]["tiles_skipped"]
    assert np.array_equal(got, skipped), (got, skipped)
    return dm


def phase_obs(model):
    """The obs path on granite-3-2b (DEPTH layers), the shared-prefix
    trace through the paged engine in kernel mode, three ways, each on a
    fresh engine with its launches counted: obs off; obs on (metrics
    block and tracer); obs on with a shadow twin on 1 in 4 dispatches.
    Tokens must be identical; the block's header equals the engine's
    counters and its per-layer tiles_skipped the kernels' counters;
    launches equal the main path's plus the twin's attention; the Chrome
    trace validates and /metrics answers one scrape on 127.0.0.1.  Then
    the cost: a timed warm pass of each in turns (off, obs, shadow,
    shadow, obs, off: host ms a dispatch) and one profiled warm pass of
    each (device busy).  -> the shadow run's launches."""
    import urllib.request

    import numpy as np
    from repro_torch.obs import MetricsServer, validate_chrome_trace
    cfg, params, mor = model
    reqs = _shared_prefix_trace(cfg)
    L = cfg.n_layers
    runs, engines = {}, {}
    widths = []                 # the shadow run's (n_valid, C) a dispatch
    for name, obs, rate in (("off", False, 0.0), ("obs", True, 0.0),
                            ("shadow", True, 0.25)):
        eng = _obs_engine(cfg, params, mor, reqs, obs, rate)
        if rate:
            build = eng.scheduler.build_batch

            def logged(kind, build=build):
                out = build(kind)
                widths.append((out[1].copy(), out[0].shape[1]))
                return out
            eng.scheduler.build_batch = logged
        (toks, skipped), launches = _counted(
            lambda: _obs_first_pass(eng, reqs))
        d = eng.counters["dispatches"]
        shadow = _shadow_sampled(d, 4) if rate else 0
        want = _want_launches(L, d, paged=True, shadow=shadow)
        assert launches == want, (name, launches, want)
        _check_tokens(cfg, reqs, toks)
        runs[name], engines[name] = (toks, launches, d, skipped), eng
        log("obs", model=cfg.name, run=name, dispatches=d,
            shadow_dispatches=shadow, launches=json.dumps(launches))
    base = runs["off"][0]
    for name in ("obs", "shadow"):
        assert runs[name][0] == base, (name, _first_diff(runs[name][0],
                                                         base))
    for name in ("obs", "shadow"):
        eng = engines[name]
        dm = _block_checks(eng, runs[name][3])
        assert dm["pages_touched"] > 0 and dm["kv_page_resets"] > 0, dm
        trace = eng.obs.tracer.to_chrome_trace()
        assert validate_chrome_trace(trace) == [], "bad chrome trace"
        log("obs", run=name, block=json.dumps(
            {k: v for k, v in dm.items() if k != "groups"}),
            trace_events=len(trace["traceEvents"]),
            n_registry_families=len(eng.obs.registry.snapshot()))
    eng = engines["shadow"]
    dm = eng._last_device_metrics
    assert dm["shadow_dispatches"] == _shadow_sampled(dm["dispatches"], 4)
    g = dm["groups"]["mor_stats"]
    assert g["shadow_tiles"].sum() > 0 and g["truth_live"].sum() > 0
    # 8-row tiles of the sampled dispatches made of chunk padding only
    # (rows past a slot's n_valid): truly dead, and never skipped by a
    # dense FFN's predictor, which gets no row mask
    pad = sum(int((~(np.arange(C)[None, :] < nv[:, None]).reshape(
        -1, cfg.mor.tile_m).any(1)).sum())
        for d, (nv, C) in enumerate(widths) if d % 4 == 0)
    pad *= L * (cfg.d_ff // cfg.mor.tile_n)
    with MetricsServer(eng.obs, host="127.0.0.1", port=0) as srv:
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            text = r.read().decode()
    assert "repro_mor_false_skip_total" in text
    log("obs", run="shadow", shadow_dispatches=dm["shadow_dispatches"],
        false_skip=int(g["false_skip"].sum()),
        false_keep=int(g["false_keep"].sum()),
        truth_live=int(g["truth_live"].sum()),
        shadow_tiles=int(g["shadow_tiles"].sum()), padding_tiles=pad,
        false_skip_rate=round(float(g["false_skip"].sum()
                                    / max(g["truth_live"].sum(), 1)), 6),
        mean_shadow_err=round(float(np.mean(g["mean_shadow_err"])), 6),
        mean_sign_agree=round(float(np.mean(g["mean_sign_agree"])), 6),
        drift=json.dumps(eng.drift.summary()["drifted"]),
        scrape_bytes=len(text))
    # the cost: warm passes in turns, then one profiled warm pass each
    host = {name: [] for name in engines}
    for name in ("off", "obs", "shadow", "shadow", "obs", "off"):
        e = engines[name]
        e.reset_counters()
        e.run(list(reqs))
        host[name].append(round(e.counters["wall_s"] * 1e3
                                / max(e.counters["dispatches"], 1), 3))
    log("obs", cost="host_ms_per_dispatch", **{k: json.dumps(v)
                                              for k, v in host.items()})
    for name, e in engines.items():
        e.reset_counters()
        _profile_fn(f"obs-{name}", lambda: e.run(list(reqs)),
                    lambda: {"dispatches": e.counters["dispatches"],
                             "host_ms_per_dispatch": round(
                                 e.counters["wall_s"] * 1e3
                                 / max(e.counters["dispatches"], 1), 3)})
    return runs["shadow"][1]


def _shadow_cell(cfg, params, mor, reqs, want_tokens, per_dispatch,
                 path):
    """A fresh paged kernel-mode engine with obs and a shadow twin on 1
    in 4 dispatches, counted: its first pass must give ``want_tokens``
    (the shadow-off engine's first pass), its launches ``per_dispatch``
    a dispatch plus the twin's attention, its block the kernels' tile
    counters."""
    t0 = time.perf_counter()
    grp = "moe_mor_stats" if cfg.family == "moe" else "mor_stats"
    eng = _obs_engine(cfg, params, mor, reqs, True, 0.25)
    (toks, skipped), launches = _counted(
        lambda: _obs_first_pass(eng, reqs, grp))
    assert toks == want_tokens, _first_diff(toks, want_tokens)
    d = eng.counters["dispatches"]
    shadow = _shadow_sampled(d, 4)
    attn = {"gqa_paged_flash": 0, "mla_paged_flash": 0}
    attn_key = "mla_paged_flash" if cfg.mla else "gqa_paged_flash"
    if per_dispatch.get(attn_key):
        attn[attn_key] = per_dispatch[attn_key] * shadow
    want = {k: per_dispatch.get(k, 0) * d + attn.get(k, 0)
            for k in launches}
    assert launches == want, (launches, want)
    dm = _block_checks(eng, skipped)
    assert dm["shadow_dispatches"] == shadow
    g = dm["groups"][grp]
    log("obs", path=path, dispatches=d, shadow_dispatches=shadow,
        launches=json.dumps(launches),
        lanes=json.dumps({k: list(v["tiles_total"].shape)
                          for k, v in dm["groups"].items()}),
        false_skip=int(g["false_skip"].sum()),
        truth_live=int(g["truth_live"].sum()),
        seconds=round(time.perf_counter() - t0, 1))
    return dm


def slice_deepseek():
    """This slice's main path: deepseek-v2-236b at its published widths,
    cut to 3 layers (layer 0 dense, layers 1-2 MoE), calibrated with
    ``calibrate_moe``, serves the shared-prefix trace through
    ``Engine(layout="paged")`` with prefix caching in kernel mode
    (counted: per dispatch 3 launches of mla_paged_flash, mor_tile_mask
    and masked_matmul_kdim, 6 of gather_matmul), then in tiled and dense
    mode, each held to greedy agreement with kernel mode, then one
    profiled pass of each.  -> the kernel-mode launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import calibrate_moe
    from repro_torch.launch.serve import calib_batches
    from repro_torch.models import get_model
    cfg = get_config("deepseek-v2-236b").replace(n_layers=3)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in _leaves(params))
    log("slice", model=cfg.name, layers=cfg.n_layers,
        depth_cut="60 -> 3 (layer 0 dense, layers 1-2 MoE)",
        d_model=cfg.d_model, heads=cfg.n_heads, experts=cfg.n_experts,
        top_k=cfg.top_k, moe_d_ff=cfg.moe_d_ff, dtype=cfg.dtype,
        params=n_params,
        param_gb=round(sum(v.numel() * v.element_size()
                           for v in _leaves(params)) / 1e9, 2),
        init_s=round(time.perf_counter() - t0, 2))
    t0 = time.perf_counter()
    params, mor, cal = calibrate_moe(params, cfg, api.forward,
                                     calib_batches(cfg, 8, "cuda"), 4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("slice", model=cfg.name, calibrate_s=round(time.perf_counter() - t0,
                                                   2),
        **{k: round(v, 4) for k, v in cal.items()})
    reqs = _shared_prefix_trace(cfg)
    (tok_k, rep_k, eng_k), launches = _counted(
        lambda: _serve(cfg, params, mor, "kernel", reqs))
    counted = _dispatches(rep_k)
    want = _want_launches(cfg.n_layers, counted, paged=True, mla=True)
    assert launches == want, (launches, want)
    _check_tokens(cfg, reqs, tok_k)
    pc = rep_k["prefix_cache"]
    assert pc["prefix_hits"] > 0 and pc["chunks_skipped"] > 0, pc
    tel = rep_k["telemetry"]
    moe = np.asarray(tel["moe_mor_stats"]["frac_tiles_computed"])
    assert moe.shape == (cfg.n_layers - cfg.first_k_dense, cfg.n_experts)
    assert np.all(np.isfinite(moe))
    log("slice", path="deepseek paged", mode="kernel",
        dispatches=rep_k["dispatches"],
        first_pass_dispatches=rep_k["first_pass_dispatches"],
        launches=json.dumps(launches),
        launches_per_dispatch=json.dumps(
            {k: v / counted for k, v in launches.items()}),
        dense_frac_tiles_computed=np.round(tel["dense_mor_stats"][
            "frac_tiles_computed"], 4).tolist(),
        moe_frac_tiles_computed_mean=np.round(moe.mean(1), 4).tolist(),
        prefix=json.dumps({k: pc[k] for k in (
            "hit_rate", "prefix_hits", "prefix_queries", "pages_shared",
            "chunks_skipped", "tokens_skipped", "pages_cowed",
            "pages_evicted")}))
    L = cfg.n_layers
    dm = _shadow_cell(cfg, params, mor, reqs, tok_k,
                      {"mor_tile_mask": L, "gather_matmul": 2 * L,
                       "masked_matmul_kdim": L, "mla_paged_flash": L},
                      "deepseek shadow")
    assert dm["groups"]["moe_mor_stats"]["tiles_total"].shape == (
        L - cfg.first_k_dense, cfg.n_experts)
    tok_t, rep_t, eng_t = _serve(cfg, params, mor, "tiled", reqs)
    tok_d, rep_d, eng_d = _serve(cfg, params, None, "dense", reqs)
    agree_t, agree_d = _agree(tok_k, tok_t), _agree(tok_k, tok_d)
    for name, rep in (("kernel", rep_k), ("tiled", rep_t),
                      ("dense", rep_d)):
        log("slice", path="deepseek paged", trace="shared-prefix",
            mode=name, tok_s=round(rep["tokens_per_s"], 2),
            decode_tok_s=round(rep["decode_tokens"] / rep["pass_s"], 2),
            pass_s=round(rep["pass_s"], 3), dispatches=rep["dispatches"],
            prefill_tokens=rep["prefill_tokens"],
            decode_tokens=rep["decode_tokens"], **_repeats(rep))
    log("slice", path="deepseek paged", agreement_kernel_vs_tiled=round(
        agree_t, 4), agreement_kernel_vs_dense=round(agree_d, 4))
    assert agree_t >= AGREE_MIN and agree_d >= AGREE_MIN, (agree_t, agree_d)
    engine = {m: (r["tokens_per_s"], r["pass_s"]) for m, r in
              (("kernel", rep_k), ("dense", rep_d))}
    static = _static_cell(cfg, params, mor, reqs, "deepseek static",
                          ("dense",), engine, DEEPSEEK_STATIC, passes=1)
    _serve_step_cell(cfg, params, mor, reqs, "deepseek serve_step",
                     DEEPSEEK_STATIC)
    # profiled last, so that the profiler cannot touch the timings above
    for eng in (eng_k, eng_t, eng_d):
        _profile(eng, reqs)
    log("slice", model=cfg.name, peak_mem_gb=round(
        torch.cuda.max_memory_allocated() / 1e9, 2))
    return launches, static


# -- the rest of the transformer zoo ----------------------------------------

def _zoo_reduced(arch):
    """The reduced float32 config with the published attention geometry
    restored (heads, KV heads, head dim), so that the card runs the
    CUDA-core GQA body at the zoo's G and D; mixtral's experts widened to
    moe_d_ff 256 (two column tiles, the trailing one killed by
    ``calibrate_moe``'s injection)."""
    from repro_torch.configs import get_config, reduce_config
    full = get_config(arch)
    cfg = reduce_config(full).replace(n_heads=full.n_heads,
                                      n_kv_heads=full.n_kv_heads,
                                      d_head=full.head_dim)
    return cfg.replace(moe_d_ff=256) if cfg.family == "moe" else cfg


def reference_zoo():
    """qwen2-7b (QKV bias, G 7, D 128), granite-20b (MQA: G 48, D 128),
    mixtral-8x7b (MoE top-2, its reduced window of 16: prompts of 20-32
    tokens wrap the ring over pages shared with the prefix cache) and
    phi-3-vision (the text path, D 96), reduced and float32, calibrated
    on the CPU and served in kernel mode through the paged engine with
    prefix caching and half budgets, on the card (CUDA kernels) and on
    the CPU (plain versions): the same tokens, telemetry and prefix
    counters; then hubert-xlarge's forward logits on frames, dense and
    kernel mode, within LOGIT_RTOL."""
    import numpy as np
    import torch
    from repro_torch.core.deploy import calibrate_lm, calibrate_moe
    from repro_torch.launch.serve import calib_batches, make_trace
    from repro_torch.models import get_model
    from repro_torch.serving import Engine
    for arch in ZOO_GQA:
        cfg = _zoo_reduced(arch)
        api = get_model(cfg)
        params = api.init(torch.Generator().manual_seed(SEED), cfg)
        moe = cfg.family == "moe"
        if cfg.qkv_bias:
            g = torch.Generator().manual_seed(SEED + 3)
            attn = params["layers"]["attn"]
            for k in ("bq", "bk", "bv"):
                attn[k] = torch.randn(attn[k].shape, generator=g) * 0.5
        cal = calibrate_moe if moe else calibrate_lm
        params, mor, _ = cal(params, cfg, api.forward,
                             calib_batches(cfg, 4, "cpu"), 2,
                             **({"inject_dead_frac": 0.5} if moe else {}))
        reqs = make_trace(cfg, 6, 4, 16, 6, 6, SEED, shared_prefix=16)
        longest = max((p for p, _ in reqs), key=len)
        reqs += [(longest[:24].copy(), 6), (longest[:24].copy(), 6)]
        caps = {"moe_mor_stats" if moe else "mor_stats": 0.5}
        out = {}
        for dev in ("cpu", "cuda"):
            eng = Engine(cfg, _to(params, dev), mor=_to(mor, dev),
                         mor_mode="kernel", n_slots=4, max_len=40,
                         capacities=caps)
            out[dev] = (eng.run(list(reqs)), eng.telemetry.summary())
        assert out["cuda"][0] == out["cpu"][0], \
            f"{arch}: card and CPU tokens differ"
        assert out["cuda"][1] == out["cpu"][1], \
            f"{arch}: card and CPU telemetry differ"
        tel = out["cuda"][1]
        pc = tel["prefix_cache"]
        assert pc["prefix_hits"] > 0 and pc["chunks_skipped"] > 0, pc
        if cfg.sliding_window:
            assert pc["pages_cowed"] > 0, pc
        fr = np.asarray(tel["moe_mor_stats" if moe else "mor_stats"][
            "frac_tiles_computed"])
        log("reference", model=f"{arch} reduced f32 paged",
            heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.head_dim,
            window=cfg.sliding_window, requests=len(reqs),
            tokens_equal=True, telemetry_equal=True,
            frac_tiles_computed=np.round(fr, 4).tolist(),
            **{k: pc[k] for k in ("prefix_hits", "chunks_skipped",
                                  "pages_cowed")})
    cfg = _zoo_reduced("hubert-xlarge")
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(SEED), cfg)
    params, mor, _ = calibrate_lm(params, cfg, api.forward,
                                  calib_batches(cfg, 4, "cpu"), 2)
    fr = next(calib_batches(cfg, 2, "cpu", seed=SEED + 1, seq=32))
    for mode in ("dense", "kernel"):
        runs = {dev: api.forward(_to(params, dev), cfg, _to(fr, dev),
                                 mor=_to(mor, dev), mor_mode=mode)[0]
                for dev in ("cpu", "cuda")}
        err = _logits_close(runs["cuda"], runs["cpu"],
                            f"hubert-xlarge {mode}")
        log("reference", model="hubert-xlarge reduced f32 forward",
            mode=mode, frames=list(fr["frames"].shape),
            logits_max_abs_err=err)


def _mixed_trace(cfg):
    """The slotted and static cells' trace: 8 requests of 8-64 prompt
    tokens, 16 new each."""
    from repro_torch.launch.serve import make_trace
    return make_trace(cfg, 8, 8, 64, 16, 16, SEED)


def _shared_prefix_trace(cfg):
    """The serving cells' trace: 12 requests of a 128-token shared prefix
    plus 8-64 unique tokens, 16 new each, two of them identical with a
    page-aligned prompt."""
    from repro_torch.launch.serve import make_trace
    reqs = make_trace(cfg, 12, 8, 64, 16, 16, SEED, shared_prefix=128)
    aligned = reqs[0][0][:len(reqs[0][0]) // 8 * 8]
    reqs[0] = (aligned, 16)
    reqs[11] = (aligned.copy(), 16)
    return reqs


def _init_logged(cfg, **kw):
    """Random weights from SEED on the card, logged with their size."""
    import torch
    from repro_torch.models import get_model
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    log("slice", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
        heads=f"{cfg.n_heads}/{cfg.n_kv_heads}", head_dim=cfg.head_dim,
        d_ff=cfg.moe_d_ff or cfg.d_ff, dtype=cfg.dtype,
        params=sum(v.numel() for v in _leaves(params)),
        param_gb=round(sum(v.numel() * v.element_size()
                           for v in _leaves(params)) / 1e9, 2),
        init_s=round(time.perf_counter() - t0, 2), **kw)
    return api, params


def _paged_cell(cfg, params, mor, reqs, modes, path, per_dispatch=None):
    """The paged engine on ``reqs``, kernel mode counted (``per_dispatch``
    {kernel: launches a dispatch}, by default a transformer's: one launch
    of each MoR kernel and of gqa_paged_flash per layer and dispatch, two
    of gather_matmul), then the other ``modes`` held to greedy agreement
    with it, each pass logged; then one profiled pass of each mode.
    -> (kernel-mode launches,
    kernel-mode report, kernel-mode tokens)."""
    import numpy as np
    (tok_k, rep_k, eng_k), launches = _counted(
        lambda: _serve(cfg, params, mor, "kernel", reqs))
    counted = _dispatches(rep_k)
    if per_dispatch is None:
        want = _want_launches(cfg.n_layers, counted, paged=True)
    else:
        want = {k: per_dispatch.get(k, 0) * counted for k in launches}
    assert launches == want, (launches, want)
    _check_tokens(cfg, reqs, tok_k)
    pc = rep_k["prefix_cache"]
    assert pc["prefix_hits"] > 0 and pc["chunks_skipped"] > 0, pc
    tel = rep_k["telemetry"]
    grp = "moe_mor_stats" if cfg.family == "moe" else "mor_stats"
    fr = np.asarray(tel[grp]["frac_tiles_computed"])
    assert np.all(np.isfinite(fr))
    pool = eng_k.pool
    log("slice", path=path, mode="kernel", n_pages=pool.n_pages,
        n_state_pages=pool.n_spages, n_blocks=pool.n_blocks)
    log("slice", path=path, mode="kernel", dispatches=rep_k["dispatches"],
        first_pass_dispatches=rep_k["first_pass_dispatches"],
        launches=json.dumps(launches),
        launches_per_dispatch=json.dumps(
            {k: v / counted for k, v in launches.items() if v}),
        frac_tiles_computed_mean=round(float(fr.mean()), 4),
        prefix=json.dumps({k: pc[k] for k in (
            "hit_rate", "prefix_hits", "prefix_queries", "pages_shared",
            "chunks_skipped", "tokens_skipped", "pages_cowed",
            "pages_evicted", "snapshots", "snap_restores")}))
    engines, reps = {"kernel": eng_k}, {"kernel": rep_k}
    for mode in modes:
        tok, reps[mode], engines[mode] = _serve(
            cfg, params, None if mode == "dense" else mor, mode, reqs)
        agree = _agree(tok_k, tok)
        log("slice", path=path, **{f"agreement_kernel_vs_{mode}":
                                   round(agree, 4)})
        assert agree >= AGREE_MIN, (mode, agree)
    for mode, rep in reps.items():
        log("slice", path=path, trace="shared-prefix", mode=mode,
            tok_s=round(rep["tokens_per_s"], 2),
            decode_tok_s=round(rep["decode_tokens"] / rep["pass_s"], 2),
            pass_s=round(rep["pass_s"], 3), dispatches=rep["dispatches"],
            prefill_tokens=rep["prefill_tokens"],
            decode_tokens=rep["decode_tokens"], **_repeats(rep))
    # profiled last, so that the profiler cannot touch the timings above
    for eng in engines.values():
        _profile(eng, reqs)
    return launches, rep_k, tok_k


def _attention_case(branch, cfg, S):
    """One layer's self-attention of ``cfg`` (its heads, head dim and
    window) at S positions, bf16, through ``attend``'s long-sequence
    branch (``_flash``: the chunked softmax; ``_banded``: the in-window
    kv rows only) against the full (S, S) mask of ``_sdpa`` on the same
    inputs.  Both are held to the float32 full-mask result on the same
    bf16 inputs, each (position, head) row to its own scale: the
    largest |error| of a row over the row's largest |value|, so that
    the early causal rows (about one v row) and the late ones (an
    average of thousands, ~0.03) count alike.  The bf16 full path is
    the control; it rounds twice (p and the output).  The branch may
    round twice as often, as the reference's does (``_flash``: q after
    its scaling and each chunk's partial sum too), so it is held within
    twice the control's error and within two bf16 steps (2 x RTOL).
    Device ms of each (``_timer``) and the peak memory each takes over
    its inputs."""
    import torch
    from repro_torch.models.layers import attention as A
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    H, Hkv, D, W = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        cfg.sliding_window
    q, k, v = (torch.randn((1, S, h, D), generator=gen, device="cuda"
                           ).bfloat16() for h in (H, Hkv, Hkv))
    pos = torch.arange(S, device="cuda")

    def fn():
        if branch == "flash":
            return A._flash(q, k, v, pos, pos, True, W)
        return A._banded(q, k, v, pos, pos, W)

    def full():
        return A._sdpa(q, k, v, A._mask_bias(pos, pos, True, W))

    def peak(f):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = f()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 1e9
    got, got_gb = peak(fn)
    want, want_gb = peak(full)
    exact = A._sdpa(q.float(), k.float(), v.float(),
                    A._mask_bias(pos, pos, True, W))
    scale = exact.abs().amax(-1).clamp(min=1e-6)

    def row_err(out):
        return float(((out.float() - exact).abs().amax(-1) / scale).max())
    err, control = row_err(got), row_err(want)
    bound = min(2 * RTOL, 2 * control)
    assert err <= bound, (branch, err, control)
    max_abs = float((got.float() - want.float()).abs().max())
    del exact, scale
    torch.cuda.empty_cache()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    log("attention", model=cfg.name, branch=branch, S=S, heads=f"{H}/{Hkv}",
        head_dim=D, window=W, row_rel_err=round(err, 6),
        full_row_rel_err=round(control, 6), bound=round(bound, 6),
        max_abs_err_vs_full=round(max_abs, 6),
        ms=round(timing.device_ms(fn, flush, iters=3), 3),
        full_ms=round(timing.device_ms(full, flush, iters=3), 3),
        peak_gb=round(got_gb, 3), full_peak_gb=round(want_gb, 3))
    del q, k, v, got, want, flush
    torch.cuda.empty_cache()


LONG_PROMPT = 16384


def _long_prefill(cfg, params, mor):
    """One 16,384-token prompt through ``make_prefill_step``'s batched
    path (``api.prefill``: one dispatch, M = 16,384 rows in the FFN
    kernels, every layer's attention through ``_flash``, counted) on the
    slot pool, in kernel (launches counted) and dense mode: seconds, the
    peak memory the prefill takes over the weights, and the two modes'
    next token.  -> kernel-mode launches."""
    import torch
    from repro_torch.launch.serve import make_trace
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.layers import attention
    from repro_torch.serving import kv_pool
    prompt = make_trace(cfg, 1, LONG_PROMPT, LONG_PROMPT, 1, 1,
                        SEED + 2)[0][0]
    toks = torch.as_tensor(prompt[None], device="cuda")
    flash, orig = [0], attention._flash

    def counted_flash(*a, **k):
        flash[0] += 1
        return orig(*a, **k)
    attention._flash = counted_flash
    nxt, out = {}, None
    try:
        for mode in ("kernel", "dense"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            cache = kv_pool.init(cfg, 1, LONG_PROMPT + 1, device="cuda")
            step = make_prefill_step(cfg, mor=None if mode == "dense"
                                     else mor, mor_mode=mode)
            flash[0] = 0
            t0 = time.perf_counter()
            (tok, _), launches = _counted(lambda: step(params, cache, toks))
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            assert flash[0] == cfg.n_layers, flash[0]
            nxt[mode] = int(tok[0])
            if mode == "kernel":
                want = {k: 0 for k in launches}
                want.update(mor_tile_mask=cfg.n_layers,
                            gather_matmul=2 * cfg.n_layers,
                            masked_matmul_kdim=cfg.n_layers)
                assert launches == want, (launches, want)
                out = launches
            log("slice", path="qwen2 long prefill", mode=mode,
                prompt_tokens=LONG_PROMPT, dispatches=1,
                flash_layers=flash[0], seconds=round(sec, 3),
                tok_s=round(LONG_PROMPT / sec, 1),
                peak_gb_over_weights=round(
                    (torch.cuda.max_memory_allocated() - base) / 1e9, 3),
                peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 3),
                launches=json.dumps(launches) if mode == "kernel" else None)
            del cache, step
    finally:
        attention._flash = orig
    assert all(0 <= t < cfg.vocab_size for t in nxt.values())
    log("slice", path="qwen2 long prefill", next_token=json.dumps(nxt),
        kernel_equals_dense=nxt["kernel"] == nxt["dense"])
    return out


def slice_mixtral():
    """This slice's main path: mixtral-8x7b at its published widths, cut
    to DEPTH (2) of its 32 layers (all 32 would take 93 GB of bf16
    weights),
    calibrated with ``calibrate_moe``, serves the shared-prefix trace and
    one request of 4,160 prompt tokens (keys slide out of the 4,096
    window) through ``Engine(layout="paged")`` with prefix caching, in
    kernel (counted: per dispatch a launch a layer of gqa_paged_flash,
    mor_tile_mask and masked_matmul_kdim, two of gather_matmul), tiled
    and dense mode, then one profiled pass of each.  -> launches."""
    import torch
    from repro_torch.core.deploy import calibrate_moe
    from repro_torch.launch.serve import calib_batches, make_trace
    cfg = _cut_config("mixtral-8x7b")
    # one layer's attention at S 8,192 under the 4,096 window, before the
    # weights take the card's memory
    _attention_case("banded", cfg, 8192)
    api, params = _init_logged(cfg, depth_cut=f"32 -> {cfg.n_layers}",
                               experts=cfg.n_experts, top_k=cfg.top_k,
                               window=cfg.sliding_window)
    t0 = time.perf_counter()
    params, mor, cal = calibrate_moe(params, cfg, api.forward,
                                     calib_batches(cfg, 8, "cuda"), 4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("slice", model=cfg.name, calibrate_s=round(time.perf_counter() - t0,
                                                   2),
        calibrate_peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
        **{k: round(v, 4) for k, v in cal.items()})
    reqs = _shared_prefix_trace(cfg)
    long_prompt = make_trace(cfg, 1, 4160, 4160, 16, 16, SEED + 1)[0]
    assert len(long_prompt[0]) == 4160 > cfg.sliding_window
    reqs.append(long_prompt)
    launches, _, _ = _paged_cell(cfg, params, mor, reqs,
                                 ("tiled", "dense"), "mixtral paged")
    log("slice", model=cfg.name, peak_mem_gb=round(
        torch.cuda.max_memory_allocated() / 1e9, 2))
    return launches


def slice_qwen2():
    """qwen2-7b at DEPTH (4 of 28) layers (QKV bias, G 7 at head dim 128),
    calibrated with ``calibrate_lm``, serves the shared-prefix trace
    through the paged engine in kernel (counted) and dense mode, then a
    profiled pass of each.  -> launches."""
    import torch
    from repro_torch.core.deploy import calibrate_lm
    from repro_torch.launch.serve import calib_batches
    cfg = _cut_config("qwen2-7b")
    # one layer's attention at S 4,608 (past the 4,096 threshold), before
    # the weights take the card's memory
    _attention_case("flash", cfg, 4608)
    api, params = _init_logged(cfg)
    t0 = time.perf_counter()
    params, mor, cal = calibrate_lm(params, cfg, api.forward,
                                    calib_batches(cfg, 8, "cuda"), 4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log("slice", model=cfg.name, calibrate_s=round(time.perf_counter() - t0,
                                                   2),
        **{k: round(v, 4) for k, v in cal.items()})
    launches, _, _ = _paged_cell(cfg, params, mor,
                                 _shared_prefix_trace(cfg), ("dense",),
                                 "qwen2 paged")
    log("slice", model=cfg.name, peak_mem_gb=round(
        torch.cuda.max_memory_allocated() / 1e9, 2))
    long = _long_prefill(cfg, params, mor)
    return launches, long


def slice_hubert():
    """hubert-xlarge whole (48 layers, an encoder over frame embeddings,
    layernorm, a native ReLU FFN: MoR predicts the up projection),
    calibrated with ``calibrate_lm`` on synthetic frames, then a forward
    over 8 x 512 frames in dense and kernel mode (counted: one launch of
    mor_tile_mask, gather_matmul and masked_matmul_kdim per layer):
    forward ms and argmax agreement with dense over the 504 classes.
    -> launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.deploy import calibrate_lm
    from repro_torch.launch.serve import calib_batches
    cfg = get_config("hubert-xlarge")
    api, params = _init_logged(cfg)
    t0 = time.perf_counter()
    params, mor, cal = calibrate_lm(params, cfg, api.forward,
                                    calib_batches(cfg, 8, "cuda"), 4)
    torch.cuda.synchronize()
    log("slice", model=cfg.name, calibrate_s=round(time.perf_counter() - t0,
                                                   2),
        **{k: round(v, 4) for k, v in cal.items()})
    batch = next(calib_batches(cfg, 8, "cuda", seed=SEED + 1, seq=512))
    dense = api.forward(params, cfg, batch)[0]
    kernel, launches = _counted(lambda: api.forward(
        params, cfg, batch, mor=mor, mor_mode="kernel")[0])
    want = {k: 0 for k in launches}
    want.update({k: cfg.n_layers for k in (
        "mor_tile_mask", "gather_matmul", "masked_matmul_kdim")})
    assert launches == want, (launches, want)
    assert kernel.shape == (8, 512, cfg.vocab_size)
    assert bool(torch.isfinite(kernel).all())
    agree = float((kernel.argmax(-1) == dense.argmax(-1)).float().mean())
    ms = {mode: _fwd_ms(lambda mode=mode: api.forward(
        params, cfg, batch, mor=None if mode == "dense" else mor,
        mor_mode=mode)) for mode in ("dense", "kernel")}
    log("slice", path="hubert forward", frames=list(batch["frames"].shape),
        dense_ms=round(ms["dense"], 3), kernel_ms=round(ms["kernel"], 3),
        argmax_agreement_with_dense=round(agree, 4),
        launches=json.dumps({k: v for k, v in launches.items() if v}),
        peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2))
    assert agree >= AGREE_MIN, agree
    return launches


# -- the recurrent families (rwkv6-3b, zamba2-7b) ----------------------------

def reference_recurrent():
    """rwkv6-3b (state pages only) and zamba2-7b (mamba state pages and
    its shared attention's kv pages, with its published head geometry
    restored: 32 / 32 heads at D 112, the float32 CUDA-core body under
    the reduced shared window of 16), reduced and float32, calibrated on
    the CPU (``calibrate_lm`` on rwkv's channel mix, ``calibrate_hybrid``
    on zamba2's shared MLP) and served in kernel mode with half budgets,
    paged with prefix caching and slotted, on the card (CUDA kernels)
    and on the CPU (plain versions): the same tokens, telemetry and
    prefix counters, state snapshots taken and restored included."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.deploy import calibrate_hybrid, calibrate_lm
    from repro_torch.launch.serve import calib_batches, make_trace
    from repro_torch.models import get_model
    from repro_torch.serving import Engine
    for arch in ("rwkv6-3b", "zamba2-7b"):
        cfg = _zoo_reduced(arch) if arch == "zamba2-7b" else \
            reduce_config(get_config(arch))
        api = get_model(cfg)
        params = api.init(torch.Generator().manual_seed(SEED), cfg)
        cal = calibrate_hybrid if cfg.family == "hybrid" else calibrate_lm
        params, mor, _ = cal(params, cfg, api.forward,
                             calib_batches(cfg, 4, "cpu"), 2)
        reqs = make_trace(cfg, 6, 4, 16, 6, 6, SEED, shared_prefix=16)
        longest = max((p for p, _ in reqs), key=len)
        reqs += [(longest[:24].copy(), 6), (longest[:24].copy(), 6)]
        for layout in ("paged", "slotted"):
            out = {}
            for dev in ("cpu", "cuda"):
                eng = Engine(cfg, _to(params, dev), mor=_to(mor, dev),
                             mor_mode="kernel", n_slots=4, max_len=40,
                             capacities={"mor_stats": 0.5}, layout=layout)
                out[dev] = (eng.run(list(reqs)), eng.telemetry.summary())
            assert out["cuda"][0] == out["cpu"][0], \
                f"{arch} {layout}: card and CPU tokens differ"
            assert out["cuda"][1] == out["cpu"][1], \
                f"{arch} {layout}: card and CPU telemetry differ"
            tel = out["cuda"][1]
            pc = tel.get("prefix_cache", {})
            if layout == "paged":
                assert pc["snapshots"] > 0 and pc["snap_restores"] > 0 \
                    and pc["chunks_skipped"] > 0, pc
            fr = np.asarray(tel["mor_stats"]["frac_tiles_computed"])
            assert float(fr.max()) <= 0.5, fr
            log("reference", model=f"{arch} reduced f32 {layout}",
                heads=f"{cfg.n_heads}/{cfg.n_kv_heads}",
                head_dim=cfg.head_dim if cfg.n_heads else 0,
                requests=len(reqs), tokens_equal=True, telemetry_equal=True,
                frac_tiles_computed=np.round(fr, 4).tolist(),
                **{k: pc[k] for k in ("prefix_hits", "chunks_skipped",
                                      "pages_shared", "pages_cowed",
                                      "snapshots", "snap_restores")
                   if k in pc})


def reference_spec():
    """Self-speculative decoding (k = 3) on reduced float32 granite-3-2b,
    rwkv6-3b and zamba2-7b (its published head geometry, as in
    ``reference_recurrent``), calibrated on the CPU, paged, 4 slots, a
    shared-prefix trace of 10 new tokens a request, on the card (CUDA
    kernels) and on the CPU (plain versions): greedy drafts in dense
    mode and in kernel mode with drafts at draft_cap 0.5 give the CPU's
    tokens and spec counters (dense: also vanilla decode's tokens);
    temperature-1.0 drafts in dense mode give vanilla's greedy tokens
    (their draws, and so their counters, are the card's own; the
    recurrent families replay); granite and rwkv6 with a spill forced
    after the first round and the restore give vanilla's tokens on both
    devices.  Kernel-mode drafts at a temperature are left out: their
    tokens depend on the draws."""
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.deploy import calibrate_hybrid, calibrate_lm
    from repro_torch.launch.serve import calib_batches, make_trace
    from repro_torch.models import get_model
    from repro_torch.serving import Engine
    for arch in ("granite-3-2b", "rwkv6-3b", "zamba2-7b"):
        cfg = _zoo_reduced(arch) if arch == "zamba2-7b" else \
            reduce_config(get_config(arch))
        api = get_model(cfg)
        params = api.init(torch.Generator().manual_seed(SEED), cfg)
        cal = calibrate_hybrid if cfg.family == "hybrid" else calibrate_lm
        params, mor, _ = cal(params, cfg, api.forward,
                             calib_batches(cfg, 4, "cpu"), 2)
        reqs = make_trace(cfg, 6, 4, 16, 10, 10, SEED, shared_prefix=16)

        def engine(dev, mode, **kw):
            return Engine(cfg, _to(params, dev),
                          mor=None if mode == "dense" else _to(mor, dev),
                          mor_mode=mode, n_slots=4, max_len=48, **kw)

        vanilla = engine("cpu", "dense").run(list(reqs))
        for mode, cap in (("dense", 0.0), ("kernel", 0.5)):
            out = {}
            for dev in ("cpu", "cuda"):
                eng = engine(dev, mode, spec_k=3, draft_cap=cap)
                out[dev] = (eng.run(list(reqs)), eng.spec.report(),
                            dict(eng.scheduler.dispatch_kinds))
            assert out["cuda"] == out["cpu"], \
                f"{arch} spec {mode}: card and CPU differ"
            if mode == "dense":
                assert out["cuda"][0] == vanilla, f"{arch}: spec != vanilla"
            sp = out["cuda"][1]
            assert sp["rounds"] > 0 and sp["aborts"] == 0, sp
            log("reference", model=f"{arch} reduced f32 paged spec",
                mode=mode, draft_cap=cap, tokens_equal=True,
                spec_counters_equal=True, vanilla_equal=mode == "dense",
                **{k: sp[k] for k in ("rounds", "tokens_drafted",
                                      "tokens_accepted", "replays")},
                dispatch_kinds=json.dumps(out["cuda"][2]))
        eng = engine("cuda", "dense", spec_k=3, spec_draft_temperature=1.0)
        assert eng.run(list(reqs)) == vanilla, \
            f"{arch}: temperature-1.0 drafts changed the greedy tokens"
        sp = eng.spec.report()
        assert arch == "granite-3-2b" or sp["replays"] > 0, sp
        log("reference", model=f"{arch} reduced f32 paged spec",
            draft_temperature=1.0, vanilla_equal=True,
            **{k: round(v, 4) if isinstance(v, float) else v
               for k, v in sp.items() if k != "draft_temperature"})
        if arch == "zamba2-7b":
            continue
        for dev in ("cpu", "cuda"):
            eng = engine(dev, "dense", spec_k=3)
            rids = [eng.submit(p, g) for p, g in reqs]
            for _ in range(50):
                if eng.spec.counters["rounds"]:
                    break
                eng.step()
            eng._preempt(eng.policy.spill_victim(eng.scheduler.slots))
            while eng.scheduler.has_work:
                eng.step()
            eng.drain()
            assert [eng.results[r] for r in rids] == \
                [vanilla[r] for r in sorted(vanilla)], \
                f"{arch} {dev}: preemption mid-speculation changed tokens"
            assert eng.pool.spill_events["restores"] == 1
        log("reference", model=f"{arch} reduced f32 paged spec",
            preempted_mid_speculation=True, vanilla_equal=True,
            spilled_bytes=eng.pool.spill_events["spilled_bytes"])


def _calibrated_logged(cfg, api, params, calibrate):
    """``calibrate`` on 4 batches of 8 x 128 tokens on the card, logged
    with its seconds and peak memory."""
    import torch
    from repro_torch.launch.serve import calib_batches
    t0 = time.perf_counter()
    params, mor, cal = calibrate(params, cfg, api.forward,
                                 calib_batches(cfg, 8, "cuda"), 4)
    torch.cuda.synchronize()
    log("slice", model=cfg.name, calibrate_s=round(time.perf_counter() - t0,
                                                   2),
        calibrate_peak_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2),
        **{k: round(v, 4) for k, v in cal.items()})
    torch.cuda.empty_cache()
    return params, mor


def slice_rwkv():
    """rwkv6-3b at DEPTH (2 of 32) layers (d 2560, d_ff 8960, vocab 65,536,
    bf16; attention-free: the serving cache is state pages only),
    calibrated with ``calibrate_lm`` on its ReLU^2 channel mix, serves the
    shared-prefix trace through the paged engine in kernel (counted: per
    dispatch a launch a layer of mor_tile_mask and of gather_matmul, none
    of masked_matmul_kdim: the channel mix's down product stays plain, as
    in the JAX package), tiled and dense mode, then the slotted engine in
    kernel mode, each held to greedy agreement with paged kernel mode; one
    profiled pass of each paged mode.  -> launches."""
    import torch
    from repro_torch.configs import param_count
    from repro_torch.core.deploy import calibrate_lm
    cfg = _cut_config("rwkv6-3b")
    api, params = _init_logged(cfg, param_count=param_count(cfg)[0],
                               rwkv_heads=cfg.d_model // cfg.rwkv_head_size)
    params, mor = _calibrated_logged(cfg, api, params, calibrate_lm)
    reqs = _shared_prefix_trace(cfg)
    L = cfg.n_layers
    launches, _, tok_k = _paged_cell(
        cfg, params, mor, reqs, ("tiled", "dense"), "rwkv paged",
        per_dispatch={"mor_tile_mask": L, "gather_matmul": L})
    _shadow_cell(cfg, params, mor, reqs, tok_k,
                 {"mor_tile_mask": L, "gather_matmul": L}, "rwkv shadow")
    tok_s, rep_s, _ = _serve(cfg, params, mor, "kernel", reqs,
                             layout="slotted")
    agree = _agree(tok_k, tok_s)
    log("slice", path="rwkv slotted", mode="kernel",
        tok_s=round(rep_s["tokens_per_s"], 2),
        pass_s=round(rep_s["pass_s"], 3), dispatches=rep_s["dispatches"],
        agreement_paged_kernel_vs_slotted_kernel=round(agree, 4),
        **_repeats(rep_s))
    assert agree >= AGREE_MIN, agree
    log("slice", model=cfg.name, peak_mem_gb=round(
        torch.cuda.max_memory_allocated() / 1e9, 2))
    return launches


def slice_zamba2():
    """zamba2-7b at DEPTH (7 of 81) layers (1 of its 13 segments of 6
    Mamba2 layers, followed by the ONE shared attention + SwiGLU block,
    and a tail of 1; d 3584, 32 / 32 heads of 112 under a shared
    window of 4,096, d_ff 14,336, state 64; bf16), calibrated with
    ``calibrate_hybrid``, serves the shared-prefix trace and one request of
    4,160 prompt tokens (the shared attention's ring wraps past its window)
    through the paged engine, state pages and snapshots beside the kv
    pages, in kernel (counted: per dispatch a launch a segment of
    gqa_paged_flash, mor_tile_mask and masked_matmul_kdim, two of
    gather_matmul) and dense mode; one profiled pass of each.  -> launches."""
    import torch
    from repro_torch.configs import param_count
    from repro_torch.core.deploy import calibrate_hybrid
    from repro_torch.launch.serve import make_trace
    from repro_torch.models.layers.ssm import _dims
    cfg = _cut_config("zamba2-7b")
    d_in, H, P, N = _dims(cfg)
    n_seg = cfg.n_layers // cfg.shared_attn_every
    # a state page: every mamba layer's SSD state (float32) and conv
    # history (bf16)
    page_bytes = cfg.n_layers * (H * N * P * 4 + 3 * (d_in + 2 * N) * 2)
    api, params = _init_logged(cfg, param_count=param_count(cfg)[0],
                               segments=n_seg, ssm_heads=H,
                               state_page_mb=round(page_bytes / 1e6, 1),
                               window=cfg.shared_attn_window)
    params, mor = _calibrated_logged(cfg, api, params, calibrate_hybrid)
    reqs = _shared_prefix_trace(cfg)
    long_prompt = make_trace(cfg, 1, 4160, 4160, 16, 16, SEED + 1)[0]
    assert len(long_prompt[0]) == 4160 > cfg.shared_attn_window
    reqs.append(long_prompt)
    launches, _, _ = _paged_cell(
        cfg, params, mor, reqs, ("dense",), "zamba2 paged",
        per_dispatch={"gqa_paged_flash": n_seg, "mor_tile_mask": n_seg,
                      "gather_matmul": 2 * n_seg,
                      "masked_matmul_kdim": n_seg})
    log("slice", model=cfg.name, peak_mem_gb=round(
        torch.cuda.max_memory_allocated() / 1e9, 2))
    return launches


# -- the paper's DNNs (TDS, CNN10, ResNet18, Darknet19) ----------------------

# (case, model, conv layer, (M, K, N)) where the kernel API is timed
# -- the paged-sharded layout: 2 ranks sharing the card ---------------------

SHARDS = 2
SHARDED_REFERENCES = ("granite-3-2b", "deepseek-v2-236b", "rwkv6-3b",
                      "zamba2-7b")
# the page-sharded shadow step: the twin samples 1 dispatch in 4; the
# reduced float32 references it runs on (a GQA stack, a state-only one)
SHARDED_SHADOW_RATE = 0.25
SHADOW_REFERENCES = ("granite-3-2b", "rwkv6-3b")


def _layout_counts(eng):
    """(attention layers, state leaves) of an engine's cache: the merges
    and the state gathers a sharded dispatch issues."""
    from repro_torch.serving import kv_pool
    attn, leaves = [0], [0]

    def kv(node):
        attn[0] += (node["pos"] if "pos" in node else
                    node["c_kv"]).shape[0]
        return node

    def st(a):
        leaves[0] += 1
        return a

    for k, v in eng.cache.items():
        if k not in ("pos", "block_table", "state_table"):
            kv_pool.map_state_leaves(kv_pool.map_kv_nodes(v, kv), st)
    return attn[0], leaves[0]


def _flat_block(dm):
    """A metrics block's read -> {lane: numpy array} ("groups/<g>/<k>"
    for a group's lanes)."""
    import numpy as np
    out = {}
    for k, v in dm.items():
        if k == "groups":
            for g, d in v.items():
                for kk, vv in d.items():
                    out[f"groups/{g}/{kk}"] = np.asarray(vv)
        else:
            out[k] = np.asarray(v)
    return out


def _shadow_engine_kw(shadow: bool) -> dict:
    """The engine's obs and shadow arguments of a shadow pass."""
    if not shadow:
        return {}
    from repro_torch.obs import Observability
    return {"obs": Observability(), "shadow_rate": SHARDED_SHADOW_RATE}


def _single_shadow(cfg, params, mor, reqs, n_slots=8):
    """The kernel-mode single-device paged engine with the shadow twin
    on ``reqs`` (the sharded pass's slots and lengths) -> (tokens, its
    metrics block, flat)."""
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, mor=mor, mor_mode="kernel", n_slots=n_slots,
                 max_len=max(len(p) for p, _ in reqs) + 18, layout="paged",
                 **_shadow_engine_kw(True))
    toks = eng.run(list(reqs))
    return toks, _flat_block(eng._last_device_metrics)


def _sharded_pass(cfg, params, mor, reqs, group, shadow=False, **kw):
    """One pass of the kernel-mode sharded engine on ``reqs``, its
    launches (partial ones apart) and collectives counted from just after
    the engine is built to the end of its flush; with ``shadow`` obs on
    and the dense twin at SHARDED_SHADOW_RATE (its merges and state
    gathers counted beside the primary's, its metrics block read).
    -> dict."""
    import torch
    from repro_torch.distributed import collectives
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving import Engine
    eng = Engine(cfg, params, mor=mor, mor_mode="kernel", n_slots=kw.pop(
        "n_slots", 8), max_len=max(len(p) for p, _ in reqs) + 18,
        layout="paged-sharded", group=group, **_shadow_engine_kw(shadow),
        **kw)
    collectives.reset_counts()
    pa.partial_launches = pa.mla_partial_launches = 0
    t0 = time.perf_counter()
    toks, launches = _counted(lambda: eng.run(list(reqs)))
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(collectives.counts)      # the report reads the block again
    rep = eng.report()
    attn, leaves = _layout_counts(eng)
    d = rep["dispatches"]
    block = _flat_block(eng._last_device_metrics) if shadow else None
    twin = int(block["shadow_dispatches"]) if shadow else 0
    want = {k: n * (d + twin) for k, n in (("flash_merge", attn),
                                           ("state_take", leaves)) if n}
    want["check_tokens"] = 1
    if shadow:
        want["obs_block"] = 1
    assert counts == want, (counts, want)
    pool_bytes = sum(t.nbytes for k, v in eng.cache.items()
                     if k not in ("pos", "block_table", "state_table")
                     for t in _leaves(v))
    return {"tokens": toks, "telemetry": eng.telemetry.summary(),
            "prefix": eng._prefix_counters(), "dispatches": d,
            "launches": launches, "attention_layers": attn,
            "state_leaves": leaves,
            "partial": {"gqa_paged_flash": pa.partial_launches,
                        "mla_paged_flash": pa.mla_partial_launches},
            "collectives": counts, "sharding": rep["sharding"],
            "pool_bytes": pool_bytes, "host_ms_per_dispatch":
            wall / max(d, 1) * 1e3, "pool": eng.pool, "block": block,
            "twin": twin}


def _sharded_rank(group):
    """One rank of the sharded phase: the reduced float32 references on
    the card and on the CPU (the same page group: gloo takes both), then
    granite-3-2b at DEPTH layers on the card.  Rank 0 calibrates each
    model and
    hands its tree to the other rank.  -> the rank's results."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.serve import calibrate, make_trace
    from repro_torch.models import get_model
    from repro_torch.serving import kv_pool
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"rank": group.rank, "backend": group.backend,
           "device": str(group.device), "references": {}}
    for arch in SHARDED_REFERENCES:
        cfg = _zoo_reduced(arch) if arch == "zamba2-7b" else \
            reduce_config(get_config(arch))
        api = get_model(cfg)
        params = api.init(torch.Generator().manual_seed(SEED), cfg)
        params, mor, _ = calibrate(params, cfg, api, "cpu", 4, group)
        reqs = make_trace(cfg, 6, 4, 16, 6, 6, SEED, shared_prefix=16)
        runs = {dev: _sharded_pass(cfg, _to(params, dev), _to(mor, dev),
                                   reqs, group, n_slots=4)
                for dev in ("cpu", "cuda")}
        cpu, card = runs["cpu"], runs["cuda"]
        for key in ("tokens", "telemetry", "prefix", "dispatches"):
            assert card[key] == cpu[key], f"{arch}: card and CPU {key} differ"
        d, attn = card["dispatches"], card["attention_layers"]
        kind = "mla_paged_flash" if cfg.mla else "gqa_paged_flash"
        assert card["launches"][kind] == card["partial"][kind] == attn * d
        out["references"][arch] = {
            k: card[k] for k in ("dispatches", "attention_layers",
                                 "state_leaves", "collectives", "partial",
                                 "sharding", "host_ms_per_dispatch")}
        if arch in SHADOW_REFERENCES:
            # the page-sharded shadow step on the card, against shadow-off
            # and (rank 0) one device's paged engine with the twin on
            sh = _sharded_pass(cfg, _to(params, "cuda"), _to(mor, "cuda"),
                               reqs, group, shadow=True, n_slots=4)
            assert sh["tokens"] == card["tokens"], f"{arch}: shadow tokens"
            out["references"][arch]["shadow"] = {
                k: sh[k] for k in ("block", "twin", "collectives")}
            if group.rank == 0:
                out["references"][arch]["single_shadow"] = _single_shadow(
                    cfg, _to(params, "cuda"), _to(mor, "cuda"), reqs, 4)
        out["references"][arch]["prefix"] = {
            k: card["prefix"][k] for k in ("prefix_hits", "chunks_skipped",
                                           "snapshots", "snap_restores")}
        torch.cuda.empty_cache()
    cfg = _cut_config("granite-3-2b")
    api = get_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device=group.device).manual_seed(SEED),
                      cfg)
    params, mor, _ = calibrate(params, cfg, api, group.device, 8, group)
    torch.cuda.synchronize()
    out["granite_setup_s"] = time.perf_counter() - t0
    reqs = _shared_prefix_trace(cfg)
    g = _sharded_pass(cfg, params, mor, reqs, group)
    # the page-sharded shadow step at full width (kernel mode: the dense
    # twin on the view of each rank's shard), and one device's paged
    # engine with the twin on the same trace (rank 0)
    gs = _sharded_pass(cfg, params, mor, reqs, group, shadow=True)
    assert gs["tokens"] == g["tokens"], "shadow-on tokens differ"
    out["granite_shadow"] = {k: gs[k] for k in (
        "block", "twin", "collectives", "launches", "partial",
        "dispatches")}
    del gs
    if group.rank == 0:
        out["granite_single_shadow"] = _single_shadow(cfg, params, mor,
                                                      reqs)
    # the single-rank pool of the same configuration, from its host half
    single = kv_pool.PagedPool(cfg, 8, max(len(p) for p, _ in reqs) + 18,
                               device="meta")
    pool = g.pop("pool")
    per_page = g["pool_bytes"] / pool.local_pages()[0]
    g["single_pool_bytes"] = (single.n_pages + 1) * per_page
    g["page_bytes"] = per_page
    g["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    g["launches_per_dispatch"] = {k: v / g["dispatches"]
                                  for k, v in g["launches"].items() if v}
    del g["telemetry"]
    out["granite"] = g
    return out


def slice_sharded(single_tokens):
    """The paged-sharded layout (``--layout paged-sharded --shards 2``'s
    ``run_ranks``): 2 rank processes on the one card, gloo (NCCL refuses
    two ranks on one device; gloo stages every merge through the host).
    Reduced float32 granite, deepseek (MLA), rwkv6 (state only) and
    zamba2 (state and its shared attention at D 112): the card's tokens,
    telemetry, prefix counters and dispatches equal the CPU's; then
    granite-3-2b at DEPTH layers (bf16) on the shared-prefix trace in
    kernel mode: the ranks' tokens equal (the engine's flush raises
    otherwise), agreement with the single-rank paged engine's tokens
    (``single_tokens``) >= AGREE_MIN, exactly one partial
    ``gqa_paged_flash`` launch and one merge a layer and dispatch and no other
    collective, pages on both shards, each rank's pool half the
    single-rank one's (within a page and the scratch page).  The
    page-sharded shadow step (obs on, the dense twin at
    SHARDED_SHADOW_RATE): on the reduced float32 SHADOW_REFERENCES and
    on granite at DEPTH, tokens equal shadow-off's on every rank, the
    metrics block's counters (the ranks' rows summed at the flush) equal
    one device's paged engine's with the twin on (on the float32
    references its fixed-point means too, within 1 / SCALE; at full
    width their largest difference is logged), and the twin's partial
    attention launches and merges are counted beside the primary's.
    -> ({kernel: launches on the sharded path, rank 0}, granite's
    launches, its launches with the twin on)."""
    from repro_torch.launch.mesh import page_backend, run_ranks
    backend = page_backend("cuda", SHARDS)
    log("sharded", ranks=SHARDS, backend=backend,
        note="two ranks share cuda:0: gloo stages every merge through "
             "the host, so no time here is the layout's speed")
    ranks = run_ranks(_sharded_rank, SHARDS, "cuda")
    for r in ranks:
        assert r["backend"] == backend
        for arch, ref in r["references"].items():
            log("sharded", rank=r["rank"], model=f"{arch} reduced f32",
                tokens_equal_cpu=True, dispatches=ref["dispatches"],
                collectives=json.dumps(ref["collectives"]),
                partial=json.dumps(ref["partial"]),
                hiwater=json.dumps({k: v for k, v in ref["sharding"].items()
                                    if "hiwater" in k}),
                prefix=json.dumps(ref["prefix"]),
                host_ms_per_dispatch=round(ref["host_ms_per_dispatch"], 2))
    for arch in SHADOW_REFERENCES:
        single_toks, single = ranks[0]["references"][arch]["single_shadow"]
        for r in ranks:
            sh = r["references"][arch]["shadow"]
            _same_shadow_block(sh["block"], single)
            log("sharded", rank=r["rank"], model=f"{arch} reduced f32",
                shadow_rate=SHARDED_SHADOW_RATE, twin_dispatches=sh["twin"],
                tokens_equal_shadow_off=True,
                block_equal_single_device_paged=True,
                shadow=json.dumps(_shadow_lanes(sh["block"])),
                collectives=json.dumps(sh["collectives"]))
    g0, g1 = (r["granite"] for r in ranks)
    assert g0["tokens"] == g1["tokens"], "the ranks' tokens differ"
    agree = _agree(g0["tokens"], single_tokens)
    _, single = ranks[0]["granite_single_shadow"]
    L = DEPTH["granite-3-2b"]
    for r in ranks:
        gs = r["granite_shadow"]
        d, twin = gs["dispatches"], gs["twin"]
        assert twin == (d + 3) // 4, (d, twin)
        assert gs["launches"]["gqa_paged_flash"] == \
            gs["partial"]["gqa_paged_flash"] == L * (d + twin), gs["launches"]
        assert gs["launches"]["mor_tile_mask"] == L * d, gs["launches"]
        # the per-element means follow the activations, which the bf16
        # merge moves (tokens agree with one device's at AGREE_MIN, not
        # bit for bit): counted, not held to one rounding
        means_diff = _same_shadow_block(gs["block"], single, means=False)
        log("sharded", rank=r["rank"], model="granite-3-2b", layers=L,
            mode="kernel", shadow_rate=SHARDED_SHADOW_RATE,
            tokens_equal_shadow_off=True, dispatches=d, twin_dispatches=twin,
            launches=json.dumps({k: v for k, v in gs["launches"].items()
                                 if v}),
            collectives=json.dumps(gs["collectives"]),
            counters_equal_single_device_paged=True,
            means_max_abs_diff=round(means_diff, 6),
            shadow=json.dumps(_shadow_lanes(gs["block"])),
            single_device_paged_shadow=json.dumps(_shadow_lanes(single)))
    for r in ranks:
        g = r["granite"]
        d = g["dispatches"]
        assert g["launches"]["gqa_paged_flash"] == \
            g["partial"]["gqa_paged_flash"] == L * d, g["launches"]
        assert g["collectives"] == {"flash_merge": L * d,
                                    "check_tokens": 1}, g["collectives"]
        hw = g["sharding"]["kv_pages_hiwater_per_shard"]
        assert all(n > 0 for n in hw), hw
        assert abs(g["pool_bytes"] - g["single_pool_bytes"] / 2) <= \
            2 * g["page_bytes"], (g["pool_bytes"], g["single_pool_bytes"])
        log("sharded", rank=r["rank"], model="granite-3-2b", layers=L,
            mode="kernel", dispatches=d, setup_s=round(r["granite_setup_s"],
                                                       1),
            launches_per_dispatch=json.dumps(g["launches_per_dispatch"]),
            partial=json.dumps(g["partial"]),
            collectives=json.dumps(g["collectives"]),
            kv_hiwater_per_shard=hw,
            pool_gb=round(g["pool_bytes"] / 1e9, 4),
            single_rank_pool_gb=round(g["single_pool_bytes"] / 1e9, 4),
            peak_gb=round(g["peak_gb"], 2),
            host_ms_per_dispatch=round(g["host_ms_per_dispatch"], 2),
            prefix=json.dumps(g["prefix"]))
    log("sharded", model="granite-3-2b", ranks_tokens_equal=True,
        agreement_vs_single_rank_paged=round(agree, 4), agree_min=AGREE_MIN)
    assert agree >= AGREE_MIN, agree
    deepseek = ranks[0]["references"]["deepseek-v2-236b"]
    return ({"gqa_paged_flash[partial]": g0["partial"]["gqa_paged_flash"],
             "mla_paged_flash[partial]": deepseek["partial"][
                 "mla_paged_flash"]}, g0["launches"],
            ranks[0]["granite_shadow"]["launches"])


def _shadow_lanes(block):
    """The shadow oracle's lanes of a flat metrics block, summed over
    layers (JSON-ready)."""
    return {k.rsplit("/", 1)[-1]: (round(float(v.sum()), 4)
                                   if v.dtype.kind == "f" else int(v.sum()))
            for k, v in block.items()
            if "shadow" in k or k.endswith(("false_skip", "false_keep",
                                            "truth_live"))}


def _same_shadow_block(got, want, means=True):
    """A sharded engine's metrics block (each rank's row gathered and
    summed at the flush) against one device's paged engine's: every
    integer lane (the counters) equal; with ``means`` the fixed-point
    lanes (rates, sign agreement, shadow error) within one rounding of
    ``frac * SCALE`` (1 / SCALE).  -> the fixed-point lanes' largest
    difference."""
    import numpy as np
    from repro_torch.obs import SCALE
    assert set(want) == set(got), set(want) ^ set(got)
    worst = 0.0
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if w.dtype.kind in "iub":
            assert np.array_equal(g, w), (k, g, w)
            continue
        worst = max(worst, float(np.abs(g - w).max()) if g.size else 0.0)
        if means:
            assert np.allclose(g, w, rtol=0, atol=1 / SCALE), (k, g, w)
    return worst


MESH_RANKS = 2
MESH_GRANITE_LAYERS = 2            # of 40: granite's train / decode here
MESH_DEEPSEEK_LAYERS = 2           # of 60: layer 0 dense, layer 1 MoE
MESH_MOE_SHAPES = ((8, 32), (8, 183))   # a dispatch's rows, a prefill's
MESH_DECODE_PROMPTS, MESH_DECODE_LEN, MESH_DECODE_STEPS = 8, 32, 16
# granite's "contract_tp" float32 decode: 8 prompts of 8 tokens through
# the serve step, then 4 greedy tokens
CONTRACT_DECODE, CONTRACT_DECODE_STEPS = (8, 8), 4
# granite's MoR-active contract forward on (1, 2): every odd tile dead,
# cap_live 0.34 (it bites mid-row); a tile whose mask differs from one
# device's must hold a proxy ReLU input v with |v| <= K x 2^-24 x
# sum_k |x_k w_k| |bn_scale| (float32 rounding of the proxy's product)
MESH_MOR_CAP, MESH_MOR_K = 0.34, 64
MESH_MOR_TOKENS = (8, 64)
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 2.0 ** -7, 1e-3   # atol x leaf max
# the bf16 norm's bound, above bf16's own noise: the (1, 2) mesh rounds
# each rank's partial products to bf16 before their sum, and moved the
# norm by up to 3.9e-4 on the card (PERF.md PR 28), while the same step
# in float32 (MESH_F32_RTOL) and the planted fault (_NormFault) bracket it
MESH_LOSS_RTOL = MESH_NORM_RTOL = 1e-3
# the float32 twin of the same step: sums in another order only
MESH_F32_RTOL = 1e-5
# this slice's families on (1, 2), at their published widths, cut so
# that one device's train state and both ranks' fit the card in turn:
# deepseek to 2 layers (layer 0 dense, layer 1 MoE) and 8 of its 160
# routed experts (the 160-expert forward stays the one above; each
# step's expert all-to-all crosses gloo's host staging), rwkv6 to 2
# layers, zamba2 to 7 (one segment of 6 mamba layers, the shared block
# once, one tail layer)
MESH_FAMILIES = {"deepseek-v2-236b": {"n_layers": 2, "n_experts": 8},
                 "rwkv6-3b": {"n_layers": 2},
                 "zamba2-7b": {"n_layers": 7}}
# the families whose (1, 2) step the dry run predicts (5e) and whose
# params are held after each step (deepseek's 1.8e9 would cross gloo's
# host staging at each hold: its loss, norm and float32 twin are held)
MESH_FAMILY_PREDICTED = ("rwkv6-3b", "zamba2-7b")
# each family's float32 twin of the (1, 2) step, at 1e-5, where it is
# cut further than its bf16 step (deepseek's runs at MESH_FAMILIES'):
# rwkv6 at its 2 layers, zamba2 to one mamba layer and the shared block
MESH_F32_CUTS = {"zamba2-7b": {"n_layers": 1, "shared_attn_every": 1}}
# the families whose bf16 (1, 2) step runs under "contract_tp" too (its
# splits moved onto the forms' dims), cut as here
MESH_CONTRACT_CUTS = {"zamba2-7b": {"n_layers": 1, "shared_attn_every": 1}}


def _mesh_gb():
    """What the phase holds at most on the one card, reckoned on the meta
    device before anything runs: granite's train state on one device
    and each rank's half of it, and deepseek's params on two ranks at
    once (each inits the whole, then keeps its half) plus a rank's own
    experts of one MoE layer at their whole f (the all-to-all's
    output)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import tree_bytes
    from repro_torch.models import param_shapes
    g = get_config("granite-3-2b").replace(n_layers=MESH_GRANITE_LAYERS)
    d = get_config("deepseek-v2-236b").replace(n_layers=MESH_DEEPSEEK_LAYERS)
    pg = tree_bytes(param_shapes(g))
    # bf16 params + bf16 moments + the float32 master: 5 x the params
    granite = 5 * pg + 2 * 5 * pg / MESH_RANKS
    ps = param_shapes(d)
    pd = tree_bytes(ps)
    layer = tree_bytes({k: v for k, v in ps["moe_layers"]["moe"].items()
                        if k != "shared"}) / (d.n_layers - d.first_k_dense)
    deepseek = MESH_RANKS * (pd + pd / MESH_RANKS + layer / MESH_RANKS)
    # a family's float32 twin (MESH_F32_CUTS): params, two moments and
    # the gradient, 16 bytes a param on one device; bf16 with the
    # master, 12
    families = 0
    for arch in MESH_FAMILIES:
        cfg = _family_cfg(arch)
        n = tree_bytes(param_shapes(cfg)) / 2
        n32 = tree_bytes(param_shapes(cfg.replace(
            **MESH_F32_CUTS.get(arch, {})))) / 2
        families = max(families, n * 12, n32 * 16)
    return granite / 1e9, deepseek / 1e9, families / 1e9


class _NormFault:
    """While active, each mesh ``global_norm`` (the train step's clip
    norm) is also taken with a fault planted: every rank counts every
    leaf, so a leaf replicated over an axis is counted once a rank of
    it.  The step goes on with the sound norm; ``faulty`` holds the
    planted one's value a step, and its collective is taken out of the
    counts."""

    def __enter__(self):
        from repro_torch.distributed import collectives as co
        from repro_torch.optim import adamw
        self._orig = orig = adamw.global_norm
        faulty = self.faulty = []

        def everywhere(specs):
            if isinstance(specs, dict):
                return {k: everywhere(v) for k, v in specs.items()}
            return (("data", "model"),)

        def global_norm(tree, mesh=None, specs=None):
            norm = orig(tree, mesh, specs)
            kept = [(d, dict(d)) for d in (co.counts, co.nbytes,
                                           co.ib_nbytes)]
            faulty.append(float(orig(tree, mesh, everywhere(specs))))
            for d, was in kept:
                d.clear()
                d.update(was)
            return norm
        adamw.global_norm = global_norm
        return self

    def __exit__(self, *exc):
        from repro_torch.optim import adamw
        adamw.global_norm = self._orig


def _mesh_train(cfg, opt, mesh, batches, hold=True, layout="fsdp_tp"):
    """Train steps of granite on ``mesh`` (None: one device; the params
    in ``layout``) from the seed's weights, one a batch -> (losses,
    norms, the params after each step gathered on the CPU (``hold``;
    else None), the learning rate of each step, the last step's device
    ms, its collectives, their bytes by kind, the norms with
    ``_NormFault``'s fault planted (mesh only))."""
    import torch
    from repro_torch.distributed import collectives as co
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import paths
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED), cfg)
    specs = None
    if mesh is not None:
        specs = steps.mesh_specs(cfg, mesh, layout)
        params = sr.shard_tree(params, specs, mesh)
        torch.cuda.empty_cache()
    state = adamw_init(params, opt)
    step = steps.make_train_step(cfg, opt, mesh=mesh, param_layout=layout)
    losses, norms, lrs, fulls, ms = [], [], [], [], 0.0
    fault = _NormFault() if mesh is not None else contextlib.nullcontext()
    with fault:
        for b in batches:
            co.reset_counts()
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            params, state, m = step(params, state, b)
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1)
            counts, nbytes = dict(co.counts), dict(co.nbytes)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
            if not hold:
                continue
            whole = (params if mesh is None else
                     sr.gather_tree(params, specs, mesh))
            fulls.append({k: v.detach().float().cpu()
                          for k, v in paths(whole).items()})
            del whole
    del params, state
    torch.cuda.empty_cache()
    return (losses, norms, fulls if hold else None, lrs, ms, counts,
            nbytes, getattr(fault, "faulty", None))


def _held_train(cfg, opt, mesh, batches, single, hold=True,
                layout="fsdp_tp"):
    """``_mesh_train`` on ``mesh`` (in ``layout``), its params held after
    each step to
    ``single`` (the single-device run's, on rank 0: the gathered params
    are the same bits on every rank; None on the others) where ``hold``
    -> (losses, norms, the planted fault's norms, each step's share of
    the params' bound, the last step's ms, its collectives, their bytes
    by kind, peak GB)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    loss, norm, fulls, lrs, ms, counts, nbytes, faulty = _mesh_train(
        cfg, opt, mesh, batches, hold, layout)
    excess = None
    if single is not None and hold:
        shape = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
        excess = [_close_params(f, w, f"{shape} step {i + 1}",
                                2 * sum(lrs[:i + 1]) if i else 0.0)
                  for i, (f, w) in enumerate(zip(fulls, single))]
    del fulls
    return (loss, norm, faulty, excess, ms, counts, nbytes,
            torch.cuda.max_memory_allocated() / 1e9)


def _check_train(phase, rank, shape, run, want_loss, want_norm, f32,
                 path="granite train"):
    """Log one rank's mesh train run (``_held_train``'s result) and hold
    it to the single-device run's losses and norms: bf16 at
    MESH_LOSS_RTOL / MESH_NORM_RTOL, the float32 twin at MESH_F32_RTOL;
    where ``model`` splits granite's params, and in rwkv6's and zamba2's
    float32 twins, the planted fault must lie past the norm's bound (a
    family's bf16 step's and deepseek's are logged: how far it lies
    depends on the share of its replicated leaves in the norm)."""
    loss, norm, faulty, excess, ms, counts, nbytes, peak = run
    rtol = MESH_F32_RTOL if f32 else MESH_NORM_RTOL
    loss_diff = [abs(a - b) / abs(b) for a, b in zip(loss, want_loss)]
    norm_diff = [abs(a - b) / b for a, b in zip(norm, want_norm)]
    fault_diff = [abs(a - b) / b for a, b in zip(faulty, want_norm)]
    log(phase, path=path, rank=rank, mesh=shape,
        losses=loss, single_losses=want_loss, loss_rel_diff=loss_diff,
        grad_norms=norm, single_grad_norms=want_norm,
        norm_rel_diff=norm_diff, norm_rtol=rtol,
        planted_fault_norm_rel_diff=fault_diff,
        params_share_of_bf16_bound=(None if excess is None else
                                    [round(e, 4) for e in excess]),
        step_ms=round(ms, 2), peak_gb=round(peak, 3),
        collectives=json.dumps(counts), bytes_by_kind=json.dumps(nbytes))
    assert max(loss_diff) <= (MESH_F32_RTOL if f32 else MESH_LOSS_RTOL), \
        (shape, loss_diff)
    assert max(norm_diff) <= rtol, (shape, norm_diff)
    if int(shape.split("_")[0].split("x")[1]) > 1 and (
            path == "granite train" or f32 and path in (
                "rwkv6 train", "zamba2 train")):
        # the bound lies between the sound run and the fault
        assert min(fault_diff) > rtol, (shape, fault_diff)


def _mesh_decode(cfg, mesh, prompts, n):
    """Prefill + ``n - 1`` greedy steps of ``cfg`` from the seed's weights
    on ``mesh`` (None: one device) -> (tokens (B, n) on the CPU, the
    collectives)."""
    import torch
    from repro_torch.distributed import collectives as co
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch import steps
    from repro_torch.models import get_model
    params = get_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(SEED), cfg)
    if mesh is not None:
        params = sr.shard_tree(params, steps.mesh_specs(cfg, mesh), mesh)
        torch.cuda.empty_cache()
    B, P = prompts.shape
    # P + n rows: even, so that the ring splits over the 2 model ranks
    cache = steps.init_cache(cfg, B, P + n, "cuda", mesh=mesh)
    prefill = steps.make_prefill_step(cfg, mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh=mesh)
    co.reset_counts()
    with torch.no_grad():
        nxt, cache = prefill(params, cache, prompts)
        toks = [nxt]
        for _ in range(n - 1):
            nxt, cache = serve(params, cache, nxt[:, None])
            toks.append(nxt)
    out = torch.stack(toks, 1).cpu()
    del params, cache
    torch.cuda.empty_cache()
    return out, dict(co.counts)


class _PredictRecorder:
    """Records every expert plan's prediction (its tile mask, the kept
    tiles and gather_matmul's live / computed counters) while active."""

    def __init__(self):
        self.preds = []

    def __enter__(self):
        from repro_torch.core.executor import MoRExecutionPlan
        self._orig = orig = MoRExecutionPlan.predict
        preds = self.preds

        def predict(plan, *a, **k):
            p = orig(plan, *a, **k)
            preds.append(p)
            return p
        MoRExecutionPlan.predict = predict
        return self

    def __exit__(self, *exc):
        from repro_torch.core.executor import MoRExecutionPlan
        MoRExecutionPlan.predict = self._orig

    def last(self):
        p = self.preds[-1]
        n_live, n_comp = p.kernel_counts
        return {"tiles": p.tiles.cpu(), "kept": p.kept.cpu(),
                "n_live": n_live.cpu(), "n_comp": n_comp.cpu()}


def _moe_layer_run(cfg, lp, ml, x):
    """One MoE layer (``moe_apply`` in kernel mode) on ``x`` -> (y on the
    CPU, the expert plan's prediction, slots and counts of the routing
    at this run's capacity)."""
    import torch
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.models.layers import moe as tmoe
    with torch.no_grad(), _PredictRecorder() as rec:
        y, _ = tmoe.moe_apply(lp, cfg, x, mor=ml, mor_mode="kernel")
        pred = rec.last()
    ctx = sr.current()
    T = x.shape[0] // (ctx.mesh.shape["data"] if ctx else 1)
    C = max(int(cfg.capacity_factor * T * cfg.top_k / cfg.n_experts), 1)
    with torch.no_grad():
        _, _, top = tmoe._route(x, lp["router"], cfg.top_k)
        slot = tmoe._dispatch_indices(top, cfg.n_experts, C).cpu()
        counts = tmoe._count(top.reshape(-1), cfg.n_experts).cpu()
    return y.cpu(), pred, slot, counts


@contextlib.contextmanager
def _moves_off():
    """While active, GQA's and the dense FFN's ``tp_keep`` keep only the
    splits that already lie on their forms' dims: under "contract_tp"
    none, so every layer gathers its splits whole, as the mesh did
    before ``sharding_rules.use`` moved them (the package has no such
    knob)."""
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.models.layers import attention, mlp
    saved = [(m, m.tp_keep) for m in (attention, mlp)]

    def where_they_lie(keep, specs, prefix):
        return {k: d for k, d in keep.items()
                if sr.on_model(specs, k[len(prefix):], d)}
    attention.tp_keep = lambda cfg, specs, mp, prefix="attn/": \
        where_they_lie(saved[0][1](cfg, specs, mp, prefix), specs, prefix)
    mlp.tp_keep = lambda specs, active, prefix="": where_they_lie(
        saved[1][1](specs, active, prefix), specs, prefix)
    try:
        yield
    finally:
        for m, f in saved:
            m.tp_keep = f


def _serve_tokens(cfg, params, mesh, prompts, n, layout="fsdp_tp",
                  mor=None):
    """Greedy tokens of ``make_serve_step`` over ``init_cache``'s cache,
    one step a prompt token then ``n - 1`` more, on ``mesh`` (None: one
    device; the params in ``layout``), under the kernel-mode plans
    ``mor`` where given -> (tokens (B, n) on the CPU, the
    collectives)."""
    import torch
    from repro_torch.distributed import collectives as co
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch import steps
    B, P = prompts.shape
    if mesh is not None:
        params = sr.shard_tree(params, steps.mesh_specs(cfg, mesh, layout),
                               mesh)
    cache = steps.init_cache(cfg, B, P + n, "cuda", mesh=mesh)
    serve = steps.make_serve_step(cfg, mor=mor, mor_mode="kernel",
                                  mesh=mesh, param_layout=layout)
    co.reset_counts()
    with torch.no_grad():
        for t in range(P):
            nxt, cache = serve(params, cache, prompts[:, t:t + 1])
        toks = [nxt]
        for _ in range(n - 1):
            nxt, cache = serve(params, cache, nxt[:, None])
            toks.append(nxt)
    out = torch.stack(toks, 1).cpu()
    del params, cache
    torch.cuda.empty_cache()
    return out, dict(co.counts)


def _dead_odd_tiles(layer):
    """Every odd 128-column tile statically dead: no proxy, the binary
    rookie enabled, an intercept far below zero."""
    import torch
    dead = (torch.arange(layer["m"].shape[-1], device=layer["m"].device)
            // 128) % 2 == 1
    return dict(layer, bn_bias=torch.where(dead, -1e3, layer["bn_bias"]),
                enable=layer["enable"] | dead,
                is_proxy=layer["is_proxy"] & ~dead,
                proxy_slot=torch.where(dead, -1, layer["proxy_slot"]))


class _MoRRecorder:
    """Every dense MoR plan's prediction while active, on the CPU: its
    tile mask, kept tiles and gather_matmul's counters; with ``ratios``
    also, per tile, how near float32 rounding of zero its members'
    proxy ReLU inputs lie (``_proxy_ratio``) on the inputs it predicted
    on."""

    def __init__(self, ratios=False):
        self.ratios, self.seen = ratios, []

    def __enter__(self):
        from repro_torch.core.executor import MoRExecutionPlan
        self._orig = orig = MoRExecutionPlan.predict

        def predict(plan, x, w, **k):
            p = orig(plan, x, w, **k)
            r = _proxy_ratio(x, w, plan.mor) if self.ratios else None
            self.seen.append((p, r))
            return p
        MoRExecutionPlan.predict = predict
        return self

    def __exit__(self, *exc):
        from repro_torch.core.executor import MoRExecutionPlan
        MoRExecutionPlan.predict = self._orig
        self.seen = [{"tiles": p.tiles.cpu(), "kept": p.kept.cpu(),
                      "counts": tuple(int(c) for c in p.kernel_counts),
                      "ratio": r} for p, r in self.seen]


def _proxy_ratio(x, w, mor):
    """(T / 8, N / 128) per tile: the least |proxy ReLU input| of its
    members over MESH_MOR_K x 2^-24 x sum_k |x_k w_k| |bn_scale| of the
    proxy (inf where no member has a proxy): a tile whose mask flips
    under another order of the float32 product holds one at or below 1."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.predictor import proxy_relu_in
    slot = torch.clamp(mor["proxy_slot"], min=0).long()
    v = proxy_relu_in(x, w, mor).abs()
    mag = (x.float().abs() @ w[:, slot].float().abs()) * \
        mor["bn_scale"][slot].abs()
    r = v / (MESH_MOR_K * 2.0 ** -24 * mag)
    r = torch.where((mor["proxy_slot"] < 0)[None, :], float("inf"), r)
    r = F.pad(r, (0, 0, 0, (-r.shape[0]) % 8), value=float("inf"))
    return (-F.max_pool2d(-r[None], (8, 128)))[0].cpu()


@contextlib.contextmanager
def _bytes_by_name():
    """While active, the collectives' bytes by name (``collectives``
    tallies them by kind): -> the dict it fills."""
    from repro_torch.distributed import collectives as co
    named, count = {}, co._count

    def tally(name, kind, x, group=None, n=0):
        named[name] = named.get(name, 0) + (n or x.numel() * x.element_size())
        count(name, kind, x, group, n)
    co._count = tally
    try:
        yield named
    finally:
        co._count = count


@contextlib.contextmanager
def _mor_ffn_whole():
    """While active, a dense FFN under an active MoR plan is gathered
    whole on every rank, as before the split (the package has no such
    knob): ``mlp.tp_keep`` keeps nothing."""
    from repro_torch.models.layers import mlp
    keep = mlp.tp_keep
    mlp.tp_keep = lambda specs, whole, prefix="": keep(specs, True, prefix)
    try:
        yield
    finally:
        mlp.tp_keep = keep


def _mor_block_stats(tiles, proxy, M):
    """-> [per column block of M: live tile fraction, tiles holding a
    proxy (always computed)]."""
    nt = tiles.shape[-1] // M
    return [[round(float(tiles[:, b * nt:(b + 1) * nt].float().mean()), 4),
             int(proxy[b * nt:(b + 1) * nt].sum())] for b in range(M)]


def _mesh_mor_granite(mesh, lead, cfg):
    """granite-3-2b at full width cut to MESH_GRANITE_LAYERS, calibrated
    in float32 (rank 0 calibrates, its plan broadcast), under its own
    "contract_tp" on (1, 2) with its FFN split by column under the
    active plan: every odd tile dead and ``cap_live`` MESH_MOR_CAP.  The
    bf16 kernel-mode forward (one device's on rank 0 with each tile's
    proxy ratio, ``_proxy_ratio``; the mesh's counted, its exchanges'
    bytes by name, ms and peak GB beside the same forward with the FFN
    gathered whole, ``_mor_ffn_whole``), the float32 twin's and the bf16
    greedy static decodes under the plan, and the calibrated plan's
    live tiles and proxy tiles by column block at model 2 and 16 (one
    device's bf16 forward, no budget).  -> the rank's results."""
    import torch
    from repro_torch.core.deploy import attach_plans
    from repro_torch.distributed import collectives as co
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch import steps
    from repro_torch.launch.serve import calibrate
    from repro_torch.models import get_model, param_shapes
    from repro_torch.models.transformer import full_logits
    from repro_torch.tree import tree_map
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    api = get_model(cfg)
    params32 = get_model(cfg32).init(
        torch.Generator(device="cuda").manual_seed(SEED), cfg32)
    params32, mor, _ = calibrate(params32, cfg32, get_model(cfg32),
                                 mesh.device, 8, mesh.group("world"))
    params = tree_map(lambda t, m: t.to(m.dtype), params32,
                      param_shapes(cfg))
    plans = attach_plans({"layers": _dead_odd_tiles(mor["layers"])}, cfg,
                         "kernel", capacities={"layers": MESH_MOR_CAP})
    out = {"n_proxy": [int(v) for v in plans["layers"].n_proxy]}
    tokens = torch.randint(0, cfg.vocab_size, MESH_MOR_TOKENS, generator=
                           torch.Generator(device="cuda").manual_seed(
                               SEED + 3), device="cuda")
    if lead:
        with torch.no_grad(), _MoRRecorder(ratios=True) as one:
            ref = api.forward(params, cfg, {"tokens": tokens}, mor=plans,
                              mor_mode="kernel")[0].float().cpu()
        out["single"] = one.seen
        calib = attach_plans(mor, cfg, "kernel")
        with torch.no_grad(), _MoRRecorder() as nat:
            api.forward(params, cfg, {"tokens": tokens}, mor=calib,
                        mor_mode="kernel")
        out["imbalance"] = []
        for l, p in enumerate(nat.seen):
            plan = calib["layers"].layer(l)
            proxy = plan.mor["is_proxy"].reshape(-1, 128).any(-1).cpu()
            out["imbalance"].append({
                "n_proxy": plan.n_proxy,
                "frac_live": round(float(p["tiles"].float().mean()), 4),
                **{f"model{M}": _mor_block_stats(p["tiles"], proxy, M)
                   for M in (2, 16)}})
        del calib
    specs = steps.mesh_specs(cfg, mesh, "contract_tp")
    loc = sr.shard_tree(params, specs, mesh)
    torch.cuda.empty_cache()

    def forward():
        return api.forward(loc, cfg, {"tokens": tokens}, mor=plans,
                           mor_mode="kernel")

    fwd = {}
    with sr.activation_context(mesh, specs=specs), torch.no_grad():
        for whole in (False, True):
            ctx = _mor_ffn_whole() if whole else contextlib.nullcontext()
            with ctx:
                forward()                                      # warm
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                sr.model_gathers.clear()
                co.reset_counts()
                t0 = time.perf_counter()
                with _MoRRecorder() as rec, _bytes_by_name() as named:
                    (logits, _), launches = _counted(forward)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            tag = "_whole" if whole else ""
            fwd["ms" + tag] = ms
            fwd["peak_gb" + tag] = torch.cuda.max_memory_allocated() / 1e9
            fwd["launches" + tag] = launches
            fwd["gathered" + tag] = sorted(sr.model_gathers)
            fwd["collectives" + tag] = dict(co.counts)
            fwd["bytes" + tag] = named
            if not whole:
                fwd["preds"] = rec.seen
                logits = full_logits(logits, cfg).float().cpu()
                fwd["tokens"] = logits.argmax(-1)
                if lead:
                    fwd["agreement"] = float(
                        (fwd["tokens"] == ref.argmax(-1)).float().mean())
                    fwd["max_abs_err"] = float((logits - ref).abs().max())
    out["forward"] = fwd
    del loc
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab_size, CONTRACT_DECODE, generator=
                            torch.Generator(device="cuda").manual_seed(
                                SEED + 4), device="cuda")
    for tag, c, p in (("_f32", cfg32, params32), ("", cfg, params)):
        if lead:
            out["single_decode" + tag] = _serve_tokens(
                c, p, None, prompts, CONTRACT_DECODE_STEPS, mor=plans)[0]
        out["decode" + tag] = _serve_tokens(
            c, p, mesh, prompts, CONTRACT_DECODE_STEPS, "contract_tp",
            mor=plans)
    del params, params32
    torch.cuda.empty_cache()
    return out


def _contract_rank(mesh, lead, cfg, opt, cfg32, batches):
    """One rank's part of granite's "contract_tp" checks on (1, 2) beyond
    the held steps: one step split (its splits moved) and one with the
    moves off (``_moves_off``: ms and peak GB only), the step as the
    dry run counts it, a greedy decode of the float32 twin against one
    device's, and the MoR-active forward and decodes with the FFN split
    by column under the plan (``_mesh_mor_granite``).  -> the rank's
    results."""
    import torch
    from repro_torch.distributed import collectives as co
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch import dryrun, steps
    from repro_torch.models import get_model
    out = {}
    torch.distributed.barrier(group=mesh.group("model").pg)
    out["split"] = _first_steps(cfg, opt, mesh, batches[:1], False,
                                "contract_tp")
    with _moves_off():
        out["moves_off"] = _first_steps(cfg, opt, mesh, batches[:1], False,
                                        "contract_tp")
    scfg, sshape, sopt = _mesh_step_cell()
    torch.cuda.empty_cache()
    co.reset_counts()
    counted = dryrun.count_cell(scfg, sshape, opt_cfg=sopt, device="cuda",
                                on=dryrun.MeshArgs(mesh, False,
                                                   "contract_tp"))
    out["step_counted"] = {"counts": dict(co.counts),
                           "nbytes": dict(co.nbytes), "args": counted.args,
                           "flops": counted.counter.flops,
                           "card": counted.card}
    del counted
    torch.cuda.empty_cache()
    # the float32 twin's greedy tokens, prompts through the serve step
    api = get_model(cfg32)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED),
                      cfg32)
    prompts = torch.randint(0, cfg.vocab_size, CONTRACT_DECODE, generator=
                            torch.Generator(device="cuda").manual_seed(
                                SEED + 2), device="cuda")
    if lead:
        out["single_decode_f32"] = _serve_tokens(
            cfg32, params, None, prompts, CONTRACT_DECODE_STEPS)[0]
    out["decode_f32"] = _serve_tokens(cfg32, params, mesh, prompts,
                                      CONTRACT_DECODE_STEPS, "contract_tp")
    del params
    torch.cuda.empty_cache()
    # the MoR-active kernel-mode forward and decodes, the FFN split
    out["mor"] = _mesh_mor_granite(mesh, lead, cfg)
    out["forward"] = out["mor"]["forward"]
    return out


def _mesh_rank(group):
    """One rank of the mesh phase (2 gloo ranks on cuda:0).  Rank 0 runs
    every single-device reference first and frees it; then both ranks
    run granite's train step on (1, 2) and on (2, 1), granite's static
    decode and a reduced float32 granite's on (1, 2), and deepseek's MoE
    layer and whole forward on (1, 2).  -> the rank's results."""
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.deploy import attach_plans
    from repro_torch.distributed import collectives as co
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch import steps
    from repro_torch.launch import timing as ttiming
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import calibrate
    from repro_torch.models import get_model
    from repro_torch.models.transformer import (_layer_plan, full_logits,
                                                layer_slice, use_layer)
    from repro_torch.optim import OptConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    lead = group.rank == 0
    out = {"rank": group.rank, "backend": group.backend}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    # -- granite-3-2b at full width, 2 layers: the train step, one
    # micro-batch of 8 x 512 (each micro-batch re-gathers every weight
    # through the host on (2, 1))
    cfg = get_config("granite-3-2b").replace(n_layers=MESH_GRANITE_LAYERS,
                                             grad_accum=1)
    opt = OptConfig(lr=1e-3, moment_dtype="bfloat16")
    batches = _device_batches(cfg, 2)
    # the float32 twin: the same step, its sums in another order only
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    opt32 = OptConfig(lr=1e-3, moment_dtype="float32")
    if lead:
        out["single_train"] = _mesh_train(cfg, opt, None, batches)
        out["single_train_f32"] = _mesh_train(cfg32, opt32, None, batches,
                                              hold=False)[:2]
    out["train"] = {}
    single = out["single_train"][2] if lead else None
    for mp, c, o, layout in ((2, cfg, opt, "fsdp_tp"),
                             (1, cfg, opt, "fsdp_tp"),
                             (2, cfg32, opt32, "fsdp_tp"),
                             (2, cfg, opt, "contract_tp"),
                             (2, cfg32, opt32, "contract_tp")):
        mesh = make_host_mesh(mp, device=group.device)
        shape = f"{mesh.shape['data']}x{mp}" + (
            "_f32" if c is cfg32 else "") + (
            "_contract" if layout == "contract_tp" else "")
        out["train"][shape] = _held_train(c, o, mesh, batches, single,
                                          hold=c is cfg, layout=layout)
    if lead:
        loss, norm, _, _, ms = out["single_train"][:5]
        out["single_train"] = (loss, norm, ms)
    m12 = make_host_mesh(MESH_RANKS, device=group.device)

    # -- the (1, 2) step as the dry run counts it, on the card
    from repro_torch.launch import dryrun
    scfg, sshape, sopt = _mesh_step_cell()
    torch.cuda.empty_cache()
    co.reset_counts()
    counted = dryrun.count_cell(scfg, sshape, opt_cfg=sopt, device="cuda",
                                on=dryrun.MeshArgs(m12, False, "fsdp_tp"))
    out["step_counted"] = {"counts": dict(co.counts),
                           "nbytes": dict(co.nbytes), "args": counted.args,
                           "flops": counted.counter.flops,
                           "card": counted.card}
    del counted
    torch.cuda.empty_cache()

    # -- granite under "contract_tp" on (1, 2): its splits moved onto
    # the forms' dims (the held steps are in out["train"] above)
    out["contract"] = _contract_rank(m12, lead, cfg, opt, cfg32, batches)

    # -- the static decode over the sequence-sharded ring
    prompts = torch.randint(0, cfg.vocab_size, (MESH_DECODE_PROMPTS,
                                                MESH_DECODE_LEN),
                            generator=gen, device="cuda")
    red = reduce_config(get_config("granite-3-2b")).replace(
        dtype="float32", param_dtype="float32")
    rprompts = prompts % red.vocab_size
    if lead:
        out["single_decode"] = _mesh_decode(cfg, None, prompts,
                                            MESH_DECODE_STEPS)[0]
        out["single_decode_f32"] = _mesh_decode(red, None, rprompts,
                                                MESH_DECODE_STEPS)[0]
    t0 = time.perf_counter()
    out["decode"] = _mesh_decode(cfg, m12, prompts, MESH_DECODE_STEPS)
    torch.cuda.synchronize()
    out["decode_s"] = time.perf_counter() - t0
    out["decode_f32"] = _mesh_decode(red, m12, rprompts, MESH_DECODE_STEPS)

    # -- deepseek-v2-236b at full width, 2 layers, calibrated on rank 0
    dcfg = get_config("deepseek-v2-236b").replace(
        n_layers=MESH_DEEPSEEK_LAYERS)
    api = get_model(dcfg)
    t0 = time.perf_counter()
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED), dcfg)
    params, mor, _ = calibrate(params, dcfg, api, group.device, 8,
                               m12.group("world"))
    torch.cuda.synchronize()
    out["deepseek_setup_s"] = time.perf_counter() - t0
    xs = [torch.randn((b * s, dcfg.d_model), generator=gen, device="cuda"
                      ).bfloat16() for b, s in MESH_MOE_SHAPES]
    tokens = torch.randint(0, dcfg.vocab_size, (8, 64), generator=gen,
                           device="cuda")
    lp0 = layer_slice(params["moe_layers"], 0)
    ml0 = _layer_plan(mor["moe_layers"], 0)
    # the forward's plans, attached once: a dense layer's FFN split by
    # column under its plan reads the plan's proxy count
    plans = attach_plans(mor, dcfg, "kernel")
    if lead:
        out["single_moe"] = [_moe_layer_run(dcfg, lp0["moe"], ml0, x)
                             for x in xs]
        with torch.no_grad():
            logits, _ = api.forward(params, dcfg, {"tokens": tokens},
                                    mor=plans, mor_mode="kernel")
        out["single_forward"] = logits.float().cpu()
        del logits
    specs = steps.mesh_specs(dcfg, m12)
    loc = sr.shard_tree(params, specs, m12)
    del params, lp0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lspec = sr.layer_specs(specs["moe_layers"])
    lp = layer_slice(loc["moe_layers"], 0)
    out["moe"] = []
    with sr.activation_context(m12, specs=specs):
        for x in xs:
            used = use_layer(lp, lspec, dcfg, "moe", ml0, "kernel",
                             x.shape[0])
            out["moe"].append(_moe_layer_run(dcfg, used["moe"], ml0, x))
            del used
        with torch.no_grad():
            (logits, _), launches = _counted(lambda: api.forward(
                loc, dcfg, {"tokens": tokens}, mor=plans, mor_mode="kernel"))
        logits = full_logits(logits, dcfg).float().cpu()
        out["forward_tokens"] = logits.argmax(-1)
        if lead:
            ref = out.pop("single_forward")
            out["forward_agreement"] = float(
                (out["forward_tokens"] == ref.argmax(-1)).float().mean())
            out["forward_max_abs_err"] = float((logits - ref).abs().max())
            del ref
        out["forward_launches"] = launches
        y = torch.randn((tokens.numel(), dcfg.d_model), generator=gen,
                        device="cuda").bfloat16()
        g = m12.group("model")
        out["all_reduce_ms"] = ttiming.device_ms(
            lambda: co.all_reduce(y, g, "timed"), flush, iters=5)
        out["all_reduce_bytes"] = y.numel() * y.element_size()
    out["deepseek_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del loc
    torch.cuda.empty_cache()

    # -- this slice's families on (1, 2): head-parallel MLA, RWKV6's time
    # mix by head and channel mix by column, Mamba2 by head and zamba2's
    # shared block
    out["families"] = {arch: _family_rank(arch, m12, lead)
                       for arch in MESH_FAMILIES}
    return out


def _family_cfg(arch):
    """``arch``'s published config cut as MESH_FAMILIES says, one
    micro-batch a step."""
    from repro_torch.configs import get_config
    return get_config(arch).replace(grad_accum=1, **MESH_FAMILIES[arch])


@contextlib.contextmanager
def _splits_gathered():
    """While active, the families' layers gather their ``model`` splits
    whole, as the mesh did before their tensor-parallel forms: MLA's
    and the shared block's attention, RWKV6's, Mamba2's and the shared
    MLP's keeps emptied here (the package has no such knob); the dense
    FFN's and the experts' stay as they were."""
    from repro_torch.models import hybrid
    from repro_torch.models.layers import attention, rwkv
    none = lambda *a, **k: {}             # noqa: E731
    saved = [(m, n, getattr(m, n)) for m, n in (
        (attention, "tp_keep"), (rwkv, "tp_keep"), (hybrid, "ssm_tp_keep"),
        (hybrid, "mlp_tp_keep"))]
    for m, n, _ in saved:
        setattr(m, n, none)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _family_rank(arch, mesh, lead):
    """One rank's part of a family's checks on (1, 2): rank 0 runs the
    single-device steps first; the (1, 2) steps with the family's
    tensor-parallel forms and deepseek's float32 twin (``_first_steps``:
    each from the same params, so that neither inherits the other's
    noise through a second step: a consecutive bf16 second step of
    rwkv6 moved the norm by 3.3e-3 on (1, 2) on an H100 at 700 W;
    params held where MESH_FAMILY_PREDICTED), the bf16 step with its
    splits gathered (``_splits_gathered``: ms and peak only), the step as the
    dry run counts it (MESH_FAMILY_PREDICTED), and rwkv6's / zamba2's
    kernel-mode forward on (1, 2) after a calibration (rank 0
    calibrates, its plan broadcast), launches counted.  -> the rank's
    results."""
    import torch
    from repro_torch.core.deploy import attach_plans
    from repro_torch.distributed import collectives as co
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.serve import calibrate
    from repro_torch.models import get_model
    from repro_torch.models.transformer import full_logits
    from repro_torch.optim import OptConfig
    cfg, shape, opt = _mesh_step_cell(arch)
    batches = _device_batches(cfg, 2)
    f32_cut = MESH_F32_CUTS.get(arch, {})
    # (tag, its cut, config, optimizer, params held, layout, batches):
    # the float32 twin and the contract step take the first batch only
    # (deepseek's twin both batches)
    twins = [("", {}, cfg, opt, arch in MESH_FAMILY_PREDICTED, "fsdp_tp",
              batches),
             ("_f32", f32_cut, cfg.replace(dtype="float32",
                                           param_dtype="float32", **f32_cut),
              OptConfig(lr=1e-3, moment_dtype="float32"), False, "fsdp_tp",
              batches if arch == "deepseek-v2-236b" else batches[:1])]
    if arch in MESH_CONTRACT_CUTS:
        cut = MESH_CONTRACT_CUTS[arch]
        twins.append(("_contract", cut, cfg.replace(**cut), opt, False,
                      "contract_tp", batches[:1]))
    out = {}
    for tag, cut, c, o, hold, layout, bs in twins:
        out["cut" + tag] = dict(MESH_FAMILIES[arch], **cut)
        single = None
        if lead:
            run = _first_steps(c, o, None, bs, hold)
            single = run[2]
            out["single" + tag] = (run[0], run[1], run[4], run[8])
        # both ranks start the mesh's steps together: a step's ms is not
        # rank 1's wait for rank 0's single-device runs
        torch.distributed.barrier(group=mesh.group("model").pg)
        loss, norm, fulls, lrs, ms, counts, nbytes, faulty, peak = \
            _first_steps(c, o, mesh, bs, hold, layout)
        shares = None
        if single is not None:
            # a leaf drawn as zeros (a LayerNorm's bias, Mamba2's conv_b,
            # dt_bias, A_log) holds only its Adam update: an entry whose
            # bf16 gradient is at the noise level may take the other sign
            # and move by 2 lr
            shares = [_bound_share(f, w, 2 * lr)
                      for f, w, lr in zip(fulls, single, lrs)]
        del fulls, single
        out["tp" + tag] = (loss, norm, faulty, shares and [
            v for v, _ in shares], ms, counts, nbytes, peak)
        out["tp_worst_leaf" + tag] = shares and [k for _, k in shares]
    with _splits_gathered():
        out["gathered"] = _first_steps(cfg, opt, mesh, batches[:1], False)
    if arch in MESH_FAMILY_PREDICTED:
        torch.cuda.empty_cache()
        co.reset_counts()
        counted = dryrun.count_cell(cfg, shape, opt_cfg=opt, device="cuda",
                                    on=dryrun.MeshArgs(mesh, False,
                                                       "fsdp_tp"))
        out["step_counted"] = {"counts": dict(co.counts),
                               "nbytes": dict(co.nbytes),
                               "args": counted.args,
                               "flops": counted.counter.flops,
                               "card": counted.card}
        del counted
        torch.cuda.empty_cache()
    if arch == "deepseek-v2-236b":
        return out
    # the kernel-mode forward: the channel mix (rwkv6, every odd tile
    # made dead) and the shared MLP (zamba2) split by column under the
    # active plan, as the time mix, the mamba layers and the shared
    # attention are by head; the masks of each rank held to its block of
    # one device's
    api = get_model(cfg)
    params = api.init(torch.Generator(device="cuda").manual_seed(SEED), cfg)
    params, mor, _ = calibrate(params, cfg, api, mesh.device, 8,
                               mesh.group("world"))
    if arch == "rwkv6-3b":
        mor = {"layers": _dead_odd_tiles(mor["layers"])}
    mor = attach_plans(mor, cfg, "kernel")
    tokens = torch.randint(0, cfg.vocab_size, (8, 64), generator=torch.
                           Generator(device="cuda").manual_seed(SEED + 1),
                           device="cuda")
    ref = single_preds = None
    if lead:
        with torch.no_grad(), _MoRRecorder(ratios=True) as one:
            ref = api.forward(params, cfg, {"tokens": tokens}, mor=mor,
                              mor_mode="kernel")[0].float().cpu()
        single_preds = one.seen
    specs = steps.mesh_specs(cfg, mesh)
    loc = sr.shard_tree(params, specs, mesh)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with sr.activation_context(mesh, specs=specs), torch.no_grad(), \
            _MoRRecorder() as rec:
        co.reset_counts()
        (logits, _), launches = _counted(lambda: api.forward(
            loc, cfg, {"tokens": tokens}, mor=mor, mor_mode="kernel"))
        logits = full_logits(logits, cfg).float().cpu()
    out["forward"] = {"tokens": logits.argmax(-1), "launches": launches,
                      "collectives": dict(co.counts), "preds": rec.seen,
                      "single_preds": single_preds,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    if lead:
        out["forward"]["agreement"] = float(
            (logits.argmax(-1) == ref.argmax(-1)).float().mean())
        out["forward"]["max_abs_err"] = float((logits - ref).abs().max())
    del loc
    torch.cuda.empty_cache()
    return out


def _first_steps(cfg, opt, mesh, batches, hold, layout="fsdp_tp"):
    """One train step from the seed's weights on each batch, on ``mesh``
    (None: one device; the params in ``layout``), each step starting
    from the same params: ->
    (losses, norms, the params after each step on the CPU (``hold``;
    else None), the learning rates, each step's device ms, the last
    step's collectives and bytes by kind, the planted fault's norms
    (mesh only), peak GB)."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    runs = [_mesh_train(cfg, opt, mesh, [b], hold, layout)
            for b in batches]
    return ([r[0][0] for r in runs], [r[1][0] for r in runs],
            [r[2][0] for r in runs] if hold else None,
            [r[3][0] for r in runs], [r[4] for r in runs], runs[-1][5],
            runs[-1][6], None if mesh is None else [r[7][0] for r in runs],
            torch.cuda.max_memory_allocated() / 1e9)


def _bound_share(got, want, flips):
    """-> (the largest share of ``_close_params``' bound any leaf takes,
    that leaf), asserting nothing: the caller holds it after logging."""
    import torch
    worst, leaf = 0.0, None
    for k, w in want.items():
        tol = MESH_PARAM_RTOL * w.abs() + MESH_PARAM_ATOL * float(
            w.abs().max()) + flips
        excess = float(((got[k] - w).abs() / torch.clamp(tol, min=1e-30)
                        ).max())
        if not excess <= worst:           # a NaN too
            worst, leaf = excess, k
    return worst, leaf


def _close_params(got, want, what, flips=0.0):
    """Every leaf within one bf16 step: rtol 2^-7, atol 1e-3 x its
    largest entry, plus ``flips``: Adam's update is about lr x sign(g),
    so a gradient at bf16's noise level that takes the other sign moves
    a master copy by 2 lr a step (2 x the sum of the steps' learning
    rates; the first step is held without it).  -> the largest share of
    the bound taken."""
    worst, leaf = _bound_share(got, want, flips)
    assert worst <= 1.0, (what, leaf, worst)
    return worst


def _mesh_kernel_cases(rows):
    """The three expert-grid kernels at deepseek's widths with E_loc = 80
    experts (one rank's half of 160), C = 8 and 256, beside the E = 160
    rows of the kernel phase."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for name, _, _, _, expert_case in KERNELS:
        for C in (8, 256):
            r = expert_case(C, gen, flush, E=80)
            rows[name][f"at_experts_eloc80_c{C}"] = _fields(r)
            log("kernel", name=name, grid="experts", E_loc=80,
                note="one rank's experts of deepseek-v2-236b under model 2",
                **{k: (round(v, 5) if isinstance(v, float) else v)
                   for k, v in r.items()})
            torch.cuda.empty_cache()


def _check_mesh_prediction(ranks, predicted):
    """The dry run's fake-group prediction of the (1, 2) granite step
    (``predict_mesh_step``) against what each rank counted running it
    on the card: collectives and their bytes by kind (also the train
    runs' own last step's), FLOPs and argument bytes equal; the step's
    peak over its arguments within DRYRUN_PEAK_TOL (+ DRYRUN_PEAK_SLACK)
    of the measured, as the ``dryrun`` phase holds one card's."""
    for r, arch in ((r, a) for a in predicted for r in ranks):
        if arch == "granite-3-2b":
            c, trained, layers = r["step_counted"], r["train"]["1x2"], \
                MESH_GRANITE_LAYERS
        elif arch == CONTRACT_PREDICTED:
            c, trained, layers = r["contract"]["step_counted"], \
                r["train"]["1x2_contract"], MESH_GRANITE_LAYERS
        else:
            fam = r["families"][arch]
            c, trained, layers = fam["step_counted"], fam["tp"], \
                MESH_FAMILIES[arch]["n_layers"]
        p = predicted[arch][str(r["rank"])]
        meas = c["card"]["peak_bytes"] - c["card"]["argument_bytes"]
        assert p["counts"] == c["counts"], (arch, p["counts"], c["counts"])
        assert p["nbytes"] == c["nbytes"] == trained[6], \
            (arch, p["nbytes"], c["nbytes"], trained[6])
        assert p["flops"] == c["flops"], (arch, p["flops"], c["flops"])
        assert p["args"] == c["args"], (arch, p["args"], c["args"])
        assert abs(p["peak_temp"] - meas) <= \
            DRYRUN_PEAK_TOL * meas + DRYRUN_PEAK_SLACK, \
            (arch, p["peak_temp"], meas)
        log("mesh", path=f"{arch.split('-')[0]} train dry-run prediction"
            + (" contract_tp" if arch == CONTRACT_PREDICTED else ""),
            rank=r["rank"], mesh="1x2", layers=layers,
            collectives_equal=True, bytes_by_kind=json.dumps(p["nbytes"]),
            flops_equal=True, argument_bytes=sum(p["args"].values()),
            argument_bytes_card=c["card"]["argument_bytes"],
            predicted_step_peak_gb=round(p["peak_temp"] / 1e9, 4),
            measured_step_peak_gb=round(meas / 1e9, 4),
            step_peak_rel_err=round((p["peak_temp"] - meas) / meas, 4),
            note="predicted on meta under a fake process group of 2")


def slice_mesh(rows, predicted):
    """The (data, model) mesh (``launch.mesh.make_host_mesh`` over 2 gloo
    ranks on the one card: NCCL refuses two ranks on one device, and
    gloo stages every collective through the host, so no time here is
    the mesh's speed).  granite-3-2b at full width cut to 2 layers: the
    train step on (1, 2) and (2, 1) against the single-device step
    (loss, norm, updated params), its static decode on (1, 2)
    (``_tp_flash_decode``) at AGREE_MIN and a reduced float32 granite's
    tokens equal; deepseek-v2-236b at full width cut to 2 layers,
    calibrated: one MoE layer on two shared inputs (tile masks and
    gather_matmul's counters of each rank's 80 experts bit-equal to the
    single-device run's rows, slots and counts exact, y within one bf16
    step) and the whole forward (expert-grid launches on both ranks,
    greedy agreement); then this slice's families (``_check_families``).
    -> {path: {kernel: launches on rank 0's forward}}: deepseek's, and
    rwkv6's and zamba2's kernel-mode forwards on (1, 2)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import page_backend, run_ranks
    granite_gb, deepseek_gb, families_gb = _mesh_gb()
    log("mesh", ranks=MESH_RANKS, backend=page_backend("cuda", MESH_RANKS),
        granite_state_gb_reckoned=round(granite_gb, 2),
        deepseek_gb_reckoned=round(deepseek_gb, 2),
        families_single_state_gb_reckoned=round(families_gb, 2),
        note="two ranks share cuda:0 over gloo: every collective is "
             "staged through the host, so no time here is the mesh's "
             "speed")
    assert max(granite_gb, deepseek_gb, families_gb) < 70, \
        (granite_gb, deepseek_gb, families_gb)
    _mesh_kernel_cases(rows)
    ranks = run_ranks(_mesh_rank, MESH_RANKS, "cuda")
    _check_mesh_prediction(ranks, predicted)
    single = ranks[0]
    s_loss, s_norm, s_ms = single["single_train"]
    f_loss, f_norm = single["single_train_f32"]
    log("mesh", path="granite train", mesh="single",
        layers=MESH_GRANITE_LAYERS, losses=s_loss,
        grad_norms=s_norm, step_ms=round(s_ms, 2), f32_losses=f_loss,
        f32_grad_norms=f_norm)
    for r in ranks:
        for shape, run in r["train"].items():
            f32 = "_f32" in shape
            _check_train("mesh", r["rank"], shape, run,
                         f_loss if f32 else s_loss,
                         f_norm if f32 else s_norm, f32)
    cfg = get_config("granite-3-2b")
    want, want32 = single["single_decode"], single["single_decode_f32"]
    for r in ranks:
        toks, counts = r["decode"]
        agree = float((toks == want).float().mean())
        diff = (toks != want).nonzero()
        first = None if len(diff) == 0 else [int(v) for v in diff[0]]
        t32, c32 = r["decode_f32"]
        log("mesh", path="granite decode", rank=r["rank"], mesh="1x2",
            layers=MESH_GRANITE_LAYERS, prompts=MESH_DECODE_PROMPTS,
            steps=MESH_DECODE_STEPS, agreement_vs_single=round(agree, 4),
            first_divergence=first, agree_min=AGREE_MIN,
            decode_s=round(r["decode_s"], 2),
            collectives=json.dumps(counts),
            f32_reduced_tokens_equal=bool(torch.equal(t32, want32)))
        assert agree >= AGREE_MIN, agree
        assert counts["flash_merge"] == MESH_GRANITE_LAYERS * (
            MESH_DECODE_STEPS - 1), counts
        assert torch.equal(t32, want32), (t32, want32)
    E_loc = None
    for i, (b, s) in enumerate(MESH_MOE_SHAPES):
        y1, p1, slot1, cnt1 = single["single_moe"][i]
        for r in ranks:
            y, p, slot, cnt = r["moe"][i]
            E_loc = p["tiles"].shape[0]
            lo = r["rank"] * E_loc
            for key in ("tiles", "kept", "n_live", "n_comp"):
                assert torch.equal(p[key], p1[key][lo:lo + E_loc]), \
                    (i, r["rank"], key)
            assert torch.equal(slot, slot1) and torch.equal(cnt, cnt1)
            y, y1 = y.float(), y1.float()
            err = float((y - y1).abs().max())
            # each rank's partial is rounded to bf16 before the sum, and
            # the single device adds its k experts in bf16: one bf16 step
            # at the output's scale
            bound = MESH_PARAM_RTOL * (y1.abs() + float(y1.abs().max()))
            assert bool(((y - y1).abs() <= bound).all()), (i, err)
            log("mesh", path="deepseek moe layer", rank=r["rank"],
                tokens=b * s, experts_local=E_loc, mode="kernel",
                tile_masks_bit_equal=True, counters_bit_equal=True,
                slots_equal=True, live_tiles=int(p["n_live"].sum()),
                computed_tiles=int(p["n_comp"].sum()), y_max_abs_err=err)
    agree = single["forward_agreement"]
    for r in ranks:
        assert torch.equal(r["forward_tokens"], single["forward_tokens"])
        launches = {k: v for k, v in r["forward_launches"].items() if v}
        for k in ("mor_tile_mask", "gather_matmul", "masked_matmul_kdim"):
            assert r["forward_launches"][k] > 0, (r["rank"], launches)
        log("mesh", path="deepseek forward", rank=r["rank"], mesh="1x2",
            layers=MESH_DEEPSEEK_LAYERS, experts_local=E_loc,
            mode="kernel", launches=json.dumps(launches),
            greedy_agreement_vs_single=round(agree, 4),
            logits_max_abs_err=single["forward_max_abs_err"],
            setup_s=round(r["deepseek_setup_s"], 1),
            peak_gb=round(r["deepseek_peak_gb"], 2),
            model_all_reduce_ms=round(r["all_reduce_ms"], 3),
            all_reduce_bytes=r["all_reduce_bytes"])
        assert agree >= AGREE_MIN, agree
    _check_contract(ranks)
    _check_families(ranks)
    return {"deepseek_mesh": ranks[0]["forward_launches"],
            "granite_contract_mesh": ranks[0]["contract"]["forward"][
                "launches"],
            **{f"{arch.split('-')[0]}_mesh": ranks[0]["families"][arch][
                "forward"]["launches"] for arch in MESH_FAMILIES
               if arch != "deepseek-v2-236b"}}


def _check_contract(ranks):
    """Log and hold granite's "contract_tp" checks on (1, 2) beyond its
    held steps: every split consumed (its moves counted in the step, no
    GQA or FFN leaf gathered over ``model``), its ms and peak GB a rank
    beside the same step with the moves off, the float32 twin's greedy
    tokens equal to one device's, and the MoR-active kernel-mode forward
    (``_mesh_mor_granite``): the FFN split by column under its plan, so
    each rank launches ``mor_tile_mask``, ``gather_matmul`` (gate and
    up) and ``masked_matmul_kdim`` once a layer (1 / 2 / 1) on its own
    columns, nothing gathered over ``model``, the exchanges' counts and
    bytes as the shapes give them, its masks against its block of one
    device's (``_check_mor_masks``), ms and peak GB beside the FFN
    gathered whole, the ranks' tokens equal, agreement with one
    device's at AGREE_MIN; the float32 twin's decode under the plan
    equal to one device's, the bf16 one's at AGREE_MIN."""
    import torch
    from repro_torch.configs import get_config
    remat = get_config("granite-3-2b").remat
    single = ranks[0]["contract"]
    want_launches = {"mor_tile_mask": MESH_GRANITE_LAYERS,
                     "gather_matmul": 2 * MESH_GRANITE_LAYERS,
                     "masked_matmul_kdim": MESH_GRANITE_LAYERS}
    for r in ranks:
        c = r["contract"]
        split, off = c["split"], c["moves_off"]
        moves = split[5].get("model_move", 0)
        log("mesh", path="granite contract train splits", rank=r["rank"],
            mesh="1x2", layers=MESH_GRANITE_LAYERS,
            step_ms=round(split[4][0], 2),
            step_ms_moves_off=round(off[4][0], 2),
            peak_gb=round(split[8], 3), peak_gb_moves_off=round(off[8], 3),
            collectives=json.dumps(split[5]),
            collectives_moves_off=json.dumps(off[5]),
            bytes_by_kind=json.dumps(split[6]),
            bytes_by_kind_moves_off=json.dumps(off[6]),
            note="two gloo ranks share the card: ms follows the host's "
                 "staging of every collective")
        # 7 leaves a layer moved in the forward (again in its recompute,
        # under remat), their gradients moved back in the backward; with
        # the moves off none
        n = 7 * MESH_GRANITE_LAYERS
        assert moves == n * (1 + (remat != "none")), split[5]
        assert split[5]["model_move.grad"] == n, split[5]
        assert "model_move" not in off[5], off[5]
        toks, counts = c["decode_f32"]
        log("mesh", path="granite contract decode", rank=r["rank"],
            mesh="1x2", layers=MESH_GRANITE_LAYERS, dtype="float32",
            prompts=list(CONTRACT_DECODE), steps=CONTRACT_DECODE_STEPS,
            tokens_equal_single=bool(torch.equal(
                toks, single["single_decode_f32"])),
            collectives=json.dumps(counts))
        assert torch.equal(toks, single["single_decode_f32"]), \
            (toks, single["single_decode_f32"])
        assert counts["model_move"] > 0, counts
        fwd = c["forward"]
        launches = {k: v for k, v in fwd["launches"].items() if v}
        whole = {k: v for k, v in fwd["launches_whole"].items() if v}
        log("mesh", path="granite contract forward", rank=r["rank"],
            mesh="1x2", layers=MESH_GRANITE_LAYERS, mode="kernel",
            tokens=list(MESH_MOR_TOKENS), cap_live=MESH_MOR_CAP,
            launches=json.dumps(launches),
            launches_expected=json.dumps(want_launches),
            gathered=fwd["gathered"],
            collectives=json.dumps(fwd["collectives"]),
            bytes_by_name=json.dumps(fwd["bytes"]),
            ms=round(fwd["ms"], 2), peak_gb=round(fwd["peak_gb"], 3),
            greedy_agreement_vs_single=round(
                single["forward"]["agreement"], 4),
            logits_max_abs_err=single["forward"]["max_abs_err"])
        log("mesh", path="granite contract forward ffn whole",
            rank=r["rank"], mesh="1x2", launches=json.dumps(whole),
            gathered=fwd["gathered_whole"],
            collectives=json.dumps(fwd["collectives_whole"]),
            bytes_by_name=json.dumps(fwd["bytes_whole"]),
            ms=round(fwd["ms_whole"], 2),
            peak_gb=round(fwd["peak_gb_whole"], 3),
            note="the same forward with the FFN gathered whole on each "
                 "rank (the smoke's own switch); two gloo ranks share "
                 "the card: no ms is the mesh's speed")
        assert launches == want_launches == whole, (r["rank"], launches,
                                                    whole)
        assert fwd["gathered"] == [], fwd["gathered"]
        assert fwd["gathered_whole"] == ["mlp/w_down", "mlp/w_gate",
                                         "mlp/w_up"], fwd["gathered_whole"]
        # the exchanges, a layer: the proxy block (every rank's T x
        # min(N / 2, P) float32 slot of gloo's gathered buffer), the row
        # counts (T / 8 int32 a rank, the budget bites) and the stats
        # (two float64 sums)
        T = MESH_MOR_TOKENS[0] * MESH_MOR_TOKENS[1]
        n = get_config("granite-3-2b").d_ff // 2
        L = MESH_GRANITE_LAYERS
        want_bytes = {"mor_proxy": sum(2 * T * min(n, P) * 4
                                       for P in c["mor"]["n_proxy"]),
                      "mor_rows": L * 2 * (T // 8) * 4,
                      "mor_stats": L * 2 * 8}
        for k, v in want_bytes.items():
            assert fwd["collectives"][k] == L, (k, fwd["collectives"])
            assert fwd["bytes"][k] == v, (k, fwd["bytes"][k], v)
        assert torch.equal(fwd["tokens"], single["forward"]["tokens"])
        assert single["forward"]["agreement"] >= AGREE_MIN, \
            single["forward"]["agreement"]
        for tag in ("_f32", ""):
            toks, counts = c["mor"]["decode" + tag]
            want = single["mor"]["single_decode" + tag]
            agree = float((toks == want).float().mean())
            log("mesh", path="granite contract mor decode", rank=r["rank"],
                mesh="1x2", layers=L, dtype="float32" if tag else "bf16",
                mode="kernel", cap_live=MESH_MOR_CAP,
                agreement_vs_single=round(agree, 4),
                collectives=json.dumps(counts))
            assert counts["mor_proxy"] > 0, counts
            if tag:
                assert torch.equal(toks, want), (toks, want)
            assert agree >= AGREE_MIN, agree
    _check_mor_masks("granite contract forward", single["mor"]["single"],
                     [r["contract"]["forward"]["preds"] for r in ranks])
    _log_mor_bytes([im["n_proxy"] for im in single["mor"]["imbalance"]])
    for l, im in enumerate(single["mor"]["imbalance"]):
        log("mesh", path="granite mor imbalance", layer=l,
            n_proxy=im["n_proxy"], frac_live=im["frac_live"],
            model2_live_and_proxy_tiles=json.dumps(im["model2"]),
            model16_live_and_proxy_tiles=json.dumps(im["model16"]),
            note="the calibrated plan (no dead tiles, no budget), one "
                 "device's bf16 forward, its tiles by column block")


def _log_mor_bytes(n_proxy):
    """Log, reckoned from granite-3-2b's shapes and the calibrated plan's
    proxy counts ``n_proxy`` (a layer each; not measured), the bytes a
    rank receives a layer at model 2 and 16 in bf16: the FFN gathered
    whole (its other ranks' blocks of the three leaves), the activation
    route of the proxy block (each other rank's T x min(f / MP, P)
    float32 slot of the all-gather; T x P x 4 its floor) at T = 8 (a
    decode_32k dispatch's rows a data rank) and 2,048 (a prefill), the
    weight route (the proxy columns gathered, d x P x 2), and the T
    where the activation route passes the weight route."""
    from repro_torch.configs import get_config
    cfg = get_config("granite-3-2b")
    d, f = cfg.d_model, cfg.d_ff
    for l, P in enumerate(n_proxy):
        for mp in (2, 16):
            slot = min(f // mp, P) * 4 * (mp - 1)
            weight = d * P * 2
            log("mesh", path="granite mor bytes reckoned", layer=l,
                model=mp, n_proxy=P,
                ffn_gather_bytes=3 * d * f * 2 * (mp - 1) // mp,
                activation_bytes_t8=8 * slot,
                activation_bytes_t2048=2048 * slot,
                activation_floor_bytes_t8=8 * P * 4,
                activation_floor_bytes_t2048=2048 * P * 4,
                weight_route_bytes=weight,
                crossover_rows=round(weight / slot, 1))


def _check_mor_masks(path, single, preds):
    """Each rank's (``preds[m]``, rank m of model 2) tile masks and kept
    tiles of every layer against its column block of one device's
    (``single``), their counters summed.  A differing tile is printed
    with its proxy ratio (``_proxy_ratio``) and must lie within float32
    rounding of zero (ratio <= 1); where no tile differs, the kept tiles
    and the summed counters are one device's.  Each layer's line prints
    the counts, zeros included, and each rank's live and kept
    fractions."""
    for l, one in enumerate(single):
        n_diff = kept_diff = 0
        live, kept = [], []
        for m, rank in enumerate(preds):
            p = rank[l]
            nt = p["tiles"].shape[-1]
            cols = slice(m * nt, (m + 1) * nt)
            for i, j in (p["tiles"] != one["tiles"][:, cols]).nonzero(
                    ).tolist():
                ratio = float(one["ratio"][i, m * nt + j])
                log("mesh", path=path, layer=l, rank=m,
                    differing_tile=[i, m * nt + j], proxy_ratio=ratio)
                assert ratio <= 1.0, (path, l, m, i, j, ratio)
                n_diff += 1
            kept_diff += int((p["kept"] != one["kept"][:, cols]).sum())
            live.append(round(float(p["tiles"].float().mean()), 4))
            kept.append(round(float(p["kept"].float().mean()), 4))
        summed = tuple(sum(rank[l]["counts"][k] for rank in preds)
                       for k in (0, 1))
        log("mesh", path=path, layer=l, tiles_differing=n_diff,
            kept_differing=kept_diff, counters_summed=list(summed),
            counters_single=list(one["counts"]), frac_live_by_rank=live,
            frac_kept_by_rank=kept)
        if n_diff == 0:
            assert kept_diff == 0 and summed == one["counts"], \
                (path, l, kept_diff, summed, one["counts"])


def _check_families(ranks):
    """Log and hold this slice's families on (1, 2): each step against
    one device's (bf16 at MESH_LOSS_RTOL / MESH_NORM_RTOL, deepseek's
    float32 twin at MESH_F32_RTOL, the params of MESH_FAMILY_PREDICTED within
    one bf16 step), its ms and peak GB a rank beside the same step with
    the splits gathered, and rwkv6's / zamba2's kernel-mode forward: MoR
    launches on both ranks, the ranks' tokens equal, agreement with one
    device's at AGREE_MIN."""
    import torch
    for arch in MESH_FAMILIES:
        single = ranks[0]["families"][arch]
        name = arch.split("-")[0]
        tags = [t for t in ("", "_f32", "_contract")
                if "single" + t in single]
        for tag in tags:
            s_loss, s_norm, s_ms, s_peak = single["single" + tag]
            log("mesh", path=f"{name} train", mesh="single" + tag,
                layers=single["cut" + tag]["n_layers"],
                cut=json.dumps(single["cut" + tag]),
                note="a first step on each batch", losses=s_loss,
                grad_norms=s_norm, step_ms=[round(v, 2) for v in s_ms],
                peak_gb=round(s_peak, 3))
        for r in ranks:
            fam = r["families"][arch]
            for tag in tags:
                want_loss, want_norm = single["single" + tag][:2]
                run = fam["tp" + tag]
                _check_train("mesh", r["rank"], "1x2" + tag,
                             run[:4] + (run[4][-1],) + run[5:], want_loss,
                             want_norm, tag == "_f32", path=f"{name} train")
            if "_contract" in tags:
                assert fam["tp_contract"][5].get("model_move", 0) > 0, \
                    fam["tp_contract"][5]
            tp, gathered = fam["tp"], fam["gathered"]
            if tp[3] is not None:
                log("mesh", path=f"{name} train params", rank=r["rank"],
                    mesh="1x2", share_of_bf16_bound=[round(v, 4)
                                                     for v in tp[3]],
                    worst_leaf=fam["tp_worst_leaf"])
                assert all(v <= 1.0 for v in tp[3]), (arch, tp[3],
                                                      fam["tp_worst_leaf"])
            log("mesh", path=f"{name} train splits", rank=r["rank"],
                mesh="1x2", step_ms=round(tp[4][0], 2),
                step_ms_splits_gathered=round(gathered[4][0], 2),
                peak_gb=round(tp[7], 3),
                peak_gb_splits_gathered=round(gathered[8], 3),
                collectives=json.dumps(tp[5]),
                collectives_splits_gathered=json.dumps(gathered[5]),
                bytes_by_kind=json.dumps(tp[6]),
                bytes_by_kind_splits_gathered=json.dumps(gathered[6]),
                note="two gloo ranks share the card: ms follows the host's "
                     "staging of every collective")
            if "forward" not in fam:
                continue
            fwd = fam["forward"]
            assert torch.equal(fwd["tokens"],
                               single["forward"]["tokens"]), (arch, r["rank"])
            want = ("mor_tile_mask", "gather_matmul") + (
                ("masked_matmul_kdim",) if arch == "zamba2-7b" else ())
            for k in want:
                assert fwd["launches"][k] > 0, (arch, r["rank"],
                                                fwd["launches"])
            assert "mor_proxy" in fwd["collectives"], fwd["collectives"]
            agree = single["forward"]["agreement"]
            log("mesh", path=f"{name} forward", rank=r["rank"], mesh="1x2",
                layers=MESH_FAMILIES[arch]["n_layers"], mode="kernel",
                launches=json.dumps({k: v for k, v in
                                     fwd["launches"].items() if v}),
                collectives=json.dumps(fwd["collectives"]),
                greedy_agreement_vs_single=round(agree, 4),
                logits_max_abs_err=single["forward"]["max_abs_err"],
                peak_gb=round(fwd["peak_gb"], 3))
            assert agree >= AGREE_MIN, (arch, agree)
        if "forward" in single:
            _check_mor_masks(f"{name} forward", single["forward"][
                "single_preds"], [r["families"][arch]["forward"]["preds"]
                                  for r in ranks])


MESH4_LAYERS = 8                   # of 40: granite on (2, 2), 4 cards


def _mesh4_rank(group):
    """One rank of the 4-card mesh (NCCL, one rank a card): rank 0 runs
    granite's single-card steps first, then every rank the (2, 2)
    mesh's, held as the ``mesh`` phase holds (1, 2)'s."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import OptConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-3-2b").replace(n_layers=MESH4_LAYERS,
                                             grad_accum=1)
    opt = OptConfig(lr=1e-3, moment_dtype="bfloat16")
    batches = _device_batches(cfg, 2)
    out = {"rank": group.rank, "backend": group.backend}
    single = None
    if group.rank == 0:
        torch.cuda.reset_peak_memory_stats()
        loss, norm, single, _, ms = _mesh_train(cfg, opt, None,
                                                batches)[:5]
        out["single_train"] = (loss, norm, ms,
                               torch.cuda.max_memory_allocated() / 1e9)
    mesh = make_host_mesh(2, device=group.device)
    out["train"] = _held_train(cfg, opt, mesh, batches, single)
    return out


def slice_mesh4():
    """The (data 2, model 2) mesh over 4 cards, one rank a card on NCCL
    (run only where 4 cards are visible): granite-3-2b at full width
    cut to MESH4_LAYERS, two train steps against one card's (loss,
    norm beside its planted fault, params after each step), with the
    step's ms, peak GB and collectives a rank."""
    from repro_torch.launch.mesh import page_backend, run_ranks
    log("mesh4", ranks=4, backend=page_backend("cuda", 4),
        layers=MESH4_LAYERS)
    ranks = run_ranks(_mesh4_rank, 4, "cuda")
    s_loss, s_norm, s_ms, s_peak = ranks[0]["single_train"]
    log("mesh4", path="granite train", mesh="single", losses=s_loss,
        grad_norms=s_norm, step_ms=round(s_ms, 2), peak_gb=round(s_peak, 3))
    for r in ranks:
        assert r["backend"] == "nccl", r["backend"]
        _check_train("mesh4", r["rank"], "2x2", r["train"], s_loss, s_norm,
                     False)


TIMED_LAYERS = (("darknet19_l13", "paper-darknet19", 13, (128, 4608, 1024)),
                ("resnet18_l1", "paper-resnet18", 1, (131072, 576, 64)))
PAPER_ARCHS = ("paper-tds", "paper-cnn10", "paper-resnet18",
               "paper-darknet19")
MOR_MODES = ("exact", "tiled", "kernel")
# an entry whose proxy pre-activation or p_hat lies within MARGIN_EPS of
# 0 may take the other side on the card: cuDNN's conv and cuBLAS sum in
# another order than the CPU (float32 differences ~1e-6 at values ~1),
# and the predictor compares those values with 0
MARGIN_EPS = 1e-4
# float32 logits, card vs CPU: the same arithmetic summed in another
# order through up to 19 layers (relative differences ~1e-6 a layer)
LOGIT_RTOL, LOGIT_ATOL_REL = 1e-4, 1e-4


def _logits_close(got, want, what):
    import torch
    g, w = got.float().cpu(), want.float().cpu()
    err = float((g - w).abs().max())
    lim = LOGIT_RTOL * w.abs() + LOGIT_ATOL_REL * float(w.abs().max())
    assert bool(torch.all((g - w).abs() <= lim)), f"{what}: logits err {err}"
    return err


def _paper_setup(cfg, device, batch, n_bn=2, n_cal=2, seq=32):
    """Random init from SEED on ``device``; for a CNN, BN running stats
    from ``n_bn`` train-mode forwards; calibration on ``n_cal`` batches.
    -> (api, params, state (None for TDS), mor list, report)."""
    import torch
    from repro_torch.core.deploy import calibrate_cnn, calibrate_tds
    from repro_torch.data.pipeline import (synthetic_frames_batch,
                                           synthetic_image_batch)
    from repro_torch.models import cnn, get_model
    api = get_model(cfg)
    gen = (torch.Generator(device="cuda") if device == "cuda"
           else torch.Generator()).manual_seed(SEED)
    params = api.init(gen, cfg)
    if cfg.family == "tds":
        mor, rep = calibrate_tds(
            params, cfg, api.forward,
            (synthetic_frames_batch(cfg, batch, seq, seed=SEED, step=k)
             for k in range(n_cal)), n_cal)
        return api, params, None, mor, rep
    state = cnn.init_state(cfg, device)
    with torch.no_grad():
        for k in range(n_bn):
            im = synthetic_image_batch(cfg, batch, seed=SEED, step=100 + k)
            _, state, _ = api.forward(params, state, cfg, torch.as_tensor(
                im["images"], device=device), train=True)
    mor, rep = calibrate_cnn(
        params, state, cfg, api.forward,
        (synthetic_image_batch(cfg, batch, seed=SEED, step=k)
         for k in range(n_cal)), n_cal)
    return api, params, state, mor, rep


def _cnn_walk(params, state, cfg, images, mor, mode):
    """``cnn.forward``'s layer loop through ``cnn.conv_layer``, keeping
    each layer's input and stride -> (logits, [layer records])."""
    from repro_torch.models import cnn
    strides = cnn._strides(cfg)
    x, shortcut, out = images, None, []
    for i, lp in enumerate(params["layers"]):
        r = cnn.conv_layer(lp, state["bn"][i], cfg, x, strides[i],
                           shortcut if cfg.residual and i % 2 == 1 else None,
                           mor=None if mor is None else mor[i],
                           mor_mode=mode)
        r["x"], r["stride"] = x, strides[i]
        out.append(r)
        x = r["y"]
        if cfg.residual and i % 2 == 0:
            shortcut = x
    return x.mean((1, 2)) @ params["head"], out


def _cnn_margin(r, lp, mor_i):
    """min(|proxy ReLU input|, |p_hat|) of every (row, permuted column)
    of one conv layer: how far its predictor inputs lie from 0."""
    import torch
    from repro_torch.core.predictor import (binary_preact, estimate_preact,
                                            proxy_relu_in)
    from repro_torch.models import cnn
    perm = mor_i["perm"].long()
    C = r["pre"].shape[-1]
    xc = cnn._im2col(r["x"], lp["w"].shape[0], r["stride"])
    w = cnn._wmat(lp["w"])[:, perm]
    res = (None if r["res_in"] is None
           else r["res_in"].reshape(-1, C)[:, perm])
    prox = proxy_relu_in(xc, w, mor_i,
                         preact_full=r["pre"].reshape(-1, C)[:, perm],
                         residual=res)
    p_hat = estimate_preact(binary_preact(xc, w), mor_i, res)
    return torch.minimum(prox.abs(), p_hat.abs())


def _tds_walk(params, cfg, frames, mor, mode):
    """``tds.forward``'s block loop through ``tds.block``; under an active
    plan each record also carries the FC1 prediction on the block's own
    FC1 input (one more predictor pass: kernel mode launches
    ``mor_tile_mask`` again).  -> (logits, [block records])."""
    from repro_torch.core.executor import as_plan
    from repro_torch.models import tds
    x, out = frames, []
    for i, lp in enumerate(params["layers"]):
        r = tds.block(lp, cfg, x, mor=None if mor is None else mor[i],
                      mor_mode=mode)
        if mor is not None and mode != "dense":
            plan = as_plan(mor[i], mode=mode, tile_m=cfg.mor.tile_m,
                           tile_n=cfg.mor.tile_n,
                           capacity_frac=cfg.mor.capacity)
            w = lp["fc1"][:, plan.mor["perm"].long()]
            r["w_perm"] = w
            pre = (r["fc_in"] @ w).float() if mode == "exact" else None
            r["pred"] = plan.predict(r["fc_in"], w, preact_full=pre)
            if mode == "kernel":
                # FC1's product through the path's own call
                # (gather_matmul on the card), kept to hold against the
                # plain version
                r["fc1_pre"] = plan.masked_matmul(r["fc_in"], w, r["pred"])
        out.append(r)
        x = r["y"]
    return x @ params["head"], out


def _tds_walk_pred(r, mor_i, cfg):
    """The kernel-mode FC1 tile mask of one block record, recomputed on
    the CPU (the plain versions) from the same operands."""
    from repro_torch.core.executor import as_plan
    plan = as_plan(_to(mor_i, "cpu"), mode="kernel", tile_m=cfg.mor.tile_m,
                   tile_n=cfg.mor.tile_n, capacity_frac=cfg.mor.capacity)
    return plan.predict(r["fc_in"].cpu(), r["w_perm"].cpu()).tiles


def _tds_fc1_err(r, mor_i, cfg):
    """The kernel-mode FC1 product of one block record (``gather_matmul``
    on the card) against the plain version on the CPU, on the same
    operands and the card's tiles: max abs err within the float32
    tolerance, and the same live and computed tile counts."""
    import torch
    from repro_torch.core.executor import as_plan
    from repro_torch.kernels import ops
    plan = as_plan(_to(mor_i, "cpu"), mode="kernel", tile_m=cfg.mor.tile_m,
                   tile_n=cfg.mor.tile_n, capacity_frac=cfg.mor.capacity)
    pred = r["pred"]
    want, n_live, n_comp = ops.gather_matmul(
        r["fc_in"].cpu(), r["w_perm"].cpu(), pred.tiles.cpu(),
        capacity_frac=plan.capacity_frac, capacity_frac_live=plan.cap_live,
        tile_m=plan.tile_m, tile_n=plan.tile_n, with_counts=True)
    got_live, got_comp = pred.kernel_counts
    assert (int(got_live), int(got_comp)) == (int(n_live), int(n_comp)), \
        ((int(got_live), int(got_comp)), (int(n_live), int(n_comp)))
    err = _close(r["fc1_pre"].cpu(), want, f32=True)
    # the same operands under a 70%-live mask: dead tiles, the padded
    # last column tile among them, at the path's shape
    g = torch.Generator().manual_seed(SEED)
    tiles = torch.rand(tuple(pred.tiles.shape), generator=g) < 0.7
    got = ops.gather_matmul(r["fc_in"], r["w_perm"], tiles.cuda(),
                            tile_m=plan.tile_m, tile_n=plan.tile_n)
    want = ops.gather_matmul(r["fc_in"].cpu(), r["w_perm"].cpu(), tiles,
                             tile_m=plan.tile_m, tile_n=plan.tile_n)
    return max(err, _close(got.cpu(), want, f32=True))


def _tds_margin(r, mor_i):
    import torch
    from repro_torch.core.predictor import (binary_preact, estimate_preact,
                                            proxy_relu_in)
    prox = proxy_relu_in(r["fc_in"], r["w_perm"], mor_i)
    p_hat = estimate_preact(binary_preact(r["fc_in"], r["w_perm"]), mor_i)
    return torch.minimum(prox.abs(), p_hat.abs())


def reference_paper():
    """The four paper DNNs, reduced and float32, on the card (CUDA
    kernels, cuDNN convs) against the CPU (plain versions), from one
    seed's weights, BN stats and calibration (made on the CPU), every
    binary rookie enabled (on random weights the calibrated Pearson
    stays below T, so nothing else would be skipped), in exact, tiled
    and kernel mode: logits allclose (LOGIT_RTOL, LOGIT_ATOL_REL);
    predictor masks (CNN neuron masks, TDS tile masks) equal except at
    entries whose CPU margin is below MARGIN_EPS; the CNN launches no
    kernel in any mode and gives the same outputs in all three."""
    import torch
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core.policy import tile_mask_from_neuron_mask
    from repro_torch.data.pipeline import (synthetic_frames_batch,
                                           synthetic_image_batch)
    for arch in PAPER_ARCHS:
        cfg = reduce_config(get_config(arch))
        api, params, state, mor, rep = _paper_setup(cfg, "cpu", 4)
        for m in mor:
            m["enable"] = torch.ones_like(m["enable"])
        tds_ = cfg.family == "tds"
        if tds_:
            inp = torch.as_tensor(synthetic_frames_batch(
                cfg, 2, 32, seed=SEED + 1, step=0)["frames"])
        else:
            inp = torch.as_tensor(synthetic_image_batch(
                cfg, 4, seed=SEED + 1, step=0)["images"])
        dev = {"cpu": (params, state, mor, inp),
               "cuda": (_to(params, "cuda"), _to(state, "cuda"),
                        _to(mor, "cuda"), inp.cuda())}
        first = None
        for mode in MOR_MODES:
            runs = {}
            for d, (p, s, ml, x) in dev.items():
                (lg, recs), launches = _counted(
                    lambda: _tds_walk(p, cfg, x, ml, mode) if tds_
                    else _cnn_walk(p, s, cfg, x, ml, mode))
                fwd = (api.forward(p, cfg, {"frames": x}, mor=ml,
                                   mor_mode=mode)[0] if tds_ else
                       api.forward(p, s, cfg, x, mor=ml, mor_mode=mode)[0])
                _logits_close(fwd, lg, f"{arch} {mode} {d} walk")
                runs[d] = (lg, recs, launches)
            err = _logits_close(runs["cuda"][0], runs["cpu"][0],
                                f"{arch} {mode}")
            n_diff = n_near = 0
            for i, (rc, rg) in enumerate(zip(runs["cpu"][1],
                                             runs["cuda"][1])):
                if tds_:
                    near = tile_mask_from_neuron_mask(
                        _tds_margin(rc, mor[i]) < MARGIN_EPS, 8, 128)
                    a, b = rc["pred"].tiles, rg["pred"].tiles.cpu()
                else:
                    near = _cnn_margin(rc, params["layers"][i],
                                       mor[i]) < MARGIN_EPS
                    a, b = rc["computed"], rg["computed"].cpu()
                diff = a != b
                assert not bool((diff & ~near).any()), \
                    f"{arch} {mode} layer {i}: masks differ away from 0"
                n_diff += int(diff.sum())
                n_near += int(near.sum())
            if not tds_:
                assert runs["cuda"][2]["mor_tile_mask"] == 0 and \
                    runs["cuda"][2]["gather_matmul"] == 0, runs["cuda"][2]
                masks = [r["computed"].cpu() for r in runs["cuda"][1]]
                if first is None:
                    first = (runs["cuda"][0].cpu(), masks)
                else:
                    assert torch.equal(first[0], runs["cuda"][0].cpu())
                    assert all(torch.equal(u, v)
                               for u, v in zip(first[1], masks))
            log("reference", model=f"{arch} reduced f32", mode=mode,
                logits_max_abs_err=err, mask_entries_differing=n_diff,
                entries_within_eps=n_near, eps=MARGIN_EPS,
                launches=json.dumps({k: v for k, v in
                                     runs["cuda"][2].items() if v}))
        log("reference", model=f"{arch} reduced f32",
            pearson_mean=round(rep["pearson_mean"], 4),
            modes_equal=("n/a (TDS)" if tds_ else True))


def _breakdown_add(acc, true_preact, computed):
    from repro_torch.core.predictor import prediction_breakdown
    n = true_preact.numel()
    for k, v in prediction_breakdown(true_preact, computed).items():
        acc[k] = acc.get(k, 0.0) + float(v) * n
    acc["n"] = acc.get("n", 0) + n


def _fwd_ms(fn, reps=3):
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up
    (CUDA events around each call, no flush: a whole forward)."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def slice_paper(flush):
    """This slice's main path: the four registered paper DNNs at full
    width on the card (random init from SEED; CNN BN stats from 3
    train-mode forwards of 128 images; calibrated on 4 batches), a batch
    of 128 images (TDS: 32 x 256 frames) in dense, exact, tiled and
    kernel mode: Pearson, enabled fraction, the Fig. 12 breakdown,
    frac_computed, argmax agreement with dense and forward ms per model
    and mode.  In TDS kernel mode each block's tile mask and FC1 product
    (``gather_matmul`` at K = 144, N = 288) are held against the plain
    versions on the CPU.  Counted: the TDS kernel-mode forward (one
    mor_tile_mask and one gather_matmul per layer), then the kernel API
    on every conv layer with K % 8 == 0, on the live im2col patches and
    permuted weights of the calibrated kernel-mode forward; the kernel
    API timed at TIMED_LAYERS.  -> (launches, {case: {kernel:
    result}})."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import tile_mask_from_neuron_mask
    from repro_torch.core.predictor import binary_preact
    from repro_torch.data.pipeline import (synthetic_frames_batch,
                                           synthetic_image_batch)
    from repro_torch.kernels import binary_dot_packed as bdp
    from repro_torch.kernels import masked_matmul as mm
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    total = {}
    timed = {}
    for arch in PAPER_ARCHS:
        cfg = get_config(arch)
        tds_ = cfg.family == "tds"
        t0 = time.perf_counter()
        api, params, state, mor, rep = _paper_setup(
            cfg, "cuda", 32 if tds_ else 128, n_bn=3, n_cal=4, seq=256)
        torch.cuda.synchronize()
        if tds_:
            inp = {"frames": torch.as_tensor(synthetic_frames_batch(
                cfg, 32, 256, seed=SEED + 1, step=0)["frames"],
                device="cuda")}
            fwd = lambda mode, m=None: api.forward(params, cfg, inp, mor=m,
                                                   mor_mode=mode)[0]
        else:
            inp = torch.as_tensor(synthetic_image_batch(
                cfg, 128, seed=SEED + 1, step=0)["images"], device="cuda")
            fwd = lambda mode, m=None: api.forward(params, state, cfg, inp,
                                                   mor=m, mor_mode=mode)[0]
        log("paper", model=arch, layers=len(params["layers"]),
            widths=(f"d {cfg.d_model} d_ff {cfg.d_ff}" if tds_ else
                    f"channels {cfg.cnn_channels[1]}-"
                    f"{max(cfg.cnn_channels)}"),
            batch="32 x 256 frames" if tds_ else "128 x 32 x 32 images",
            setup_s=round(time.perf_counter() - t0, 2),
            pearson_mean=round(rep["pearson_mean"], 4),
            enabled_frac=round(rep["enabled_frac"], 4))
        with torch.no_grad():
            dense = fwd("dense")
            log("paper", model=arch, mode="dense",
                ms=round(_fwd_ms(lambda: fwd("dense")), 3),
                finite=bool(torch.isfinite(dense).all()))
            _profile_fn(f"{arch}-dense", lambda: fwd("dense"), top=5)
            assert bool(torch.isfinite(dense).all())
            for mode in MOR_MODES:
                if tds_ and mode == "kernel":
                    logits, n = _counted(lambda: fwd(mode, mor))
                    want = dict.fromkeys(n, 0)
                    want.update(mor_tile_mask=cfg.n_layers,
                                gather_matmul=cfg.n_layers)
                    assert n == want, (n, want)
                    for k, v in n.items():
                        total[k] = total.get(k, 0) + v
                else:
                    logits = fwd(mode, mor)
                assert bool(torch.isfinite(logits).all())
                agree = float((logits.argmax(-1) == dense.argmax(-1)
                               ).float().mean())
                ms = _fwd_ms(lambda: fwd(mode, mor))
                bd_acc, fracs = {}, []
                gm_err = 0.0 if tds_ and mode == "kernel" else None
                if tds_:
                    _, recs = _tds_walk(params, cfg, inp["frames"], mor,
                                        mode)
                    for i, r in enumerate(recs):
                        lp = params["layers"][i]
                        perm = mor[i]["perm"].long()
                        true = (r["fc_in"] @ r["w_perm"] + lp["fc1_b"][perm])
                        pred = r["pred"]
                        if mode == "kernel":
                            # K = 144, N = 288 (padded to 384): the
                            # kernel's tiles against the plain version's
                            cpu = _tds_walk_pred(r, mor[i], cfg)
                            near = tile_mask_from_neuron_mask(_tds_margin(
                                {k: r[k].cpu() for k in ("fc_in", "w_perm")},
                                _to(mor[i], "cpu")) < MARGIN_EPS, 8, 128)
                            diff = pred.tiles.cpu() != cpu
                            assert not bool((diff & ~near).any()), \
                                f"{arch} layer {i}: tiles differ"
                            # gather_matmul at M = 8192, K = 144, N = 288
                            # (its last column tile padded): the card's
                            # FC1 product against the plain version
                            gm_err = max(gm_err, _tds_fc1_err(r, mor[i],
                                                              cfg))
                        comp = (pred.computed if mode == "exact" else
                                pred.keep_mask(*true.shape, 8, 128))
                        _breakdown_add(bd_acc, true, comp)
                        fracs.append(float(r["stats"]["frac_computed"]))
                else:
                    _, recs = _cnn_walk(params, state, cfg, inp, mor, mode)
                    for i, r in enumerate(recs):
                        C = r["pre"].shape[-1]
                        perm = mor[i]["perm"].long()
                        _breakdown_add(bd_acc, r["relu_in"].reshape(-1, C)[
                            :, perm], r["computed"])
                        fracs.append(float(r["computed"].float().mean()))
                if mode == "kernel":
                    _profile_fn(f"{arch}-kernel", lambda: fwd(mode, mor),
                                top=5)
                n_all = bd_acc.pop("n")
                log("paper", model=arch, mode=mode, ms=round(ms, 3),
                    argmax_agreement_with_dense=round(agree, 4),
                    **({} if gm_err is None else
                       {"gather_matmul_max_abs_err": gm_err}),
                    frac_computed=np.round(fracs, 4).tolist(),
                    fig12=json.dumps({k: round(v / n_all, 4)
                                      for k, v in bd_acc.items()}))
            if tds_:
                continue
            # the kernel API on every conv layer's live operands (the
            # calibrated kernel-mode forward's im2col and permuted
            # weights, its predicted tiles), counted
            _, recs = _cnn_walk(params, state, cfg, inp, mor, "kernel")
            checked = []

            def api_calls():
                for i, r in enumerate(recs):
                    lp = params["layers"][i]
                    K = lp["w"].shape[0] * lp["w"].shape[1] * lp["w"].shape[2]
                    if K % 8:
                        continue
                    perm = mor[i]["perm"].long()
                    xc = cnn._im2col(r["x"], lp["w"].shape[0], r["stride"])
                    w = cnn._wmat(lp["w"])[:, perm].contiguous()
                    tiles = tile_mask_from_neuron_mask(r["computed"], 8, 128)
                    got = ops.binary_dot(xc, w)
                    got_p = bdp.binary_dot_packed(xc, bdp.pack_signs(w))
                    got_m, n_live = ops.masked_matmul(xc, w, tiles,
                                                      with_counts=True)
                    checked.append((i, xc, w, tiles, got, got_p, got_m,
                                    n_live))
            _, n = _counted(api_calls)
            want = dict.fromkeys(n, 0)
            want.update(binary_dot=len(checked),
                        binary_dot_packed=len(checked),
                        masked_matmul=len(checked))
            assert n == want, (n, want)
            for k, v in n.items():
                total[k] = total.get(k, 0) + v
            err = 0.0
            for i, xc, w, tiles, got, got_p, got_m, n_live in checked:
                assert torch.equal(got, binary_preact(xc, w)), \
                    f"{arch} layer {i}: binary_dot != binary_preact"
                assert torch.equal(got_p, got), \
                    f"{arch} layer {i}: binary_dot_packed != binary_dot"
                assert int(n_live) == int(tiles.sum())
                err = max(err, _close(got_m, mm.masked_matmul_plain(
                    xc, w, tiles), f32=True))
            log("paper", model=arch, kernel_api_layers=len(checked),
                binary_dot_bit_equal=True, packed_bit_equal=True,
                masked_matmul_max_abs_err=err,
                rows=[int(c[1].shape[0]) for c in checked][:4])
            # timed on the live operands: Darknet19's layer 13 (K = 9 x
            # 512, N = 1024) and ResNet18's layer 1, the largest conv
            # layer of the four (131,072 im2col rows, K = 9 x 64, N = 64)
            for case, model, layer, shape in TIMED_LAYERS:
                if arch != model:
                    continue
                i, xc, w, tiles = checked[[c[0] for c in checked]
                                          .index(layer)][:4]
                assert (*xc.shape, w.shape[1]) == shape, xc.shape
                timed[case] = binary_cases(xc.contiguous(), w, flush, tiles)
                for name, r in timed[case].items():
                    log("kernel", name=name, case=case,
                        **{k: (round(v, 5) if isinstance(v, float) else v)
                           for k, v in r.items()})
            del recs, checked
        torch.cuda.empty_cache()
    log("paper", peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9,
                                   2))
    return total, timed


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
    global timing, roofline
    from repro_torch.launch import roofline, timing
    # a float32 reference is full float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = phase_card()

    def timed(name, fn, *a):
        """Run a phase and log its seconds; each path's peak memory is
        its own."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        log("phase", name=name, seconds=round(time.perf_counter() - t, 1))
        return out

    ptxas = timed("build", phase_build)
    rows = timed("kernels", phase_kernels, ptxas)
    timed("reference granite", phase_reference)
    timed("reference deepseek", reference_deepseek)
    timed("reference zoo", reference_zoo)
    timed("reference recurrent", reference_recurrent)
    timed("reference spec", reference_spec)
    timed("reference paper", reference_paper)
    timed("reference train", reference_train)
    granite, granite_tokens, granite_static, granite_model, random_skip = \
        timed("granite", phase_slice)
    granite_obs = timed("obs", phase_obs, granite_model)
    granite_spec, spec_vanilla = timed("spec", phase_spec, granite_model)
    timed("slo", phase_slo, granite_model, spec_vanilla)
    del granite_model
    granite_train = timed("train", phase_train, random_skip)
    timed("dryrun", phase_dryrun)
    predicted = timed("dryrun_mesh", phase_dryrun_mesh)
    sharded, granite_sharded, granite_sharded_shadow = timed(
        "sharded", slice_sharded, granite_tokens)
    mesh_launches = timed("mesh", slice_mesh, rows, predicted)
    if torch.cuda.device_count() >= 4:
        timed("mesh4", slice_mesh4)
    deepseek, deepseek_static = timed("deepseek", slice_deepseek)
    mixtral = timed("mixtral", slice_mixtral)
    qwen2, qwen2_long = timed("qwen2", slice_qwen2)
    hubert = timed("hubert", slice_hubert)
    rwkv = timed("rwkv", slice_rwkv)
    zamba2 = timed("zamba2", slice_zamba2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    paper, timed_layers = timed("paper", slice_paper, flush)
    # "launches": each kernel's count on the main path that runs it:
    # the sharded path (this slice's) for the partial forms (granite
    # whole on rank 0; mla's from the reduced deepseek there), zamba2's
    # paged path for the three MoR kernels and gqa_paged_flash,
    # deepseek's for mla_paged_flash, the paper DNNs' for the kernel API
    by_path = {"zamba2_paged": zamba2, "rwkv_paged": rwkv,
               "mixtral_paged": mixtral, "qwen2_paged": qwen2,
               "hubert": hubert, "deepseek_paged": deepseek,
               "granite_paged": granite, "granite_sharded": granite_sharded,
               "granite_sharded_shadow": granite_sharded_shadow,
               **mesh_launches,
               "granite_obs_shadow": granite_obs,
               "granite_spec": granite_spec,
               "granite_static": granite_static,
               "granite_train_serve": granite_train,
               "deepseek_static": deepseek_static,
               "qwen2_long_prefill": qwen2_long, "paper_dnns": paper}
    for name, row in rows.items():
        if name in sharded:
            # the partial forms: the sharded path's counts, rank 0
            row["launches"] = sharded[name]
            continue
        if name in API_KERNELS:
            row["launches"] = paper[name]
            for case, r in timed_layers.items():
                row[f"at_{case}"] = _fields(r[name])
        else:
            row["launches"] = (deepseek if name == "mla_paged_flash"
                               else zamba2)[name]
        row["launches_by_path"] = {k: v[name] for k, v in by_path.items()}
    log("done", seconds=round(time.perf_counter() - t0, 1))
    print(smi, flush=True)                # every number above is this card's
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
