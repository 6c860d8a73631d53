"""Training CLI (``repro.launch.train``): a loop with auto-resume,
async checkpoints, straggler monitoring, deterministic data and an
optional MoR calibration of the trained weights.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch granite-3-2b --reduced --steps 200 --batch 16 --seq 64 \
      --ckpt-dir /tmp/ckpt --calibrate
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --reduced --ckpt-dir /tmp/ckpt --mor kernel --compare

The batch of step s is ``make_batch(cfg, --batch, --seq, seed=--seed,
step=s)`` (drawn ahead by ``make_train_iterator``), so a run resumed
from ``--ckpt-dir`` at the step its checkpoint records sees the batches
a straight run would.  As in the reference, the CLI trains with
``grad_accum=1`` whatever the config says: ``make_train_step`` with a
config's own ``grad_accum`` is the library path.  ``--calibrate`` runs
``calibrate_lm`` on batches from step 10,000 on and, with
``--ckpt-dir``, saves the calibrated (permuted) params as step
``--steps + 1``, which ``launch.serve --ckpt-dir`` serves.  The port has
one layout, the host's (``--mesh host --model-parallel 1``); sharded
training is ROADMAP queue A 7.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import make_batch, make_train_iterator
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models import get_model
from repro_torch.optim import OptConfig

CALIB_START = 10_000                 # the calibration batches' first step


def _on(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def calibrate(params, cfg, batch: int, seq: int, seed: int, device):
    """The CLI's ``--calibrate``: ``calibrate_lm`` over
    ``cfg.mor.calib_batches`` batches of the training stream from step
    ``CALIB_START`` on -> (params with permuted FFN weights, mor,
    report)."""
    from repro_torch.core.deploy import calibrate_lm

    def batches():
        s = CALIB_START
        while True:
            yield _on(make_batch(cfg, batch, seq, seed=seed, step=s), device)
            s += 1

    return calibrate_lm(params, cfg, get_model(cfg).forward, batches(),
                        cfg.mor.calib_batches)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="host", choices=("host", "pod"))
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--calibrate", action="store_true",
                    help="run MoR calibration after training")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args(argv)

    if args.mesh != "host" or args.model_parallel != 1:
        raise NotImplementedError(
            "sharded training (--mesh pod, --model-parallel > 1) is "
            "ROADMAP queue A 7 of the port: train with --mesh host "
            "--model-parallel 1")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to train on the CPU)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cfg.replace(grad_accum=1)
    opt_cfg = OptConfig(lr=args.lr, moment_dtype="float32"
                        if cfg.dtype == "float32" else "bfloat16")

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, opt_state = init_train_state(gen, cfg, opt_cfg)
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state, extra = mgr.restore({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start_step = extra["step"]
        print(f"[train] resumed from step {start_step}")

    train_step = make_train_step(cfg, opt_cfg, total_steps=args.steps)
    monitor = StragglerMonitor(n_hosts=1)
    losses = []
    t_start = time.time()
    data = make_train_iterator(cfg, args.batch, args.seq, seed=args.seed,
                               start_step=start_step)
    try:
        for step in range(start_step, args.steps):
            batch = _on(next(data), device)
            t0 = time.time()
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])          # waits for the step
            dt = time.time() - t0
            monitor.record_step({0: dt})
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if mgr and (step + 1) % args.save_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state})
    finally:
        data.close()
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state},
                 block=True)
        mgr.wait()

    report = {
        "arch": cfg.name, "steps": args.steps, "device": str(device),
        "loss_first": losses[0] if losses else None,
        "loss_last": float(np.mean(losses[-10:])) if losses else None,
        "wall_s": round(time.time() - t_start, 1),
    }

    if args.calibrate:
        params2, _, cal = calibrate(params, cfg, args.batch, args.seq,
                                    args.seed, device)
        report["calibration"] = cal
        if mgr:
            mgr.save(args.steps + 1,
                     {"params": params2, "opt": opt_state}, block=True)
        print("[train] calibration:", cal)

    print("[train] done:", report)
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
