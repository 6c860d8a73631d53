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
``--steps + 1``, which ``launch.serve --ckpt-dir`` serves.

``--mesh host --model-parallel N`` trains on the ``(data, model)`` host
mesh (``launch.mesh.make_host_mesh``): one rank a visible card (NCCL),
or, with ``--device cpu`` or where the ranks share a card, ``--ranks
R`` gloo ranks (JAX takes the count from its devices); R / N data ranks
of N model ranks each.  Every rank draws the same initial weights and
the same global batches and keeps its blocks of the params and the
optimizer state (``launch.steps.mesh_specs``); rank 0 prints, writes
``--out-json`` and the checkpoints (gathered whole: a checkpoint saved
on one mesh resumes on another).  ``--mesh pod`` trains on the
production mesh, 16 x 16 (``launch.mesh.make_production_mesh``), and
``--mesh multipod`` on 2 pods of it: ``--model-parallel`` is 16 and the
run needs 256 (512) ranks, and raises ``ValueError`` naming that count
on fewer.  As the reference's, the CLI trains without sequence
parallelism.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --reduced --ranks 4 --model-parallel 2 --steps 20
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
from repro_torch.optim import OptConfig, adamw_init

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
    ap.add_argument("--mesh", default="host",
                    choices=("host", "pod", "multipod"))
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=0,
                    help="gloo rank processes of the host mesh on the CPU "
                         "or on a shared card (default: one rank a "
                         "visible card; JAX takes this from its device "
                         "count)")
    ap.add_argument("--calibrate", action="store_true",
                    help="run MoR calibration after training")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible "
                         "(pass --device cpu to train on the CPU)")
    ranks = args.ranks or (torch.cuda.device_count()
                           if device.type == "cuda" else 1)
    args.pods = 1
    if args.mesh != "host":
        from repro_torch.launch.mesh import make_production_mesh
        shape = make_production_mesh(multi_pod=args.mesh == "multipod")
        if ranks != shape.size:
            raise ValueError(
                f"--mesh {args.mesh} runs on {shape.size} ranks "
                f"({shape.shape}); this run has {ranks}")
        args.model_parallel = shape.shape["model"]
        args.pods = shape.shape.get("pod", 1)
    if ranks % args.model_parallel:
        raise ValueError(f"--ranks {ranks} is not a multiple of "
                         f"--model-parallel {args.model_parallel}")
    if ranks == 1:
        return _train(args, device, None)
    from repro_torch.launch.mesh import run_ranks
    return run_ranks(_train_rank, ranks, device, args)[0]


def _train_rank(group, args):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(args.model_parallel, device=group.device,
                          pods=args.pods)
    return _train(args, group.device, mesh)


def _train(args, device, mesh):
    """The training loop on one process (``mesh`` None) or on this
    rank of ``mesh``; -> the report (rank 0's prints)."""
    from repro_torch.distributed import sharding_rules as sr
    from repro_torch.launch.steps import mesh_specs, opt_specs
    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    cfg = cfg.replace(grad_accum=1)
    opt_cfg = OptConfig(lr=args.lr, moment_dtype="float32"
                        if cfg.dtype == "float32" else "bfloat16")

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    gen = torch.Generator(device=device).manual_seed(args.seed)
    specs = state_specs = None
    if mesh is None:
        params, opt_state = init_train_state(gen, cfg, opt_cfg)
    else:
        # every rank draws the whole init and keeps its blocks
        specs = mesh_specs(cfg, mesh)
        params = sr.shard_tree(get_model(cfg).init(gen, cfg), specs, mesh)
        opt_state = adamw_init(params, opt_cfg)
        state_specs = {"params": specs, "opt": opt_specs(opt_state, specs)}
    save_kw = {} if mesh is None else {"shardings": state_specs,
                                       "mesh": mesh}
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        state, extra = mgr.restore({"params": params, "opt": opt_state},
                                   **save_kw)
        params, opt_state = state["params"], state["opt"]
        start_step = extra["step"]
        say(f"[train] resumed from step {start_step}")

    train_step = make_train_step(cfg, opt_cfg, total_steps=args.steps,
                                 mesh=mesh)
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
                say(f"[train] step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if mgr and (step + 1) % args.save_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         **save_kw)
    finally:
        data.close()
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state},
                 block=True, **save_kw)
        mgr.wait()

    report = {
        "arch": cfg.name, "steps": args.steps, "device": str(device),
        "mesh": None if mesh is None else dict(mesh.shape),
        "losses": losses,
        "loss_first": losses[0] if losses else None,
        "loss_last": float(np.mean(losses[-10:])) if losses else None,
        "wall_s": round(time.time() - t_start, 1),
    }

    if args.calibrate:
        if mesh is not None:
            raise NotImplementedError(
                "--calibrate on a mesh: calibrate the checkpoint in one "
                "process (launch.serve --ckpt-dir)")
        params2, _, cal = calibrate(params, cfg, args.batch, args.seq,
                                    args.seed, device)
        report["calibration"] = cal
        if mgr:
            mgr.save(args.steps + 1,
                     {"params": params2, "opt": opt_state}, block=True)
        print("[train] calibration:", cal)

    say("[train] done:", {k: v for k, v in report.items()
                          if k != "losses"})
    if args.out_json and lead:
        with open(args.out_json, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
