"""The (arch x shape x mesh) dry-run grid (``repro.launch.dryrun_all``):
every cell of ``ARCHS`` x ``SHAPE_NAMES`` x the ``--mesh`` kinds (one
H100 by default; "pod" / "multipod": rank 0 of the production mesh on
torch's fake process group, which ``run_cell`` joins and leaves a
cell) through ``dryrun.run_cell`` on the meta device, in this process
(a failed cell is caught and recorded by ``run_cell``, so the sweep
goes on).

Writes experiments/dryrun/torch/<arch>_<shape>_<mesh>.json; a cell with
an existing OK or skip record is skipped unless ``--force``, so the sweep
is resumable.

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun_all
           [--archs a,b,...] [--shapes s,...] [--mesh 1xh100,pod,...]
           [--force]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch.launch import dryrun

ARCHS = ["qwen1.5-110b", "granite-20b", "granite-3-2b", "qwen2-7b",
         "deepseek-v2-236b", "mixtral-8x7b", "rwkv6-3b",
         "phi-3-vision-4.2b", "zamba2-7b", "hubert-xlarge"]
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
OUT_DIR = os.path.join("experiments", "dryrun", "torch")


def cell_path(arch: str, shape: str, out_dir: str = OUT_DIR,
              mesh: str = dryrun.MESH) -> str:
    return os.path.join(out_dir, f"{arch}_{shape}_{mesh}.json")


def is_done(path: str, force: bool) -> bool:
    if force or not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            rec = json.load(f)
        return rec.get("status", "").startswith(("ok", "skip"))
    except (OSError, ValueError):
        return False


def sweep(archs=None, shapes=None, force: bool = False,
          out_dir: str = OUT_DIR, log=print, meshes=None) -> dict:
    """Run (or take from ``out_dir``) every cell -> {(arch, shape):
    record} (keys {(arch, shape, mesh): record} where ``meshes`` names
    more than one mesh kind); one ``log`` line a cell."""
    archs = archs or ARCHS
    shapes = shapes or SHAPE_NAMES
    meshes = meshes or [dryrun.MESH]
    cells = [(a, s, m) for m in meshes for a in archs for s in shapes]
    out = {}
    t_start = time.time()
    for i, (a, s, m) in enumerate(cells):
        path = cell_path(a, s, out_dir, m)
        t0 = time.time()
        if is_done(path, force):
            with open(path) as f:
                rec = json.load(f)
            tag = "cached"
        else:
            rec = dryrun.run_cell(a, s, m, out_path=path)
            tag = rec["status"].split(":")[0]
        out[(a, s, m) if len(meshes) > 1 else (a, s)] = rec
        log(f"[{i + 1}/{len(cells)}] {a} {s} {m}: {tag} "
            f"({time.time() - t0:.1f}s) {summary(rec)}")
    n = {k: sum(r["status"].startswith(k) for r in out.values())
         for k in ("ok", "skip", "error")}
    log(f"done in {(time.time() - t_start) / 60:.1f} min: {n['ok']} ok, "
        f"{n['skip']} skipped, {n['error']} failed")
    return out


def summary(rec: dict) -> str:
    """One line of a cell's record: status, per-device GB, fits_80gb,
    the eager op stream's dominant term and roofline fraction, the
    floor's dominant term and time."""
    if not rec["status"].startswith("ok"):
        return rec["status"][:160]
    rl = rec["roofline"]
    coll = ""
    if "t_collective_ib_s" in rl:
        coll = (f"collective_ms={rl['t_collective_s'] * 1e3:.3f} "
                f"ib_ms={rl['t_collective_ib_s'] * 1e3:.3f} ")
    return (f"per_device_gb={rec['per_device_bytes'] / 1e9:.2f} "
            f"fits_80gb={rec['fits_80gb']} dominant={rl['dominant']} "
            f"{coll}"
            f"roofline_fraction={rl['roofline_fraction']:.4f} "
            f"floor={rl['floor_dominant']} "
            f"floor_ms={rl['floor_time_s'] * 1e3:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default=None)
    ap.add_argument("--shapes", default=None)
    ap.add_argument("--mesh", default=dryrun.MESH,
                    help="comma-separated mesh kinds: "
                         + ", ".join(dryrun.MESH_KINDS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out-dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    sweep(args.archs.split(",") if args.archs else None,
          args.shapes.split(",") if args.shapes else None, args.force,
          args.out_dir, meshes=args.mesh.split(","))


if __name__ == "__main__":
    main()
