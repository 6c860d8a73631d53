"""Checkpoint manager (``repro.checkpoint.manager``): atomic commit,
keep-last-k, an async background writer and auto-resume.

  * a step directory becomes visible only after its COMMIT file exists:
    the writer fills ``step_XXXXXXXX.writing`` and renames it, so a
    crash mid-save never corrupts the restore point;
  * ``latest_step`` scans for the newest committed step, so a job
    restarted after a kill resumes from the last durable state;
  * ``restore`` takes a *template* tree (the freshly initialised state)
    and gives each leaf its template leaf's shape check, dtype and
    device;
  * on a mesh (``shardings``: the state's spec tree, and the ``mesh``)
    ``save`` gathers every leaf whole (``sharding_rules.gather_leaf``)
    and rank 0 writes the reference's mesh-agnostic payload, and
    ``restore`` hands every rank its block under the specs of the mesh
    it runs on now: a checkpoint saved on one mesh restores on another,
    or in one process.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

from repro_torch.checkpoint.serialization import load_pytree, save_pytree
from repro_torch.tree import tree_map


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    # ---------- write path ----------
    def save(self, step: int, state: Any, extra: Dict | None = None,
             block: bool = False, shardings: Any = None,
             mesh=None) -> None:
        """The snapshot is taken synchronously (a host copy of every
        leaf, so that training may go on updating the tensors in place);
        the disk write happens on the background thread.  With
        ``shardings`` (``state``'s spec tree on ``mesh``) every rank
        joins the gathers, rank 0 alone writes, at once, and every rank
        returns once the step is committed."""
        self.wait()                       # one in-flight save at a time
        if shardings is not None and getattr(mesh, "groups", None):
            from repro_torch.distributed import sharding_rules as sr
            host_state = tree_map(
                lambda x, s: sr.gather_leaf(x.detach(), s, mesh).to(
                    "cpu", copy=True), state, shardings)
            if mesh.rank == 0:
                self.save(step, host_state, extra, block=True)
            import torch.distributed as dist
            dist.barrier(group=mesh.group("world").pg)
            return
        host_state = tree_map(lambda x: x.detach().to("cpu", copy=True),
                              state)

        def _write():
            d = self._step_dir(step)
            tmp = d + ".writing"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            save_pytree(host_state, os.path.join(tmp, "state"),
                        {"step": step, **(extra or {})})
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write(str(step))
            if os.path.exists(d):          # re-save of the same step
                shutil.rmtree(d)
            os.replace(tmp, d)
            self._gc()

        def _write_caught():
            try:
                _write()
            except Exception as e:        # re-raised by wait()
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write_caught,
                                            daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        """Join the in-flight save; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------- read path ----------
    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "COMMIT")):
                steps.append(int(m.group(1)))
        return max(steps) if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None, mesh=None) -> Tuple[Any, Dict]:
        """Load into ``template``'s structure -> (state, extra).  With
        ``shardings`` (the spec tree of ``template`` on ``mesh``, the
        mesh this job runs on) each rank takes its block of every leaf:
        the elastic re-placement; ``template`` holds the blocks."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        place = None
        if shardings is not None and getattr(mesh, "groups", None):
            from repro_torch.distributed import sharding_rules as sr
            spec_of = sr.spec_paths(shardings)

            def place(key, full):
                return sr.shard_leaf(full, spec_of[key], mesh)
        return load_pytree(template,
                           os.path.join(self._step_dir(step), "state"),
                           place=place)

    # ---------- internals ----------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.dir))
            if m)
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
