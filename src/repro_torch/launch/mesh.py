"""The page group of the ``paged-sharded`` serving layout
(``repro.launch.mesh`` ``make_page_mesh``: a mesh over the page axis,
``distributed.PAGE_AXIS``) and the launcher of its rank processes.

JAX runs the layout as one program over a 1-D device mesh.  The port
runs one process per page shard under ``torch.distributed``: each rank
makes the same weights, holds one shard of every page pool, and merges
the attention statistics with one collective per layer.  The backend is
stated, not guessed: NCCL only where each rank has a card of its own,
gloo on the CPU and where ranks share a card (NCCL refuses two ranks on
one device; gloo stages CUDA tensors through the host).  The rendezvous
is a ``file://`` in the run's temporary directory, so no port is chosen
and no network is used.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


@dataclass
class PageGroup:
    """One rank of the page group: its rank, the world size, the process
    group its collectives run on, its device and the backend."""
    rank: int
    size: int
    pg: Any
    device: torch.device
    backend: str


def page_backend(device, n_shards: int) -> str:
    """gloo on the CPU and where the ranks would share a card, NCCL where
    each rank has its own."""
    device = torch.device(device)
    if device.type == "cpu" or torch.cuda.device_count() < n_shards:
        return "gloo"
    return "nccl"


def make_page_group(n_shards: int, rank: int, init_file: str,
                    device="cuda") -> PageGroup:
    """Join the page group as ``rank`` of ``n_shards`` through the
    rendezvous file ``init_file`` (every rank passes the same path)."""
    device = torch.device(device)
    backend = page_backend(device, n_shards)
    if device.type == "cuda":
        if backend == "nccl":
            device = torch.device("cuda", rank)
        elif device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            world_size=n_shards, rank=rank)
    return PageGroup(rank, n_shards, dist.group.WORLD, device, backend)


def _rank_main(rank: int, fn: Callable, n_shards: int, device: str,
               workdir: str, args: tuple) -> None:
    # the ranks share the host's cores: one thread each on the CPU (the
    # reduced models' steps are too small to spread), a share otherwise
    torch.set_num_threads(1 if torch.device(device).type == "cpu" else
                          max(1, (os.cpu_count() or 1) // n_shards))
    group = make_page_group(n_shards, rank,
                            os.path.join(workdir, "rendezvous"), device)
    try:
        out = fn(group, *args)
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, n_shards: int, device, *args,
              workdir: Optional[str] = None) -> List[Any]:
    """Run ``fn(group, *args)`` on ``n_shards`` rank processes (start
    method "spawn"; ``fn`` and ``args`` must pickle) and return each
    rank's result, in rank order.  A rank that raises, or dies, fails
    the call and the others are stopped; no rank is dropped.  The
    rendezvous and the results go through ``workdir`` (a new temporary
    directory by default, removed at the end)."""
    import torch.multiprocessing as mp
    if workdir is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_ranks(fn, n_shards, device, *args, workdir=tmp)
    mp.start_processes(_rank_main, args=(fn, n_shards, str(device),
                                         str(workdir), args),
                       nprocs=n_shards, join=True, start_method="spawn")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n_shards)]
