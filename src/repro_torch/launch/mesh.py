"""The meshes (``repro.launch.mesh``): the ``("data", "model")`` host
mesh of training and tensor-parallel serving (``make_host_mesh``), the
production mesh's shape (``make_production_mesh``), the page group of
the ``paged-sharded`` serving layout (``make_page_mesh``'s counterpart:
a mesh over the page axis, ``distributed.PAGE_AXIS``), and the launcher
of their rank processes (``run_ranks``).

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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass
class PageGroup:
    """One rank's place in a group of ranks (the page group, or one axis
    of a host mesh): its index in the group, the group's size, the
    process group its collectives run on (None for a group of one), its
    device and the backend."""
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


@dataclass
class MeshShape:
    """A mesh as a shape only: its axis names and sizes, no processes
    (``make_production_mesh``; ``ElasticPlan`` and the sharding rules
    read no more)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        return n


@dataclass
class HostMesh(MeshShape):
    """This rank's place on a ``("data", "model")`` mesh of processes:
    its world rank, its coordinates, and the process groups of its row
    (``groups["model"]``: the ranks of its data index), of its column
    (``groups["data"]``) and of every rank (``groups["world"]``)."""
    rank: int = 0
    coords: Dict[str, int] = None
    groups: Dict[str, PageGroup] = None
    device: torch.device = None
    backend: str = "gloo"

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str) -> PageGroup:
        return self.groups[axis]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips multi-pod: the
    shape and names only.  The port runs no such mesh (ROADMAP queue A
    7: ``--mesh pod`` needs 256 ranks)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"),
                         {"pod": 2, "data": 16, "model": 16})
    return MeshShape(("data", "model"), {"data": 16, "model": 16})


def make_host_mesh(model_parallel: int = 1, device=None) -> HostMesh:
    """The ``(data, model)`` mesh over this job's ranks: every rank of
    ``torch.distributed``'s world (one process and no groups when it is
    not initialised), ``model_parallel`` ranks a row.  Ranks are laid
    out as ``jax.make_mesh`` lays out devices, row-major: rank = data
    index x model_parallel + model index.  Every rank must call it, in
    the same order as any other group it makes: it makes one process
    group a row and one a column (a group of one rank has none)."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks do not divide into rows of "
                         f"model_parallel={model_parallel}")
    dp, mp = world // model_parallel, model_parallel
    backend = dist.get_backend() if init else "gloo"
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() and backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    di, mi = divmod(rank, mp)
    groups: Dict[str, PageGroup] = {}
    rows = [[i * mp + j for j in range(mp)] for i in range(dp)]
    cols = [[i * mp + j for i in range(dp)] for j in range(mp)]
    for axis, sets, mine, idx in (("model", rows, di, mi),
                                  ("data", cols, mi, di)):
        n = len(sets[0])
        pg = None
        for k, group_ranks in enumerate(sets):
            g = dist.new_group(group_ranks) if n > 1 else None
            if k == mine:
                pg = g
        groups[axis] = PageGroup(idx, n, pg, device, backend)
    groups["world"] = PageGroup(rank, world,
                                dist.group.WORLD if init else None,
                                device, backend)
    return HostMesh(("data", "model"), {"data": dp, "model": mp},
                    rank=rank, coords={"data": di, "model": mi},
                    groups=groups, device=device, backend=backend)


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
