"""The meshes (``repro.launch.mesh``): the ``("data", "model")`` host
mesh of training and tensor-parallel serving, with a ``"pod"`` axis
outside them on the multi-pod layout (``make_host_mesh``), the
production mesh's shape (``make_production_mesh``) and its ranks on a
fake process group for the dry run (``dry_mesh``), the page group of
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

Every group knows its world ranks, so that the collectives can tell the
bytes that cross a node (``NODE_CARDS`` cards on NVLink a node, nodes
joined by InfiniBand: ``PageGroup.spans_nodes``) from those that stay
inside one, as the reference tells a pod's ICI from the DCI between
pods.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# cards a node: an HGX / DGX H100 node joins 8 cards by NVLink (NVSwitch);
# its nodes are joined by InfiniBand
NODE_CARDS = 8


@dataclass
class PageGroup:
    """One rank's place in a group of ranks (the page group, or one axis
    of a host mesh): its index in the group, the group's size, the
    process group its collectives run on (None for a group of one), its
    device, the backend, and its members' world ranks in group order."""
    rank: int
    size: int
    pg: Any
    device: torch.device
    backend: str
    ranks: Tuple[int, ...] = ()

    @property
    def spans_nodes(self) -> bool:
        """Whether the group's ranks lie on more than one node of
        ``NODE_CARDS`` cards (world rank // NODE_CARDS)."""
        return len({r // NODE_CARDS for r in self.ranks}) > 1


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
    return PageGroup(rank, n_shards, dist.group.WORLD, device, backend,
                     tuple(range(n_shards)))


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
    """This rank's place on a ``("data", "model")`` (or ``("pod",
    "data", "model")``) mesh of processes: its world rank, its
    coordinates, and the process groups of its row (``groups["model"]``:
    the ranks of its data index), of its column (``groups["data"]``), of
    its pod column (``groups["pod"]``), of every data-parallel rank of
    its model index (``groups[("pod", "data")]``: the tuple axis, pod
    outer) and of every rank (``groups["world"]``)."""
    rank: int = 0
    coords: Dict[str, int] = None
    groups: Dict[Any, PageGroup] = None
    device: torch.device = None
    backend: str = "gloo"

    def index(self, axis) -> int:
        """The rank's coordinate on ``axis``, or on a tuple of axes its
        index in their row-major product (the first axis outer)."""
        if isinstance(axis, str):
            return self.coords[axis]
        idx = 0
        for a in axis:
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group(self, axis) -> PageGroup:
        """The group of ``axis``: a name, or a tuple of names (one name
        in a tuple is that axis)."""
        if not isinstance(axis, str) and len(axis) == 1:
            axis = axis[0]
        return self.groups[axis if isinstance(axis, str) else tuple(axis)]


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16 x 16 = 256 chips a pod; 2 pods = 512 chips multi-pod: the
    shape and names (``dry_mesh`` joins its ranks on a fake process
    group; ``make_host_mesh(16, pods=)`` on a world of as many ranks)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"),
                         {"pod": 2, "data": 16, "model": 16})
    return MeshShape(("data", "model"), {"data": 16, "model": 16})


def make_host_mesh(model_parallel: int = 1, device=None, pods: int = 1,
                   backend: Optional[str] = None) -> HostMesh:
    """The ``(data, model)`` mesh over this job's ranks (``("pod",
    "data", "model")`` where ``pods`` > 1): every rank of
    ``torch.distributed``'s world (one process and no groups when it is
    not initialised), ``model_parallel`` ranks a row, ``pods`` pods.
    Ranks are laid out as ``jax.make_mesh`` lays out devices, row-major,
    the pod outer: rank = (pod x data + data index) x model_parallel +
    model index.  Every rank must call it, in the same order as any
    other group it makes: it makes one process group a row, a column, a
    pod column and a data-parallel tuple (a group of one rank has none).
    ``backend`` states the collectives' backend where the world's
    differs from it (``dry_mesh``'s fake group models NCCL or gloo)."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    rank = dist.get_rank() if init else 0
    if model_parallel < 1 or pods < 1 or world % (model_parallel * pods):
        raise ValueError(f"{world} ranks do not divide into {pods} pod(s) "
                         f"of rows of model_parallel={model_parallel}")
    pp, mp = pods, model_parallel
    dp = world // (mp * pp)
    backend = backend or (dist.get_backend() if init else "gloo")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() and backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    names = ("pod", "data", "model") if pp > 1 else ("data", "model")
    shape = {"pod": pp, "data": dp, "model": mp}
    pi, rest = divmod(rank, dp * mp)
    di, mi = divmod(rest, mp)
    coords = {"pod": pi, "data": di, "model": mi}

    def at(c):
        return (c["pod"] * dp + c["data"]) * mp + c["model"]

    groups: Dict[Any, PageGroup] = {}
    # one group each over the axes ``vary``, one per value of the others
    for key, vary in (("model", ("model",)), ("data", ("data",)),
                      ("pod", ("pod",)), (("pod", "data"), ("pod", "data"))):
        if "pod" in vary and pp == 1:
            continue
        fixed = [a for a in ("pod", "data", "model") if a not in vary]
        n = 1
        for a in vary:
            n *= shape[a]
        mine = None
        for fix in _product([shape[a] for a in fixed]):
            members = []
            for var in _product([shape[a] for a in vary]):
                c = dict(zip(fixed, fix))
                c.update(zip(vary, var))
                members.append(at(c))
            pg = dist.new_group(members) if n > 1 else None
            if all(coords[a] == v for a, v in zip(fixed, fix)):
                mine = PageGroup(members.index(rank), n, pg, device,
                                 backend, tuple(members))
        groups[key] = mine
    if pp == 1:
        # one pod: the data-parallel tuple is the data axis
        groups[("pod", "data")] = groups["data"]
    groups["world"] = PageGroup(rank, world,
                                dist.group.WORLD if init else None,
                                device, backend, tuple(range(world)))
    return HostMesh(names, {a: shape[a] for a in names}, rank=rank,
                    coords={a: coords[a] for a in names}, groups=groups,
                    device=device, backend=backend)


def _product(sizes):
    """Every index tuple of a grid of ``sizes``, row-major."""
    out = [()]
    for n in sizes:
        out = [t + (i,) for t in out for i in range(n)]
    return out


@contextlib.contextmanager
def dry_mesh(shape: Dict[str, int], rank: int = 0, backend: str = "nccl"):
    """This process as rank ``rank`` of a mesh of ``shape`` ({"data",
    "model"} and optionally "pod", e.g. ``make_production_mesh()
    .shape``) on torch's fake process group: the same groups as
    ``make_host_mesh`` builds, on the meta device, whose collectives
    return at once and move nothing, so that one process can run one
    rank's step on meta tensors under the real collective calls (the
    dry run: ``launch.dryrun``; never a serving or training path).
    ``backend`` is the one the collectives model: "nccl" (a cluster of
    one rank a card) or "gloo" (the ranks of ``run_ranks``).  The
    process group is destroyed on exit.  Needs a process of its own
    (no other process group may be live)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = 1
    for v in shape.values():
        world *= v
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield make_host_mesh(shape["model"], device="meta",
                             pods=shape.get("pod", 1), backend=backend)
    finally:
        dist.destroy_process_group()


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
