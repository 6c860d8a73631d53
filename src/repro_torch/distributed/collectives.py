"""The page shards' flash merge (``repro.distributed.collectives``
``flash_merge``): ONE collective per attention layer.

Each rank holds partial flash statistics over its locally resident kv
pages: running max ``m`` (...), denominator ``l`` (...) and the
unnormalised accumulator ``acc`` (..., Dv), all float32.  The ranks
exchange them packed into one (..., Dv + 2) float32 buffer, by one
``all_reduce(SUM)`` of a (world, ..., Dv + 2) zero buffer in which rank r
fills slot r, summed as bytes: adding zeros is exact, so every rank
receives every rank's statistics bit for bit, on gloo (CPU or CUDA
tensors) and NCCL alike, and then combines them locally in rank order
(``merge_stacked``):

    m* = max_i m_i;  w_i = exp(m_i - m*);
    o = sum_i w_i acc_i / max(sum_i w_i l_i, 1e-30)

A rank with no resident page for a row (m_i = -1e30, l_i = 0) weighs
nothing against a real score.  ``counts`` tallies the collectives this
module and ``decode_attention`` issue, by name, so that a run can show
exactly one merge per attention layer per dispatch; ``nbytes`` their
buffers' bytes by kind ("all-reduce", "all-gather", "reduce-scatter",
"all-to-all", "collective-permute"), which
``launch.roofline.collective_wire_bytes`` turns into wire bytes;
``ib_nbytes`` the part of them that crossed a node, by kind: the bytes
of a collective whose group's ranks lie on more than one node
(``launch.mesh.PageGroup.spans_nodes``: 8 cards a node on NVLink, the
nodes on InfiniBand), the port's counterpart of the reference's DCI
share (``repro.launch.roofline._replica_group_size``).

The mesh's collectives (``launch.mesh.HostMesh``; a ``PageGroup`` an
axis) follow the group's stated backend, never a caught error.  NCCL
runs ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single`` and the ring's ``batch_isend_irecv`` as they are.
On gloo an all-gather is the exact all-reduce of a zero buffer in which
each rank fills its own slot (``all_ranks``), a reduce-scatter an
all-reduce of which each rank keeps its block, and the all-to-all and
the ring's point-to-point steps of a CUDA tensor go through a host
copy.  The bytes counted are what moved.  ``all_gather_dim`` /
``all_reduce_sum`` / ``copy_to_model`` are the autograd Functions the
tensor-parallel layers use (Megatron's ``g`` / ``f`` pair and the FSDP
gather), ``all_to_all_dim`` expert slicing's reshard of the expert
weights and the move of a ``"contract_tp"`` split onto the dim its form
consumes; ``ag_matmul_overlapped`` and ``psum_scatter_matmul`` are the
reference's explicit-schedule matmuls.  ``reduce_scatter_dim`` and
``split_dim`` are sequence parallelism's pair (``sharding_rules``):
the sum of the ranks' partials cut along S, and this rank's rows of a
whole tensor.

Every collective runs as well on meta tensors under torch's fake
process group (``launch.mesh.dry_mesh``): the calls return at once and
move nothing, and the counts and bytes recorded are what the ranks of
the modelled backend would move.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

# collectives run since the last reset, by name; their buffers' bytes,
# by kind; the bytes of those whose group spans nodes, by kind
counts: Dict[str, int] = {}
nbytes: Dict[str, int] = {}
ib_nbytes: Dict[str, int] = {}


def reset_counts() -> None:
    counts.clear()
    nbytes.clear()
    ib_nbytes.clear()


def _count(name: str, kind: str, x: torch.Tensor, group=None,
           n: int = 0) -> None:
    """One collective ``name`` of ``kind`` over ``group`` moving ``x``'s
    bytes (or ``n``)."""
    counts[name] = counts.get(name, 0) + 1
    b = n or x.numel() * x.element_size()
    nbytes[kind] = nbytes.get(kind, 0) + b
    if getattr(group, "spans_nodes", False):
        ib_nbytes[kind] = ib_nbytes.get(kind, 0) + b


def sum_disjoint(x: torch.Tensor, group, name: str) -> torch.Tensor:
    """``all_reduce(SUM)`` IN PLACE of a tensor whose non-zero entries
    on each rank are zero on every other rank, summed as bytes (viewed as
    uint8): x + 0 = x with no carry, so every dtype travels bit for bit
    on any backend.  -> x."""
    dist.all_reduce(x.view(torch.uint8), op=dist.ReduceOp.SUM,
                    group=group.pg)
    _count(name, "all-reduce", x, group)
    return x


def all_ranks(x: torch.Tensor, group, name: str) -> torch.Tensor:
    """-> (world, *x.shape): every rank's ``x``, by one collective over
    a zero buffer in which this rank fills its own slot."""
    buf = torch.zeros((group.size,) + tuple(x.shape), dtype=x.dtype,
                      device=x.device)
    buf[group.rank] = x
    return sum_disjoint(buf, group, name)


def merge_stacked(m: torch.Tensor, l: torch.Tensor,
                  acc: torch.Tensor) -> torch.Tensor:
    """The local combine of P ranks' statistics stacked on a leading
    axis, in rank order: m, l (P, ...), acc (P, ..., Dv) -> the
    normalised output (..., Dv) in float32."""
    m, l, acc = m.float(), l.float(), acc.float()
    w = torch.exp(m - m.amax(0))
    den = (w * l).sum(0)
    return (w[..., None] * acc).sum(0) / torch.clamp(den, min=1e-30)[
        ..., None]


def flash_merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                group) -> torch.Tensor:
    """Exact softmax merge of the ranks' partial statistics with ONE
    collective: m, l (...), acc (..., Dv) -> (..., Dv) float32, the same
    bits on every rank."""
    packed = torch.cat([m.float()[..., None], l.float()[..., None],
                        acc.float()], -1)
    allp = all_ranks(packed, group, "flash_merge")
    return merge_stacked(allp[..., 0], allp[..., 1], allp[..., 2:])


# --- the mesh's collectives ---------------------------------------------------

def _nccl(group) -> bool:
    return group.backend == "nccl"


def all_gather(x: torch.Tensor, dim: int, group, name: str) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in group
    rank order; the same bits on every rank."""
    if group.size == 1:
        return x
    if _nccl(group):
        out = torch.empty((group.size,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group.pg)
        _count(name, "all-gather", out, group)
    else:
        out = all_ranks(x.contiguous(), group, name)
    return torch.cat(out.unbind(0), dim)


def reduce_scatter(x: torch.Tensor, dim: int, group,
                   name: str) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's block along ``dim``."""
    if group.size == 1:
        return x
    n = x.shape[dim] // group.size
    if _nccl(group):
        xs = torch.stack(x.split(n, dim), 0).contiguous()
        out = torch.empty_like(xs[0])
        dist.reduce_scatter_tensor(out, xs, group=group.pg)
        _count(name, "reduce-scatter", xs, group)
        return out
    return all_reduce(x, group, name).narrow(dim, group.rank * n, n)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group,
               name: str) -> torch.Tensor:
    """``x`` cut along ``split_dim`` into the group's size of blocks,
    block s sent to rank s; the blocks received concatenated along
    ``cat_dim`` in group rank order.  One ``all_to_all_single`` (a CUDA
    tensor on gloo travels through a host copy); each element moves to
    one rank only, bit for bit."""
    if group.size == 1:
        return x
    stage = x.is_cuda and not _nccl(group)
    src = torch.stack(x.chunk(group.size, split_dim), 0)
    src = src.cpu() if stage else src.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group.pg)
    _count(name, "all-to-all", src, group)
    if stage:
        out = out.to(x.device)
    return torch.cat(out.unbind(0), cat_dim)


def all_reduce(x: torch.Tensor, group, name: str) -> torch.Tensor:
    """The group's sum of ``x`` (a new tensor)."""
    if group.size == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group.pg)
    _count(name, "all-reduce", out, group)
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The group's elementwise max of ``x`` (a new tensor; no
    gradient)."""
    if group is None or group.size == 1:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group.pg)
    _count("all_reduce_max", "all-reduce", out, group)
    return out


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, reduce_grad):
        ctx.dim, ctx.group, ctx.reduce_grad = dim, group, reduce_grad
        return all_gather(x, dim, group, "all_gather_dim")

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.group, ctx.dim
        if ctx.reduce_grad:
            out = reduce_scatter(g, dim, group, "all_gather_dim.grad")
        else:
            n = g.shape[dim] // group.size
            out = g.narrow(dim, group.rank * n, n).contiguous()
        return out, None, None, None


def all_gather_dim(x: torch.Tensor, dim: int, group,
                   reduce_grad: bool = True) -> torch.Tensor:
    """All-gather along ``dim`` over ``group``.  Backward: the gradient
    reduce-scattered (summed) over the group where the ranks fed
    different inputs (``reduce_grad``), else this rank's block of it
    (the ranks computed the same thing, each holding the whole
    gradient)."""
    if group is None or group.size == 1:
        return x
    return _AllGatherDim.apply(x, dim, group, reduce_grad)


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter(x, dim, group, "reduce_scatter_dim")

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.dim, ctx.group,
                           "reduce_scatter_dim.grad"), None, None)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's sum of the ranks' partial ``x``, this rank's block
    along ``dim`` (sequence parallelism's close of a tensor-parallel
    region).  Backward: the rows' gradients all-gathered, whole on
    every rank (each rank's partial fed every row)."""
    if group is None or group.size == 1:
        return x
    return _ReduceScatterDim.apply(x, dim, group)


class _SplitDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = x.shape[dim] // group.size
        return x.narrow(dim, group.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather(g.contiguous(), ctx.dim, ctx.group,
                           "split_dim.grad"), None, None)


def split_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of an ``x`` every rank of the
    group holds whole; no collective forward.  Backward: the blocks'
    gradients all-gathered, so that upstream sees the whole gradient on
    every rank, as it would without the split."""
    if group is None or group.size == 1:
        return x
    return _SplitDim.apply(x, dim, group)


class _AllToAllDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group, name):
        ctx.dims, ctx.group, ctx.name = (split_dim, cat_dim), group, name
        return all_to_all(x, split_dim, cat_dim, group, name)

    @staticmethod
    def backward(ctx, g):
        split_dim, cat_dim = ctx.dims
        return (all_to_all(g, cat_dim, split_dim, ctx.group,
                           ctx.name + ".grad"), None, None, None, None)


def all_to_all_dim(x: torch.Tensor, split_dim: int, cat_dim: int,
                   group, name: str = "all_to_all_dim") -> torch.Tensor:
    """``all_to_all`` with its inverse as the backward: the gradient goes
    back to the ranks its blocks came from (a reshard, no sum).  Counted
    as ``name`` (its backward as ``name + ".grad"``): expert slicing's
    reshard of the expert weights, or ``sharding_rules.use``'s move of a
    contraction split ("model_move")."""
    if group is None or group.size == 1:
        return x
    return _AllToAllDim.apply(x, split_dim, cat_dim, group, name)


class _AllToAllV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.sizes, ctx.group = (send, recv), group
        return _all_to_all_v(x, send, recv, group, "regroup")

    @staticmethod
    def backward(ctx, g):
        send, recv = ctx.sizes
        return (_all_to_all_v(g, recv, send, ctx.group, "regroup.grad"),
                None, None, None)


def _all_to_all_v(x: torch.Tensor, send, recv, group, name: str
                  ) -> torch.Tensor:
    """x's rows (dim 0) cut into ``send[q]`` rows for rank q; -> the rows
    received, ``recv[s]`` from rank s, in group rank order.  One
    ``all_to_all_single`` (a CUDA tensor on gloo travels through a host
    copy)."""
    stage = x.is_cuda and not _nccl(group)
    src = x.contiguous().cpu() if stage else x.contiguous()
    out = src.new_empty((sum(recv),) + tuple(src.shape[1:]))
    dist.all_to_all_single(out, src, output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=group.pg)
    _count(name, "all-to-all", src, group)
    return out.to(x.device) if stage else out


def regroup(x: torch.Tensor, dim: int, need, group) -> torch.Tensor:
    """This rank's block along ``dim`` of a leaf split evenly over
    ``group`` -> the leaf's indices along ``dim`` that ``need(rank)`` (a
    sorted CPU int64 tensor of global indices) names for this rank, in
    that order, each from the rank that holds it: one all-to-all of
    uneven parts in place of gathering the leaf whole.  Backward: the
    reverse all-to-all, the gradients of an index sent to several ranks
    summed on its holder."""
    c, n = x.shape[dim], group.size
    lo = group.rank * c
    parts = []
    for q in range(n):
        want = need(q)
        idx = want[(want >= lo) & (want < lo + c)] - lo
        parts.append(x.index_select(dim, idx.to(x.device)))
    mine = need(group.rank)
    recv = [int(((mine >= q * c) & (mine < (q + 1) * c)).sum())
            for q in range(n)]
    send = [p.shape[dim] for p in parts]
    out = _AllToAllV.apply(torch.cat(parts, dim).movedim(dim, 0), send,
                           recv, group)
    return out.movedim(0, dim)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, "all_reduce_sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, "copy_to_model.grad"), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: the group's sum in the forward, the identity in
    the backward (each rank's partial gets the whole gradient).  Closes
    a tensor-parallel region."""
    if group is None or group.size == 1:
        return x
    return _AllReduceSum.apply(x, group)


class _AllReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group, "all_reduce_partial")

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, "all_reduce_partial.grad"), None


def all_reduce_partial(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of the ranks' partial ``x``, used inside a
    tensor-parallel region by every rank's own part of the work (the
    psum of a statistic over a split dim: Mamba2's gated-norm sum of
    squares).  Backward: the sum again, each rank's part having seen
    only its own share of the gradient."""
    if group is None or group.size == 1:
        return x
    return _AllReducePartial.apply(x, group)


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: the identity in the forward, the group's sum of
    the gradient in the backward (each rank's partial region contributed
    part of it).  Opens a tensor-parallel region."""
    if group is None or group.size == 1 or not torch.is_grad_enabled():
        return x
    return _CopyToModel.apply(x, group)


# --- explicit-schedule matmuls (``repro.distributed.collectives``) ------------

def _ring_steps(p: int) -> int:
    return max((p + 1) // 2 + (0 if p % 2 else 1), 1)


def _permute_pair(fwd: torch.Tensor, bwd: torch.Tensor, group,
                  ) -> List[torch.Tensor]:
    """One bidirectional ring step: ``fwd`` goes to the previous rank and
    ``bwd`` to the next, by ``batch_isend_irecv``; -> the pair received.
    A CUDA tensor on gloo travels through a host copy."""
    p, r = group.size, group.rank
    stage = fwd.is_cuda and not _nccl(group)
    dev = fwd.device
    send = [t.cpu() if stage else t.contiguous() for t in (fwd, bwd)]
    recv = [torch.empty_like(t) for t in send]
    ranks = dist.get_process_group_ranks(group.pg)
    ops = [dist.P2POp(dist.isend, send[0], ranks[(r - 1) % p], group.pg),
           dist.P2POp(dist.isend, send[1], ranks[(r + 1) % p], group.pg),
           dist.P2POp(dist.irecv, recv[0], ranks[(r + 1) % p], group.pg),
           dist.P2POp(dist.irecv, recv[1], ranks[(r - 1) % p], group.pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    _count("ag_matmul_overlapped", "collective-permute", fwd, group,
           2 * fwd.numel() * fwd.element_size())
    return [t.to(dev) if stage else t for t in recv]


def ag_matmul_overlapped(x: torch.Tensor, w_local: torch.Tensor, mesh,
                         axis: str = "model") -> torch.Tensor:
    """x (M, K), this rank's own; w_local (K/P, N), this rank's K block
    of w over ``axis`` (as FSDP leaves it) -> x @ w_full (M, N), without
    materialising the all-gathered weight: the bidirectional ring of the
    reference (``_ring_ag_matmul``).  At each of ``(P + 1) // 2 + (0 if P
    odd else 1)`` steps the resident shard pair is multiplied against
    its matching column blocks of x while the next pair moves, one
    ``batch_isend_irecv`` a step (counted as "ag_matmul_overlapped", its
    bytes as "collective-permute"); the backward shard is used from the
    second step on, and not where it is the forward one.  Accumulates in
    float32, returns x's dtype."""
    group = mesh.group(axis)
    p, idx = group.size, group.rank
    kb = w_local.shape[0]
    acc = torch.zeros((x.shape[0], w_local.shape[1]), dtype=torch.float32,
                      device=x.device)
    if p == 1:
        return (acc + (x @ w_local).float()).to(x.dtype)
    fwd = bwd = w_local
    n_steps = _ring_steps(p)
    for i in range(n_steps):
        k_fwd, k_bwd = (idx + i) % p, (idx - i) % p
        nxt = None
        if i + 1 < n_steps:
            # the next pair moves while the resident one is multiplied
            # (the exchange is issued first; eager code has no overlap
            # of its own on one stream)
            nxt = _permute_pair(fwd, bwd, group)
        acc += (x[:, k_fwd * kb:(k_fwd + 1) * kb] @ fwd).float()
        if i > 0 and k_bwd != k_fwd:
            acc += (x[:, k_bwd * kb:(k_bwd + 1) * kb] @ bwd).float()
        if nxt is not None:
            fwd, bwd = nxt
    return acc.to(x.dtype)


def psum_scatter_matmul(x_local: torch.Tensor, w_local: torch.Tensor,
                        mesh, axis: str = "model") -> torch.Tensor:
    """Tensor-parallel down projection: x_local (M, F/P), w_local (F/P,
    N) -> this rank's (M, N/P) block of the sum over ``axis`` of the
    local products: the local product, then one reduce-scatter along
    dim 1 (counted as "psum_scatter_matmul")."""
    return reduce_scatter(x_local @ w_local, 1, mesh.group(axis),
                          "psum_scatter_matmul")
