"""Sharding rules (``repro.distributed.sharding_rules``): the logical-axis
-> mesh-axis mapping of params and activations (DP + FSDP + TP, the pod
axis an extra DP dim), and the port's realisation of them on a mesh of
processes.

The rule tables, ``ShardingRules.resolve``, ``default_rules``,
``param_sharding`` and ``batch_sharding`` are the reference's: a spec is
a tuple with one entry a dim, each None, a mesh axis name, or a tuple of
names (a ``PartitionSpec``'s entries), matched on the '/'-joined key path
of the leaf, right-aligned over a layer stack, a dim left unsharded
where its axis does not divide it.

The reference hands those specs to GSPMD: XLA reads the
``NamedSharding``s and inserts the collectives.  Eager PyTorch has no
such compiler, so the port realises the same layouts by hand:

  * every rank is one process (``launch.mesh.make_host_mesh`` over
    ``torch.distributed``'s world) and holds only its own block of every
    leaf (``shard_leaf``; ``gather_leaf`` rebuilds the whole);
  * a leaf's dims on ``data``, and its ``model`` dims that no
    tensor-parallel code consumes, are all-gathered layer by layer where
    they are used (``use``: FSDP, ZeRO-3 style; the backward
    reduce-scatters the gradient over ``data``);
  * the tensor-parallel layers consume their ``model`` blocks and issue
    their collectives themselves (``distributed.collectives``): GQA
    attention and MLA by head, the dense FFN and RWKV6's channel mix by
    d_ff column (under an active MoR plan too, where d_ff divides over
    ``model`` in whole ``tile_n`` tiles: the rank's plan is its column
    block of the plan's per-neuron tables, ``neuron_block``, and the
    plan exchanges its proxies' inputs and its tile rows' live counts,
    ``core.executor``), RWKV6's time mix and Mamba2 by head
    (each where its heads divide over ``model``), the
    vocabulary-parallel embedding, head and loss, the experts of
    ``moe_apply_a2a`` and the f columns of ``_moe_mesh``'s.  Each
    family's ``tp_keep`` names the leaves it consumes and the dim it
    consumes each on: the input projections (``wq`` / ``wk`` / ``wv``,
    ``w_gate`` / ``w_up``, ``lm_head``, the experts' up projections) by
    output column, the output projections (``wo``, ``w_down``,
    ``out_proj``) by input row.  The default layout, ``"fsdp_tp"``
    (``_PARAM_RULES``), puts ``model`` on exactly those dims.
    ``"contract_tp"`` (``_PARAM_RULES_CONTRACT``) puts it on the other
    dim of each: the input projections' input (contraction) dim, the
    output projections' output dim.  ``use`` then moves such a split
    onto the dim its form consumes, once the leaf's ``data`` dims are
    gathered, with one all-to-all over ``model``
    (``collectives.all_to_all_dim``, counted as "model_move"), so that
    every form receives the block ``"fsdp_tp"`` would have handed it
    and runs unchanged; the stored blocks and the optimizer state keep
    the layout's own.  The forms that consume ``"contract_tp"``'s
    splits so are GQA, the dense FFN (MoR on or off), Mamba2, zamba2's
    shared block, hubert's encoder, the ``moe_tp`` experts and the head;
    MLA's
    and RWKV6's ``"contract_tp"`` splits (``wq_a`` / ``wkv_a``, the time
    mix's ``Wr`` / ``Wk`` / ...) stay gathered whole.  A split that
    does not fall on a form's boundaries is redistributed (Mamba2's
    ``in_proj``, whose [z | xBC | dt] columns ``"fsdp_tp"`` cuts
    mid-segment and ``"contract_tp"`` splits by row: ``ssm._tp_local``)
    or gathered and sliced (RWKV6's ``Wo``, split by column and used by
    row: ``tp_slice``, as the replicated per-head vectors are, RWKV6's
    ``u``, Mamba2's ``A_log`` and ``"contract_tp"``'s qkv biases).

``torch.distributed.tensor`` (DTensor) is deliberately not the route:
the hand-written kernels take plain local tensors through ``ctypes``, and
every collective is counted and every integer output (dispatch slots,
tile masks, greedy tokens) held bit for bit against one device, which an
op-propagation layer would hide.

A dim over the data-parallel tuple ``("pod", "data")`` (the multi-pod
mesh) is one data-parallel group, laid out pod outer as the reference's
``_dp_axes`` resolve it (``dp_group``); a dim that does not divide its
axes stays whole.

Sequence parallelism (``activation_context(sequence_parallel=True)``,
the reference's ``"residual": ("dp", "sp_seq", None)``): between blocks
each ``model`` rank holds its S / MP rows of the residual stream.  A
tensor-parallel layer all-gathers its normed input over S (the
backward reduce-scatters, summing the ranks' partial gradients), opens
its region with no ``copy_to_model`` (``tp_enter``; a whole weight used
inside it sums its gradient over ``model`` instead: ``tp_weight``) and
closes it with a reduce-scatter over S in place of the all-reduce
(``tp_exit``).  A layer the mesh gathers whole gathers S, does its whole
work with the flag off and keeps this rank's rows (``seq_call``); the
replicated weights used on the S shards (the norms) sum their
gradients over ``model`` (``seq_weights``).  A forward whose S does not
divide over ``model`` runs with the flag off (``seq_sharded``), and the
decode never S-shards.

``activation_context`` is the thread-local the layers consult, as the
reference's ``_TLS.ctx`` is.  Its ``rows_split`` says whether the data
ranks hold distinct rows of one batch (a batch the data ranks do not
divide is run whole on each: ``launch.steps.local_rows``), which a MoR
plan's capacity clip over the global batch reads.  ``_ACT_SPECS``
states each activation's
layout; ``constrain`` / ``constrain_grad`` are identities here, because
the explicit code above realises those layouts itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_map

_TLS = threading.local()

# Mesh axis the serving page pools shard over: physical kv / state pages
# partitioned, block tables, params and activations replicated.
# Deliberately distinct from the train-time axes ('pod', 'data',
# 'model'), so that _dp_axes / 'tp' resolution never capture it.
PAGE_AXIS = "pages"

Spec = Tuple[Any, ...]


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def _dp_axes(mesh):
    """Data-parallel axes: ('pod','data') when a pod axis exists."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


@dataclass(frozen=True)
class ShardingRules:
    """Pattern (regex on '/'-joined param path) -> spec factory.

    Specs may reference the logical axes 'dp' (data+pod), 'tp' ('model');
    they are resolved against the active mesh."""
    rules: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...]
    sequence_parallel: bool = False

    def resolve(self, spec: Tuple[Optional[str], ...], mesh) -> Spec:
        out = []
        for ax in spec:
            if ax is None:
                out.append(None)
            elif ax == "dp":
                dp = _dp_axes(mesh)
                out.append(dp if len(dp) > 1 else (dp[0] if dp else None))
            elif ax == "tp":
                out.append("model" if "model" in mesh.axis_names else None)
            else:
                out.append(ax if ax in mesh.axis_names else None)
        return tuple(out)


# Parameter rules: matched against the '/'-joined path, first match wins.
# Layout: TP on the 'model' axis over heads/d_ff/experts/vocab, FSDP over
# 'data' on the other major dim (ZeRO-3).
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / unembedding
    (r"embed$", ("tp", "dp")),
    (r"lm_head$", ("dp", "tp")),
    # attention (GQA + MLA)
    (r"(wq|wk|wv)$", ("dp", "tp")),
    (r"wo$", ("tp", "dp")),
    (r"(bq|bk|bv)$", ("tp",)),
    (r"wq_a$", ("dp", "tp")),
    (r"wq_b$", ("dp", "tp")),
    (r"wkv_a$", ("dp", "tp")),
    (r"(wk_b|wv_b)$", ("dp", "tp")),
    # dense FFN
    (r"(w_gate|w_up)$", ("dp", "tp")),
    (r"w_down$", ("tp", "dp")),
    # MoE experts: EP handled by moe-specific rule injected per-config
    (r"router$", ("dp", "tp")),
    (r"moe_ep/(w_gate|w_up)$", ("tp", "dp", None)),
    (r"moe_ep/w_down$", ("tp", "dp", None)),
    (r"moe_tp/(w_gate|w_up)$", (None, "dp", "tp")),
    (r"moe_tp/w_down$", (None, "tp", "dp")),
    # mamba2 / rwkv
    (r"in_proj$", ("dp", "tp")),
    (r"out_proj$", ("tp", "dp")),
    (r"(Wr|Wk|Wv|Wg|Wo|wA|wB)$", ("dp", "tp")),
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"norm_scale$", ("tp",)),
    # MoR predictor tables: per-output-neuron vectors follow d_ff (tp)
    (r"mor/.*(m|b|enable|proxy_slot|is_proxy|perm|inv_perm|bn_scale|bn_bias)$",
     ("tp",)),
    # everything else (norms, scalars, small tables): replicated
    (r".*", ()),
)


# Alternative layout: 'model' on the dim _PARAM_RULES leaves to 'data',
# and the reverse: the input projections' (wq / wk / wv, w_gate / w_up,
# in_proj, lm_head, the experts' up projections) CONTRACTION dim and the
# output projections' (wo, w_down, out_proj) output dim; FSDP over
# 'data' on the other dim.  A/B-able via param_sharding(layout=...);
# ``use`` moves each 'model' split onto the dim its form consumes.
_PARAM_RULES_CONTRACT: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed$", ("tp", "dp")),
    (r"lm_head$", ("tp", "dp")),
    (r"(wq|wk|wv)$", ("tp", "dp")),
    (r"wo$", ("dp", "tp")),
    (r"(bq|bk|bv)$", ()),
    (r"wq_a$", ("tp", "dp")),
    (r"wq_b$", ("tp", "dp")),
    (r"wkv_a$", ("tp", "dp")),
    (r"(wk_b|wv_b)$", ("tp", "dp")),
    (r"(w_gate|w_up)$", ("tp", "dp")),
    (r"w_down$", ("dp", "tp")),
    (r"router$", ("tp", None)),
    (r"moe_ep/(w_gate|w_up)$", ("tp", "dp", None)),
    (r"moe_ep/w_down$", ("tp", None, "dp")),
    (r"moe_tp/(w_gate|w_up)$", (None, "tp", "dp")),
    (r"moe_tp/w_down$", (None, "dp", "tp")),
    (r"in_proj$", ("tp", "dp")),
    (r"out_proj$", ("dp", "tp")),
    (r"(Wr|Wk|Wv|Wg|Wo|wA|wB)$", ("tp", "dp")),
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"norm_scale$", ("tp",)),
    (r"mor/.*", ("tp",)),
    (r".*", ()),
)


def default_rules(sequence_parallel: bool = False,
                  layout: str = "fsdp_tp") -> ShardingRules:
    rules = (_PARAM_RULES_CONTRACT if layout == "contract_tp"
             else _PARAM_RULES)
    return ShardingRules(rules=rules, sequence_parallel=sequence_parallel)


def _axes_size(mesh, ax) -> int:
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    return size


def moe_mode_of(cfg) -> str:
    """The ``moe_mode`` of ``param_sharding`` a config's
    ``expert_sharding`` asks for ("tp", "ep" or "ep_shmap")."""
    return cfg.expert_sharding if cfg.expert_sharding in (
        "tp", "ep", "ep_shmap") else "tp"


def param_sharding(params, mesh, rules: Optional[ShardingRules] = None,
                   moe_mode: str = "tp", layout: str = "fsdp_tp"):
    """A tree of specs matching ``params`` (tensors, meta tensors or
    anything with ``.shape``), each a tuple of axis entries."""
    rules = rules or default_rules(layout=layout)

    def spec_for(p: str, shape) -> Spec:
        ndim = len(shape)
        # tag expert tensors so EP/TP rules can disambiguate
        if re.search(r"moe/(w_gate|w_up|w_down)$", p):
            mode = moe_mode
            if moe_mode == "ep_shmap":
                # expert dim is leaf dim -3 for (L, E, d, f) stacks
                e_dim = shape[-3]
                mp = mesh.shape.get("model", 1)
                mode = "ep" if e_dim % mp == 0 else "tp"
            p = p.replace("moe/", f"moe_{mode}/")
        for pat, spec in rules.rules:
            if re.search(pat, p):
                specs = list(rules.resolve(spec, mesh))
                # rules describe the LOGICAL per-layer shape; a layer
                # stack's leading L dim stays unsharded (right-aligned)
                if ndim > len(specs):
                    specs = [None] * (ndim - len(specs)) + specs
                specs = specs[:ndim]
                # drop sharding on dims that don't divide evenly
                for i, ax in enumerate(specs):
                    if ax is not None and shape[i] % _axes_size(mesh, ax):
                        specs[i] = None
                return tuple(specs)
        return ()

    def walk(tree, prefix: str):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        return spec_for(prefix[:-1], tuple(tree.shape))

    return walk(params, "")


def batch_sharding(batch, mesh):
    """Shard the leading (global-batch) dim over all DP axes: a spec a
    leaf, () where the dim does not divide (replicated)."""
    dp = _dp_axes(mesh)
    spec = dp if len(dp) > 1 else (dp[0] if dp else None)

    def one(x):
        if x.ndim == 0 or (spec and x.shape[0] % _dp_size(mesh) != 0):
            return ()
        return (spec,)
    return tree_map(one, batch)


def _dp_size(mesh) -> int:
    s = 1
    for a in _dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def dp_group(mesh):
    """The group of every data-parallel rank of this rank's model index:
    the ``data`` axis, or the ``("pod", "data")`` tuple on a multi-pod
    mesh (pod outer)."""
    return mesh.group(_dp_axes(mesh))


def on_dp(spec: Spec) -> bool:
    """Whether ``spec`` puts a dim on a data-parallel axis."""
    return any(a in ("pod", "data") for ax in spec if ax is not None
               for a in ((ax,) if isinstance(ax, str) else ax))


# --- activation context -----------------------------------------------------

@dataclass
class MeshContext:
    """What the layers consult under ``activation_context``: the mesh,
    the sequence-parallel flag, the spec tree of the params the layers
    are handed (their rank-local blocks), and whether the data ranks
    hold distinct rows (``rows_split``)."""
    mesh: Any
    sequence_parallel: bool = False
    specs: Any = None
    rows_split: bool = True


@contextlib.contextmanager
def activation_context(mesh, sequence_parallel: bool = False, specs=None,
                       rows_split: bool = True):
    """Run the model code under ``mesh``: the layers gather and split
    their params as ``specs`` (``param_sharding``'s tree of the params
    they are handed) says; each data rank runs its own rows of one
    batch, or (``rows_split`` False) every data rank the same rows.
    Nests; restores the outer context."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = MeshContext(mesh, sequence_parallel, specs, rows_split)
    try:
        yield
    finally:
        _TLS.ctx = prev


def bind(fn):
    """``fn`` run under the context active now, wherever it is called
    from: a rematerialised block is recomputed by the autograd engine,
    which runs a CUDA backward on a thread of its own (where this
    thread's context is not set)."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        prev = getattr(_TLS, "ctx", None)
        _TLS.ctx = ctx
        try:
            return fn(*args, **kwargs)
        finally:
            _TLS.ctx = prev
    return run


def current() -> Optional[MeshContext]:
    """The active context, or None outside one and on a one-rank mesh."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or getattr(ctx.mesh, "groups", None) is None:
        return None
    return ctx


def model_group(ctx: Optional[MeshContext] = None):
    """The context's ``model`` axis group, or None where it has one
    rank."""
    ctx = ctx or current()
    if ctx is None:
        return None
    g = ctx.mesh.group("model")
    return g if g.size > 1 else None


def sp_group(ctx: Optional[MeshContext] = None):
    """The ``model`` group the residual stream is S-sharded over, or None
    where sequence parallelism is off (or ``model`` has one rank)."""
    ctx = ctx or current()
    if ctx is None or not ctx.sequence_parallel:
        return None
    return model_group(ctx)


@contextlib.contextmanager
def sequence_parallel(on: bool):
    """The active context with its sequence-parallel flag ``on``
    (restored on exit); nothing outside a context."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or ctx.sequence_parallel == on:
        yield
        return
    _TLS.ctx = dataclasses.replace(ctx, sequence_parallel=on)
    try:
        yield
    finally:
        _TLS.ctx = ctx


def seq_sharded(seq_len: int):
    """The context of a forward over ``seq_len`` positions: sequence
    parallelism stays on only where ``model`` divides them (a dim that
    does not divide stays whole, as the reference's constraints
    leave it)."""
    g = sp_group()
    return sequence_parallel(g is not None and seq_len % g.size == 0)


def seq_split(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's S rows of a whole (replicated) activation; the
    backward all-gathers the rows' gradients whole."""
    g = sp_group()
    if g is None:
        return x
    from repro_torch.distributed import collectives as co
    return co.split_dim(x, dim, g)


def seq_gather(x: torch.Tensor, partial_grad: bool, dim: int = 1
               ) -> torch.Tensor:
    """The whole S of an S-sharded activation.  ``partial_grad``: what
    consumes it is a tensor-parallel region whose ranks each hold a
    part of its gradient (the backward reduce-scatters their sum), else
    every rank computes the same from it (the backward keeps this
    rank's rows of the whole gradient)."""
    g = sp_group()
    if g is None:
        return x
    from repro_torch.distributed import collectives as co
    return co.all_gather_dim(x, dim, g, reduce_grad=partial_grad)


def seq_call(fn, tp: bool, h: torch.Tensor, dim: int = 1):
    """``fn(h)`` on an S-sharded ``h`` under sequence parallelism (else
    as it is): a tensor-parallel layer (``tp``) on the gathered rows,
    closing its region with ``tp_exit``'s reduce-scatter; any other on
    the gathered rows with the flag off, this rank's rows of its
    output kept.  ``fn`` returns a tensor or a tuple whose first entry
    is the output."""
    g = sp_group()
    if g is None:
        return fn(h)
    hf = seq_gather(h, tp, dim)
    if tp:
        return fn(hf)
    with sequence_parallel(False):
        out = fn(hf)
    if isinstance(out, tuple):
        return (seq_split(out[0], dim),) + tuple(out[1:])
    return seq_split(out, dim)


def seq_weights(tree):
    """Replicated weights applied to S-sharded activations (the norms):
    under sequence parallelism each leaf's gradient is summed over
    ``model`` (``copy_to_model``), each rank having seen its rows only."""
    g = sp_group()
    if g is None:
        return tree
    from repro_torch.distributed import collectives as co
    return tree_map(lambda w: co.copy_to_model(w, g), tree)


def tp_enter(x: torch.Tensor, group) -> torch.Tensor:
    """Open a tensor-parallel region over ``group``: Megatron's ``f``
    (``copy_to_model``), or under sequence parallelism nothing (the
    input was gathered over S with a reduce-scatter backward)."""
    from repro_torch.distributed import collectives as co
    if sp_group() is not None:
        return x
    return co.copy_to_model(x, group)


def tp_weight(w: torch.Tensor, group) -> torch.Tensor:
    """A whole weight used inside a tensor-parallel region: under
    sequence parallelism each rank's gradient of it is a part, summed
    over ``group``; else it is already whole."""
    from repro_torch.distributed import collectives as co
    if sp_group() is None:
        return w
    return co.copy_to_model(w, group)


def tp_shared(w: torch.Tensor, group) -> torch.Tensor:
    """A whole weight applied inside a tensor-parallel region to the
    entered input, by every rank for its own heads (RWKV6's lerps and
    decay LoRA, Mamba2's B / C columns): each rank's gradient is a part,
    summed over ``group`` with or without sequence parallelism
    (``copy_to_model``)."""
    from repro_torch.distributed import collectives as co
    return co.copy_to_model(w, group)


def tp_slice(w: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of a leaf it holds whole (a
    replicated per-head vector, or a weight gathered over ``model``
    whose split is on another dim): the forward a slice, the backward
    the blocks' gradients all-gathered, so that the leaf's gradient is
    whole and the same on every rank (``collectives.split_dim``)."""
    from repro_torch.distributed import collectives as co
    return co.split_dim(w, dim, group)


def seq_rows(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's S rows of an activation gathered over S for a
    tensor-parallel region (a plain slice: its gradient stays in those
    rows, and the gather's reduce-scatter adds it to the ranks'
    partials), or ``x`` itself without sequence parallelism."""
    g = sp_group()
    if g is None:
        return x
    n = x.shape[dim] // g.size
    return x.narrow(dim, g.rank * n, n)


def tp_exit(y: torch.Tensor, group, seq_dim: int = 1) -> torch.Tensor:
    """Close a tensor-parallel region: the ranks' partial sums added,
    whole (``all_reduce_sum``), or under sequence parallelism this
    rank's S rows of the sum (``reduce_scatter_dim`` along
    ``seq_dim``)."""
    from repro_torch.distributed import collectives as co
    if sp_group() is not None:
        return co.reduce_scatter_dim(y, seq_dim, group)
    return co.all_reduce_sum(y, group)


_ACT_SPECS: Dict[str, Tuple] = {
    # (B, S, D) residual stream; S over model axis if sequence-parallel
    "residual": ("dp", "sp_seq", None),
    "residual_decode": ("dp", None, None),
    "logits": ("dp", None, "tp"),
    "ffn_hidden": ("dp", None, "tp"),
    "heads": ("dp", None, "tp", None),       # (B, S, H, hd)
    "kv_cache": ("dp", None, "tp", None),
    "expert_buf": ("tp", None, None),        # (E, C, d) under EP
    "expert_hidden_ep": ("tp", None, None),  # (E, C, f) under EP
    "expert_hidden_tp": (None, None, "tp"),  # (E, C, f) under TP
    # TP-standard FFN/attention interior layouts (2D flattened tokens):
    # input gathered on model, hidden sharded over model -> single
    # all-reduce of the (T, d) down-projection partials
    "ffn_in_2d": ("dp", None),
    "ffn_hidden_2d": ("dp", "tp"),
    "w_down_grad": ("tp", "dp"),
    "attn_in": ("dp", None, None),
}


def constrain(x, kind: str):
    """The reference pins ``x`` (and its cotangent) to ``_ACT_SPECS[kind]``
    for GSPMD; the port's layers realise those layouts explicitly, so
    this is the identity."""
    return x


def constrain_grad(x, kind: str):
    """The identity (see ``constrain``)."""
    return x


# --- rank-local blocks --------------------------------------------------------

def _block_index(mesh, ax) -> int:
    axes = (ax,) if isinstance(ax, str) else tuple(ax)
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + mesh.index(a)
    return idx


def shard_leaf(full: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a contiguous copy)."""
    out = full
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        n = _axes_size(mesh, ax)
        if n == 1:
            continue
        c = full.shape[i] // n
        out = out.narrow(i, _block_index(mesh, ax) * c, c)
    return out.contiguous().clone() if out is full else out.contiguous()


def gather_leaf(local: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole leaf from every rank's block (``local`` is this rank's),
    one all-gather a sharded dim; the same bits on every rank."""
    from repro_torch.distributed import collectives as co
    out = local
    for i, ax in enumerate(spec):
        if ax is None or _axes_size(mesh, ax) == 1:
            continue
        out = co.all_gather(out, i, mesh.group(ax), "gather_leaf")
    return out


def shard_tree(tree, specs, mesh):
    return tree_map(lambda x, s: shard_leaf(x, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    return tree_map(lambda x, s: gather_leaf(x, s, mesh), tree, specs)


def spec_paths(specs, prefix: str = "") -> Dict[str, Spec]:
    """{'/'-joined key path: spec} of a spec tree, in ``tree.paths``'
    order (the spec tuples are its leaves)."""
    if isinstance(specs, dict):
        out: Dict[str, Spec] = {}
        for k in sorted(specs):
            out.update(spec_paths(specs[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: specs}


def layer_specs(specs):
    """The specs of one layer's views of a layer-stacked spec tree (the
    stack's leading dim, never sharded, dropped)."""
    if isinstance(specs, dict):
        return {k: layer_specs(v) for k, v in specs.items()}
    assert not specs or specs[0] is None, specs
    return tuple(specs[1:])


# the leaves ``use`` gathered over ``model`` since the last
# ``model_gathers.clear()``, by '/'-joined path within what it was handed
# (a count each): the splits no tensor-parallel form consumed
model_gathers: Dict[str, int] = {}


def use(tree, specs, keep=None, prefix: str = ""):
    """Gather-on-use: every dim of ``tree``'s leaves that ``specs`` puts
    on a mesh axis of more than one rank is all-gathered
    (``collectives.all_gather_dim``), except the ``model`` dims of the
    leaves named in ``keep`` ({'/'-joined path under ``prefix``: the dim
    its tensor-parallel form consumes the split on}): those stay split
    and carry their group (``split_group``).  A kept leaf whose split
    lies on another dim than its form's (``"contract_tp"``'s
    contraction splits) has it moved there once its ``data`` dims are
    gathered: one all-to-all over ``model``
    (``collectives.all_to_all_dim``, counted as "model_move"; its
    backward moves the gradient back), after which it is the block the
    ``"fsdp_tp"`` layout would have handed the same form.  A move whose
    target dim does not divide over ``model`` gathers the leaf whole
    instead.  Each ``model`` gather is tallied in ``model_gathers``.  A
    ``data`` gather's backward reduce-scatters the gradient (each data
    rank saw its own batch); a ``model`` gather's takes this rank's
    block of it (the ranks of a row computed the same thing)."""
    ctx = current()
    if ctx is None or specs is None:
        return tree
    from repro_torch.distributed import collectives as co
    mesh = ctx.mesh
    keep = keep or {}

    def walk(t, s, p):
        if isinstance(t, dict):
            return {k: walk(v, s[k], f"{p}{k}/") for k, v in t.items()}
        name = p[:-1]
        mi = next((i for i, ax in enumerate(s) if ax == "model"), None)
        group = mesh.group("model") if mi is not None else None
        target = None
        if name in keep and group is not None and group.size > 1:
            target = keep[name] % len(s)
            whole = t.shape[target] * (1 if s[target] is None else
                                       _axes_size(mesh, s[target]))
            if whole % group.size:
                target = None           # the form's dim does not divide
        out = t
        for i, ax in enumerate(s):
            if ax is None or _axes_size(mesh, ax) == 1 or (
                    i == mi and target is not None):
                continue
            if ax == "model":
                model_gathers[name] = model_gathers.get(name, 0) + 1
            out = co.all_gather_dim(out, i, mesh.group(ax),
                                    reduce_grad=ax != "model")
        if target is None:
            return out
        if target != mi:
            out = co.all_to_all_dim(out, target, mi, group, "model_move")
        elif out is t:
            out = t.view_as(t)
        out._model_split = group
        out._model_dim = target - len(s)
        return out

    return walk(tree, specs, prefix)


def neuron_block(v: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of a per-neuron leaf (..., N) whose FFN is
    split over ``group`` by d_ff column (the reference's ``mor/...``
    rule, ``("tp",)``): columns [r N / MP, (r + 1) N / MP), a view."""
    n = v.shape[-1] // group.size
    return v.narrow(-1, group.rank * n, n)


def split_group(t: torch.Tensor):
    """The ``model`` group a leaf handed out by ``use`` stays split
    over (its tensor-parallel consumer's collectives run on it), or
    None for a whole leaf."""
    return getattr(t, "_model_split", None)


def split_on(t: torch.Tensor):
    """The dim (negative) of a leaf handed out by ``use`` that is split
    over ``model``, or None for a whole leaf."""
    return getattr(t, "_model_dim", None)


def model_dim(specs, name: str):
    """The dim (negative) of leaf ``name`` of ``specs`` split over
    ``model``, or None: where a form finds the split it consumes (on
    its own dim, or on another that ``use`` moves it from)."""
    s = specs.get(name) if isinstance(specs, dict) else None
    for i, ax in enumerate(s or ()):
        if ax == "model":
            return i - len(s)
    return None


def on_model(specs, name: str, dim: int) -> bool:
    """Whether leaf ``name`` of ``specs`` is split over ``model`` on
    ``dim``."""
    s = specs.get(name) if isinstance(specs, dict) else None
    return bool(s) and len(s) >= abs(dim) and s[dim] == "model"
