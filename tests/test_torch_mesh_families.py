"""The tensor-parallel forms of the port's remaining decoder families on
the ``(data, model)`` mesh under ``"fsdp_tp"``: head-parallel MLA
(deepseek-v2-236b), RWKV6's time mix by head and channel mix by column
(rwkv6-3b), Mamba2 by head and zamba2's shared GQA + FFN block
(zamba2-7b), and hubert-xlarge's GQA and FFN (its 4 heads over model 2),
against the JAX package's single-device train step.

The port's side runs on 4 gloo rank processes, spawned once for the
module (``launch.mesh.run_ranks``): (1, 2) over ranks 0-1 and (2, 2)
over all four.  The JAX side runs in ONE subprocess
(``tests/mesh_families_reference.py``), which writes the reference's
weights first and its two steps' outputs after, and the fake-group dry
run in another (``tests/dry_mesh_probe.py families``), all side by
side.  The configs are reduced and float32 (``dry_mesh_probe.
count_cfg``): deepseek at a lossless expert capacity, rwkv6 at 8 heads,
zamba2 at 5 layers, 4 SSM heads and 4 attention heads.

Tolerances, as ``tests/test_torch_mesh.py`` holds granite and deepseek:
the loss is a float32 mean over 64 positions of terms ~6 (rtol 1e-5),
the clip's norm 1e-4, the params within 1e-5 x their leaf's largest
entry.  A leaf drawn as zeros (the LayerNorm biases, Mamba2's
``conv_b`` and ``dt_bias``) holds after two steps nothing but its two
Adam updates, each about lr x m / sqrt(v), so its largest entry is
their size: 1e-5 of it holds the updates themselves to 1e-5, finer than
their gradients allow.  Those are float32 sums that cancel, held by
``tests/test_torch_train.py`` to rtol 1e-4 with a floor of 1e-4 x the
leaf's largest gradient, i.e. to 1e-3 relative at an entry a tenth of
that size; Adam's update carries the gradient's relative error, and
where the second step's update cancels most of the first, the param is
a small difference of two.  The port on ONE device misses 1e-5 against
the reference by up to 1.0e-4 of such a leaf's largest entry, the mesh
by up to 5.7e-4.  Such a leaf is held within 1e-3 x its largest entry:
a tensor-parallel fault (a gradient not summed, or summed twice) moves
an update by its whole size.  Integer outputs (greedy tokens,
collective counts, bytes, FLOPs) are equal.
"""
import json
import os
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import mesh_families_reference as R  # noqa: E402
from dry_mesh_probe import COUNT_CELLS, FAMILY_ARCHS  # noqa: E402
from mesh_reference import TRAIN_LR  # noqa: E402
from test_torch_mesh import _sub_mesh  # noqa: E402
from test_torch_mesh_pod import _tree  # noqa: E402
from repro_torch import configs as tc  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import collectives as co  # noqa: E402
from repro_torch.distributed import sharding_rules as sr  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, run_ranks  # noqa: E402
from repro_torch.models import get_model, param_shapes  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.models.layers import mlp as tmlp  # noqa: E402
from repro_torch.models.layers import rwkv as trwkv  # noqa: E402
from repro_torch.models.layers import ssm as tssm  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.tree import paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = R.ARCHS
DECODE_ARCHS = FAMILY_ARCHS
DECODE_B, DECODE_P, DECODE_N = 4, 6, 6
# the leaves each family may still gather over ``model`` in a forward on
# (1, 2), and why: MLA's latent projections (their outputs feed q_norm /
# kv_norm over the whole latent: wkv_a's split at model 2 cuts its 40
# columns mid-latent); RWKV's decay LoRA's A (64 columns every head's
# decay reads), its time mix's Wo (split by output column, used by row:
# gathered and sliced, d^2 weights against 2 B S d activations) and its
# channel mix's gate Wr (applied whole after the reduction); the
# vocabulary of the recurrent families, whose embedding and head run
# whole; the experts' router.  Mamba2's in_proj and conv, whose splits
# cut [z | xBC | dt] mid-segment, are regrouped by an all-to-all
MAY_GATHER = {
    "deepseek-v2-236b": {"attn/wq_a", "attn/wkv_a", "moe/router"},
    "rwkv6-3b": {"tm/wA", "tm/Wo", "cm/Wr", "embed", "lm_head"},
    "zamba2-7b": {"embed", "lm_head"},
    "hubert-xlarge": set(),
}
# ... and the ones no rank may gather: the splits the forms consume
NEVER = {
    "deepseek-v2-236b": {"attn/wq_b", "attn/wk_b", "attn/wv_b", "attn/wo",
                         "mlp/w_gate", "mlp/w_up", "mlp/w_down"},
    "rwkv6-3b": {"tm/Wr", "tm/Wk", "tm/Wv", "tm/Wg", "tm/wB", "cm/w_up",
                 "cm/w_down"},
    "zamba2-7b": {"mamba/in_proj", "mamba/conv_w", "mamba/conv_b",
                  "mamba/out_proj", "mamba/norm_scale", "shared/attn/wq",
                  "shared/attn/wk", "shared/attn/wv", "shared/attn/wo",
                  "shared/mlp/w_gate", "shared/mlp/w_up",
                  "shared/mlp/w_down"},
    "hubert-xlarge": {"attn/wq", "attn/wk", "attn/wv", "attn/wo",
                      "mlp/w_up", "mlp/w_down"},
}


def _batches(cfg):
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in R.train_batches(cfg)]


def _train(cfg, weights, mesh, sp):
    """Two train steps from ``weights`` on ``mesh`` -> (losses, norms,
    the params gathered whole as numpy)."""
    opt_cfg = OptConfig(lr=TRAIN_LR, moment_dtype="float32")
    specs = steps.mesh_specs(cfg, mesh)
    loc = sr.shard_tree(_tree(weights), specs, mesh)
    opt = adamw_init(loc, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg, mesh=mesh,
                                 sequence_parallel=sp)
    losses, norms = [], []
    for b in _batches(cfg):
        loc, opt, m = step(loc, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    full = sr.gather_tree(loc, specs, mesh)
    return (losses, norms, {k: v.detach().numpy().copy()
                            for k, v in paths(full).items()})


def _gathers(cfg, weights, mesh):
    """The leaves one teacher-forced forward gathers over ``model``, and
    its collectives."""
    specs = steps.mesh_specs(cfg, mesh)
    loc = sr.shard_tree(_tree(weights), specs, mesh)
    batch = {k: v for k, v in _batches(cfg)[0].items() if k != "labels"}
    co.reset_counts()
    sr.model_gathers.clear()
    with torch.no_grad(), sr.activation_context(mesh, specs=specs):
        get_model(cfg).forward(loc, cfg, batch)
    return set(sr.model_gathers), dict(co.counts)


def _decode(cfg, params, mesh):
    """Greedy tokens of ``make_serve_step`` over ``init_cache``'s cache
    on ``mesh`` (None: one device): deepseek's prompts through
    ``make_prefill_step``'s batched prefill, the recurrent families'
    through one decode step a token."""
    g = torch.Generator().manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (DECODE_B, DECODE_P),
                            generator=g)
    if mesh is not None:
        params = sr.shard_tree(params, steps.mesh_specs(cfg, mesh), mesh)
    cache = steps.init_cache(cfg, DECODE_B, DECODE_P + DECODE_N, "cpu",
                             mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh=mesh)
    co.reset_counts()
    with torch.no_grad():
        if cfg.family == "moe":
            nxt, cache = steps.make_prefill_step(cfg, mesh=mesh)(
                params, cache, prompts)
        else:
            for t in range(DECODE_P):
                nxt, cache = serve(params, cache, prompts[:, t:t + 1])
        toks = [nxt]
        for _ in range(DECODE_N - 1):
            nxt, cache = serve(params, cache, nxt[:, None])
            toks.append(nxt)
    return torch.stack(toks, 1).numpy(), dict(co.counts)


def _rank(group, weights):
    torch.manual_seed(0)
    out = {"rank": group.rank}
    m22 = make_host_mesh(2, device="cpu")
    m12 = _sub_mesh(2, 2, "cpu")
    for arch in ARCHS:
        cfg = R.family_cfg(tc, arch)
        w = weights[arch]
        for sp in (False, True):
            out[(arch, "2x2", sp)] = _train(cfg, w, m22, sp)
            if m12 is not None:
                out[(arch, "1x2", sp)] = _train(cfg, w, m12, sp)
        if m12 is None:
            continue
        out[("gathers", arch)] = _gathers(cfg, w, m12)
        if arch in DECODE_ARCHS:
            params = _tree(w)
            out[("decode", arch)] = (_decode(cfg, params, None)[0],
                                     _decode(cfg, params, m12))
            for name, S, B, kind in COUNT_CELLS:
                for sp in (False, True):
                    co.reset_counts()
                    c = dryrun.count_cell(
                        cfg, ShapeSpec(name, S, B, kind), device="cpu",
                        on=dryrun.MeshArgs(m12, sp, "fsdp_tp"))
                    out[("count", arch, name, sp)] = {
                        "counts": dict(co.counts),
                        "nbytes": dict(co.nbytes),
                        "flops": c.counter.flops, "args": c.args}
    return out


@pytest.fixture(scope="module")
def run():
    """-> (the reference's outputs, its weights by arch, the 4 ranks'
    results, the fake group's counts), the two subprocesses and the
    ranks side by side."""
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "weights.npz")
        opath = os.path.join(tmp, "out.npz")
        cpath = os.path.join(tmp, "counts.json")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        logs = {n: os.path.join(tmp, f"{n}.log") for n in ("ref", "dry")}

        def tail(name):
            with open(logs[name]) as f:
                return f.read()[-3000:]
        procs = {}
        for name, argv in (("ref", ["mesh_families_reference.py", wpath,
                                    opath]),
                           ("dry", ["dry_mesh_probe.py", "families",
                                    cpath])):
            with open(logs[name], "w") as f:
                procs[name] = subprocess.Popen(
                    [sys.executable, os.path.join(ROOT, "tests", argv[0])]
                    + argv[1:], env=env, stdout=f, stderr=subprocess.STDOUT)
        try:
            t0 = time.time()
            while not os.path.exists(wpath):
                assert procs["ref"].poll() is None, tail("ref")
                assert time.time() - t0 < 300, "no reference weights"
                time.sleep(0.2)
            with np.load(wpath) as f:
                flat = {k: f[k] for k in f.files}
            weights = {a: {k[len(a) + 1:]: v for k, v in flat.items()
                           if k.startswith(a + "/")} for a in ARCHS}
            ranks = run_ranks(_rank, 4, "cpu", weights)
            for name, proc in procs.items():
                assert proc.wait(timeout=600) == 0, tail(name)
            assert "MESH_FAMILIES_REFERENCE_OK" in tail("ref")
            with np.load(opath) as f:
                ref = {k: f[k] for k in f.files}
            with open(cpath) as f:
                dry = json.load(f)
            yield ref, weights, ranks, dry
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _params_close(got, want, weights0):
    """Every leaf within 1e-5 x its largest entry, a leaf drawn as zeros
    within 1e-3 x (the module's docstring)."""
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-30)
        tol = (1e-5 if np.abs(weights0[k]).any() else 1e-3) * scale
        err = float(np.abs(got[k] - w).max())
        assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("name", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_family_train_step_matches_reference(run, arch, name, sp):
    """Two float32 train steps on the mesh, sequence parallelism off and
    on, against the reference's single-device ``make_loss_fn`` +
    ``jax.value_and_grad`` + ``adamw_update`` (deepseek on (2, 2): each
    data shard's expert capacity and load-balance loss, the shards'
    gradients averaged): the losses, the clip's norms, the params
    gathered after the second step."""
    ref, weights, ranks, _ = run
    dp = 2 if (name == "2x2" and arch == "deepseek-v2-236b") else 1
    pre = f"{arch}/dp{dp}"
    want = {k[len(pre) + 8:]: ref[k] for k in ref
            if k.startswith(pre + "/params/")}
    members = ranks[:2] if name == "1x2" else ranks
    for r in members:
        losses, norms, full = r[(arch, name, sp)]
        for s in range(2):
            np.testing.assert_allclose(losses[s], ref[f"{pre}/loss/{s}"],
                                       rtol=1e-5)
            np.testing.assert_allclose(norms[s], ref[f"{pre}/gnorm/{s}"],
                                       rtol=1e-4)
        _params_close(full, want, weights[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_family_consumes_its_model_splits(run, arch):
    """One forward on (1, 2): the leaves gathered over ``model`` lie in
    the family's named list, and none of the splits its tensor-parallel
    form consumes is gathered; the region's collectives ran (a
    reduction closing each tensor-parallel layer)."""
    _, _, ranks, _ = run
    for r in ranks[:2]:
        gathered, counts = r[("gathers", arch)]
        assert gathered <= MAY_GATHER[arch], gathered - MAY_GATHER[arch]
        assert not gathered & NEVER[arch], gathered & NEVER[arch]
        assert counts.get("all_reduce_sum", 0) > 0, counts
        if arch == "zamba2-7b":
            # a mamba layer: one sum of squares, and in_proj, conv_w and
            # conv_b regrouped by an all-to-all each
            n = R.family_cfg(tc, arch).n_layers
            assert counts["all_reduce_partial"] == n, counts
            assert counts["regroup"] == 3 * n, counts


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_family_decode_tokens_equal_one_device(run, arch):
    """Greedy tokens of the static decode on (1, 2) (``make_serve_step``
    over ``init_cache``'s cache; deepseek prefilled in one batched
    dispatch through the head-parallel ``mla_prefill``, then
    ``mla_decode`` by head; zamba2's shared attention over the
    sequence-sharded ring, its mamba layers whole; rwkv6 whole) equal
    one device's."""
    _, _, ranks, _ = run
    for r in ranks[:2]:
        single, (toks, counts) = r[("decode", arch)]
        np.testing.assert_array_equal(toks, single)
        if arch == "zamba2-7b":
            assert counts["flash_merge"] > 0, counts
        if arch == "deepseek-v2-236b":
            assert counts["all_reduce_sum"] > 0, counts


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("cell", [c[0] for c in COUNT_CELLS])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_dry_run_counts_equal_real_ranks(run, arch, cell, sp):
    """The fake-group dry run of each rank of (1, 2) counts what that
    rank counts running the same step for real: the collectives by
    name, their bytes by kind, op_cost's FLOPs and the argument bytes,
    exactly."""
    _, _, ranks, dry = run
    for r in ranks[:2]:
        got = dry[f"{arch}|{cell}|{sp}|{r['rank']}"]
        want = r[("count", arch, cell, sp)]
        assert got["counts"] == want["counts"]
        assert got["nbytes"] == want["nbytes"]
        assert got["flops"] == want["flops"]
        assert got["args"] == want["args"]


def _pod_specs(arch):
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 16, "model": 16})
    cfg = tc.get_config(arch)
    specs = sr.param_sharding(param_shapes(cfg), mesh,
                              moe_mode=sr.moe_mode_of(cfg))
    return cfg, specs


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "rwkv6-3b",
                                  "zamba2-7b"])
def test_tp_keep_at_the_pod(arch):
    """At the pod's model 16 under ``"fsdp_tp"``: deepseek's 128 heads
    and zamba2's 112 SSM heads and 32 attention heads divide, and every
    split their forms consume is kept, on the dim it lies on; rwkv6-3b's
    40 heads do not, so its time mix stays gathered whole while its
    channel mix (MoR off) is kept; a MoR plan keeps RWKV's channel mix
    whole too."""
    cfg, specs = _pod_specs(arch)
    if arch == "deepseek-v2-236b":
        lspec = sr.layer_specs(specs["moe_layers"])
        assert tattn.tp_keep(cfg, lspec["attn"], 16) == {
            "attn/wq_b": -1, "attn/wk_b": -1, "attn/wv_b": -1,
            "attn/wo": -2}
        assert tattn.tp_keep(cfg.replace(n_heads=40), lspec["attn"],
                             16) == {}
    elif arch == "rwkv6-3b":
        lspec = sr.layer_specs(specs["layers"])
        assert trwkv._heads(cfg)[0] == 40
        assert trwkv.tp_keep(cfg, lspec, 16, False) == {"cm/w_up": -1,
                                                        "cm/w_down": -2}
        assert trwkv.tp_keep(cfg, lspec, 16, True) == {}
        assert trwkv.tp_keep(cfg, lspec, 8, False) == {
            "tm/Wr": -1, "tm/Wk": -1, "tm/Wv": -1, "tm/Wg": -1,
            "tm/wB": -1, "cm/w_up": -1, "cm/w_down": -2}
    else:
        lspec = sr.layer_specs(specs["mamba_layers"])
        assert tssm.tp_keep(cfg, lspec["mamba"], 16) == {
            "mamba/in_proj": -1, "mamba/conv_w": -1, "mamba/conv_b": -1,
            "mamba/norm_scale": -1, "mamba/out_proj": -2}
        sp = specs["shared"]
        assert tattn.tp_keep(cfg, sp["attn"], 16, "shared/attn/") == {
            "shared/attn/wq": -1, "shared/attn/wk": -1,
            "shared/attn/wv": -1, "shared/attn/wo": -2}
        assert tmlp.tp_keep(sp["mlp"], False, "shared/mlp/") == {
            "shared/mlp/w_gate": -1, "shared/mlp/w_up": -1,
            "shared/mlp/w_down": -2}
