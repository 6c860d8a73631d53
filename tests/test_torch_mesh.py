"""The port's ``(data, model)`` mesh against the JAX package: the
overlapped collectives, expert slicing (``moe_apply_a2a``) in every MoR
mode, the sequence-sharded decode, the FSDP + tensor-parallel train
step, re-placed checkpoints and the train CLI on ranks.

The port's side runs on 4 gloo rank processes, spawned once for the
module (``launch.mesh.run_ranks``): a (data 2, model 2) host mesh over
all four, (1, 2) over ranks 0-1, (1, 4) over all four, and rings of 2, 3
and 4 ranks.  The JAX side runs in ONE subprocess over 8 host devices
(``tests/mesh_reference.py``), which writes the reference's weights
first (carried over by ``repro_torch.convert``'s layout: the same trees)
and its outputs after, while the ranks run.

Tolerances: integers (dispatch slots, expert counts, greedy tokens,
collective counts) are equal.  The overlapped matmuls sum float32
products in another order: 1e-5.  MoE outputs compose a router softmax
and three float32 matmuls an expert in other orders, and the reference
test's own bound holds (rtol 2e-4, atol 2e-3).  The decode's flash
merge is one softmax over at most 16 keys, merged in rank order: 1e-5.
Training: the loss is a float32 mean over 64 positions of terms ~6:
1e-5 relative; AdamW's first step is sign(g) x lr, so a parameter whose
gradient is float32 noise (a key bias: the softmax cannot see it) may
flip; the params are held within 1e-5 x their leaf's largest entry,
counting the entries of a leaf whose reference gradient is below 1e-6
apart.  A checkpoint restores bit for bit.
"""
import contextlib
import io
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))
import mesh_reference as R  # noqa: E402
from repro_torch import configs as tc  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.executor import MoRExecutionPlan  # noqa: E402
from repro_torch.distributed import collectives as co  # noqa: E402
from repro_torch.distributed import sharding_rules as sr  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.mesh import (HostMesh, PageGroup,  # noqa: E402
                                     make_host_mesh, run_ranks)
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.tree import paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_TOL = dict(rtol=2e-4, atol=2e-3)
TRAIN_SHAPES = {"granite-3-2b": ((2, 2), (1, 2)),
                "deepseek-v2-236b": ((2, 2), (1, 2))}


def _tree(arrays, prefix):
    """The nested dict of the npz entries under ``prefix/``, as tensors."""
    out = {}
    for key in arrays:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(arrays[key]))
    return out


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in paths(tree).items()}


# -- the rank side ------------------------------------------------------------

def _sub_mesh(p, mp, device):
    """The (p / mp, mp) mesh over world ranks 0..p-1, laid out as
    ``make_host_mesh`` lays out the world's; None on the other ranks.
    Every rank calls it (``dist.new_group`` is collective)."""
    dp, me, backend = p // mp, dist.get_rank(), dist.get_backend()
    rows = [dist.new_group(list(range(i * mp, (i + 1) * mp)))
            if mp > 1 else None for i in range(dp)]
    cols = [dist.new_group(list(range(j, p, mp))) if dp > 1 else None
            for j in range(mp)]
    world = dist.new_group(list(range(p)))
    if me >= p:
        return None
    di, mi = divmod(me, mp)
    groups = {"model": PageGroup(mi, mp, rows[di], device, backend),
              "data": PageGroup(di, dp, cols[mi], device, backend),
              "world": PageGroup(me, p, world, device, backend)}
    return HostMesh(("data", "model"), {"data": dp, "model": mp}, rank=me,
                    coords={"data": di, "model": mi}, groups=groups,
                    device=device, backend=backend)


def _collectives(out, inp, rings):
    x, w = torch.from_numpy(inp["coll_x"]), torch.from_numpy(inp["coll_w"])
    for p, mesh in rings.items():
        if mesh is None:
            continue
        j = mesh.index("model")
        kb = w.shape[0] // p
        co.reset_counts()
        got = co.ag_matmul_overlapped(x, w[j * kb:(j + 1) * kb], mesh)
        out[f"ag/{p}"] = (got.numpy(), dict(co.counts))
        if p in R.PSUM_P:
            co.reset_counts()
            got = co.psum_scatter_matmul(x[:, j * kb:(j + 1) * kb],
                                         w[j * kb:(j + 1) * kb], mesh)
            out[f"psum/{p}"] = (got.numpy(), dict(co.counts))
        # rank r's blocks are r * 1000 + their place: a reshard whose
        # backward is its inverse gives each x its own values back
        xa = (torch.arange(2 * p * 3, dtype=torch.float32).reshape(2 * p, 3)
              + 1000.0 * j).requires_grad_(True)
        co.reset_counts()
        ya = co.all_to_all_dim(xa, 0, 1, mesh.group("model"))
        (0.5 * (ya ** 2).sum()).backward()
        out[f"a2a_dim/{p}"] = (ya.detach().numpy(),
                               bool(torch.equal(xa.grad, xa.detach())),
                               dict(co.counts))


def _moe_case(out, weights, tag, E, mesh):
    """moe_apply on this rank's rows as the layer loop hands it its
    weights (``moe.tp_keep`` + ``sharding_rules.use``)."""
    base = R.moe_cfg(tc, E, R.MOE_CF["lossless"]).replace(
        expert_sharding="ep_shmap")
    params = {"moe": _tree(weights, f"{tag}/params")}
    x = np.random.default_rng(E).normal(
        size=R.MOE_X + (base.d_model,)).astype(np.float32)
    dp, di = mesh.shape["data"], mesh.index("data")
    xl = torch.from_numpy(x.reshape(dp, -1, *x.shape[1:])[di])
    T_loc = xl.shape[0] * xl.shape[1]
    specs = sr.param_sharding(params, mesh, moe_mode="ep_shmap")
    loc = sr.shard_tree(params, specs, mesh)
    em = {k: torch.from_numpy(v) for k, v in
          R.truth_proxy(base.moe_d_ff, E).items()}
    for cf_name, cf in R.MOE_CF.items():
        cfg = base.replace(capacity_factor=cf)
        modes = R.MOE_MODES if tag == "a2a" else ("dense",)
        plans = {m: None if m == "dense" else {"experts": em}
                 for m in modes}
        if tag == "a2a":
            plans["capped"] = {"experts": MoRExecutionPlan(
                em, mode="kernel", tile_m=4, tile_n=16,
                cap_live=torch.full((E,), R.MOE_CAP))}
        for mode, mor in plans.items():
            with sr.activation_context(mesh, specs=specs):
                keep = tmoe.tp_keep(cfg, specs["moe"], mesh, T_loc, False,
                                    mor is not None)
                lp = sr.use(loc, specs, keep)["moe"]
                co.reset_counts()
                y, aux = tmoe.moe_apply(lp, cfg, xl, mor=mor,
                                        mor_mode="dense" if mor is None
                                        else mode)
            out[f"{tag}/{cf_name}/{mode}"] = (y.numpy(), dict(co.counts),
                                              float(aux["lb_loss"]))
        # this data shard's routing and slots, as moe_apply_a2a takes them
        xf = xl.reshape(-1, base.d_model)
        C_loc = max(int(cf * T_loc * R.MOE_K / E), 1)
        _, _, top = tmoe._route(xf, params["moe"]["router"], R.MOE_K)
        out[f"{tag}/{cf_name}/slot"] = tmoe._dispatch_indices(
            top, E, C_loc).numpy()
        out[f"{tag}/{cf_name}/counts"] = tmoe._count(
            top.reshape(-1), E).numpy()


def _decode_case(out, inp, mesh, name):
    q, k, v = (torch.from_numpy(inp[n]) for n in ("dec_q", "dec_k",
                                                  "dec_v"))
    tags = torch.from_numpy(inp["dec_pos"])
    dp, di = mesh.shape["data"], mesh.index("data")
    g = mesh.group("model")
    rows = R.DEC_LR // g.size
    sl = slice(g.rank * rows, (g.rank + 1) * rows)
    b = slice(di * R.DEC_B // dp, (di + 1) * R.DEC_B // dp)
    for window in R.DEC_WINDOWS:
        co.reset_counts()
        o = tattn._tp_flash_decode(q[b], k[b, sl], v[b, sl], tags[sl],
                                   torch.tensor([R.DEC_POS]), window, g)
        out[f"dec/{name}/{window}"] = (o.numpy(), dict(co.counts))


def _gen_case(out, weights, mesh, name):
    cfg = R.f32_cfg(tc, "granite-3-2b")
    params = _tree(weights, "granite/params")
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (R.GEN_B, R.GEN_P)).astype(np.int32))
    specs = steps.mesh_specs(cfg, mesh)
    loc = sr.shard_tree(params, specs, mesh)
    cache = steps.init_cache(cfg, R.GEN_B, R.GEN_P + R.GEN_N + 2, "cpu",
                             mesh=mesh)
    prefill = steps.make_prefill_step(cfg, mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh=mesh)
    co.reset_counts()
    nxt, cache = prefill(loc, cache, prompts)
    toks = [nxt]
    for _ in range(R.GEN_N - 1):
        nxt, cache = serve(loc, cache, nxt[:, None])
        toks.append(nxt)
    out[f"gen/{name}"] = (torch.stack(toks, 1).numpy(), dict(co.counts),
                          {k: tuple(v.shape) for k, v in
                           paths(cache["layers"]).items()})


def _train_case(out, weights, arch, mesh, name, ckpt_dir=None):
    cfg = R.f32_cfg(tc, arch)
    if arch == "deepseek-v2-236b":
        cfg = cfg.replace(capacity_factor=float(cfg.n_experts) / cfg.top_k)
    opt_cfg = OptConfig(lr=R.TRAIN_LR, moment_dtype="float32")
    params = _tree(weights, f"train/{arch}/params0")
    specs = steps.mesh_specs(cfg, mesh)
    loc = sr.shard_tree(params, specs, mesh)
    opt = adamw_init(loc, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg, mesh=mesh)
    losses, norms = [], []
    co.reset_counts()
    for b in R.train_batches(cfg.vocab_size):
        loc, opt, m = step(loc, opt, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts = dict(co.counts)
    norm_scales = {k: v.numpy().copy() for k, v in paths(loc).items()
                   if k.endswith("scale") or k.endswith("bias")}
    full = sr.gather_tree(loc, specs, mesh)
    out[f"train/{arch}/{name}"] = (losses, norms, _np(full), counts,
                                   norm_scales)
    if ckpt_dir is not None:
        state = {"params": loc, "opt": opt}
        state_specs = {"params": specs, "opt": steps.opt_specs(opt, specs)}
        CheckpointManager(ckpt_dir).save(2, state, shardings=state_specs,
                                         mesh=mesh)
    return cfg, opt_cfg


def _restore_case(out, ckpt_dir, mesh, name):
    """Restore the (2, 2) run's checkpoint into this mesh's blocks of a
    freshly drawn state."""
    from repro_torch.models import get_model
    cfg = R.f32_cfg(tc, "granite-3-2b")
    opt_cfg = OptConfig(lr=R.TRAIN_LR, moment_dtype="float32")
    specs = steps.mesh_specs(cfg, mesh)
    loc = sr.shard_tree(get_model(cfg).init(
        torch.Generator().manual_seed(5), cfg), specs, mesh)
    opt = adamw_init(loc, opt_cfg)
    state_specs = {"params": specs, "opt": steps.opt_specs(opt, specs)}
    state, extra = CheckpointManager(ckpt_dir).restore(
        {"params": loc, "opt": opt}, shardings=state_specs, mesh=mesh)
    full = sr.gather_tree(state["params"], specs, mesh)
    out[f"restore/{name}"] = (_np(full), extra["step"],
                              {k: tuple(v.shape) for k, v in
                               paths(state["params"]).items()})


def _rank(group, weights, ckpt_dir):
    torch.manual_seed(0)
    out = {"rank": group.rank}
    inp = R.inputs()
    m22 = make_host_mesh(2, device=group.device)
    m12 = _sub_mesh(2, 2, group.device)
    m14 = make_host_mesh(4, device=group.device)
    rings = {p: _sub_mesh(p, p, group.device) for p in R.COLL_P}
    _collectives(out, inp, rings)
    _moe_case(out, weights, "a2a", R.MOE_E, m22)
    _moe_case(out, weights, "fslice", R.FSLICE_E, m14)
    _decode_case(out, inp, m22, "2x2")
    _gen_case(out, weights, m22, "2x2")
    for arch in TRAIN_SHAPES:
        _train_case(out, weights, arch, m22, "2x2",
                    ckpt_dir if arch == "granite-3-2b" else None)
    if m12 is not None:
        _decode_case(out, inp, m12, "1x2")
        _gen_case(out, weights, m12, "1x2")
        for arch in TRAIN_SHAPES:
            _train_case(out, weights, arch, m12, "1x2")
        _restore_case(out, ckpt_dir, m12, "1x2")
    return out


@pytest.fixture(scope="module")
def run():
    """-> (the reference's outputs, its weights, the 4 ranks' results,
    the checkpoint directory), the subprocess and the ranks side by
    side."""
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "weights.npz")
        opath = os.path.join(tmp, "out.npz")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        log = os.path.join(tmp, "reference.log")

        def tail():
            with open(log) as f:
                return f.read()[-3000:]
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests",
                                              "mesh_reference.py"),
                 wpath, opath], env=env, stdout=out,
                stderr=subprocess.STDOUT)
        try:
            t0 = time.time()
            while not os.path.exists(wpath):
                assert proc.poll() is None, tail()
                assert time.time() - t0 < 300, "no reference weights"
                time.sleep(0.2)
            with np.load(wpath) as f:
                weights = {k: f[k] for k in f.files}
            ckpt = os.path.join(tmp, "ckpt")
            ranks = run_ranks(_rank, 4, "cpu", weights, ckpt)
            assert proc.wait(timeout=600) == 0, tail()
            assert "MESH_REFERENCE_OK" in tail()
            with np.load(opath) as f:
                ref = {k: f[k] for k in f.files}
            yield ref, weights, ranks, ckpt
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


# -- the tests ------------------------------------------------------------------

@pytest.mark.parametrize("p", R.COLL_P)
def test_ag_matmul_overlapped(run, p):
    """Every ring member's x @ w from its own K block equals the
    reference's and torch.matmul's; the ring moves (P + 1) // 2 + (0 if
    P odd else 1) - 1 shard pairs (the reference's last permute, whose
    pair it discards, is not issued)."""
    ref, _, ranks, _ = run
    inp = R.inputs()
    want = inp["coll_x"] @ inp["coll_w"]
    steps_ = (p + 1) // 2 + (0 if p % 2 else 1)
    for r in ranks[:p]:
        got, counts = r[f"ag/{p}"]
        np.testing.assert_allclose(got, ref[f"ag/{p}"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert counts == {"ag_matmul_overlapped": steps_ - 1}, counts


@pytest.mark.parametrize("p", R.PSUM_P)
def test_psum_scatter_matmul(run, p):
    """Rank j's block of columns of the sum, as the reference's."""
    ref, _, ranks, _ = run
    inp = R.inputs()
    n = inp["coll_w"].shape[1] // p
    for j, r in enumerate(ranks[:p]):
        got, counts = r[f"psum/{p}"]
        np.testing.assert_allclose(got, ref[f"psum/{p}"][:, j * n:(j + 1)
                                                          * n],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(
            got, (inp["coll_x"] @ inp["coll_w"])[:, j * n:(j + 1) * n],
            rtol=1e-5, atol=1e-5)
        assert counts == {"psum_scatter_matmul": 1}


@pytest.mark.parametrize("p", R.COLL_P)
def test_all_to_all_dim(run, p):
    """Rank j receives block j (rows [2j, 2j + 2)) of every rank's x, set
    side by side in rank order; the backward sends each gradient block
    back where it came from, bit for bit; one all-to-all each way."""
    _, _, ranks, _ = run
    base = np.arange(2 * p * 3, dtype=np.float32).reshape(2 * p, 3)
    for j, r in enumerate(ranks[:p]):
        y, grad_is_x, counts = r[f"a2a_dim/{p}"]
        want = np.concatenate([base[2 * j:2 * j + 2] + 1000.0 * s
                               for s in range(p)], 1)
        np.testing.assert_array_equal(y, want)
        assert grad_is_x
        assert counts == {"all_to_all_dim": 1, "all_to_all_dim.grad": 1}


@pytest.mark.parametrize("cf", list(R.MOE_CF))
@pytest.mark.parametrize("mode", R.MOE_MODES + ("capped",))
def test_moe_apply_a2a_matches_reference(run, mode, cf):
    """Expert slicing on (data 2, model 2), E 4 (2 a rank): each data
    rank's rows of y equal the reference's ``moe_apply_a2a`` on the same
    mesh, in every mode (the kernels' plain versions), lossless and
    lossy, and with a per-expert ``cap_live`` of 0.25 in kernel mode;
    one ``all_reduce_sum`` over ``model`` a call, and one all-to-all an
    expert weight (each rank gets only its own experts' other f
    blocks), the two model ranks' y bit-equal; each shard's slots and
    expert counts exact."""
    ref, weights, ranks, _ = run
    want = ref[f"a2a/{cf}/{mode}/y"]
    n_expert_leaves = sum(f"a2a/params/{n}" in weights
                          for n in ("w_gate", "w_up", "w_down"))
    for r in ranks:
        di = r["rank"] // 2
        y, counts, _ = r[f"a2a/{cf}/{mode}"]
        rows = want.reshape(2, -1, *want.shape[1:])[di]
        np.testing.assert_allclose(y, rows, **MOE_TOL)
        assert counts.get("all_reduce_sum") == 1, counts
        assert counts.get("all_to_all_dim") == n_expert_leaves, counts
        assert "all_gather_dim" not in counts, counts
        np.testing.assert_array_equal(r[f"a2a/{cf}/slot"],
                                      ref[f"a2a/{cf}/slot/{di}"])
        np.testing.assert_array_equal(r[f"a2a/{cf}/counts"],
                                      ref[f"a2a/{cf}/counts/{di}"])
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(ranks[a][f"a2a/{cf}/{mode}"][0],
                                      ranks[b][f"a2a/{cf}/{mode}"][0])
    if mode == "capped":
        dense = ref[f"a2a/{cf}/dense/y"]
        assert np.abs(want - dense).max() > 1e-4, "cap_live did not engage"


@pytest.mark.parametrize("cf", list(R.MOE_CF))
def test_moe_apply_a2a_f_slicing(run, cf):
    """E 6 over model 4 (1, 4): every rank runs all experts on its f / 4
    columns, one all-reduce; y equals the reference's."""
    ref, _, ranks, _ = run
    want = ref[f"fslice/{cf}/dense/y"]
    for r in ranks:
        y, counts, _ = r[f"fslice/{cf}/dense"]
        np.testing.assert_allclose(y, want, **MOE_TOL)
        assert counts.get("all_reduce_sum") == 1, counts
        np.testing.assert_array_equal(r[f"fslice/{cf}/slot"],
                                      ref[f"fslice/{cf}/slot/0"])


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_tp_flash_decode(run, name):
    """The sequence-sharded decode (rank j: ring rows [8 j, 8 j + 8)) over
    ``flash_merge``'s one collective, against the single-device
    attention over the whole ring (jax 0.9.0 refuses the reference's
    ``_tp_flash_decode`` under an explicit mesh), with and without a
    window of 6; the model ranks' outputs bit-equal."""
    ref, _, ranks, _ = run
    members = ranks[:2] if name == "1x2" else ranks
    for window in R.DEC_WINDOWS:
        want = ref[f"dec/single/{window}"]
        for r in members:
            o, counts = r[f"dec/{name}/{window}"]
            dp = 1 if name == "1x2" else 2
            di = r["rank"] // 2 if dp == 2 else 0
            b = want.shape[0] // dp
            np.testing.assert_allclose(o, want[di * b:(di + 1) * b],
                                       rtol=1e-5, atol=1e-5)
            assert counts == {"flash_merge": 1}, counts
        np.testing.assert_array_equal(members[0][f"dec/{name}/{window}"][0],
                                      members[1][f"dec/{name}/{window}"][0])


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_sharded_decode_greedy_tokens_exact(run, name):
    """Reduced float32 granite, 8 prompts, prefill + 7 greedy steps under
    the mesh (tensor-parallel attention and FFN, vocabulary-parallel
    embedding and head, the ring's rows split over model): the tokens
    equal the reference's single-device decode; one merge a layer a
    step; each rank's ring holds half the rows."""
    ref, _, ranks, _ = run
    members = ranks[:2] if name == "1x2" else ranks
    want = ref["gen/tokens"]
    cfg = R.f32_cfg(tc, "granite-3-2b")
    for r in members:
        toks, counts, shapes = r[f"gen/{name}"]
        np.testing.assert_array_equal(toks, want)
        assert counts["flash_merge"] == cfg.n_layers * (R.GEN_N - 1)
        assert shapes["k"][2] == (R.GEN_P + R.GEN_N + 2) // 2
        assert shapes["ring_lo"] == (cfg.n_layers,)


def _params_close(got, want, grads_tiny=()):
    for k, w in want.items():
        g = got[k]
        tol = 1e-5 * max(float(np.abs(w).max()), 1e-30)
        bad = np.abs(g - w) > tol
        assert not bad.any() or k in grads_tiny, \
            (k, float(np.abs(g - w).max()), tol)


@pytest.mark.parametrize("name", ["2x2", "1x2"])
@pytest.mark.parametrize("arch", list(TRAIN_SHAPES))
def test_sharded_train_step_matches_reference(run, arch, name):
    """Two train steps on the mesh (FSDP gather-on-use, tensor-parallel
    GQA / FFN / vocabulary, expert slicing for deepseek at a lossless
    capacity, head-parallel MLA) against the reference's
    ``make_loss_fn`` + ``jax.value_and_grad`` + ``adamw_update`` with
    the data shards' gradients averaged (deepseek's expert capacity and
    load-balance loss are each shard's, as in ``moe_apply_a2a``): the
    losses, the clip's norms, the params after gathering; the
    replicated norms' params bit-equal on the two model ranks."""
    ref, _, ranks, _ = run
    dp = 2 if (name == "2x2" and arch == "deepseek-v2-236b") else 1
    pre = f"train/{arch}/dp{dp}"
    want = {k[len(pre) + 8:]: ref[k] for k in ref
            if k.startswith(pre + "/params/")}
    # a key bias cannot move the loss: its gradient is float32 noise
    tiny = {k for k in want if k.endswith("/bk")}
    members = ranks[:2] if name == "1x2" else ranks
    for r in members:
        losses, norms, full, counts, local = r[f"train/{arch}/{name}"]
        for s in range(2):
            np.testing.assert_allclose(losses[s], ref[f"{pre}/loss/{s}"],
                                       rtol=1e-5)
            np.testing.assert_allclose(norms[s], ref[f"{pre}/gnorm/{s}"],
                                       rtol=1e-4)
        _params_close(full, want, tiny)
        assert counts.get("all_reduce_sum", 0) > 0
    for a, b in ((0, 1), (2, 3))[:len(members) // 2]:
        la, lb = (members[i][f"train/{arch}/{name}"][4] for i in (a, b))
        for k in la:
            if "norm" in k or "ln" in k:
                np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_checkpoint_replaces_across_meshes(run):
    """Saved on (2, 2) (rank 0 writes the gathered leaves), restored on
    (1, 2) and in one process: every leaf bit-equal to the (2, 2) run's
    gathered params; the reference's ``CheckpointManager.restore``
    loads the same step."""
    import jax
    from repro import configs as jc
    from repro.checkpoint import CheckpointManager as JManager
    from repro.models import get_model as jget_model
    _, weights, ranks, ckpt = run
    saved = ranks[0]["train/granite-3-2b/2x2"][2]
    for r in ranks[:2]:
        full, step, local = r["restore/1x2"]
        assert step == 2
        for k, v in saved.items():
            np.testing.assert_array_equal(full[k], v, err_msg=k)
        assert local["layers/attn/wq"][-1] * 2 == saved[
            "layers/attn/wq"].shape[-1]
    cfg = R.f32_cfg(tc, "granite-3-2b")
    params = _tree(weights, "train/granite-3-2b/params0")
    opt = adamw_init(params, OptConfig(moment_dtype="float32"))
    state, extra = CheckpointManager(ckpt).restore({"params": params,
                                                    "opt": opt})
    assert extra["step"] == 2
    for k, v in paths(state["params"]).items():
        np.testing.assert_array_equal(v.numpy(), saved[k], err_msg=k)
    jcfg = R.f32_cfg(jc, "granite-3-2b")
    jp = jax.eval_shape(lambda: jget_model(jcfg).init(
        jax.random.PRNGKey(0), jcfg))
    tmpl = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), jp)
    jstate, jextra = JManager(ckpt).restore({"params": tmpl})
    assert jextra["step"] == 2
    flat, _ = jax.tree_util.tree_flatten_with_path(jstate["params"])
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_array_equal(np.asarray(leaf), saved[key],
                                      err_msg=key)
    assert cfg.n_layers == jcfg.n_layers


def test_train_cli_on_ranks_follows_one_process():
    """``--ranks 2 --model-parallel 2`` on the CPU: the losses follow
    ``--model-parallel 1``'s within 1e-4; rank 0 reports the mesh."""
    base = ["--device", "cpu", "--reduced", "--steps", "3", "--batch", "4",
            "--seq", "16"]
    with contextlib.redirect_stdout(io.StringIO()):
        one = ttrain.main(base)
        two = ttrain.main(base + ["--ranks", "2", "--model-parallel", "2"])
    assert two["mesh"] == {"data": 1, "model": 2}
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-4)
    with pytest.raises(ValueError, match="not a multiple"):
        ttrain.main(base + ["--ranks", "3", "--model-parallel", "2"])


def test_remat_recompute_keeps_the_mesh_context():
    """A rematerialised block is recomputed by the autograd engine, on a
    thread of its own for a CUDA backward: run the backward from another
    thread (one process, a one-rank mesh) and the recompute still sees
    the context (``sharding_rules.bind``)."""
    import threading
    cfg = R.f32_cfg(tc, "granite-3-2b", remat="nothing_saveable")
    mesh = make_host_mesh(1)
    from repro_torch.models import get_model
    params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg)
    for p in paths(params).values():
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with sr.activation_context(mesh, specs=steps.mesh_specs(cfg, mesh)):
        loss = get_model(cfg).forward(params, cfg, {"tokens": tokens})[
            0].float().square().mean()
    box = {}

    def backward():
        try:
            box["g"] = torch.autograd.grad(loss, list(paths(params).values()))
        except Exception as e:          # re-raised below
            box["e"] = e
    t = threading.Thread(target=backward)
    t.start()
    t.join()
    assert "e" not in box, box.get("e")
    want = torch.autograd.grad(get_model(cfg).forward(
        params, cfg, {"tokens": tokens})[0].float().square().mean(),
        list(paths(params).values()))
    for a, b in zip(box["g"], want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
