"""The ``"contract_tp"`` param layout on the ``(data, model)`` mesh: its
contraction splits moved onto the dims the tensor-parallel forms
consume (``sharding_rules.use``), against the JAX package's
single-device train step.

``"contract_tp"`` (the reference's ``_PARAM_RULES_CONTRACT``) splits
``wq`` / ``wk`` / ``wv``, ``w_gate`` / ``w_up``, ``in_proj``, ``lm_head``
and the ``moe_tp`` experts' up projections on their input dim, and
``wo``, ``w_down``, ``out_proj`` on their output dim.  Each layer moves
them with one all-to-all over ``model`` onto the heads or columns its
form consumes, so that GQA, the dense FFN (MoR off), Mamba2, zamba2's
shared block, hubert's encoder, mixtral's experts and the head run on
the rank's own heads or columns, as under ``"fsdp_tp"``.

The port's side runs on 4 gloo rank processes, spawned once for the
module (``launch.mesh.run_ranks``): (1, 2) over ranks 0-1 and (2, 2)
over all four.  The JAX side runs in two subprocesses, each over half
the configs (``tests/mesh_contract_reference.py``: its compiles are
most of its time), which write the reference's weights first (the
ranks wait for them) and its two steps' outputs after.  The configs are
reduced and float32 (``mesh_contract_reference.contract_cfg``):
granite-3-2b as reduced and with one kv head (which does not divide
over model 2: ``wk`` / ``wv`` are then gathered whole), qwen2-7b (its
qkv biases replicated, each rank taking its heads' slice), zamba2-7b,
hubert-xlarge and mixtral-8x7b.

Tolerances, as ``tests/test_torch_mesh_families.py`` holds the
``"fsdp_tp"`` families: the loss rtol 1e-5, the clip's norm 1e-4, the
params within 1e-5 x their leaf's largest entry; a leaf drawn as zeros
(LayerNorm biases, Mamba2's ``conv_b``, ``dt_bias`` and ``A_log``, the
qkv biases) within 1e-3 x its largest entry, and a key bias, whose
gradient is float32 noise the softmax cannot see, apart
(``tests/test_torch_mesh.py``).  Integer outputs are equal: greedy
tokens, the kernel-mode forward's tile masks and counters, the moves'
counts and bytes.
"""
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import mesh_contract_reference as R  # noqa: E402
from mesh_families_reference import train_batches  # noqa: E402
from mesh_reference import TRAIN_LR  # noqa: E402
from test_torch_mesh import _sub_mesh  # noqa: E402
from test_torch_mesh_pod import _tree  # noqa: E402
from repro_torch import configs as tc  # noqa: E402
from repro_torch.distributed import collectives as co  # noqa: E402
from repro_torch.distributed import sharding_rules as sr  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, run_ranks  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.tree import paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = "contract_tp"
ARCHS = R.ARCHS
# the reference's archs split over two processes of their own (their
# compiles are most of its time; zamba2's and mixtral's the longest)
REF_SPLIT = (("granite-3-2b", "granite-3-2b+kv1", "qwen2-7b",
              "hubert-xlarge"), ("zamba2-7b", "mixtral-8x7b"))
DECODE_ARCHS = ("granite-3-2b", "granite-3-2b+kv1", "qwen2-7b",
                "zamba2-7b", "mixtral-8x7b")
DECODE_B, DECODE_P, DECODE_N = 4, 6, 6
# the moves one forward makes (each a "model_move" all-to-all): granite
# 2 layers x (wq, wk, wv, wo, w_gate, w_up, w_down), its head tied to the
# embedding, which is split by vocabulary row under both layouts; with
# one kv head wk / wv stay whole; qwen2 and mixtral (experts' w_gate /
# w_up / w_down) add lm_head; zamba2's 5 mamba layers move out_proj and
# route in_proj (2 each), its shared block applied once moves 7; hubert
# 2 x (wq, wk, wv, wo, w_up, w_down) and its head
MOVES = {"granite-3-2b": 14, "granite-3-2b+kv1": 10, "qwen2-7b": 15,
         "zamba2-7b": 17, "hubert-xlarge": 13, "mixtral-8x7b": 15}
# the leaves a step may still gather over ``model``, and why: the kv
# projections of a layer whose kv heads do not divide; zamba2's
# vocabulary, whose embedding and head run whole in the hybrid family
# (as under "fsdp_tp"); the experts' router
MAY_GATHER = {"granite-3-2b": set(),
              "granite-3-2b+kv1": {"attn/wk", "attn/wv"},
              "qwen2-7b": set(), "zamba2-7b": {"embed", "lm_head"},
              "hubert-xlarge": set(), "mixtral-8x7b": {"moe/router"}}
_GQA = {"attn/wq", "attn/wk", "attn/wv", "attn/wo"}
_FFN = {"mlp/w_gate", "mlp/w_up", "mlp/w_down"}
# ... and the ones no step may gather: the splits the forms consume
NEVER = {"granite-3-2b": _GQA | _FFN,
         "granite-3-2b+kv1": {"attn/wq", "attn/wo"} | _FFN,
         "qwen2-7b": _GQA | _FFN | {"lm_head"},
         "zamba2-7b": {"mamba/in_proj", "mamba/out_proj", "mamba/conv_w",
                       "mamba/conv_b", "mamba/norm_scale"}
         | {"shared/" + k for k in _GQA | _FFN},
         "hubert-xlarge": _GQA | {"mlp/w_up", "mlp/w_down", "lm_head"},
         "mixtral-8x7b": _GQA | {"moe/w_gate", "moe/w_up", "moe/w_down",
                                 "lm_head"}}


def _cfg(arch):
    return R.contract_cfg(tc, arch)


def _batches(cfg):
    return [{k: torch.from_numpy(v) for k, v in b.items()}
            for b in train_batches(cfg)]


def _train(cfg, weights, mesh, sp):
    """Two train steps from ``weights`` on ``mesh`` under
    ``"contract_tp"`` -> (losses, norms, the params gathered whole as
    numpy, the leaves gathered over ``model``, the collectives, their
    bytes by kind)."""
    opt_cfg = OptConfig(lr=TRAIN_LR, moment_dtype="float32")
    specs = steps.mesh_specs(cfg, mesh, LAYOUT)
    loc = sr.shard_tree(_tree(weights), specs, mesh)
    opt = adamw_init(loc, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg, mesh=mesh,
                                 sequence_parallel=sp, param_layout=LAYOUT)
    losses, norms = [], []
    co.reset_counts()
    sr.model_gathers.clear()
    for b in _batches(cfg):
        loc, opt, m = step(loc, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    seen = (set(sr.model_gathers), dict(co.counts), dict(co.nbytes))
    full = sr.gather_tree(loc, specs, mesh)
    return (losses, norms, {k: v.detach().numpy().copy()
                            for k, v in paths(full).items()}) + seen


def _decode(cfg, params, mesh):
    """Greedy tokens of ``make_serve_step`` over ``init_cache``'s cache,
    one step a prompt token, on ``mesh`` under ``"contract_tp"`` (None:
    one device) -> (tokens, the collectives)."""
    g = torch.Generator().manual_seed(2)
    prompts = torch.randint(0, cfg.vocab_size, (DECODE_B, DECODE_P),
                            generator=g)
    if mesh is not None:
        params = sr.shard_tree(params, steps.mesh_specs(cfg, mesh, LAYOUT),
                               mesh)
    cache = steps.init_cache(cfg, DECODE_B, DECODE_P + DECODE_N, "cpu",
                             mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh=mesh, param_layout=LAYOUT)
    co.reset_counts()
    with torch.no_grad():
        for t in range(DECODE_P):
            nxt, cache = serve(params, cache, prompts[:, t:t + 1])
        toks = [nxt]
        for _ in range(DECODE_N - 1):
            nxt, cache = serve(params, cache, nxt[:, None])
            toks.append(nxt)
    return torch.stack(toks, 1).numpy(), dict(co.counts)


class _Predictions:
    """Every MoR plan's prediction (tile mask, kept tiles,
    ``gather_matmul``'s live / computed counters) while active."""

    def __enter__(self):
        from repro_torch.core.executor import MoRExecutionPlan
        self._orig = orig = MoRExecutionPlan.predict
        self.seen = seen = []

        def predict(plan, *a, **k):
            p = orig(plan, *a, **k)
            seen.append(p)
            return p
        MoRExecutionPlan.predict = predict
        return self

    def __exit__(self, *exc):
        from repro_torch.core.executor import MoRExecutionPlan
        MoRExecutionPlan.predict = self._orig
        # the counters are filled in by gather_matmul after the predict
        self.seen = [[t.numpy().copy() for t in (p.tiles, p.kept,
                                                 *p.kernel_counts)]
                     for p in self.seen]


def _kernel_forward(weights, mesh):
    """granite calibrated (``calibrate_lm``, the same on every rank),
    every odd 128-column tile made statically dead
    (``test_torch_mesh_mor._dead_odd_tiles``), then one kernel-mode
    forward on one device and one on ``mesh`` under ``"contract_tp"``
    -> (one device's predictions, the mesh's, the leaves the mesh
    gathered over ``model``)."""
    from repro_torch.core.deploy import attach_plans, calibrate_lm
    from repro_torch.launch.serve import calib_batches
    from test_torch_mesh_mor import _dead_odd_tiles
    cfg = _cfg("granite-3-2b")
    api = get_model(cfg)
    params, mor, _ = calibrate_lm(_tree(weights), cfg, api.forward,
                                  calib_batches(cfg, 4, "cpu"), 2)
    mor = attach_plans({"layers": _dead_odd_tiles(mor["layers"])}, cfg,
                       "kernel")
    batch = {"tokens": _batches(cfg)[0]["tokens"]}
    with torch.no_grad(), _Predictions() as one:
        api.forward(params, cfg, batch, mor=mor, mor_mode="kernel")
    specs = steps.mesh_specs(cfg, mesh, LAYOUT)
    loc = sr.shard_tree(params, specs, mesh)
    sr.model_gathers.clear()
    with torch.no_grad(), _Predictions() as split, \
            sr.activation_context(mesh, specs=specs):
        api.forward(loc, cfg, batch, mor=mor, mor_mode="kernel")
    return one.seen, split.seen, set(sr.model_gathers)


def _move_case(mesh):
    """``sharding_rules.use`` on one leaf W (4, 6) stored as ("model",
    "data"), named with target dim -1: the rank's block W[rows_m,
    cols_d] (cols_d 3 wide, which does not divide over model 2; the
    gathered 6 does) -> (the moved block, the gradient of sum(block x
    C) at the rank's stored block, whether ``use`` gathered it over
    ``model``)."""
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    c = torch.arange(24, dtype=torch.float32).reshape(4, 6) * 0.5 + 1
    spec = ("model", "data")
    loc = sr.shard_leaf(w, spec, mesh).requires_grad_(True)
    sr.model_gathers.clear()
    with sr.activation_context(mesh, specs={"w": spec}):
        out = sr.use({"w": loc}, {"w": spec}, {"w": -1})["w"]
    mi = mesh.index("model")
    (out * c[:, 3 * mi:3 * mi + 3]).sum().backward()
    return (out.detach().numpy(), loc.grad.numpy(), sr.split_on(out),
            "w" in sr.model_gathers)


def _rank(group, wpaths):
    torch.manual_seed(0)
    out = {"rank": group.rank}
    weights = _weights(wpaths)
    m22 = make_host_mesh(2, device="cpu")
    m12 = _sub_mesh(2, 2, "cpu")
    out["move"] = (m22.index("data"), m22.index("model"), _move_case(m22))
    for arch in ARCHS:
        cfg = _cfg(arch)
        w = weights[arch]
        for sp in (False, True):
            out[(arch, "2x2", sp)] = _train(cfg, w, m22, sp)
            if m12 is not None:
                out[(arch, "1x2", sp)] = _train(cfg, w, m12, sp)
        if m12 is not None and arch in DECODE_ARCHS:
            params = _tree(w)
            out[("decode", arch)] = (_decode(cfg, params, None)[0],
                                     _decode(cfg, params, m12))
    if m12 is not None:
        out["kernel"] = _kernel_forward(weights["granite-3-2b"], m12)
    return out


def _weights(wpaths):
    """{arch: {'/'-joined path: numpy}}: the reference's weights, once
    its processes have written them."""
    t0 = time.time()
    while not all(os.path.exists(p) for p in wpaths):
        assert time.time() - t0 < 300, "no reference weights"
        time.sleep(0.2)
    flat = {}
    for p in wpaths:
        with np.load(p) as f:
            flat.update({k: f[k] for k in f.files})
    return {a: {k[len(a) + 1:]: v for k, v in flat.items()
                if k.startswith(a + "/")} for a in ARCHS}


@pytest.fixture(scope="module")
def run():
    """-> (the reference's outputs, its weights by arch, the 4 ranks'
    results), the reference's processes and the ranks side by side: the
    ranks start at once and read the weights when the reference has
    written them."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        procs = []
        try:
            for i, archs in enumerate(REF_SPLIT):
                files = [os.path.join(tmp, f"{n}{i}.{x}") for n, x in (
                    ("weights", "npz"), ("out", "npz"), ("ref", "log"))]
                with open(files[2], "w") as f:
                    procs.append((subprocess.Popen(
                        [sys.executable, os.path.join(
                            ROOT, "tests", "mesh_contract_reference.py")]
                        + files[:2] + list(archs), env=env, stdout=f,
                        stderr=subprocess.STDOUT), files))
            wpaths = [files[0] for _, files in procs]
            ranks = run_ranks(_rank, 4, "cpu", wpaths)
            ref = {}
            for proc, files in procs:
                rc = proc.wait(timeout=600)
                with open(files[2]) as f:
                    text = f.read()
                assert rc == 0 and "MESH_FAMILIES_REFERENCE_OK" in text, \
                    text[-3000:]
                with np.load(files[1]) as f:
                    ref.update({k: f[k] for k in f.files})
            yield ref, _weights(wpaths), ranks
        finally:
            for proc, _ in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _params_close(got, want, weights0):
    """Every leaf within 1e-5 x its largest entry, a leaf drawn as zeros
    within 1e-3 x, a key bias apart (the module's docstring)."""
    for k, w in want.items():
        if k.endswith("/bk"):
            continue
        scale = max(float(np.abs(w).max()), 1e-30)
        tol = (1e-5 if np.abs(weights0[k]).any() else 1e-3) * scale
        err = float(np.abs(got[k] - w).max())
        assert err <= tol, (k, err, tol)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("name", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_contract_train_step_matches_reference(run, arch, name, sp):
    """Two float32 train steps under ``"contract_tp"`` on the mesh,
    sequence parallelism off and on, against the reference's
    single-device ``make_loss_fn`` + ``jax.value_and_grad`` +
    ``adamw_update``: the losses, the clip's norms, the params gathered
    after the second step."""
    ref, weights, ranks = run
    pre = f"{arch}/dp1"
    want = {k[len(pre) + 8:]: ref[k] for k in ref
            if k.startswith(pre + "/params/")}
    members = ranks[:2] if name == "1x2" else ranks
    for r in members:
        losses, norms, full = r[(arch, name, sp)][:3]
        for s in range(2):
            np.testing.assert_allclose(losses[s], ref[f"{pre}/loss/{s}"],
                                       rtol=1e-5)
            np.testing.assert_allclose(norms[s], ref[f"{pre}/gnorm/{s}"],
                                       rtol=1e-4)
        _params_close(full, want, weights[arch])


@pytest.mark.parametrize("arch", ARCHS)
def test_contract_splits_are_consumed(run, arch):
    """After the contract steps, on (1, 2) and (2, 2) with sequence
    parallelism off and on: the leaves gathered over ``model`` lie in
    the arch's named list, and none of the splits its forms consume is
    gathered (with one kv head: exactly ``wk`` / ``wv``); each forward
    moved its splits (``"model_move"``) and each backward moved their
    gradients back, as many times."""
    _, _, ranks = run
    for r in ranks:
        for key in [k for k in r if k[0] == arch]:
            gathered, counts = r[key][3:5]
            assert gathered <= MAY_GATHER[arch], (key, gathered)
            assert not gathered & NEVER[arch], (key, gathered)
            if arch == "granite-3-2b+kv1":
                assert gathered == {"attn/wk", "attn/wv"}, (key, gathered)
            assert counts["model_move"] == 2 * MOVES[arch], (key, counts)
            assert counts["model_move.grad"] == counts["model_move"]


@pytest.mark.parametrize("arch", ["granite-3-2b", "granite-3-2b+kv1",
                                  "qwen2-7b", "hubert-xlarge",
                                  "mixtral-8x7b"])
def test_contract_moves_bytes(run, arch):
    """The moves' bytes on (1, 2) without sequence parallelism, where
    they are the step's only all-to-alls: each moved leaf's rank block
    (its whole / 2, float32) forward and backward, in each of the two
    steps; the moved leaves are the consumed splits the rank's forms
    read (``NEVER``) and not the gathered ones."""
    _, weights, ranks = run
    w = weights[arch]
    moved = [k for k in w if any(k.endswith("/" + n) or k == n
                                 for n in NEVER[arch])]
    block = sum(w[k].size for k in moved) // 2 * 4
    for r in ranks[:2]:
        nbytes = r[(arch, "1x2", False)][5]
        assert nbytes["all-to-all"] == 2 * 2 * block, (nbytes, block)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_contract_decode_tokens_equal_one_device(run, arch):
    """Greedy tokens of the static decode on (1, 2) under
    ``"contract_tp"`` (``make_serve_step``: the moved splits each step,
    the sequence-sharded GQA ring) equal one device's."""
    _, _, ranks = run
    for r in ranks[:2]:
        single, (toks, counts) = r[("decode", arch)]
        np.testing.assert_array_equal(toks, single)
        assert counts["model_move"] > 0, counts


def test_contract_kernel_forward_masks_equal_one_device(run):
    """granite calibrated with every odd tile statically dead, one
    kernel-mode forward on (1, 2) under ``"contract_tp"``: the attention
    by head and the FFN under its active plan by column, both on the
    moved splits (nothing gathered over ``model``), so each rank runs
    the three MoR kernels' forms on its own 128 columns; one device's
    tile masks hold dead and live tiles, each rank's tile masks and kept
    tiles of every layer are its column block of one device's, and the
    two ranks' ``gather_matmul`` counters sum to one device's."""
    _, _, ranks = run
    L = _cfg("granite-3-2b").n_layers
    for m, r in enumerate(ranks[:2]):
        one, split, gathered = r["kernel"]
        assert gathered == set(), gathered
        assert len(split) == len(one) == L
        for a, b in zip(split, one):
            assert b[0].any() and not b[0].all(), b[0]
            n = a[0].shape[1]
            for x, y in zip(a[:2], b[:2]):
                np.testing.assert_array_equal(x, y[:, m * n:(m + 1) * n])
    for layer in range(L):
        one = ranks[0]["kernel"][0][layer]
        for j in (2, 3):
            assert sum(int(r["kernel"][1][layer][j]) for r in ranks[:2]) \
                == int(one[j])


def test_use_moves_a_split_whose_block_does_not_divide(run):
    """``sharding_rules.use`` on (2, 2): a leaf stored ("model", "data")
    whose form consumes its split on dim -1 is moved there although the
    rank's stored block (3 columns) does not divide over model 2 (the
    gathered 6 columns do): each rank gets W[:, its 3 columns], split on
    dim -1, gathered over ``model`` by no one; the gradient comes back
    to the stored block, summed over the data ranks (each fed the same
    block)."""
    _, _, ranks = run
    w = np.arange(24, dtype=np.float32).reshape(4, 6)
    c = w * 0.5 + 1
    for r in ranks:
        di, mi, (block, grad, dim, gathered) = r["move"]
        np.testing.assert_array_equal(block, w[:, 3 * mi:3 * mi + 3])
        np.testing.assert_array_equal(
            grad, 2 * c[2 * mi:2 * mi + 2, 3 * di:3 * di + 3])
        assert dim == -1 and not gathered
