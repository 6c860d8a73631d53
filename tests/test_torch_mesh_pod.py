"""The production mesh's pieces on real ranks: sequence parallelism,
the multi-pod mesh, and the dry run (``launch.dryrun`` on torch's fake
process group) against what real ranks count.

The port's side runs on 4 gloo rank processes, spawned once for the
module: (1, 2) over ranks 0-1, (2, 2) and the multi-pod (2, 1, 2) over
all four.  The fake-group side runs in ONE subprocess
(``tests/dry_mesh_probe.py counts``), and the reference's single-device
train steps in this process (the JAX package's ``make_loss_fn`` +
``jax.value_and_grad`` + ``adamw_update``, no ``activation_context``: jax
0.9.0 cannot train under it), all side by side.

Tolerances: the sequence-parallel step sums the same float32 products in
another order (a reduce-scatter of S blocks in place of an all-reduce):
its loss and clip norm within 1e-5 (relative) of the same mesh without
it and of the reference, the params within 1e-5 x their leaf's largest
entry (a key bias, whose gradient is float32 noise the softmax cannot
see, apart: ``tests/test_torch_mesh.py``).  The multi-pod (2, 1, 2) mesh
has data-parallel groups of the same ranks in the same order as (2, 2):
its steps are bit-equal.  The dry run's collective counts, bytes by
kind, FLOPs and argument bytes are integers and equal the ranks'.
"""
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import mesh_reference as MR  # noqa: E402
from dry_mesh_probe import (COUNT_ARCHS, COUNT_CELLS,  # noqa: E402
                            CONTRACT_COUNT_ARCHS, count_cfg)
from test_torch_mesh import _params_close, _sub_mesh  # noqa: E402
from repro_torch import configs as tc  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import collectives as co  # noqa: E402
from repro_torch.distributed import sharding_rules as sr  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, run_ranks  # noqa: E402
from repro_torch.optim import OptConfig, adamw_init  # noqa: E402
from repro_torch.tree import paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = COUNT_ARCHS
F32 = 1e-5


def _tree(flat):
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(v))
    return out


def _train(cfg, weights, mesh, sp):
    """Two train steps from ``weights`` on ``mesh`` -> (losses, norms,
    the params gathered whole as numpy, the collectives)."""
    opt_cfg = OptConfig(lr=MR.TRAIN_LR, moment_dtype="float32")
    specs = steps.mesh_specs(cfg, mesh)
    loc = sr.shard_tree(_tree(weights), specs, mesh)
    opt = adamw_init(loc, opt_cfg)
    step = steps.make_train_step(cfg, opt_cfg, mesh=mesh,
                                 sequence_parallel=sp)
    losses, norms = [], []
    co.reset_counts()
    for b in MR.train_batches(cfg.vocab_size):
        loc, opt, m = step(loc, opt, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts = dict(co.counts)
    full = sr.gather_tree(loc, specs, mesh)
    return (losses, norms, {k: v.detach().numpy().copy()
                            for k, v in paths(full).items()}, counts)


def _rank(group, weights):
    torch.manual_seed(0)
    out = {"rank": group.rank}
    m22 = make_host_mesh(2, device="cpu")
    m212 = make_host_mesh(2, device="cpu", pods=2)
    m12 = _sub_mesh(2, 2, "cpu")
    for arch in ARCHS:
        cfg = count_cfg(tc, arch)
        for sp in (False, True):
            out[(arch, "2x2", sp)] = _train(cfg, weights[arch], m22, sp)
            if m12 is not None:
                out[(arch, "1x2", sp)] = _train(cfg, weights[arch], m12, sp)
        out[(arch, "2x1x2", False)] = _train(cfg, weights[arch], m212,
                                             False)
        # what these ranks count running the dry run's cells
        for name, S, B, kind in COUNT_CELLS:
            for sp in (False, True):
                co.reset_counts()
                c = dryrun.count_cell(cfg, ShapeSpec(name, S, B, kind),
                                      device="cpu",
                                      on=dryrun.MeshArgs(m22, sp, "fsdp_tp"))
                out[("count", arch, name, sp)] = {
                    "counts": dict(co.counts), "nbytes": dict(co.nbytes),
                    "flops": c.counter.flops, "args": c.args,
                    "peak_temp": c.counter.peak_live_bytes}
                if arch not in CONTRACT_COUNT_ARCHS:
                    continue
                co.reset_counts()
                c = dryrun.count_cell(cfg, ShapeSpec(name, S, B, kind),
                                      device="cpu",
                                      on=dryrun.MeshArgs(m22, sp,
                                                         "contract_tp"))
                out[("count", arch, name, sp, "contract_tp")] = {
                    "counts": dict(co.counts), "nbytes": dict(co.nbytes),
                    "flops": c.counter.flops, "args": c.args}
    return out


def _reference():
    """The JAX package's reduced float32 weights (PRNGKey(1), as
    ``tests/mesh_reference.py`` draws them) and its single-device two
    steps, data parallelism as the mean over the shards' gradients:
    {arch: (numpy weights, {dp: (losses, norms, params)})}."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jc
    from repro.launch import steps as jsteps
    from repro.models import get_model
    from repro.optim import OptConfig as JOpt
    from repro.optim import adamw_init as jinit
    from repro.optim import adamw_update
    from repro.optim.schedules import cosine_schedule
    out = {}
    opt_cfg = JOpt(lr=MR.TRAIN_LR, moment_dtype="float32")
    for arch in ARCHS:
        cfg = count_cfg(jc, arch)
        params0 = get_model(cfg).init(jax.random.PRNGKey(1), cfg)
        flat = {}
        MR._flat("w", params0, flat)
        weights = {k[2:]: v for k, v in flat.items()}
        vg = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(cfg),
                                        has_aux=True))
        runs = {}
        for dp in ((1, 2) if arch == "deepseek-v2-236b" else (1,)):
            params, opt = params0, jinit(params0, opt_cfg)
            losses, norms = [], []
            for b in MR.train_batches(cfg.vocab_size):
                parts = [{k: jnp.asarray(a.reshape(dp, -1, MR.TRAIN_S)[i])
                          for k, a in b.items()} for i in range(dp)]
                res = [vg(params, p) for p in parts]
                loss = sum(r[0][0] for r in res) / dp
                grads = jax.tree_util.tree_map(lambda *g: sum(g) / dp,
                                               *[r[1] for r in res])
                params, opt, m = adamw_update(
                    params, grads, opt, opt_cfg,
                    cosine_schedule(opt["step"], 10000, 100))
                losses.append(float(loss))
                norms.append(float(m["grad_norm"]))
            pf = {}
            MR._flat("w", params, pf)
            runs[dp] = (losses, norms, {k[2:]: v for k, v in pf.items()})
        out[arch] = (weights, runs)
    return out


@pytest.fixture(scope="module")
def run():
    """-> (the reference, the 4 ranks' results, the dry run's counts)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "counts.json")
        log = os.path.join(tmp, "probe.log")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests",
                                              "dry_mesh_probe.py"),
                 "counts", path], env=env, stdout=f,
                stderr=subprocess.STDOUT)
        try:
            ref = _reference()
            ranks = run_ranks(_rank, 4, "cpu",
                              {a: w for a, (w, _) in ref.items()})
            rc = proc.wait(timeout=600)
            with open(log) as f:
                assert rc == 0, f.read()[-3000:]
            import json
            with open(path) as f:
                dry = json.load(f)
            yield ref, ranks, dry
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.mark.parametrize("name", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_parallel_train_step(run, arch, name):
    """Two float32 train steps with the residual stream S-sharded over
    model follow the same mesh without it and the reference's
    single-device steps (deepseek on (2, 2): each data shard's expert
    capacity and load-balance loss, as the reference's dp 2 run):
    losses and clip norms within 1e-5, params within 1e-5 x their
    leaf's largest entry; the step reduce-scatters S."""
    ref, ranks, _ = run
    dp = 2 if (name == "2x2" and arch == "deepseek-v2-236b") else 1
    want_l, want_n, want_p = ref[arch][1][dp]
    tiny = {k for k in want_p if k.endswith("/bk")}
    members = ranks[:2] if name == "1x2" else ranks
    for r in members:
        l_sp, n_sp, p_sp, c_sp = r[(arch, name, True)]
        l_0, n_0, _, c_0 = r[(arch, name, False)]
        np.testing.assert_allclose(l_sp, l_0, rtol=F32)
        np.testing.assert_allclose(n_sp, n_0, rtol=F32)
        np.testing.assert_allclose(l_sp, want_l, rtol=F32)
        np.testing.assert_allclose(n_sp, want_n, rtol=F32)
        _params_close(p_sp, want_p, tiny)
        assert c_sp.get("reduce_scatter_dim", 0) > 0, c_sp
        assert "reduce_scatter_dim" not in c_0


@pytest.mark.parametrize("arch", ARCHS)
def test_multipod_train_step_is_bit_equal_to_2x2(run, arch):
    """(pod 2, data 1, model 2) over 4 ranks: the data-parallel tuple
    ("pod", "data") holds the ranks the (2, 2) mesh's data axis holds,
    in the same order, so the two train steps are bit-equal: losses,
    norms, every param; the same collectives."""
    _, ranks, _ = run
    for r in ranks:
        a, b = r[(arch, "2x1x2", False)], r[(arch, "2x2", False)]
        assert a[0] == b[0] and a[1] == b[1]
        for k, v in b[2].items():
            np.testing.assert_array_equal(a[2][k], v, err_msg=k)
        assert a[3] == b[3]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("cell", [c[0] for c in COUNT_CELLS])
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_counts_equal_real_ranks(run, arch, cell, sp):
    """The fake-group dry run of each rank on (2, 2) (gloo's collectives
    modelled) counts what that rank counts running the same step for
    real: the collectives by name, their bytes by kind, op_cost's FLOPs
    and the argument bytes, exactly; sequence parallelism lowers the
    train step's peak temp."""
    _, ranks, dry = run
    for r in ranks:
        got = dry[f"{arch}|{cell}|{sp}|{r['rank']}"]
        want = r[("count", arch, cell, sp)]
        assert got["counts"] == want["counts"]
        assert got["nbytes"] == want["nbytes"]
        assert got["flops"] == want["flops"]
        assert got["args"] == want["args"]
        if sp and cell.startswith("train"):
            off = dry[f"{arch}|{cell}|False|{r['rank']}"]
            assert got["peak_temp"] < off["peak_temp"]


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("cell", [c[0] for c in COUNT_CELLS])
@pytest.mark.parametrize("arch", CONTRACT_COUNT_ARCHS)
def test_dry_run_counts_equal_real_ranks_contract(run, arch, cell, sp):
    """The same under ``"contract_tp"``, whose splits each layer moves
    onto the dims its tensor-parallel forms consume (one all-to-all a
    leaf, "model_move"): the fake group's collectives, bytes by kind,
    FLOPs and argument bytes equal each real rank's, and the moves ran
    (their gradients moved back in the train step)."""
    _, ranks, dry = run
    for r in ranks:
        got = dry[f"{arch}|{cell}|{sp}|{r['rank']}|contract_tp"]
        want = r[("count", arch, cell, sp, "contract_tp")]
        assert got["counts"] == want["counts"]
        assert got["nbytes"] == want["nbytes"]
        assert got["flops"] == want["flops"]
        assert got["args"] == want["args"]
        assert want["counts"]["model_move"] > 0, want["counts"]
        assert ("model_move.grad" in want["counts"]) == \
            cell.startswith("train")
