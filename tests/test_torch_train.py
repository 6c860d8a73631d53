"""The training path against the JAX package: AdamW, the schedule, the
loss and its gradients, the train step with micro-batch accumulation,
rematerialisation, RWKV's serial time mix, the prefetching iterator, and
the port's own training CLI (``repro_torch.launch.train``) with resume
and the serve CLI's ``--ckpt-dir``.

The reference is ``repro.launch.steps``' ``make_loss_fn`` /
``make_train_step`` and ``repro.optim.adamw_update`` under ``jax.jit``,
called without ``activation_context`` (on one device its constraints are
the identity).  Weights come from the JAX ``init`` through
``repro_torch.convert``, batches from ``repro.data.pipeline``; the
models are reduced and float32.

Tolerances: AdamW in float32 is the same elementwise arithmetic in
another association of a few terms: 1e-6 (absolute and relative); a
bfloat16 param is the float32 master rounded, so within one bf16 step
(2^-8 relative) where the two masters fall on either side of a rounding
boundary.  The loss is a float32 sum over 128 positions of terms ~6:
1e-5.  Gradients are float32 backward sums of the same terms in other
orders: rtol 1e-4, with an absolute floor of 1e-4 x the leaf's largest
entry for entries near zero.  A train step's moments are linear and
quadratic in the gradients: the gradients' tolerance; so are the params
after a step other than the first (``_first_step_params`` says why the
first is held entry by entry).
Rematerialisation recomputes the same float32 operations: 1e-6.
"""
import functools
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.configs.base import ShapeSpec
from repro.data import DataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro.models.layers import rwkv as jrwkv
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim.schedules import cosine_schedule as jcosine
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduce_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models.layers import rwkv
from repro_torch.optim import (OptConfig, adamw_init, adamw_update,
                               cosine_schedule, linear_warmup)
from repro_torch.tree import leaves, paths
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("granite-3-2b", "deepseek-v2-236b", "rwkv6-3b", "zamba2-7b")
ADAM_TOL = 1e-6
LOSS_TOL = 1e-5
GRAD_RTOL = 1e-4
REMAT_TOL = 1e-6
BATCH, SEQ = 4, 32


def _jpaths(tree):
    """{"/"-joined key path: numpy leaf} of a JAX tree (the reference's
    checkpoint keys)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _tpaths(tree):
    """{key path: a float32 numpy copy} of a port tree (a copy: the
    train step updates its tensors in place)."""
    return {k: v.detach().float().numpy().copy()
            for k, v in paths(tree).items()}


def _grad_close(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        floor = GRAD_RTOL * max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=floor, err_msg=f"{what} {k}")


def _opt(dtype="float32"):
    kw = dict(lr=1e-3, moment_dtype=dtype)
    return JOptConfig(**kw), OptConfig(**kw)


# --------------------------------------------------------------------------
# AdamW and the schedule on random trees
# --------------------------------------------------------------------------

def _random_tree(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 10), "b": (10,), "stack": {"scale": (3, 10),
                                                  "w3": (3, 4, 5)}}

    def make(s):
        return rng.standard_normal(s).astype(np.float32)
    tree = jax.tree_util.tree_map(make, shapes,
                                  is_leaf=lambda x: isinstance(x, tuple))
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _as_port(tree):
    return convert._tree(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.mark.parametrize("case", ["float32", "bf16_master", "clipped"])
def test_adamw_update_matches_reference(case):
    """Three updates from a fresh state: float32 params and moments;
    bf16 params and moments with the float32 master copy; float32 with
    gradients large enough that the global-norm clip is active.  Decay
    touches only leaves of ndim >= 2 (the (3, 10) stacked scale too)."""
    dtype = jnp.bfloat16 if case == "bf16_master" else jnp.float32
    jcfg, tcfg = _opt("bfloat16" if case == "bf16_master" else "float32")
    jp = _random_tree(0, dtype)
    js = jadamw_init(jp, jcfg)
    tp = _as_port(jp)
    ts = adamw_init(tp, tcfg)
    assert ("master" in ts) == ("master" in js) == (case == "bf16_master")
    upd = jax.jit(lambda p, g, s, lr: jadamw_update(p, g, s, jcfg, lr))
    scale = 50.0 if case == "clipped" else 0.1
    for i in range(3):
        jg = jax.tree_util.tree_map(lambda a: a * scale,
                                    _random_tree(10 + i, jnp.float32))
        lr = float(jcosine(jnp.int32(i), 10, 2))
        jp, js, jm = upd(jp, jg, js, lr)
        tp, ts, tm = adamw_update(tp, _as_port(jg), ts, tcfg, lr)
        gnorm = float(jm["grad_norm"])
        if case == "clipped":
            assert gnorm > jcfg.grad_clip
        np.testing.assert_allclose(float(tm["grad_norm"]), gnorm,
                                   rtol=ADAM_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=ADAM_TOL)
    assert int(ts["step"]) == int(js["step"]) == 3
    want_p, got_p = _jpaths(jp), _tpaths(tp)
    if case == "bf16_master":
        for k in want_p:            # one bf16 step where masters straddle
            np.testing.assert_allclose(got_p[k], want_p[k], rtol=2 ** -8,
                                       atol=0)
        groups = ("master", "mu", "nu")
        tol = {"master": ADAM_TOL, "mu": 2 ** -8, "nu": 2 ** -8}
    else:
        for k in want_p:
            np.testing.assert_allclose(got_p[k], want_p[k], rtol=ADAM_TOL,
                                       atol=ADAM_TOL)
        groups = ("mu", "nu")
        tol = {"mu": ADAM_TOL, "nu": ADAM_TOL}
    for g in groups:
        want, got = _jpaths(js[g]), _tpaths(ts[g])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=tol[g],
                                       atol=ADAM_TOL, err_msg=f"{g} {k}")
    if case == "float32":
        # from a fresh state a zero gradient moves a param by its decay
        # alone: every leaf of ndim >= 2 moves, the vector does not
        zero = _as_port(jax.tree_util.tree_map(jnp.zeros_like, jp))
        p0 = _as_port(_random_tree(0, jnp.float32))
        before = _tpaths(p0)
        p0, _, _ = adamw_update(p0, zero, adamw_init(p0, tcfg), tcfg, 1.0)
        after = _tpaths(p0)
        for k in before:
            assert np.array_equal(after[k], before[k]) == (k == "b"), k


def test_cosine_schedule_matches_reference():
    for total, warm in ((100, 10), (40, 100), (10, 0)):
        for s in list(range(0, total + 5)):
            want = float(jcosine(jnp.int32(s), total, warm))
            got = float(cosine_schedule(s, total, warm))
            got_t = float(cosine_schedule(torch.tensor(s, dtype=torch.int32),
                                          total, warm))
            assert got == got_t
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        assert float(linear_warmup(torch.tensor(warm), warm)) == 1.0


# --------------------------------------------------------------------------
# loss, gradients and the train step against the reference
# --------------------------------------------------------------------------

def _batch(jcfg, step=0):
    return jmake_batch(jcfg, ShapeSpec("t", SEQ, BATCH, "train"),
                       DataConfig(seed=0), step)


def _port_batch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's numbers for ``arch``, computed once a module: the
    loss and gradients of one batch, and two train steps at grad_accum 2
    (the params, optimizer state and metrics after each)."""
    jcfg = jreduce_config(jget_config(arch))
    jo, _ = _opt()
    api = jget_model(jcfg)
    jparams = jax.jit(lambda k: api.init(k, jcfg))(jax.random.PRNGKey(0))
    state = jax.jit(lambda p: jadamw_init(p, jo))(jparams)
    b0, b1 = _batch(jcfg, 0), _batch(jcfg, 1)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jsteps.make_loss_fn(jcfg), has_aux=True))(jparams, b0)
    step = jax.jit(jsteps.make_train_step(jcfg.replace(grad_accum=2), jo,
                                          total_steps=10, warmup=1))
    p, steps = jparams, []
    for b in (b0, b1):
        p, state, m = step(p, state, b)
        steps.append({"params": _jpaths(p), "mu": _jpaths(state["mu"]),
                      "nu": _jpaths(state["nu"]),
                      "tree": jax.tree_util.tree_map(np.asarray,
                                                     (p, state)),
                      "metrics": {k: float(v) for k, v in m.items()}})
    return {"params": jax.tree_util.tree_map(np.asarray, jparams),
            "loss": float(loss), "grads": _jpaths(grads), "steps": steps,
            "batches": (b0, b1)}


def _port(arch):
    cfg = reduce_config(get_config(arch))
    params = convert.params_from_numpy(cfg, _reference(arch)["params"],
                                       device="cpu")
    return cfg, params


def _loss_grads(cfg, params, batch):
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = tsteps.make_loss_fn(cfg)(params, batch)
    grads = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    return float(loss.detach()), {k: g.numpy()
                                  for k, g in zip(paths(params), grads)}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    """granite (GQA, dense), deepseek (MLA + MoE: the load-balance term),
    rwkv6 and zamba2: one batch's loss and every leaf's gradient."""
    ref = _reference(arch)
    cfg, params = _port(arch)
    loss, grads = _loss_grads(cfg, params, _port_batch(ref["batches"][0]))
    np.testing.assert_allclose(loss, ref["loss"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    _grad_close(grads, ref["grads"], arch)


def _first_step_params(got, want, mu, lr):
    """Adam's first step moves an entry by lr x g / (|g| + eps): its sign
    for every gradient above eps.  Where the reference's gradient (mu / (1
    - b1)) is above the gradient tolerance's floor the two packages agree
    on it, and so the params to ADAM_TOL; an entry whose gradient is at
    the float32 noise level may take the other sign in one package, and
    its param differs by at most 2 lr."""
    for k in want:
        live = np.abs(mu[k]) >= GRAD_RTOL * np.abs(mu[k]).max()
        diff = np.abs(got[k] - want[k])
        np.testing.assert_allclose(got[k][live], want[k][live],
                                   rtol=ADAM_TOL, atol=ADAM_TOL, err_msg=k)
        assert diff[~live].max(initial=0.0) <= 2 * lr + ADAM_TOL, k


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_accum_matches_reference(arch):
    """``make_train_step`` at grad_accum 2 (two micro-batches of 2,
    float32 accumulators, a warm-up of 1 step): the first step from the
    shared init, the second from the reference's state after the first
    (so that the first step's sign-sensitive entries, see
    ``_first_step_params``, do not feed the second): metrics, params and
    both moments after each."""
    ref = _reference(arch)
    cfg, params = _port(arch)
    _, to = _opt()
    state = adamw_init(params, to)
    step = tsteps.make_train_step(cfg.replace(grad_accum=2), to,
                                  total_steps=10, warmup=1)
    for i, want in enumerate(ref["steps"]):
        if i:
            jp, js = ref["steps"][i - 1]["tree"]
            params = convert.params_from_numpy(cfg, jp, device="cpu")
            state = {"step": torch.tensor(int(js["step"]),
                                          dtype=torch.int32),
                     "mu": convert._tree(js["mu"], "cpu"),
                     "nu": convert._tree(js["nu"], "cpu")}
        params, state, m = step(params, state,
                                _port_batch(ref["batches"][i]))
        assert int(state["step"]) == i + 1
        for name, v in want["metrics"].items():
            np.testing.assert_allclose(float(m[name]), v, rtol=GRAD_RTOL,
                                       err_msg=f"step {i} {name}")
        _grad_close(_tpaths(state["mu"]), want["mu"], f"{arch} mu {i}")
        _grad_close(_tpaths(state["nu"]), want["nu"], f"{arch} nu {i}")
        if i:
            _grad_close(_tpaths(params), want["params"], f"{arch} params")
        else:
            _first_step_params(_tpaths(params), want["params"], want["mu"],
                               want["metrics"]["lr"])
    assert all(not p.requires_grad for p in leaves(params))


# the function inside each family's rematerialised block, by module
REMAT_SPY = {"granite-3-2b": ("repro_torch.models.layers.attention",
                              "gqa_forward"),
             "deepseek-v2-236b": ("repro_torch.models.layers.attention",
                                  "mla_forward"),
             "rwkv6-3b": ("repro_torch.models.layers.rwkv",
                          "timemix_forward"),
             "zamba2-7b": ("repro_torch.models.hybrid", "mamba2_forward")}


@pytest.mark.parametrize("arch", tuple(REMAT_SPY))
@pytest.mark.parametrize("remat", ("nothing_saveable", "dots_saveable"))
def test_remat_leaves_loss_and_grads_equal(arch, remat, monkeypatch):
    """Loss and gradients under each policy equal remat "none"'s, and
    the blocks really are recomputed: the spied function inside every
    rematerialised block runs twice (forward, then backward); deepseek's
    two layer groups (a dense layer, then the MoE stack) each recompute
    their own kind of block."""
    import importlib
    cfg, params = _port(arch)
    batch = _port_batch(_reference(arch)["batches"][0])
    mod, name = REMAT_SPY[arch]
    mod = importlib.import_module(mod)
    calls = []

    def spy(*a, _orig=getattr(mod, name), **k):
        calls.append(1)
        return _orig(*a, **k)
    monkeypatch.setattr(mod, name, spy)
    want_loss, want = _loss_grads(cfg, params, batch)
    plain = len(calls)
    got_loss, got = _loss_grads(cfg.replace(remat=remat), params, batch)
    # zamba2's tail layers are not rematerialised, as in the reference
    tail = cfg.n_layers % cfg.shared_attn_every if cfg.family == "hybrid" \
        else 0
    assert plain > 0 and len(calls) - plain == 2 * plain - tail
    np.testing.assert_allclose(got_loss, want_loss, rtol=REMAT_TOL)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=REMAT_TOL,
                                   atol=REMAT_TOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_reads_nothing_back(arch, monkeypatch):
    """A train step (grad_accum 2, remat nothing_saveable) moves no
    tensor to the host: loss, grad norm, clip factor, bias corrections
    and learning rate stay tensors, and no branch reads a value."""
    cfg, params = _port(arch)
    cfg = cfg.replace(grad_accum=2, remat="nothing_saveable")
    _, to = _opt()
    state = adamw_init(params, to)
    step = tsteps.make_train_step(cfg, to)
    batch = _port_batch(_reference(arch)["batches"][0])
    calls = []
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__float__",
                 "__int__", "__index__"):
        def spy(self, *a, _orig=getattr(torch.Tensor, name), _name=name,
                **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    _, state, m = step(params, state, batch)
    monkeypatch.undo()
    assert calls == []
    assert int(state["step"]) == 1 and np.isfinite(float(m["loss"]))


def test_timemix_serial_matches_chunked_and_reference():
    """The serial scan over 300 positions (two rematerialised chunks of
    ``SERIAL_CHUNK``) against the chunked form and the reference's serial
    form; under autograd its gradients equal the chunked form's."""
    cfg, params = _port("rwkv6-3b")
    jcfg = jreduce_config(jget_config("rwkv6-3b"))
    tm = {k: v[0] for k, v in params["layers"]["tm"].items()}
    jtm = {k: jnp.asarray(v.numpy()) for k, v in tm.items()}
    x = np.random.default_rng(0).standard_normal((2, 300, cfg.d_model)
                                                 ).astype(np.float32)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        serial = rwkv.timemix_forward(tm, cfg, xt, chunked=False).numpy()
        chunked = rwkv.timemix_forward(tm, cfg, xt).numpy()
    want = np.asarray(jax.jit(lambda p, a: jrwkv.timemix_forward(
        p, jcfg, a, chunked=False))(jtm, jnp.asarray(x)))
    np.testing.assert_allclose(serial, chunked, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(serial, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    grads = []
    for chunked_form in (False, True):
        xg = xt.clone().requires_grad_(True)
        w = tm["Wr"].clone().requires_grad_(True)
        y = rwkv.timemix_forward({**tm, "Wr": w}, cfg, xg,
                                 chunked=chunked_form)
        grads.append(torch.autograd.grad((y * y).sum(), (xg, w)))
    for g_s, g_c in zip(*grads):
        np.testing.assert_allclose(g_s.numpy(), g_c.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(g_c.abs().max()))


def test_make_train_iterator_is_make_batch_in_step_order():
    cfg = reduce_config(get_config("granite-3-2b"))
    it = tpipe.make_train_iterator(cfg, 3, 16, seed=5, start_step=7,
                                   prefetch=2)
    try:
        for s in range(7, 12):
            got, want = next(it), tpipe.make_batch(cfg, 3, 16, seed=5,
                                                   step=s)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        it.close()
    assert not it._thread.is_alive()


# --------------------------------------------------------------------------
# the port's CLIs
# --------------------------------------------------------------------------

TRAIN = ["--arch", "granite-3-2b", "--reduced", "--log-every", "100",
         "--device", "cpu"]


def _train(args):
    with contextlib.redirect_stdout(io.StringIO()):
        return ttrain.main(TRAIN + args)


def test_train_main_reduces_loss():
    """The reference test's run (40 steps, batch 8, seq 48) from the
    port's own seed-0 weights.  The same run from the reference's
    weights follows the reference's trajectory (the train-step test
    above) and falls 0.136 there; the port's seed-0 init falls 0.067, so
    the bar here is a fall of 0.05 (the mean of the last 10 losses below
    the first step's)."""
    r = _train(["--steps", "40", "--batch", "8", "--seq", "48"])
    assert np.isfinite(r["loss_first"]) and np.isfinite(r["loss_last"])
    assert r["loss_last"] < r["loss_first"] - 0.05, r


@pytest.mark.parametrize("layout", (["--mesh", "pod"],
                                    ["--model-parallel", "2"]))
def test_train_main_refuses_sharded_layouts(layout):
    """``--mesh pod`` runs on the production mesh's 256 ranks and
    refuses one, naming the count; ``--model-parallel 2`` on one rank
    does not divide (the host mesh itself runs on ``--ranks``:
    tests/test_torch_mesh.py)."""
    if "--mesh" in layout:
        with pytest.raises(ValueError, match="runs on 256 ranks"):
            _train(["--steps", "1"] + layout)
    else:
        with pytest.raises(ValueError, match="not a multiple"):
            _train(["--steps", "1"] + layout)


def test_train_main_resume_matches_straight_run(tmp_path):
    """2 x 12 steps with a checkpoint and restore between them == 24
    straight steps (the same data stream): the last losses within 1e-3,
    and the resumed run starts at the checkpoint's step."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["--batch", "4", "--seq", "32"]
    straight = _train(args + ["--steps", "24", "--ckpt-dir", d1,
                              "--save-every", "100"])
    _train(args + ["--steps", "12", "--ckpt-dir", d2, "--save-every", "12"])
    assert CheckpointManager(d2).latest_step() == 12
    resumed = _train(args + ["--steps", "24", "--ckpt-dir", d2,
                             "--save-every", "100"])
    assert abs(straight["loss_last"] - resumed["loss_last"]) < 1e-3
    assert CheckpointManager(d2).latest_step() == 24


def test_serve_ckpt_dir_serves_trained_params(tmp_path, monkeypatch):
    """train --calibrate saves the calibrated params as step steps + 1;
    serve --ckpt-dir serves exactly those (dense mode: no calibration
    permutes them), not the seed's."""
    d = str(tmp_path / "ck")
    r = _train(["--steps", "3", "--batch", "4", "--seq", "32",
                "--ckpt-dir", d, "--calibrate"])
    assert "calibration" in r
    mgr = CheckpointManager(d)
    assert mgr.latest_step() == 4
    cfg = reduce_config(get_config("granite-3-2b"))
    seeded = tsteps.init_train_state(torch.Generator().manual_seed(0), cfg,
                                     OptConfig())[0]
    saved, extra = mgr.restore({"params": seeded})
    assert extra["step"] == 4
    served = {}
    orig = tserve.run_engine

    def spy(cfg, params, *a, **k):
        served.setdefault("params", params)
        return orig(cfg, params, *a, **k)
    monkeypatch.setattr(tserve, "run_engine", spy)
    with contextlib.redirect_stdout(io.StringIO()):
        rep = tserve.main(["--reduced", "--device", "cpu", "--ckpt-dir", d,
                           "--batch", "2", "--prompt-len", "8",
                           "--gen-len", "4", "--mor", "dense"])
    assert rep["requests_finished"] == 2
    got, want = _tpaths(served["params"]), _tpaths(saved["params"])
    seed = _tpaths(seeded)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert any(not np.array_equal(got[k], seed[k]) for k in want)
