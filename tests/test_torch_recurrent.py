"""The recurrent families against the JAX package: rwkv6-3b (RWKV6 time
mix + the ReLU^2 channel mix, a native MoR target) and zamba2-7b (Mamba2
+ one shared attention and SwiGLU block, relufied), reduced and float32.

Weights come from the JAX ``init`` and pass to the port as numpy
(``repro_torch.convert``); inputs come from a numpy seed.  Integer
results (masks, permutations, proxies) must be equal.  Tolerances: the
layers and the reduced models' logits are float32 computations of the
same sums in other orders (chunked scans of at most 16 positions, sums
over d 128 or d_ff 256 of terms of magnitude ~1): rtol = atol = 1e-5;
regression coefficients over a few hundred terms to 1e-4 relative and
1e-5 absolute, the Pearson mean to 2e-4, as in ``tests/test_torch_zoo.
py``.  JAX kernel mode runs the Pallas kernels in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import param_count as jparam_count
from repro.configs import reduce_config as jreduce_config
from repro.core.deploy import calibrate_hybrid as jcalibrate_hybrid
from repro.core.deploy import calibrate_lm as jcalibrate_lm
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro.models.layers import rwkv as jrwkv
from repro.models.layers import ssm as jssm
from repro_torch import convert
from repro_torch.configs import get_config, param_count, reduce_config
from repro_torch.core.deploy import calibrate_hybrid, calibrate_lm
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import paged_attention as tpk
from repro_torch.models import get_model
from repro_torch.models.layers import rwkv, ssm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RECURRENT = ("rwkv6-3b", "zamba2-7b")
TOL = 1e-5
MODES = ("dense", "exact", "tiled", "kernel")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _model(arch):
    jcfg = jreduce_config(jget_config(arch))
    cfg = reduce_config(get_config(arch))
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_numpy(cfg, _np(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _batches(cfg, n=2):
    return [tpipe.make_batch(cfg, 2, 32, seed=0, step=i)["tokens"]
            for i in range(n)]


def _calibrate(arch, dead_odd_tiles=False):
    """Both packages calibrated on the same batches (``calibrate_lm`` for
    rwkv's channel mix, ``calibrate_hybrid`` for zamba2's shared MLP);
    with ``dead_odd_tiles`` the odd 128-column tiles of the MoR layer
    are made statically dead, so that the predictor really skips (random
    weights leave every tile live).  -> (jcfg, jparams, jmor, cfg,
    params, mor, reports)."""
    jcfg, jparams, cfg, params = _model(arch)
    bs = _batches(cfg)
    hybrid = cfg.family == "hybrid"
    jcal = jcalibrate_hybrid if hybrid else jcalibrate_lm
    tcal = calibrate_hybrid if hybrid else calibrate_lm
    jp, jmor, jrep = jcal(jparams, jcfg, jget_model(jcfg).forward,
                          iter([{"tokens": jnp.asarray(b)} for b in bs]), 2)
    tp, tmor, trep = tcal(params, cfg, get_model(cfg).forward,
                          iter([{"tokens": _t(b)} for b in bs]), 2)
    if dead_odd_tiles:
        (group, layer), = _np(jmor).items()
        layer = {k: np.array(v) for k, v in layer.items()}
        dead = (np.arange(layer["m"].shape[-1]) // 128) % 2 == 1
        layer["bn_bias"] = np.where(dead, -1e3, layer["bn_bias"]).astype(
            np.float32)
        layer["enable"] = layer["enable"] | dead
        layer["is_proxy"] = layer["is_proxy"] & ~dead
        layer["proxy_slot"] = np.where(dead, -1, layer["proxy_slot"]
                                       ).astype(np.int32)
        jmor = {group: {k: jnp.asarray(v) for k, v in layer.items()}}
        tmor = convert.mor_from_numpy({group: layer}, device="cpu")
    return jcfg, jp, jmor, cfg, tp, tmor, (jrep, trep)


@pytest.fixture(scope="module")
def calibrated():
    return {arch: _calibrate(arch, dead_odd_tiles=True)
            for arch in RECURRENT}


# -- configs ------------------------------------------------------------------

def test_recurrent_configs_match_reference():
    """The published configs, their reduction (ssm_state / chunk, the
    hybrid's 5 layers in segments of 2 under a window of 16, RWKV heads
    of 16) and the analytic parameter counts equal JAX's: 3.06 B for
    rwkv6-3b, 6.71 B total (9.18 B active: the shared block counted at
    each of its 13 applications) for zamba2-7b."""
    import dataclasses
    for arch in RECURRENT:
        for red in (False, True):
            jc, tc = jget_config(arch), get_config(arch)
            if red:
                jc, tc = jreduce_config(jc), reduce_config(tc)
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
            assert param_count(tc) == jparam_count(jc)
    assert param_count(get_config("rwkv6-3b")) == (3061841920, 3061841920)
    assert param_count(get_config("zamba2-7b")) == (6714753024, 9181003776)
    assert tpk.gqa_body(torch.bfloat16, get_config("zamba2-7b").head_dim
                        ) == "tensor_cores"


# -- RWKV6 layers -------------------------------------------------------------

def _rwkv_inputs(seed, B=2, S=13, H=3, hd=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.2, 1.0, size=(B, S, H, hd)).astype(np.float32)
    w[0, 3, 0, :2] = 1e-6                 # below the e^-10 clamp
    u = rng.normal(size=(H, hd)).astype(np.float32) * 0.5
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("S", [5, 13, 16])
def test_wkv6_chunked_matches_jax(S):
    """The chunked wkv (chunks of 8, S padded) from a zero and from a
    carried float32 state: outputs and the final state."""
    r, k, v, w, u, s0 = _rwkv_inputs(S, S=S)
    want = jrwkv._wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)))
    got = rwkv._wkv6_chunked(*map(_t, (r, k, v, w, u)))
    _close(got, want)
    want, wst = jrwkv._wkv6_chunked(*map(jnp.asarray, (r, k, v, w, u)),
                                    initial_state=jnp.asarray(s0),
                                    return_state=True)
    got, gst = rwkv._wkv6_chunked(*map(_t, (r, k, v, w, u)),
                                  initial_state=_t(s0), return_state=True)
    _close(got, want)
    _close(gst, wst)


def _valid(n_valid, C):
    return np.arange(C)[None, :] < np.asarray(n_valid)[:, None]


def test_timemix_chunk_and_decode_match_jax():
    """``timemix_chunk`` on a ragged chunk (one row idle) from a carried
    shift and wkv state, then ``timemix_decode`` from its result: outputs
    and the new states."""
    jcfg, jparams, cfg, params = _model("rwkv6-3b")
    jtm = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["tm"])
    ttm = {k: v[0] for k, v in params["layers"]["tm"].items()}
    H, hd = cfg.d_model // cfg.rwkv_head_size, cfg.rwkv_head_size
    rng = np.random.default_rng(3)
    B, C = 3, 8
    x = rng.normal(size=(B, C, cfg.d_model)).astype(np.float32)
    sh = rng.normal(size=(B, cfg.d_model)).astype(np.float32)
    s0 = rng.normal(size=(B, H, hd, hd)).astype(np.float32) * 0.1
    valid = _valid([8, 3, 0], C)
    want = jrwkv.timemix_chunk(jtm, jcfg, *map(jnp.asarray,
                                               (x, sh, s0, valid)))
    got = rwkv.timemix_chunk(ttm, cfg, *map(_t, (x, sh, s0, valid)))
    for g, w in zip(got, want):
        _close(g, w)
    # the idle row's state is left exactly as it was
    np.testing.assert_array_equal(got[1][2].numpy(), sh[2])
    np.testing.assert_array_equal(got[2][2].numpy(), s0[2])
    xd = rng.normal(size=(B, cfg.d_model)).astype(np.float32)
    wy, wst = jrwkv.timemix_decode(jtm, jcfg, jnp.asarray(xd), {
        "shift": want[1], "wkv": want[2]})
    gy, gst = rwkv.timemix_decode(ttm, cfg, _t(xd), {"shift": got[1],
                                                     "wkv": got[2]})
    _close(gy, wy)
    _close(gst["wkv"], wst["wkv"])


@pytest.mark.parametrize("mode", MODES)
def test_chanmix_forward_matches_jax(calibrated, mode):
    """The ReLU^2 channel mix through the calibrated MoR layer (odd
    column tiles dead) in each mode: the output and the realised skip
    statistics.  In tiled and kernel mode half the tiles are skipped."""
    jcfg, jparams, jmor, cfg, params, mor, _ = calibrated["rwkv6-3b"]
    jcm = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["cm"])
    tcm = {k: v[0] for k, v in params["layers"]["cm"].items()}
    jl = jax.tree_util.tree_map(lambda a: a[0], jmor["layers"])
    tl = {k: v[0] for k, v in mor["layers"].items()}
    rng = np.random.default_rng(5)
    x, xp = (rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
             for _ in range(2))
    want, wst = jrwkv.chanmix_forward(jcm, jcfg, jnp.asarray(x),
                                      jnp.asarray(xp), mor=jl,
                                      mor_mode=mode)
    got, gst = rwkv.chanmix_forward(tcm, cfg, _t(x), _t(xp), mor=tl,
                                    mor_mode=mode)
    _close(got, want)
    assert set(gst) == set(wst)
    for k in gst:
        _close(gst[k], wst[k])
    if mode in ("tiled", "kernel"):
        assert float(gst["frac_tiles_computed"]) == 0.5


# -- Mamba2 layers ------------------------------------------------------------

def test_ssd_matches_jax():
    """The chunked SSD core over 3 chunks from a carried state."""
    rng = np.random.default_rng(7)
    B, nc, Q, H, P, N = 2, 3, 4, 3, 5, 6
    xbar = rng.normal(size=(B, nc, Q, H, P)).astype(np.float32)
    Bc, Cc = (rng.normal(size=(B, nc, Q, N)).astype(np.float32)
              for _ in range(2))
    la = -rng.uniform(0, 1.5, size=(B, nc, Q, H)).astype(np.float32)
    s0 = rng.normal(size=(B, H, N, P)).astype(np.float32)
    want = jssm._ssd(*map(jnp.asarray, (xbar, Bc, Cc, la, s0)))
    got = ssm._ssd(*map(_t, (xbar, Bc, Cc, la, s0)))
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_mamba2_chunk_and_decode_match_jax():
    """``mamba2_chunk`` on a ragged 24-row chunk (two SSD chunks of 16,
    padded; rows valid for 24, 5 and 0 tokens) from a carried conv
    history and SSD state: the conv history advances by exactly the
    valid count.  Then two chained chunks equal one long forward, and
    ``mamba2_decode`` continues from the chunk's state."""
    jcfg, jparams, cfg, params = _model("zamba2-7b")
    jm = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["mamba_layers"]["mamba"])
    tm = {k: v[0] for k, v in params["mamba_layers"]["mamba"].items()}
    d_in, H, P, N = ssm._dims(cfg)
    rng = np.random.default_rng(11)
    B, C = 3, 24
    x = rng.normal(size=(B, C, cfg.d_model)).astype(np.float32)
    cache = {"conv": rng.normal(size=(B, 3, d_in + 2 * N)).astype(
        np.float32), "ssm": rng.normal(size=(B, H, N, P)).astype(
            np.float32)}
    valid = _valid([24, 5, 0], C)
    want = jssm.mamba2_chunk(jm, jcfg, jnp.asarray(x),
                             {k: jnp.asarray(v) for k, v in cache.items()},
                             jnp.asarray(valid))
    got = ssm.mamba2_chunk(tm, cfg, _t(x), {k: _t(v) for k, v in
                                            cache.items()}, _t(valid))
    _close(got[0], want[0])
    for k in ("conv", "ssm"):
        _close(got[1][k], want[1][k])
        np.testing.assert_array_equal(got[1][k][2].numpy(), cache[k][2])
    # two chunks of 7 + 9 tokens from a zero state equal the forward
    zero = {k: torch.zeros_like(_t(v)) for k, v in cache.items()}
    full = ssm.mamba2_forward(tm, cfg, _t(x[:, :16]))
    y1, c1 = ssm.mamba2_chunk(tm, cfg, _t(x[:, :7]), zero,
                              torch.ones((B, 7), dtype=torch.bool))
    y2, _ = ssm.mamba2_chunk(tm, cfg, _t(x[:, 7:16]), c1,
                             torch.ones((B, 9), dtype=torch.bool))
    _close(torch.cat([y1, y2], 1), full, 1e-4)
    _close(full, jssm.mamba2_forward(jm, jcfg, jnp.asarray(x[:, :16])))
    xd = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    wy, wc = jssm.mamba2_decode(jm, jcfg, jnp.asarray(xd), want[1])
    gy, gc = ssm.mamba2_decode(tm, cfg, _t(xd), got[1])
    _close(gy, wy)
    _close(gc["ssm"], wc["ssm"])
    _close(gc["conv"], wc["conv"])


# -- the models ----------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_forward_logits_match_jax(arch):
    """Reduced forward logits and the calibration taps (rwkv: (L, B*S,
    N) of the channel mix; zamba2: (n_seg, B*S, N) of the shared MLP,
    one entry per application): p_bin equal, p_base allclose."""
    jcfg, jparams, cfg, params = _model(arch)
    tk = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13)
                                           ).astype(np.int32)
    want, waux = jget_model(jcfg).forward(jparams, jcfg,
                                          {"tokens": jnp.asarray(tk)},
                                          with_taps=True)
    got, gaux = get_model(cfg).forward(params, cfg, {"tokens": _t(tk)},
                                       with_taps=True)
    assert got.shape == (2, 13, cfg.vocab_size)
    _close(got, want)
    wt, gt = waux["taps"], gaux["taps"]
    n = 2 if arch == "zamba2-7b" else cfg.n_layers
    assert gt["p_bin"].shape == (n, 26, cfg.d_ff)
    np.testing.assert_array_equal(gt["p_bin"].numpy(),
                                  np.asarray(wt["p_bin"]))
    _close(gt["p_base"], wt["p_base"])


@pytest.mark.parametrize("arch", RECURRENT)
def test_decode_step_matches_jax(arch):
    """Three static-batch decode steps from ``cache_init`` (rwkv: state
    only; zamba2: mamba state and the shared attention's ring at a
    shared position): logits and every cache leaf."""
    jcfg, jparams, cfg, params = _model(arch)
    japi, api = jget_model(jcfg), get_model(cfg)
    jcache = japi.cache_init(jcfg, 2, 8, jnp.float32)
    cache = api.cache_init(cfg, 2, 8, torch.float32, "cpu")
    rng = np.random.default_rng(2)
    for _ in range(3):
        tk = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        want, jcache = japi.decode_step(jparams, jcfg, jnp.asarray(tk),
                                        jcache)
        got = api.decode_step(params, cfg, _t(tk), cache)
        _close(got, want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jcache),
                            jax.tree_util.tree_leaves(
                                jax.tree_util.tree_map(
                                    lambda t: t.numpy(), cache))):
        _close(g, w)


# -- calibration ---------------------------------------------------------------

@pytest.mark.parametrize("arch", RECURRENT)
def test_calibration_matches_jax(arch):
    """``calibrate_lm`` on rwkv's channel mix (target ``cm.w_up``) and
    ``calibrate_hybrid`` on zamba2's shared MLP (its taps folded over the
    segments): the integer MoR fields and the permutations equal JAX's,
    the regression allclose, the permuted weights equal.  Then the
    calibrated forward in kernel mode equals JAX's."""
    jcfg, jp, jmor, cfg, tp, tmor, (jrep, trep) = _calibrate(arch)
    (group,) = tuple(jmor)
    assert tuple(tmor) == (group,) == (
        ("shared",) if arch == "zamba2-7b" else ("layers",))
    want, got = _np(jmor[group]), tmor[group]
    for key in ("enable", "proxy_slot", "is_proxy", "perm", "inv_perm",
                "bn_scale"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    for key in ("m", "b", "bn_bias"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(trep["pearson_mean"], jrep["pearson_mean"],
                               atol=2e-4)
    assert trep["n_proxies_mean"] == jrep["n_proxies_mean"]
    if arch == "zamba2-7b":
        tw, jw = tp["shared"]["mlp"], jp["shared"]["mlp"]
        keys = ("w_gate", "w_up", "w_down")
    else:
        tw, jw = tp["layers"]["cm"], jp["layers"]["cm"]
        keys = ("w_up", "w_down")
    for key in keys:
        np.testing.assert_array_equal(tw[key].numpy(),
                                      np.asarray(jw[key], np.float32))
    tk = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 16)
                                           ).astype(np.int32)
    want_l, _ = jget_model(jcfg).forward(jp, jcfg, {"tokens": jnp.asarray(
        tk)}, mor=jmor, mor_mode="kernel")
    got_l, _ = get_model(cfg).forward(tp, cfg, {"tokens": _t(tk)},
                                      mor=tmor, mor_mode="kernel")
    _close(got_l, want_l)


@pytest.mark.parametrize("mode", ["tiled", "kernel"])
def test_hybrid_forward_mor_stats_per_segment(calibrated, mode):
    """zamba2's calibrated forward (odd tiles dead) in tiled and kernel
    mode: logits equal JAX's, and the shared MLP's skip statistics come
    back n_seg-stacked, one entry per application."""
    jcfg, jparams, jmor, cfg, params, mor, _ = calibrated["zamba2-7b"]
    tk = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)
                                           ).astype(np.int32)
    want, waux = jget_model(jcfg).forward(jparams, jcfg, {
        "tokens": jnp.asarray(tk)}, mor=jmor, mor_mode=mode)
    got, gaux = get_model(cfg).forward(params, cfg, {"tokens": _t(tk)},
                                       mor=mor, mor_mode=mode)
    _close(got, want)
    for k, v in gaux["mor_stats"].items():
        assert v.shape == (2,)
        _close(v, waux["mor_stats"][k])
    np.testing.assert_array_equal(
        gaux["mor_stats"]["frac_tiles_computed"].numpy(), [0.5, 0.5])


def test_attach_plans_gives_the_shared_layer_its_worst_budget(calibrated):
    """zamba2's one shared MoRLayer takes per-application budgets (the
    telemetry's n_seg-stacked calibration) as their maximum, as JAX's
    ``attach_plans`` does; a stacked rwkv group keeps one per layer."""
    from repro.core.deploy import attach_plans as jattach_plans
    from repro_torch.core.deploy import attach_plans
    for arch, caps in (("zamba2-7b", [0.25, 0.5]), ("rwkv6-3b",
                                                    [0.25, 0.5])):
        jcfg, _, jmor, cfg, _, mor, _ = calibrated[arch]
        (group,) = tuple(mor)
        want = jattach_plans(jmor, jcfg, "kernel", capacities={
            group: np.asarray(caps, np.float32)})[group]
        got = attach_plans(mor, cfg, "kernel", capacities={group: caps})[
            group]
        np.testing.assert_array_equal(np.asarray(got.cap_live),
                                      np.asarray(want.cap_live))
    assert got.layer(1).cap_live == 0.5


# -- zamba2's shared attention on the paged kernel's plain version -----------

def test_gqa_paged_flash_at_zamba2_head_dim():
    """The plain version at zamba2's geometry (G 1, head dim 112) under a
    window equals ``ref.gqa_paged_ref``; the CUDA-core body's head plan
    at D 112 takes 16 rows a block (its rows padded to 128 accumulator
    slots: 2048 / 128), and its blocks cover every (row, head) pair once
    for G 1-48 at decode and mixed chunks."""
    rng = np.random.default_rng(12)
    B, C, W, page, hkv, D, window = 3, 4, 5, 8, 2, 112, 20
    n_pages = 2 * B * W + 1
    q = rng.normal(size=(B, C, hkv, D)).astype(np.float32)
    kp, vp = (rng.normal(size=(n_pages, page, hkv, D)).astype(np.float32)
              for _ in range(2))
    pp = rng.integers(-1, W * page, size=(n_pages, page)).astype(np.int32)
    pp[0] = -1
    tbl = rng.integers(1, n_pages, size=(B, W)).astype(np.int32)
    tbl[0, 1] = 0
    qpos = (W * page // 2 + np.arange(C)[None, :]
            + rng.integers(0, 8, size=(B, 1))).astype(np.int32)
    want = np.asarray(jref.gqa_paged_ref(*map(jnp.asarray, (
        q, kp, vp, pp, tbl, qpos)), window=window))
    got = tpk.gqa_paged_flash(*map(_t, (q, kp, vp, pp, tbl, qpos)),
                              window=window).numpy()
    _close(got, want)
    assert 112 in tpk.HEAD_DIMS
    assert tpk.gqa_heads_plan(1, 112) == (16, 1)
    assert [tpk.gqa_cc_rmax(d) for d in (32, 64, 96, 112, 128)] == \
        [64, 32, 21, 16, 16]
    assert len(tpk.gqa_cc_blocks(32, 1, 112)) == 2
    for G in range(1, 49):
        rows, heads = tpk.gqa_heads_plan(G, 112)
        assert rows * heads <= 16
        for Cq in (1, 8, 32, 37):
            seen = np.zeros((Cq, G), np.int64)
            for c0, nr, g0, ng in tpk.gqa_cc_blocks(Cq, G, 112):
                seen[c0:c0 + nr, g0:g0 + ng] += 1
            assert np.all(seen == 1), (G, Cq)


def test_convert_checks_the_recurrent_layouts():
    """An rwkv tree without its ``in_norm`` and a zamba2 tree without its
    shared block or its tail are refused; the MoR tree's unstacked
    ``shared`` group carries across."""
    _, jparams, cfg, _ = _model("rwkv6-3b")
    bad = {k: v for k, v in _np(jparams).items() if k != "in_norm"}
    with pytest.raises(ValueError, match="in_norm"):
        convert.params_from_numpy(cfg, bad, device="cpu")
    _, jparams, cfg, params = _model("zamba2-7b")
    assert set(params) == {"embed", "mamba_layers", "tail_layers",
                           "shared", "final_norm", "lm_head"}
    for key in ("shared", "tail_layers"):
        bad = {k: v for k, v in _np(jparams).items() if k != key}
        with pytest.raises(ValueError, match=key):
            convert.params_from_numpy(cfg, bad, device="cpu")
