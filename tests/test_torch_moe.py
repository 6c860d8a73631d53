"""The port's MoE slice against the JAX package on reduced
deepseek-v2-236b (float32): the dispatch, ``moe_apply`` in every MoR
mode over the expert grid, the per-expert capacity clamp,
``calibrate_moe``, ``convert`` for the moe family, the serve CLI, and
the paged and slotted engines serving MLA + MoE token for token.

Tolerances: integer results (slots, masks, permutations, counters,
tokens) must be equal; the fractions computed from them agree to one
float32 rounding (rtol = 1e-6: the two frameworks divide a mean in
different ways), and the telemetry's float64 means of them to 1e-12.  MoE
outputs compose a router softmax and three float32 matmuls per expert
in another summation order: rtol = atol = 2e-4; regression
coefficients over 128-term sums: 1e-5 absolute on m (order 1e-2) and
b, 2e-4 on the Pearson c.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.configs.base import MoRConfig as JMoRConfig
from repro.core.deploy import calibrate_moe as jcalibrate_moe
from repro.core.executor import MoRExecutionPlan as JPlan
from repro.models import get_model as jget_model
from repro.models.layers import moe as jmoe
from repro.serving import Engine as JEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.configs.base import MoRConfig
from repro_torch.core.deploy import calibrate_moe
from repro_torch.core.executor import MoRExecutionPlan as TPlan
from repro_torch.core.predictor import (predictor_eval_count,
                                        reset_predictor_eval_count)
from repro_torch.models import get_model
from repro_torch.models.layers import moe as tmoe
from repro_torch.serving import Engine

ARCH = "deepseek-v2-236b"
TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _same_stat(got, want, msg):
    """Integer tile counters equal; fractions to one float32 rounding."""
    want = np.asarray(want)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   err_msg=str(msg))
    else:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(msg))


# -- dispatch ----------------------------------------------------------------

def _routing(rng, T, E, k, masked):
    top = np.stack([rng.choice(E, size=k, replace=False)
                    for _ in range(T)]).astype(np.int32)
    if masked:
        top[rng.random(T) < 0.3] = E            # masked-token sentinel
    return top


@pytest.mark.parametrize("seed", range(2))
def test_dispatch_indices_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        E = int(rng.integers(1, 9))
        k = int(rng.integers(1, min(E, 4) + 1))
        T = int(rng.integers(1, 33))
        C = int(rng.integers(1, 2 * T + 1))
        top = _routing(rng, T, E, k, masked=seed % 2 == 0)
        want = np.asarray(jmoe._dispatch_indices(jnp.asarray(top), E, C))
        got = tmoe._dispatch_indices(_t(top), E, C)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_dispatch_indices_properties():
    """``tests/test_moe_modes.py``'s properties, on the port: a kept pair
    lands in its own expert's buffer once, drops happen only on
    overflow and earlier tokens win, masked pairs land on E*C."""
    for trial in range(20):
        rng = np.random.default_rng(trial)
        E = int(rng.integers(1, 9))
        k = int(rng.integers(1, min(E, 4) + 1))
        T = int(rng.integers(1, 33))
        C = int(rng.integers(1, 2 * T + 1))
        top = _routing(rng, T, E, k, masked=trial % 3 == 0)
        slot = tmoe._dispatch_indices(_t(top), E, C).numpy()
        seen = {}
        for t in range(T):
            for kk in range(k):
                e, s = top[t, kk], slot[t, kk]
                if e >= E:
                    assert s == E * C
                elif s < E * C:
                    assert s // C == e and s % C not in seen.setdefault(e,
                                                                        set())
                    seen[e].add(s % C)
        counts = np.bincount(top[top < E].reshape(-1), minlength=E)
        for e in range(E):
            assert len(seen.get(e, ())) == min(counts[e], C)
            dropped = [t for t in range(T) for kk in range(k)
                       if top[t, kk] == e and slot[t, kk] == E * C]
            kept = [t for t in range(T) for kk in range(k)
                    if top[t, kk] == e and slot[t, kk] < E * C]
            if dropped:
                assert counts[e] > C and max(kept) <= min(dropped)


# -- moe_apply over the expert grid -----------------------------------------

def _cfgs(E, k):
    """Reduced deepseek with E experts, top-k, and (4, 16) MoR tiles, so
    that the 64-wide experts span four column tiles."""
    kw = dict(n_experts=E, top_k=k)
    jc = jreduce_config(jget_config(ARCH))
    tc = reduce_config(get_config(ARCH))
    jc = jc.replace(mor=JMoRConfig(enabled=True, relufied=True, tile_m=4,
                                   tile_n=16), **kw)
    tc = tc.replace(mor=MoRConfig(enabled=True, relufied=True, tile_m=4,
                                  tile_n=16), **kw)
    return jc, tc


def _truth_proxy(f, E, dead_tiles=False, tile_n=16):
    """(E,)-stacked MoRLayer whose skips are exactly the true zeros
    (``tests/test_moe_modes.py::truth_proxy_layer``): every neuron is its
    own proxy at base precision and the binary rookie always votes skip.
    ``dead_tiles`` folds a bias of -1e3 into every odd column tile, so
    that whole tiles die and the kernels skip them."""
    idx = np.arange(f, dtype=np.int32)
    bias = np.zeros(f, np.float32)
    if dead_tiles:
        bias[(idx // tile_n) % 2 == 1] = -1e3
    one = {"m": np.zeros(f, np.float32), "b": np.full(f, -1.0, np.float32),
           "enable": np.ones(f, bool), "proxy_slot": idx,
           "is_proxy": np.zeros(f, bool), "perm": idx, "inv_perm": idx,
           "bn_scale": np.ones(f, np.float32), "bn_bias": bias}
    return {k: np.broadcast_to(v[None], (E,) + v.shape).copy()
            for k, v in one.items()}


def _moe_case(E, k, seed=0):
    jc, tc = _cfgs(E, k)
    jp = jmoe.moe_init(jax.random.PRNGKey(E * 10 + k), jc)
    tp = jax.tree_util.tree_map(_t, _np(jp))
    x = np.random.default_rng(seed).normal(
        size=(3, 7, tc.d_model)).astype(np.float32)
    mask = np.ones((3, 7), bool)
    mask[1, 4:] = mask[2, 2:] = False
    return jc, tc, jp, tp, x, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("E,k", [(4, 1), (4, 2), (8, 1), (8, 2)])
@pytest.mark.parametrize("mode", ["dense", "exact", "tiled", "kernel"])
def test_moe_apply_matches_jax(mode, E, k, masked):
    """One MoE layer, with and without the serving ``token_mask``:
    outputs and the auxiliary losses allclose, the (E,)-shaped
    ``mor_stats`` equal.  Odd column tiles are dead, so the tiled and
    kernel paths really skip."""
    jc, tc, jp, tp, x, mask = _moe_case(E, k)
    em = _truth_proxy(tc.moe_d_ff, E, dead_tiles=True)
    tm = dict(token_mask=mask) if masked else {}
    want, waux = jmoe.moe_apply(
        jp, jc, jnp.asarray(x), mor={"experts": jax.tree_util.tree_map(
            jnp.asarray, em)}, mor_mode=mode,
        **{k_: jnp.asarray(v) for k_, v in tm.items()})
    got, gaux = tmoe.moe_apply(tp, tc, _t(x), mor={"experts": {
        k_: _t(v) for k_, v in em.items()}}, mor_mode=mode,
        **{k_: _t(v) for k_, v in tm.items()})
    rows = mask if masked else np.ones_like(mask)
    np.testing.assert_allclose(got.numpy()[rows], np.asarray(want)[rows],
                               rtol=TOL, atol=TOL)
    for key in ("lb_loss", "router_entropy"):
        np.testing.assert_allclose(float(gaux[key]), float(waux[key]),
                                   rtol=1e-5, err_msg=key)
    assert ("mor_stats" in gaux) == (mode != "dense") == \
        ("mor_stats" in waux)
    for key, v in gaux.get("mor_stats", {}).items():
        assert tuple(v.shape) == (E,), key
        _same_stat(v, waux["mor_stats"][key], key)
    if mode in ("tiled", "kernel"):
        assert float(gaux["mor_stats"]["frac_tiles_computed"].max()) <= 0.5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("E,k", [(4, 2), (8, 1)])
def test_moe_modes_agree(E, k, masked):
    """exact == tiled == kernel == dense on the port when the predictor
    skips only true zeros (``test_moe_modes_differential``)."""
    _, tc, _, tp, x, mask = _moe_case(E, k, seed=1)
    em = {k_: _t(v) for k_, v in _truth_proxy(tc.moe_d_ff, E).items()}
    tm = {"token_mask": _t(mask)} if masked else {}
    rows = mask if masked else np.ones_like(mask)
    y_dense, _ = tmoe.moe_apply(tp, tc, _t(x), **tm)
    outs = {}
    for mode in ("exact", "tiled", "kernel"):
        y, _ = tmoe.moe_apply(tp, tc, _t(x), mor={"experts": em},
                              mor_mode=mode, **tm)
        outs[mode] = y.numpy()[rows]
        np.testing.assert_allclose(outs[mode], y_dense.numpy()[rows],
                                   rtol=TOL, atol=2e-3, err_msg=mode)
    np.testing.assert_allclose(outs["tiled"], outs["exact"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(outs["kernel"], outs["tiled"], rtol=TOL,
                               atol=TOL)


def test_moe_dense_mode_runs_no_predictor():
    """MoR off means no predictor work; a live mode evaluates it exactly
    once per layer call (all experts at once), as JAX counts one per
    trace of the vmapped body."""
    _, tc, _, tp, x, _ = _moe_case(4, 2)
    em = {k_: _t(v) for k_, v in _truth_proxy(tc.moe_d_ff, 4).items()}
    reset_predictor_eval_count()
    _, aux = tmoe.moe_apply(tp, tc, _t(x), mor={"experts": em},
                            mor_mode="dense")
    assert predictor_eval_count() == 0 and "mor_stats" not in aux
    _, aux = tmoe.moe_apply(tp, tc, _t(x),
                            mor={"experts": TPlan(em, mode="dense")},
                            mor_mode="tiled")
    assert predictor_eval_count() == 0 and "mor_stats" not in aux
    for mode in ("tiled", "kernel"):
        reset_predictor_eval_count()
        tmoe.moe_apply(tp, tc, _t(x), mor={"experts": em}, mor_mode=mode)
        assert predictor_eval_count() == 1, mode


def test_expert_cap_live_clamps_per_expert():
    """Per-expert budgets (an (E,) device tensor) clamp each expert's
    realised tile compute on its own, and equal JAX's per-expert stats
    (``test_moe_modes.py::test_expert_cap_live_clamps_per_expert``)."""
    E, C, d, f = 3, 16, 64, 256
    rng = np.random.default_rng(5)
    eb, wu, wd = (rng.normal(size=s).astype(np.float32)
                  for s in ((E, C, d), (E, d, f), (E, f, d)))
    idx = np.arange(f, dtype=np.int32)
    one = {"m": np.ones(f, np.float32), "b": np.zeros(f, np.float32),
           "enable": np.zeros(f, bool), "proxy_slot": np.full(f, -1,
                                                             np.int32),
           "is_proxy": np.zeros(f, bool), "perm": idx, "inv_perm": idx,
           "bn_scale": np.ones(f, np.float32),
           "bn_bias": np.zeros(f, np.float32)}
    em = {k: np.broadcast_to(v[None], (E,) + v.shape).copy()
          for k, v in one.items()}
    caps = np.asarray([0.25, 0.5, 1.0], np.float32)
    n_tiles = (C // 8) * (f // 64)
    for mode in ("tiled", "kernel"):
        jplan = JPlan(jax.tree_util.tree_map(jnp.asarray, em), mode=mode,
                      tile_m=8, tile_n=64, cap_live=jnp.asarray(caps))
        wout, wstats = jplan.expert_ffn(jnp.asarray(eb), jnp.asarray(wu),
                                        jnp.asarray(wd), activation="relu")
        tplan = TPlan({k: _t(v) for k, v in em.items()}, mode=mode,
                      tile_m=8, tile_n=64, cap_live=_t(caps))
        out, stats = tplan.expert_ffn(_t(eb), _t(wu), _t(wd),
                                      activation="relu")
        comp = stats["frac_tiles_computed"].numpy()
        for e in range(E):
            budget = np.ceil(float(caps[e]) * n_tiles) / n_tiles
            assert comp[e] <= budget + 1e-6, (mode, e, comp[e], budget)
        assert comp[0] < comp[1] < comp[2]
        for key, v in stats.items():
            _same_stat(v, wstats[key], (mode, key))
        np.testing.assert_allclose(out.numpy(), np.asarray(wout),
                                   rtol=TOL, atol=2e-3)


# -- calibration and conversion ---------------------------------------------

def _calib_batches(tmod, vocab, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": tmod(rng.integers(0, vocab, (2, 32)).astype(
            np.int32))}


@pytest.fixture(scope="module")
def calibrated():
    """Reduced deepseek with its experts widened to moe_d_ff 256 (two
    column tiles), JAX-initialised and calibrated by both packages from
    the same batches, with the trailing half of every expert's columns
    made dead by the injection."""
    jcfg = jreduce_config(jget_config(ARCH)).replace(moe_d_ff=256)
    cfg = reduce_config(get_config(ARCH)).replace(moe_d_ff=256)
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    jout = jcalibrate_moe(jparams, jcfg, japi.forward, _calib_batches(
        jnp.asarray, cfg.vocab_size), 2, inject_dead_frac=0.5)
    tparams = convert.params_from_numpy(cfg, _np(jparams), device="cpu")
    tout = calibrate_moe(tparams, cfg, get_model(cfg).forward,
                         _calib_batches(torch.as_tensor, cfg.vocab_size), 2,
                         inject_dead_frac=0.5)
    return jcfg, cfg, jout, tout


def test_calibrate_moe_matches_jax(calibrated):
    _, cfg, (jp, jmor, jrep), (tp, tmor, trep) = calibrated
    jmor = _np(jmor)
    assert trep["injected_dead_cols"] == jrep["injected_dead_cols"] == 128
    groups = [("dense_layers", jmor["dense_layers"], tmor["dense_layers"]),
              ("experts", jmor["moe_layers"]["experts"],
               tmor["moe_layers"]["experts"])]
    for name, want, got in groups:
        for key in ("enable", "proxy_slot", "is_proxy", "perm", "inv_perm",
                    "bn_scale"):
            np.testing.assert_array_equal(got[key].numpy(), want[key],
                                          err_msg=(name, key))
        for key in ("m", "b", "bn_bias"):
            np.testing.assert_allclose(got[key].numpy(), want[key],
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=(name, key))
    assert tmor["moe_layers"]["experts"]["m"].shape == (1, 4, 256)
    np.testing.assert_allclose(trep["pearson_mean"], jrep["pearson_mean"],
                               atol=2e-4)
    for grp, sub in (("moe_layers", "moe"), ("dense_layers", "mlp")):
        for key in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(tp[grp][sub][key].numpy(),
                                          np.asarray(jp[grp][sub][key],
                                                     np.float32))


def test_calibrate_moe_without_clustering_matches_jax(calibrated):
    """``cluster_experts=False``: binary-rookie-only experts (identity
    permutation, no proxies), the weights left unpermuted; the dense
    layer is still clustered."""
    jcfg, cfg, _, _ = calibrated
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(1), jcfg)
    _, jmor, _ = jcalibrate_moe(jparams, jcfg, japi.forward, _calib_batches(
        jnp.asarray, cfg.vocab_size, seed=1), 1, cluster_experts=False)
    tparams = convert.params_from_numpy(cfg, _np(jparams), device="cpu")
    tp, tmor, _ = calibrate_moe(tparams, cfg, get_model(cfg).forward,
                                _calib_batches(torch.as_tensor,
                                               cfg.vocab_size, seed=1), 1,
                                cluster_experts=False)
    want, got = _np(jmor["moe_layers"]["experts"]), \
        tmor["moe_layers"]["experts"]
    for key in ("enable", "proxy_slot", "is_proxy", "perm", "inv_perm"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    assert torch.all(got["proxy_slot"] == -1)
    for key in ("w_gate", "w_up", "w_down"):
        assert tp["moe_layers"]["moe"][key] is \
            tparams["moe_layers"]["moe"][key]
    np.testing.assert_array_equal(
        tmor["dense_layers"]["perm"].numpy(),
        np.asarray(jmor["dense_layers"]["perm"]))


def test_convert_moe_round_trip(calibrated):
    jcfg, cfg, (jp, jmor, _), _ = calibrated
    tp = convert.params_from_numpy(cfg, _np(jp), device="cpu")
    assert jax.tree_util.tree_structure(_np(jp)) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda t: t.numpy(), tp))
    for (path, want), got in zip(
            jax.tree_util.tree_leaves_with_path(_np(jp)),
            jax.tree_util.tree_leaves(tp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want,
                                                              np.float32))
    tmor = convert.mor_from_numpy(_np(jmor), device="cpu")
    assert set(tmor) == {"dense_layers", "moe_layers"}
    assert set(tmor["moe_layers"]) == {"experts"}
    bad = dict(_np(jp))
    del bad["moe_layers"]
    with pytest.raises(ValueError, match="lack"):
        convert.params_from_numpy(cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        convert.params_from_numpy(cfg.replace(n_layers=3), _np(jp),
                                  device="cpu")


# -- the engine against JAX's -----------------------------------------------

@pytest.fixture(scope="module")
def engines(calibrated):
    jcfg, cfg, (jp, jmor, _), _ = calibrated
    tparams = convert.params_from_numpy(cfg, _np(jp), device="cpu")
    tmor = convert.mor_from_numpy(_np(jmor), device="cpu")
    prng = np.random.default_rng(7)
    prefix = prng.integers(0, cfg.vocab_size, 16)
    reqs = [(np.concatenate([prefix, prng.integers(0, cfg.vocab_size, n)]
                            ).astype(np.int32), g)
            for n, g in ((3, 4), (9, 3), (8, 5), (5, 3))]
    reqs.append((reqs[2][0].copy(), 4))
    return jcfg, jp, jmor, cfg, tparams, tmor, reqs


def _same_telemetry(teng, jeng):
    jtel, ttel = jeng.telemetry.summary(), teng.telemetry.summary()
    assert ttel.get("prefix_cache") == jtel.get("prefix_cache")
    assert ttel["n_dispatches"] == jtel["n_dispatches"]
    for grp in ("dense_mor_stats", "moe_mor_stats"):
        assert (grp in ttel) == (grp in jtel), grp
        for name, vals in ttel.get(grp, {}).items():
            np.testing.assert_allclose(vals, jtel[grp][name], rtol=1e-12,
                                       err_msg=(grp, name))
    return ttel


@pytest.mark.parametrize("mode", ["dense", "exact", "tiled", "kernel"])
@pytest.mark.parametrize("layout,prefix_cache", [
    ("paged", True), ("paged", False), ("slotted", False)])
def test_engine_matches_jax(engines, layout, prefix_cache, mode):
    """Greedy tokens, dispatches, telemetry (the (L, E) moe_mor_stats
    included) and prefix counters identical to JAX's engine."""
    jcfg, jp, jmor, cfg, tparams, tmor, reqs = engines
    kw = dict(n_slots=2, max_len=48, mor_mode=mode, layout=layout)
    if layout == "paged":
        kw["prefix_cache"] = prefix_cache
    jeng = JEngine(jcfg, jp, mor=jmor, **kw)
    want = jeng.run(list(reqs))
    teng = Engine(cfg, tparams, mor=tmor, **kw)
    assert teng.run(list(reqs)) == want
    assert teng.counters["dispatches"] == jeng.counters["dispatches"]
    if layout == "paged":
        assert teng._prefix_counters() == jeng._prefix_counters()
        assert (teng._prefix_counters()["prefix_hits"] > 0) == prefix_cache
    tel = _same_telemetry(teng, jeng)
    if mode in ("tiled", "kernel"):
        moe = np.asarray(tel["moe_mor_stats"]["frac_tiles_computed"])
        assert moe.shape == (1, 4) and moe.max() < 1.0


def test_engine_per_expert_capacities_match_jax(engines):
    """``calibrate_capacities`` gives (L, E) budgets equal to JAX's, and
    the plans re-attached with them (per-expert ``cap_live``) serve the
    same tokens with the same telemetry."""
    jcfg, jp, jmor, cfg, tparams, tmor, reqs = engines
    kw = dict(n_slots=2, max_len=48, mor_mode="tiled")
    jeng = JEngine(jcfg, jp, mor=jmor, **kw)
    teng = Engine(cfg, tparams, mor=tmor, **kw)
    jeng.run(list(reqs))
    teng.run(list(reqs))
    jcaps = jeng.calibrate_capacities(quantile=0.5)
    tcaps = teng.calibrate_capacities(quantile=0.5)
    assert set(tcaps) == set(jcaps) == {"dense_mor_stats", "moe_mor_stats"}
    for k in tcaps:
        np.testing.assert_array_equal(tcaps[k], jcaps[k])
    assert np.asarray(tcaps["moe_mor_stats"]).shape == (1, 4)
    assert teng.run(list(reqs)) == jeng.run(list(reqs))
    _same_telemetry(teng, jeng)
    rep = teng.report()
    assert np.asarray(rep["per_layer_capacity"]["moe_mor_stats"]).shape == \
        (1, 4)


def test_moe_hot_loop_reads_nothing_back_before_the_flush(engines,
                                                       monkeypatch):
    """No dispatch of the paged MLA + MoE engine in kernel mode moves a
    tensor to the host: routing counts, per-expert budgets and slot
    lists stay on the device until ``run`` flushes."""
    _, _, _, cfg, tparams, tmor, reqs = engines
    eng = Engine(cfg, tparams, mor=tmor, mor_mode="kernel", n_slots=2,
                 max_len=48, capacities={"moe_mor_stats": 0.5})
    for p, g in reqs:
        eng.submit(p, g)
    calls = []
    for name in ("item", "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    while eng.scheduler.has_work:
        eng.step()
    assert calls == []
    monkeypatch.undo()
    eng._flush_tokens()
    assert sorted(len(v) for v in eng.results.values()) == \
        sorted(g for _, g in reqs)


def test_serve_cli_deepseek_on_cpu():
    from repro_torch.launch import serve
    rep = serve.main(["--arch", ARCH, "--reduced", "--layers", "3",
                      "--device", "cpu", "--batch", "2", "--requests", "3",
                      "--prompt-min", "3", "--prompt-max", "9",
                      "--gen-len", "3", "--shared-prefix", "8", "--mor",
                      "kernel", "--compare"])
    assert rep["requests_finished"] == 3
    assert np.asarray(rep["per_layer_moe_frac_tiles_live"]).shape == (2, 4)
    assert len(rep["per_layer_dense_frac_tiles_live"]) == 1
    assert rep["prefix_cache"]["prefix_hits"] > 0
    assert 0.0 <= rep["token_agreement_vs_dense"] <= 1.0
