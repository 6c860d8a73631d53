"""The port's MoR core against the JAX package on reduced granite-3-2b:
configs, clustering, calibration, the tile policy, the predictor, the
execution plans in all four modes, and ``calibrate_lm``.

Weights come from the JAX ``init`` and pass to the port as numpy
(``repro_torch.convert``); inputs come from a numpy seed.  Integer
results (masks, permutations, counters) must be equal.  Float
tolerances: float32 results of the same arithmetic in another summation
order agree to rtol = atol = 1e-5 (2e-4 where a whole FFN or a
regression over 256-term sums sits between input and output).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core import calibration as jcal
from repro.core import clustering as jclu
from repro.core import deploy as jdeploy
from repro.core import policy as jpol
from repro.core import predictor as jpred
from repro.core.executor import MoRExecutionPlan as JPlan
from repro.models import get_model as jget_model
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import calibration as tcal
from repro_torch.core import clustering as tclu
from repro_torch.core import deploy as tdeploy
from repro_torch.core import policy as tpol
from repro_torch.core import predictor as tpred
from repro_torch.core.executor import MoRExecutionPlan as TPlan
from repro_torch.models import get_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "granite-3-2b"


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))            # a writable copy


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_reference(reduced):
    """Every ported arch, field by field: granite-3-2b, the MLA + MoE
    deepseek-v2-236b, the rest of the transformer zoo, the recurrent
    rwkv6-3b and zamba2-7b, and the paper's four DNNs."""
    for arch in (ARCH, "deepseek-v2-236b", "qwen2-7b", "qwen1.5-110b",
                 "granite-20b", "mixtral-8x7b", "phi-3-vision-4.2b",
                 "hubert-xlarge", "rwkv6-3b", "zamba2-7b", "paper-tds",
                 "paper-cnn10", "paper-resnet18", "paper-darknet19"):
        jc, tc = jget_config(arch), get_config(arch)
        if reduced:
            jc, tc = jreduce_config(jc), reduce_config(tc)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), arch
        assert tc.tdtype == getattr(torch, jc.dtype)


@pytest.mark.parametrize("shape", [(64, 300), (128, 256)])
def test_clustering_matches_reference(shape):
    """Closest-neighbour graph (device cosine slabs, first-max argmax)
    and the greedy proxy election equal the numpy reference."""
    rng = np.random.default_rng(shape[1])
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 7] = w[:, 3] * 2.0                 # an exact duplicate direction
    want = jclu.cluster_layer(w, 60.0)
    got = tclu.cluster_layer(_t(w), 60.0)
    np.testing.assert_array_equal(got["nn_idx"], want["nn_idx"])
    np.testing.assert_allclose(got["nn_angle"], want["nn_angle"],
                               atol=1e-3)
    np.testing.assert_array_equal(got["proxy_of"], want["proxy_of"])
    np.testing.assert_array_equal(got["is_proxy"], want["is_proxy"])


def test_calibration_regression_matches_reference():
    rng = np.random.default_rng(1)
    acc_j = jcal.init_accumulator(96)
    acc_t = tcal.init_accumulator(96, "cpu")
    for _ in range(3):
        xb = rng.integers(-40, 40, (64, 96)).astype(np.float32)
        yb = (0.1 * xb + rng.normal(0, 1.0, (64, 96))).astype(np.float32)
        acc_j = jcal.update_accumulator(acc_j, jnp.asarray(xb),
                                        jnp.asarray(yb))
        acc_t = tcal.update_accumulator(acc_t, _t(xb), _t(yb))
    for want, got in zip(jcal.finalize_regression(acc_j),
                         tcal.finalize_regression(acc_t)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


def test_policy_matches_reference():
    rng = np.random.default_rng(2)
    n = 256
    w = rng.normal(size=(64, n)).astype(np.float32)
    cl = jclu.cluster_layer(w)
    m, b, c = (rng.normal(size=n).astype(np.float32) for _ in range(3))
    cfg = jget_config(ARCH).mor
    want = jpol.build_mor_layer(m, b, c + 0.5, cl, cfg)
    got = tpol.build_mor_layer(m, b, c + 0.5, cl, get_config(ARCH).mor,
                               "cpu")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), k)
    computed = rng.random((21, n)) < 0.02
    tiles_j = jpol.tile_mask_from_neuron_mask(jnp.asarray(computed), 8, 128)
    tiles_t = tpol.tile_mask_from_neuron_mask(_t(computed), 8, 128)
    np.testing.assert_array_equal(tiles_t.numpy(), np.asarray(tiles_j))
    np.testing.assert_array_equal(
        tpol.expand_tile_mask(tiles_t, 8, 128, 21, n).numpy(),
        np.asarray(jpol.expand_tile_mask(tiles_j, 8, 128, 21, n)))


# -- carried-across weights and MoR tree -------------------------------------

def _jax_calibrated(seed=0, n_batches=2):
    cfg = jreduce_config(jget_config(ARCH))
    api = jget_model(cfg)
    params = api.init(jax.random.PRNGKey(seed), cfg)

    def batches():
        rng = np.random.default_rng(seed)
        while True:
            yield {"tokens": jnp.asarray(
                rng.integers(0, cfg.vocab_size, (2, 32)), jnp.int32)}

    return cfg, api, params, jdeploy.calibrate_lm(
        params, cfg, api.forward, batches(), n_batches)


@pytest.fixture(scope="module")
def calibrated():
    return _jax_calibrated()


def _sparse_mor(mor_np):
    """The calibrated tree with a predictor that really skips: the odd
    128-column tiles get a folded bias far below zero, the binary rookie
    enabled and no proxy (slot -1), so both rookies say dead."""
    out = {k: np.array(v) for k, v in mor_np.items()}
    n = out["m"].shape[-1]
    dead = (np.arange(n) // 128) % 2 == 1
    out["bn_bias"] = np.where(dead, -1e3, out["bn_bias"]).astype(np.float32)
    out["enable"] = out["enable"] | dead
    out["is_proxy"] = out["is_proxy"] & ~dead
    out["proxy_slot"] = np.where(dead, -1, out["proxy_slot"]).astype(
        np.int32)
    return out


@pytest.mark.parametrize("mode", ["dense", "exact", "tiled", "kernel"])
@pytest.mark.parametrize("cap", [(1.0, None), (0.5, None), (1.0, 0.4)])
def test_executor_ffn_matches_jax(calibrated, mode, cap):
    """``MoRExecutionPlan.ffn`` (relufied GLU) in every mode, on the
    calibrated layer-0 weights and a sparse carried-across MoR layer:
    output allclose, tile masks / counters equal, one predictor
    evaluation per FFN."""
    cfg, _, _, (params, mor, _) = calibrated
    frac, live = cap
    mlp = _np_tree(params["layers"]["mlp"])
    layer = _sparse_mor({k: v[0] for k, v in _np_tree(mor["layers"]).items()})
    w = {k: v[0] for k, v in mlp.items()}
    x = np.random.default_rng(5).normal(size=(21, cfg.d_model)).astype(
        np.float32)
    jplan = JPlan({k: jnp.asarray(v) for k, v in layer.items()}, mode=mode,
                  capacity_frac=frac, cap_live=live)
    tmor = convert.mor_from_numpy({"g": layer}, device="cpu")["g"]
    tplan = TPlan(tmor, mode=mode, capacity_frac=frac, cap_live=live)
    jpred.reset_predictor_eval_count()
    want, wstats = jplan.ffn(jnp.asarray(x), jnp.asarray(w["w_up"]),
                             jnp.asarray(w["w_down"]), activation="relu",
                             w_gate=jnp.asarray(w["w_gate"]))
    tpred.reset_predictor_eval_count()
    got, gstats = tplan.ffn(_t(x), _t(w["w_up"]), _t(w["w_down"]),
                            activation="relu", w_gate=_t(w["w_gate"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    assert set(gstats) == set(wstats)
    for k in gstats:
        np.testing.assert_allclose(gstats[k].numpy(), np.asarray(wstats[k]),
                                   rtol=1e-6, err_msg=k)
    if mode != "dense":
        assert tpred.predictor_eval_count() == 1
        live_frac = float(gstats["frac_tiles_computed"])
        assert live_frac < 1.0                    # skipping really happened


def test_calibrate_lm_matches_jax(calibrated):
    """Same weights, same batches: perm, proxy_slot and enable equal;
    m, b and the folded weights allclose."""
    cfg_j, _, params_j, (new_j, mor_j, rep_j) = calibrated
    cfg = reduce_config(get_config(ARCH))
    params = convert.params_from_numpy(cfg, _np_tree(params_j),
                                       device="cpu")

    def batches():
        rng = np.random.default_rng(0)
        while True:
            yield {"tokens": torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (2, 32)), dtype=torch.int32)}

    api = get_model(cfg)
    new_t, mor_t, rep_t = tdeploy.calibrate_lm(params, cfg, api.forward,
                                               batches(), 2)
    mj = _np_tree(mor_j["layers"])
    for k in ("perm", "inv_perm", "proxy_slot", "is_proxy", "enable"):
        np.testing.assert_array_equal(mor_t["layers"][k].numpy(), mj[k], k)
    for k in ("m", "b", "bn_scale", "bn_bias"):
        np.testing.assert_allclose(mor_t["layers"][k].numpy(), mj[k],
                                   rtol=2e-4, atol=2e-4, err_msg=k)
    for k in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            new_t["layers"]["mlp"][k].numpy(),
            np.asarray(new_j["layers"]["mlp"][k]), k)
    assert rep_t["n_proxies_mean"] == rep_j["n_proxies_mean"]
    np.testing.assert_allclose(rep_t["pearson_mean"], rep_j["pearson_mean"],
                               rtol=1e-4)


def test_attach_plans_capacities():
    """Scalar and per-layer capacities land as per-layer ``cap_live``."""
    cfg = reduce_config(get_config(ARCH))
    mor = {"layers": {"m": torch.zeros(2, 256), "enable": torch.zeros(
        2, 256, dtype=torch.bool), "bn_scale": torch.ones(2, 256)}}
    assert tdeploy.attach_plans(mor, cfg, "dense") is mor
    plans = tdeploy.attach_plans(mor, cfg, "kernel",
                                 capacities={"layers": 0.5})
    assert [plans["layers"].layer(l).cap_live for l in (0, 1)] == [0.5, 0.5]
    plans = tdeploy.attach_plans(mor, cfg, "tiled",
                                 capacities={"layers": np.array([0.25,
                                                                 0.75])})
    assert plans["layers"].layer(1).cap_live == 0.75
    assert plans["layers"].layer(1).mode == "tiled"
    assert tdeploy.attach_plans(mor, cfg, "exact")["layers"].cap_live is None
