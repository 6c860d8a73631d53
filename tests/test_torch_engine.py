"""The port's slotted serving engine against the JAX ``Engine(layout=
"slotted")`` on reduced granite-3-2b, with carried-across weights and a
carried-across MoR tree.

A mixed trace of four requests over two slots (chunked prefill, mixed
dispatches, slot recycling) is served in every MoR mode.  Greedy tokens
must be identical and the per-layer live-tile fractions of the serving
telemetry equal.  The MoR tree is the JAX calibration's, with the odd
128-column tiles made statically dead so that the predictor really
skips (random-init weights alone leave every tile live).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core.deploy import calibrate_lm as jcalibrate_lm
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.serving import Engine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "granite-3-2b"
TRACE = [(3, 4), (9, 3), (5, 5), (12, 3)]      # (prompt length, new tokens)


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduce_config(jget_config(ARCH))
    api = jget_model(jcfg)
    params = api.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield {"tokens": jnp.asarray(
                rng.integers(0, jcfg.vocab_size, (2, 32)), jnp.int32)}

    params, mor, _ = jcalibrate_lm(params, jcfg, api.forward, batches(), 2)
    layer = {k: np.array(v) for k, v in
             jax.tree_util.tree_map(np.asarray, mor["layers"]).items()}
    n = layer["m"].shape[-1]
    dead = (np.arange(n) // 128) % 2 == 1
    layer["bn_bias"] = np.where(dead, -1e3, layer["bn_bias"]).astype(
        np.float32)
    layer["enable"] = layer["enable"] | dead
    layer["is_proxy"] = layer["is_proxy"] & ~dead
    layer["proxy_slot"] = np.where(dead, -1, layer["proxy_slot"]).astype(
        np.int32)
    jmor = {"layers": {k: jnp.asarray(v) for k, v in layer.items()}}
    cfg = reduce_config(get_config(ARCH))
    tparams = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tmor = convert.mor_from_numpy({"layers": layer}, device="cpu")
    prng = np.random.default_rng(7)
    reqs = [(prng.integers(0, cfg.vocab_size, p).astype(np.int32), g)
            for p, g in TRACE]
    return jcfg, params, jmor, cfg, tparams, tmor, reqs


@pytest.mark.parametrize("mode,capacity", [("dense", None),
                                           ("exact", None),
                                           ("tiled", None),
                                           ("kernel", None),
                                           ("kernel", 0.5)])
def test_slotted_engine_matches_jax(setup, mode, capacity):
    jcfg, params, jmor, cfg, tparams, tmor, reqs = setup
    caps = None if capacity is None else {"mor_stats": capacity}
    kw = dict(mor_mode=mode, n_slots=2, max_len=24, capacities=caps)
    jeng = JEngine(jcfg, params, mor=jmor, layout="slotted", **kw)
    want = jeng.run(list(reqs))
    teng = Engine(cfg, tparams, mor=tmor, layout="slotted", **kw)
    got = teng.run(list(reqs))
    assert got == want
    assert [len(got[r]) for r in sorted(got)] == [g for _, g in TRACE]
    assert teng.counters["dispatches"] == jeng.counters["dispatches"]
    jtel, ttel = jeng.telemetry.summary(), teng.telemetry.summary()
    assert ttel["n_dispatches"] == jtel["n_dispatches"]
    if mode == "dense":
        assert "mor_stats" not in ttel and "mor_stats" not in jtel
        return
    for name in ("frac_tiles_live", "frac_tiles_computed"):
        np.testing.assert_allclose(ttel["mor_stats"][name],
                                   jtel["mor_stats"][name], rtol=1e-12,
                                   err_msg=name)
    assert max(ttel["mor_stats"]["frac_tiles_computed"]) < 1.0


def test_calibrated_capacities_match_jax(setup):
    """Telemetry -> per-layer capacities -> re-attached plans: the same
    budgets, then the same tokens under them."""
    jcfg, params, jmor, cfg, tparams, tmor, reqs = setup
    kw = dict(mor_mode="tiled", n_slots=2, max_len=24)
    jeng = JEngine(jcfg, params, mor=jmor, layout="slotted", **kw)
    teng = Engine(cfg, tparams, mor=tmor, layout="slotted", **kw)
    jeng.run(list(reqs))
    teng.run(list(reqs))
    jcaps = jeng.calibrate_capacities(quantile=0.5)
    tcaps = teng.calibrate_capacities(quantile=0.5)
    np.testing.assert_array_equal(tcaps["mor_stats"], jcaps["mor_stats"])
    assert teng.run(list(reqs)) == jeng.run(list(reqs))
    assert teng.report()["per_layer_capacity"] == {
        "mor_stats": np.asarray(jcaps["mor_stats"]).tolist()}


def test_hot_loop_reads_nothing_back_before_the_flush(setup, monkeypatch):
    """No dispatch moves a tensor to the host: tokens and tile counters
    stay device tensors until ``run`` flushes."""
    _, _, _, cfg, tparams, tmor, reqs = setup
    eng = Engine(cfg, tparams, mor=tmor, mor_mode="kernel", n_slots=2,
                 max_len=24, layout="slotted")
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
    assert all(isinstance(t, torch.Tensor) for _, t in eng._tok_log)
    monkeypatch.undo()
    eng._flush_tokens()
    assert sorted(len(v) for v in eng.results.values()) == \
        sorted(g for _, g in TRACE)
