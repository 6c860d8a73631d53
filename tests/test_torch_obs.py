"""The port's observability stack (``repro_torch.obs``, the ``shadow`` /
``scored`` plan modes, ``export_telemetry``, the engine's metrics block,
shadow twin, drift detector and tracer hooks, the CLI's obs flags)
against the JAX package's ``repro.obs``.

Registry, tracer and telemetry export get the same inputs in both
packages and must give the same snapshots, texts and traces.  The
engines serve one trace of reduced float32 granite-3-2b on weights from
the JAX ``init`` and calibration (odd column tiles made statically dead
so that the predictor really skips): the metrics blocks' integer lanes
must be equal, the fixed-point lanes within 1 a dispatch (one rounding
of ``frac * SCALE``).  Shadow-on must give the tokens of shadow-off; on
the recurrent families the twin runs on a view of the cache, and the
cache must end as it ends with shadow off.
"""
import json
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core.deploy import calibrate_lm as jcalibrate_lm
from repro.core.executor import MoRExecutionPlan as JPlan
from repro.models import get_model as jget_model
from repro.obs import MetricsRegistry as JRegistry
from repro.obs import Observability as JObservability
from repro.obs import Tracer as JTracer
from repro.obs import inject_coefficient_drift as jinject
from repro.obs import validate_chrome_trace as jvalidate
from repro.serving import Engine as JEngine
from repro.serving.telemetry import ServingTelemetry as JTelemetry
from repro.serving.telemetry import export_telemetry as jexport
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import deploy
from repro_torch.core.executor import MoRExecutionPlan
from repro_torch.models import get_model
from repro_torch.obs import (SCALE, MetricsRegistry, MetricsServer,
                             Observability, Tracer,
                             inject_coefficient_drift,
                             validate_chrome_trace)
from repro_torch.serving import Engine
from repro_torch.serving.telemetry import ServingTelemetry, export_telemetry

ARCH = "granite-3-2b"
TRACE = [(3, 4), (9, 3), (5, 5), (12, 3)]      # (prompt length, new tokens)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _dead_odd_tiles(layer):
    """Make every odd 128-column tile statically dead (random-init
    weights alone leave every tile live)."""
    layer = {k: np.array(v) for k, v in layer.items()}
    dead = (np.arange(layer["m"].shape[-1]) // 128) % 2 == 1
    layer["bn_bias"] = np.where(dead, -1e3, layer["bn_bias"]).astype(
        np.float32)
    layer["enable"] = layer["enable"] | dead
    layer["is_proxy"] = layer["is_proxy"] & ~dead
    layer["proxy_slot"] = np.where(dead, -1, layer["proxy_slot"]).astype(
        np.int32)
    return layer


@pytest.fixture(scope="module")
def granite():
    jcfg = jreduce_config(jget_config(ARCH))
    api = jget_model(jcfg)
    params = api.init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield {"tokens": jnp.asarray(
                rng.integers(0, jcfg.vocab_size, (2, 32)), jnp.int32)}

    params, mor, _ = jcalibrate_lm(params, jcfg, api.forward, batches(), 2)
    layer = _dead_odd_tiles(_np(mor["layers"]))
    jmor = {"layers": {k: jnp.asarray(v) for k, v in layer.items()}}
    cfg = reduce_config(get_config(ARCH))
    tparams = convert.params_from_numpy(cfg, _np(params), device="cpu")
    tmor = convert.mor_from_numpy({"layers": layer}, device="cpu")
    prng = np.random.default_rng(7)
    reqs = [(prng.integers(0, cfg.vocab_size, p).astype(np.int32), g)
            for p, g in TRACE]
    return jcfg, params, jmor, cfg, tparams, tmor, reqs


# -- registry, tracer, server ---------------------------------------------

def _fill_registry(reg):
    rng = np.random.default_rng(3)
    c = reg.counter("repro_x_total", "a counter", ("layout", "kind"))
    c.inc(3, layout="paged", kind="mixed")
    c.inc(layout="paged", kind="decode")
    c.set(7.5, layout='odd "name"\\\n', kind="x")
    g = reg.gauge("repro_gauge", "a gauge", ("layer",))
    for i in range(3):
        g.set(float(rng.uniform()), layer=i)
    reg.gauge("repro_bare").set(2.0)
    h = reg.histogram("repro_lat_seconds", "latencies", ("kind",))
    for v in rng.exponential(0.01, 64):
        h.observe(float(v), kind="decode")
    h2 = reg.histogram("repro_small", "custom buckets", buckets=(0.5, 1, 2))
    for v in (0.1, 0.7, 1.5, 9.0):
        h2.observe(v)
    reg.counter("repro_cleared").inc(5)
    reg.get("repro_cleared").clear()


def test_registry_snapshot_and_prometheus_match_jax():
    """The same observations give the same JSON snapshot, Prometheus
    text and histogram quantiles."""
    reg, jreg = MetricsRegistry(), JRegistry()
    _fill_registry(reg)
    _fill_registry(jreg)
    assert reg.snapshot() == jreg.snapshot()
    assert reg.to_prometheus() == jreg.to_prometheus()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert reg.get("repro_lat_seconds").quantile(q, kind="decode") == \
            jreg.get("repro_lat_seconds").quantile(q, kind="decode")


def test_histogram_summary_rounding_limit_is_the_reference_s():
    """A reference limit, kept: with one observation of 1.1328125 the
    quantile returns the value itself while ``summary`` rounds min and
    max to 6 places (half to even: 1.132812), so the quantile lies
    outside the summary's [min, max] (the seed failure of
    ``test_obs.py::test_histogram_bucket_invariants_property``).  The
    port gives the reference's numbers."""
    for reg in (MetricsRegistry(), JRegistry()):
        h = reg.histogram("x")
        h.observe(1.1328125)
        s = h.summary()
        assert s["min"] == s["max"] == 1.132812
        assert [h.quantile(q) for q in (0.1, 0.5, 0.99)] == [1.1328125] * 3
        assert h.quantile(0.5) > s["max"]


def _drive(tr):
    """One scripted stream of tracer events under an injected clock."""
    t = [100.0]

    def tick(dt):
        t[0] += dt
        return t[0]

    tr.on_submit(7, t=tick(0.0))
    tr.on_submit(8, t=tick(0.002))
    t0 = tick(0.010)
    tr.on_dispatch("mixed", t0, tick(0.020), admitted=[(0, 7), (1, 8)],
                   prefilling=[(0, 7, 0, 8), (1, 8, 0, 4)],
                   emits=[(1, 8)], finished=[], queue_depth=1, n_active=2)
    for k in range(3):
        t0 = tick(0.001)
        tr.on_dispatch("decode", t0, tick(0.004 + k * 0.001), admitted=[],
                       prefilling=[], emits=[(0, 7), (1, 8)],
                       finished=[8] if k == 2 else [], queue_depth=0,
                       n_active=2)
    tr.on_preempt(7, 0, t=tick(0.001))
    tr.on_restore(7, 1, t=tick(0.003))
    tr.on_drift("mor_stats", 1, None, 0.4375, t=tick(0.001))
    tr.on_drift("moe_mor_stats", 0, 3, 0.5, t=tick(0.001))
    t0 = tick(0.001)
    tr.on_dispatch("decode", t0, tick(0.005), emits=[(1, 7)],
                   emit_counts=[2], finished=[7], n_active=1)


def test_tracer_chrome_trace_matches_jax(tmp_path):
    """The same event sequence under an injected clock gives the same
    Chrome trace, summary and histogram series; the validator accepts it
    and flags the same faults as the reference's."""
    reg, jreg = MetricsRegistry(), JRegistry()
    tr, jtr = Tracer(reg), JTracer(jreg)
    _drive(tr)
    _drive(jtr)
    got, want = tr.to_chrome_trace(), jtr.to_chrome_trace()
    assert got["metadata"] == {"tool": "repro_torch.obs.tracer"}
    assert got["traceEvents"] == want["traceEvents"]
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    assert tr.summary() == jtr.summary()
    assert tr.request_spans() == jtr.request_spans()
    assert reg.snapshot() == jreg.snapshot()
    tr.write_chrome_trace(tmp_path / "t.json")
    assert validate_chrome_trace(json.loads((tmp_path / "t.json")
                                            .read_text())) == []
    bad = {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "ts": "x",
                            "dur": -1}, {"ph": "Q"}, 3]}
    assert validate_chrome_trace(bad) == jvalidate(bad)
    assert len(validate_chrome_trace(bad)) == 4
    tr.reset()
    assert tr.summary()["n_dispatches"] == 0
    assert reg.get("repro_serving_ttft_seconds").summary() == {"count": 0}


def test_metrics_server_answers_on_localhost():
    """``/metrics`` (Prometheus text) and ``/metrics.json`` (snapshot +
    tracer summary) on 127.0.0.1 at an ephemeral port; 404 elsewhere."""
    obs = Observability()
    obs.registry.counter("repro_x_total", "x", ("layout",)).set(
        3, layout="paged")
    with MetricsServer(obs, host="127.0.0.1", port=0) as srv:
        assert srv.port > 0
        with urllib.request.urlopen(srv.url + "/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        assert 'repro_x_total{layout="paged"} 3' in text
        with urllib.request.urlopen(srv.url + "/metrics.json",
                                    timeout=10) as r:
            body = json.loads(r.read())
        assert body["metrics"]["repro_x_total"]["values"][0]["value"] == 3
        assert body["tracing"]["n_dispatches"] == 0
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope", timeout=10)


# -- the shadow / scored plan modes ---------------------------------------

def test_shadow_and_scored_modes_match_jax(granite):
    """On one layer's FFN: the shadow / scored outputs and every
    ``shadow_*`` stat equal JAX's (tile counts exact, fractions to float32
    rounding); scored is bitwise the tiled output; the expert form (a
    leading E dim) gives the per-expert stats."""
    jcfg, params, jmor, cfg, tparams, tmor, _ = granite
    rng = np.random.default_rng(5)
    x = rng.standard_normal((24, cfg.d_model)).astype(np.float32)
    lp = _np(params["layers"]["mlp"])
    w = {k: lp[k][0] for k in ("w_gate", "w_up", "w_down")}
    jlayer = {k: v[0] for k, v in jmor["layers"].items()}
    tlayer = {k: v[0] for k, v in tmor["layers"].items()}
    tw = {k: torch.as_tensor(np.array(v)) for k, v in w.items()}
    tx = torch.as_tensor(x)
    # a calibrated budget under the live share: every mode's clip drops
    # live tiles (a static capacity_frac < 1 alone clips shadow and
    # scored but not tiled, in both packages)
    kw = dict(tile_m=8, tile_n=128, cap_live=0.3)
    outs = {}
    for mode in ("shadow", "scored", "tiled"):
        y, st = MoRExecutionPlan(tlayer, mode=mode, **kw).ffn(
            tx, tw["w_up"], tw["w_down"], activation="relu",
            w_gate=tw["w_gate"])
        jy, jst = JPlan(jlayer, mode=mode, **kw).ffn(
            jnp.asarray(x), w["w_up"], w["w_down"], activation="relu",
            w_gate=w["w_gate"])
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5, err_msg=mode)
        assert set(st) == set(jst), mode
        for k, v in st.items():
            if v.dtype == torch.int32:
                assert int(v) == int(jst[k]), (mode, k)
            else:
                np.testing.assert_allclose(float(v), float(jst[k]),
                                           rtol=1e-5, err_msg=(mode, k))
        outs[mode] = (y, st)
    assert torch.equal(outs["scored"][0], outs["tiled"][0])
    sst = outs["shadow"][1]
    assert 0 < int(sst["shadow_truth_live"]) < int(sst["shadow_tiles"])
    assert int(sst["shadow_false_skip"]) > 0
    # the expert form: two experts, the second on other rows
    x2 = torch.stack([tx, tx.flip(0)])
    ew = {k: torch.stack([v, v]) for k, v in tw.items()}
    elayer = {k: torch.stack([v, v]) for k, v in tlayer.items()}
    _, est = MoRExecutionPlan(elayer, mode="shadow", **kw).expert_ffn(
        x2, ew["w_up"], ew["w_down"], activation="relu",
        w_gate=ew["w_gate"])
    _, st1 = MoRExecutionPlan(tlayer, mode="shadow", **kw).ffn(
        x2[1], tw["w_up"], tw["w_down"], activation="relu",
        w_gate=tw["w_gate"])
    for k in ("shadow_tiles", "shadow_false_skip", "shadow_false_keep",
              "shadow_truth_live"):
        assert est[k].tolist() == [int(sst[k]), int(st1[k])], k
    plan = MoRExecutionPlan(tlayer, mode="kernel", **kw)
    with pytest.raises(AssertionError, match="tiled plans only"):
        plan.as_scored()
    assert plan.as_shadow().mode == "shadow"
    assert MoRExecutionPlan(None).as_shadow().mor is None


# -- the engine: metrics block, shadow twin, drift --------------------------

def _same_block(got, want):
    assert {k: v for k, v in got.items() if k != "groups"} == \
        {k: v for k, v in want.items() if k != "groups"}
    assert set(got["groups"]) == set(want["groups"])
    for g, d in want["groups"].items():
        for k, v in d.items():
            t = got["groups"][g][k]
            if np.asarray(v).dtype.kind in "iu":
                np.testing.assert_array_equal(t, v, err_msg=(g, k))
            else:
                # fixed-point lanes: one rounding of frac * SCALE a
                # dispatch at most
                np.testing.assert_allclose(t, v, rtol=0, atol=1 / SCALE,
                                           err_msg=(g, k))


@pytest.mark.parametrize("layout,mode", [("slotted", "kernel"),
                                         ("paged", "kernel"),
                                         ("paged", "tiled")])
def test_engine_metrics_block_and_shadow_match_jax(granite, layout, mode):
    """With obs on and shadow_rate 0.5 (kernel: the standalone dense
    twin; tiled: the in-step scored twin) the port's tokens equal JAX's
    and its own shadow-off tokens, the metrics block's read equals JAX's
    lane for lane, and the block's header equals the engine's host
    counters."""
    jcfg, params, jmor, cfg, tparams, tmor, reqs = granite
    kw = dict(mor_mode=mode, n_slots=2, max_len=24, layout=layout)
    jeng = JEngine(jcfg, params, mor=jmor, obs=JObservability(),
                   shadow_rate=0.5, **kw)
    want = jeng.run(list(reqs))
    teng = Engine(cfg, tparams, mor=tmor, obs=Observability(),
                  shadow_rate=0.5, **kw)
    assert teng.run(list(reqs)) == want
    assert Engine(cfg, tparams, mor=tmor, **kw).run(list(reqs)) == want
    assert teng._twin == (mode == "kernel")
    dm = teng._last_device_metrics
    _same_block(dm, jeng._last_device_metrics)
    for k in ("dispatches", "prefill_tokens", "decode_tokens"):
        assert dm[k] == teng.counters[k], k
    assert dm["shadow_dispatches"] == (dm["dispatches"] + 1) // 2
    g = dm["groups"]["mor_stats"]
    assert g["tiles_skipped"].sum() > 0 and g["truth_live"].sum() > 0
    if layout == "paged":
        assert dm["pages_touched"] > 0 and dm["kv_page_resets"] > 0
    rep = teng.report()
    assert set(rep["obs"]) == {"device_metrics", "tracing"}
    assert rep["obs"]["tracing"]["n_dispatches"] == dm["dispatches"]
    assert rep["quality"]["shadow_dispatches"] == dm["shadow_dispatches"]
    reg = teng.obs.registry
    assert reg.get("repro_engine_dispatches_total").get(
        layout=layout) == dm["dispatches"]
    teng.reset_counters()
    assert int(teng._mblock.abs().sum()) == 0


def _port_calibrated(arch, **replace):
    """JAX-initialised weights through the converter, calibrated by the
    port (``calibrate_lm`` / ``_hybrid`` / ``_moe``), with the odd tiles
    of a dense group made dead."""
    jcfg = jreduce_config(jget_config(arch)).replace(**replace)
    cfg = reduce_config(get_config(arch)).replace(**replace)
    params = convert.params_from_numpy(
        cfg, _np(jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    api = get_model(cfg)
    rng = np.random.default_rng(1)
    batches = ({"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))}
        for _ in range(2))
    if cfg.family == "moe":
        params, mor, _ = deploy.calibrate_moe(params, cfg, api.forward,
                                              batches, 2,
                                              inject_dead_frac=0.5)
    else:
        fn = (deploy.calibrate_hybrid if cfg.family == "hybrid"
              else deploy.calibrate_lm)
        params, mor, _ = fn(params, cfg, api.forward, batches, 2)
        (group, layer), = mor.items()
        mor = convert.mor_from_numpy(
            {group: _dead_odd_tiles({k: v.numpy()
                                     for k, v in layer.items()})},
            device="cpu")
    prefix = rng.integers(0, cfg.vocab_size, 16)
    reqs = [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)]
                            ).astype(np.int32), g)
            for n, g in ((3, 4), (9, 3), (5, 5))]
    reqs.append((reqs[1][0].copy(), 3))
    return cfg, params, mor, reqs


@pytest.fixture(scope="module")
def recurrent():
    return {arch: _port_calibrated(arch) for arch in ("rwkv6-3b",
                                                      "zamba2-7b")}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("layout", ["paged", "slotted"])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_recurrent_shadow_twin_leaves_the_cache_as_it_was(recurrent, arch,
                                                          layout):
    """Kernel mode with shadow_rate 0.5 runs the dense twin on a view of
    the cache (state copies, shared kv pools): tokens, prefix counters
    and every cache leaf at the end equal shadow-off's."""
    cfg, params, mor, reqs = recurrent[arch]
    kw = dict(mor_mode="kernel", n_slots=2, max_len=48, layout=layout)
    off = Engine(cfg, params, mor=mor, obs=Observability(), **kw)
    on = Engine(cfg, params, mor=mor, obs=Observability(), shadow_rate=0.5,
                **kw)
    assert on.run(list(reqs)) == off.run(list(reqs))
    for a, b in zip(_leaves(on.cache), _leaves(off.cache)):
        assert torch.equal(a, b)
    dm = on._last_device_metrics
    assert dm["shadow_dispatches"] > 0
    g = dm["groups"]["mor_stats"]
    assert g["shadow_tiles"].sum() > 0 and g["truth_live"].sum() > 0
    assert on._stat_shapes()["mor_stats"] == g["tiles_total"].shape
    if layout == "paged":
        assert on._prefix_counters() == off._prefix_counters()
        assert on._prefix_counters()["snap_restores"] > 0
        assert dm["state_page_copies"] > 0


def test_moe_expert_lanes_and_shadow_twin():
    """Reduced deepseek-v2-236b, paged kernel mode: the block holds the
    dense layers' (L_dense,) and the experts' (L, E) lanes, and the
    shadow twin leaves the tokens alone."""
    cfg, params, mor, reqs = _port_calibrated("deepseek-v2-236b",
                                              moe_d_ff=256)
    kw = dict(mor_mode="kernel", n_slots=2, max_len=48)
    want = Engine(cfg, params, mor=mor, **kw).run(list(reqs))
    eng = Engine(cfg, params, mor=mor, obs=Observability(),
                 shadow_rate=0.5, **kw)
    assert eng.run(list(reqs)) == want
    groups = eng._last_device_metrics["groups"]
    L_moe = cfg.n_layers - cfg.first_k_dense
    assert groups["moe_mor_stats"]["tiles_total"].shape == \
        (L_moe, cfg.n_experts)
    assert groups["dense_mor_stats"]["tiles_total"].shape == \
        (cfg.first_k_dense,)
    assert groups["moe_mor_stats"]["tiles_skipped"].sum() > 0
    assert groups["moe_mor_stats"]["shadow_tiles"].sum() > 0
    with pytest.raises(NotImplementedError, match="queue A 7"):
        Engine(cfg, params, mor=mor, layout="paged-sharded", group=object(),
               obs=Observability(), shadow_rate=0.5, **kw)


def test_drift_fires_at_the_same_flush_as_jax(granite):
    """Clean serving stays silent; after ``inject_coefficient_drift`` on
    layer 1 both packages' detectors flag that layer, and only it, at
    the same flush, with the same rates; the tracer records the event and
    the registry's drift gauge is raised.  No column is a proxy here
    (proxies are always computed): each keeps its own column as proxy
    rookie, which vetoes every false skip until the injection clears
    it."""
    jcfg, params, jmor, cfg, tparams, tmor, reqs = granite
    layer = _np(jmor["layers"])
    layer = dict(layer, is_proxy=np.zeros_like(layer["is_proxy"]))
    jmor = {"layers": {k: jnp.asarray(v) for k, v in layer.items()}}
    tmor = convert.mor_from_numpy({"layers": layer}, device="cpu")
    kw = dict(mor_mode="tiled", n_slots=2, max_len=24, shadow_rate=1.0,
              drift_threshold=0.25)
    jeng = JEngine(jcfg, params, mor=jmor, obs=JObservability(), **kw)
    teng = Engine(cfg, tparams, mor=tmor, obs=Observability(), **kw)
    flushes = {}
    for name, eng, inject in (("jax", jeng, jinject),
                              ("port", teng, inject_coefficient_drift)):
        events = []
        eng.run(list(reqs))
        eng.update_mor(inject(eng.raw_mor, "layers", 1))
        for _ in range(2):
            eng.run(list(reqs))
            events.append([(e["group"], e["layer"], e["expert"])
                           for e in eng.drift.drifted_series()])
        flushes[name] = (events, eng.drift.summary())
    assert flushes["port"][0] == flushes["jax"][0]
    assert flushes["port"][0][-1] == [("mor_stats", 1, None)]
    tsum, jsum = flushes["port"][1], flushes["jax"][1]
    assert tsum["n_drifted"] == jsum["n_drifted"] == 1
    np.testing.assert_allclose(tsum["false_skip_rate"]["mor_stats"],
                               jsum["false_skip_rate"]["mor_stats"],
                               atol=1e-6)
    rep = teng.report()
    assert rep["obs"]["tracing"]["n_drift_events"] >= 1
    lab = dict(layout="paged", group="mor_stats", layer="1")
    reg = teng.obs.registry
    assert reg.get("repro_mor_drift").get(**lab) == 1.0
    assert reg.get("repro_mor_false_skip_rate").get(**lab) > 0.25


def test_export_telemetry_matches_jax():
    """The same telemetry updates and capacities give the same registry
    series and labels: (L,) and (L, E) groups, scalar / (L,) / (L, E)
    capacities, two layouts in one registry."""
    rng = np.random.default_rng(2)
    updates = [{"mor_stats": {
                    k: rng.uniform(size=3).astype(np.float32)
                    for k in ("frac_computed", "frac_tiles_live",
                              "frac_tiles_computed")},
                "moe_mor_stats": {
                    k: rng.uniform(size=(2, 4)).astype(np.float32)
                    for k in ("frac_tiles_live", "frac_tiles_computed")}}
               for _ in range(3)]
    caps = {"mor_stats": np.array([0.5, 0.25, 1.0]),
            "moe_mor_stats": rng.uniform(size=(2, 4)),
            "dense_mor_stats": 0.75}
    snaps = []
    for tel_cls, export, reg in ((ServingTelemetry, export_telemetry,
                                  MetricsRegistry()),
                                 (JTelemetry, jexport, JRegistry())):
        tel = tel_cls()
        for u in updates:
            tel.update(u)
        export(reg, tel, layout="paged", capacities=caps)
        export(reg, tel, layout="slotted")
        snaps.append(reg.snapshot())
    assert snaps[0] == snaps[1]
    assert len(snaps[0]["repro_telemetry_capacity"]["values"]) == 3 + 8 + 1


def test_serve_cli_writes_the_obs_files(tmp_path):
    """``launch.serve --obs --metrics-json --trace-out --shadow-rate
    --drift-threshold`` writes the registry snapshot and a valid Chrome
    trace, and its report carries the reference CLI's obs and quality
    keys."""
    from repro_torch.launch import serve
    mj, to = tmp_path / "metrics.json", tmp_path / "trace.json"
    rep = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                      "--requests", "3", "--prompt-min", "4",
                      "--prompt-max", "12", "--gen-len", "3", "--mor",
                      "kernel", "--obs", "--metrics-json", str(mj),
                      "--trace-out", str(to), "--shadow-rate", "0.5",
                      "--drift-threshold", "0.25", "--metrics-port", "0"])
    snap = json.loads(mj.read_text())
    assert set(snap) == {"metrics", "tracing"}
    for name in ("repro_engine_dispatches_total", "repro_mor_false_skip_total",
                 "repro_serving_ttft_seconds", "repro_telemetry_frac",
                 "repro_kernel_launches_total"):
        assert name in snap["metrics"], name
    assert validate_chrome_trace(json.loads(to.read_text())) == []
    assert set(rep["obs"]) == {"device_metrics", "tracing"}
    assert set(rep["quality"]) == {"shadow_rate", "shadow_every",
                                   "shadow_dispatches", "groups", "drift"}
    assert rep["quality"]["shadow_every"] == 2
    assert rep["obs"]["device_metrics"]["dispatches"] == rep["dispatches"]


@pytest.mark.parametrize("case", ["granite-slotted-kernel",
                                  "granite-paged-kernel",
                                  "granite-paged-tiled",
                                  "zamba2-paged-kernel"])
def test_obs_hot_loop_reads_nothing_back_before_the_flush(granite,
                                                          recurrent, case,
                                                          monkeypatch):
    """With obs and shadow_rate 0.5 on, no dispatch moves a tensor to the
    host: the block, the twin's scores and the tracer's spans wait for
    ``run``'s flush, which reads the block once."""
    arch, layout, mode = case.split("-")
    if arch == "granite":
        _, _, _, cfg, params, mor, reqs = granite
    else:
        cfg, params, mor, reqs = recurrent["zamba2-7b"]
    eng = Engine(cfg, params, mor=mor, mor_mode=mode, n_slots=2, max_len=48,
                 layout=layout, obs=Observability(), shadow_rate=0.5)
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
    eng._flush_obs()
    assert calls.count("cpu") == 1           # the block, read once
    monkeypatch.undo()
    dm = eng._last_device_metrics
    assert dm["dispatches"] == eng.counters["dispatches"]
    assert dm["shadow_dispatches"] == (dm["dispatches"] + 1) // 2
