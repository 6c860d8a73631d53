"""The rest of the transformer zoo against the JAX package: qwen2-7b,
qwen1.5-110b (QKV bias), granite-20b (MQA), mixtral-8x7b (MoE, top-2,
sliding window), phi-3-vision-4.2b (the vision stub) and hubert-xlarge
(the audio stub: an encoder, layernorm, a native ReLU FFN), reduced and
float32; and the CUDA-core ``gqa_paged_flash`` body's head-group plan,
which lets it take every G = H / hkv the zoo uses.

Weights come from the JAX ``init`` and pass to the port as numpy
(``repro_torch.convert``); the QKV biases, zero at init, are drawn from
a numpy seed so that they matter.  Inputs come from a numpy seed.
Integer results (tokens, masks, permutations, counters) must be equal.
Tolerances: logits of a 2-layer float32 model computed by two frameworks
(other matmul and softmax summation orders) agree to rtol = atol =
2e-4, as in ``tests/test_torch_model.py``; regression coefficients over
a few hundred terms to 1e-4 relative and 1e-5 absolute, the Pearson
mean to 2e-4, as in ``tests/test_torch_moe.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core.deploy import calibrate_lm as jcalibrate_lm
from repro.core.deploy import calibrate_moe as jcalibrate_moe
from repro.data import pipeline as jpipe
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.deploy import calibrate_lm, calibrate_moe
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import paged_attention as tpk
from repro_torch.models import get_model
from repro_torch.serving import Engine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ZOO = ("qwen2-7b", "qwen1.5-110b", "granite-20b", "mixtral-8x7b",
       "phi-3-vision-4.2b", "hubert-xlarge")
TOL = 2e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_model(arch, **replace):
    """Reduced JAX config and params (biased where the arch has QKV
    biases), and the port's config and converted params."""
    jcfg = jreduce_config(jget_config(arch)).replace(**replace)
    cfg = reduce_config(get_config(arch)).replace(**replace)
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(3)
        attn = dict(jparams["layers"]["attn"])
        for k in ("bq", "bk", "bv"):
            attn[k] = jnp.asarray(rng.normal(0, 0.5, attn[k].shape),
                                  attn[k].dtype)
        jparams = dict(jparams, layers=dict(jparams["layers"], attn=attn))
    params = convert.params_from_numpy(cfg, _np(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _batches(cfg, seq, to, n=2):
    """{"frames"} of the audio stub or {"tokens"} from each package's
    own ``make_batch`` copy, equal by construction (numpy-seeded)."""
    key = "frames" if cfg.frontend == "audio_stub" else "tokens"
    out = []
    for step in range(n):
        b = tpipe.make_batch(cfg, 2, seq, seed=0, step=step)
        out.append({key: to(b[key])})
    return out


# -- configs, the batch maker, the model ------------------------------------

def test_make_batch_matches_reference():
    """The port's batch maker picks the JAX one's generator per family
    and draws the same arrays from the same seed."""
    from repro.configs.base import ShapeSpec
    for arch in ("hubert-xlarge", "mixtral-8x7b", "paper-tds",
                 "paper-cnn10"):
        jcfg = jreduce_config(jget_config(arch))
        cfg = reduce_config(get_config(arch))
        want = jpipe.make_batch(jcfg, ShapeSpec("t", 16, 3, "train"),
                                jpipe.DataConfig(seed=5), step=2)
        got = tpipe.make_batch(cfg, 3, 16, seed=5, step=2)
        assert set(got) == set(want), arch
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=arch)


@pytest.mark.parametrize("arch", ZOO)
def test_forward_logits_match_jax(arch):
    """Reduced forward logits (phi-3 with 16 prepended patch embeddings,
    hubert on frames through its input norm, bidirectional) and the
    calibration taps: p_bin equal, p_base allclose."""
    jcfg, jparams, cfg, params = _jax_model(arch)
    rng = np.random.default_rng(1)
    if cfg.frontend == "audio_stub":
        fr = rng.normal(size=(2, 13, cfg.d_model)).astype(np.float32)
        jb, tb = {"frames": jnp.asarray(fr)}, {"frames": torch.as_tensor(fr)}
    else:
        tk = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
        jb, tb = {"tokens": jnp.asarray(tk)}, {"tokens": torch.as_tensor(tk)}
    if cfg.frontend == "vision_stub":
        assert cfg.frontend_tokens == 16
        pe = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
        jb["patch_embeds"], tb["patch_embeds"] = (jnp.asarray(pe),
                                                  torch.as_tensor(pe))
    want, waux = jget_model(jcfg).forward(jparams, jcfg, jb, with_taps=True)
    got, gaux = get_model(cfg).forward(params, cfg, tb, with_taps=True)
    assert got.shape == tuple(want.shape)
    assert got.shape[1] == (29 if cfg.frontend == "vision_stub" else 13)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    wt, gt = waux["taps"], gaux["taps"]
    np.testing.assert_array_equal(gt["p_bin"].numpy(),
                                  np.asarray(wt["p_bin"]))
    np.testing.assert_allclose(gt["p_base"].numpy(),
                               np.asarray(wt["p_base"]), rtol=TOL, atol=TOL)


def test_hubert_is_bidirectional_and_encoder_only():
    """A later frame changes an earlier frame's logits (causal False);
    the API has no decode and the serving entry points refuse it."""
    _, _, cfg, params = _jax_model("hubert-xlarge")
    api = get_model(cfg)
    assert not api.has_decode and api.cache_init is None
    assert "in_norm" in params and not cfg.causal
    fr = torch.as_tensor(np.random.default_rng(2).normal(
        size=(1, 9, cfg.d_model)).astype(np.float32))
    a, _ = api.forward(params, cfg, {"frames": fr})
    fr2 = fr.clone()
    fr2[0, -1] += 1.0
    b, _ = api.forward(params, cfg, {"frames": fr2})
    assert not torch.allclose(a[0, 0], b[0, 0])
    from repro_torch.models import transformer
    with pytest.raises(ValueError, match="encoder-only"):
        transformer.cache_init(cfg, 1, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="encoder-only"):
        Engine(cfg, params, n_slots=1, max_len=8)


def test_convert_checks_the_zoo_layouts():
    """A QKV-biased model without its biases, an audio model without its
    input norm, and a mixtral stack (no dense layers) are recognised."""
    _, jparams, cfg, _ = _jax_model("qwen2-7b")
    bad = _np(jparams)
    bad["layers"] = dict(bad["layers"], attn={
        k: v for k, v in bad["layers"]["attn"].items() if k != "bk"})
    with pytest.raises(ValueError, match="layers.attn.bk"):
        convert.params_from_numpy(cfg, bad, device="cpu")
    _, jparams, cfg, _ = _jax_model("hubert-xlarge")
    bad = {k: v for k, v in _np(jparams).items() if k != "in_norm"}
    with pytest.raises(ValueError, match="in_norm"):
        convert.params_from_numpy(cfg, bad, device="cpu")
    _, _, cfg, params = _jax_model("mixtral-8x7b")
    assert cfg.first_k_dense == 0 and set(params) == {
        "embed", "moe_layers", "final_norm", "lm_head"}
    assert "shared" not in params["moe_layers"]["moe"]


def test_recurrent_families_still_raise():
    """The recurrent families are ported (``tests/test_torch_recurrent.
    py``): their configs register, reduce and dispatch, and their engines
    sample at a temperature (seeded: ``tests/test_torch_spec.py``); what
    still raises is an unknown family, and the page-sharded layout asks
    for its rank's group."""
    from repro_torch.configs.base import ModelConfig
    for arch in ("rwkv6-3b", "zamba2-7b"):
        cfg = reduce_config(get_config(arch))
        api = get_model(cfg)
        assert api.prefill_chunk is not None and api.decode_step is not None
        params = api.init(torch.Generator().manual_seed(0), cfg)
        with pytest.raises(ValueError, match="takes that rank's group="):
            Engine(cfg, params, layout="paged-sharded")
        eng = Engine(cfg, params, temperature=0.5, n_slots=2, max_len=16)
        out = eng.run([(np.arange(1, 6, dtype=np.int32), 3)])
        assert len(out[0]) == 3 and all(0 <= t < cfg.vocab_size
                                        for t in out[0])
    with pytest.raises(ValueError, match="unknown family"):
        get_model(ModelConfig(name="x", family="rnn", n_layers=2,
                              d_model=64))


# -- the CUDA-core GQA body's head-group plan --------------------------------

@pytest.mark.parametrize("D", [32, 64, 96, 128])
@pytest.mark.parametrize("C", [1, 5, 32])
def test_gqa_heads_plan_covers_every_pair_once(D, C):
    """For every G up to 48: each block serves at most 2048 // D (row,
    head) pairs, and the blocks, as the kernel derives them from the
    plan, cover every (query row, head) pair of a KV head exactly
    once."""
    rmax = tpk.GQA_CC_ELEMS // D
    for G in range(1, 49):
        rows, heads = tpk.gqa_heads_plan(G, D)
        assert rows >= 1 and 1 <= heads <= G and rows * heads <= rmax
        seen = np.zeros((C, G), np.int64)
        for c0, nr, g0, ng in tpk.gqa_cc_blocks(C, G, D):
            assert 1 <= nr <= rows and 1 <= ng <= heads
            seen[c0:c0 + nr, g0:g0 + ng] += 1
        assert np.all(seen == 1), (G, D, C)


def test_gqa_heads_plan_at_the_zoo_shapes():
    """granite-3-2b (G 4, D 64: 8 rows), qwen2-7b (G 7, D 128: 2 rows,
    14 of 16 pairs), mixtral (G 4, D 128: 4 rows), granite-20b's MQA (G
    48, D 128: 3 groups of 16 heads, one row), qwen1.5-110b (G 8),
    phi-3 (G 1, D 96: 21 rows): the float32 body's plan.  bf16 at D 96
    takes the tensor cores."""
    assert tpk.gqa_heads_plan(4, 64) == (8, 4)
    assert tpk.gqa_heads_plan(7, 128) == (2, 7)
    assert tpk.gqa_heads_plan(4, 128) == (4, 4)
    assert tpk.gqa_heads_plan(48, 128) == (1, 16)
    assert tpk.gqa_heads_plan(8, 128) == (2, 8)
    assert tpk.gqa_heads_plan(1, 96) == (21, 1)
    assert tpk.gqa_heads_plan(17, 128) == (1, 9)
    assert len(tpk.gqa_cc_blocks(1, 48, 128)) == 3
    assert 96 in tpk.HEAD_DIMS
    assert tpk.gqa_body(torch.bfloat16, 96) == "tensor_cores"


# -- calibration --------------------------------------------------------------

def test_calibrate_moe_on_mixtral_matches_jax():
    """Mixtral (8 experts reduced to 4, top-2, no dense layer, no shared
    expert; its experts widened to moe_d_ff 256 so that the injection
    kills a whole column tile): the (L, E) predictors, permutations and
    permuted weights equal JAX's from the same batches."""
    jcfg, jparams, cfg, params = _jax_model("mixtral-8x7b", moe_d_ff=256)
    jb = _batches(cfg, 32, jnp.asarray)
    tb = _batches(cfg, 32, torch.as_tensor)
    jp, jmor, jrep = jcalibrate_moe(jparams, jcfg, jget_model(jcfg).forward,
                                    iter(jb), 2, inject_dead_frac=0.5)
    tp, tmor, trep = calibrate_moe(params, cfg, get_model(cfg).forward,
                                   iter(tb), 2, inject_dead_frac=0.5)
    assert set(tmor) == set(jmor) == {"moe_layers"}
    want, got = _np(jmor["moe_layers"]["experts"]), \
        tmor["moe_layers"]["experts"]
    assert got["m"].shape == (2, 4, 256)
    for key in ("enable", "proxy_slot", "is_proxy", "perm", "inv_perm",
                "bn_scale"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    for key in ("m", "b", "bn_bias"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    assert trep["injected_dead_cols"] == jrep["injected_dead_cols"] == 128
    np.testing.assert_allclose(trep["pearson_mean"], jrep["pearson_mean"],
                               atol=2e-4)
    for key in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(
            tp["moe_layers"]["moe"][key].numpy(),
            np.asarray(jp["moe_layers"]["moe"][key], np.float32))


def test_calibrate_lm_on_hubert_frames_matches_jax():
    """Hubert's native ReLU, non-GLU FFN calibrated on frames batches:
    the predictor is fitted on the up projection; masks, permutations and
    the permuted up / down weights equal JAX's."""
    jcfg, jparams, cfg, params = _jax_model("hubert-xlarge")
    jb = _batches(cfg, 32, jnp.asarray)
    tb = _batches(cfg, 32, torch.as_tensor)
    jp, jmor, jrep = jcalibrate_lm(jparams, jcfg, jget_model(jcfg).forward,
                                   iter(jb), 2)
    tp, tmor, trep = calibrate_lm(params, cfg, get_model(cfg).forward,
                                  iter(tb), 2)
    want, got = _np(jmor["layers"]), tmor["layers"]
    for key in ("enable", "proxy_slot", "is_proxy", "perm", "inv_perm"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)
    for key in ("m", "b"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-4,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(trep["pearson_mean"], jrep["pearson_mean"],
                               atol=2e-4)
    assert "w_gate" not in tp["layers"]["mlp"]
    for key in ("w_up", "w_down"):
        np.testing.assert_array_equal(
            tp["layers"]["mlp"][key].numpy(),
            np.asarray(jp["layers"]["mlp"][key], np.float32))
    # the calibrated kernel-mode forward equals JAX's on the same frames
    fr = tb[0]["frames"]
    want_l, _ = jget_model(jcfg).forward(jp, jcfg, {"frames": jnp.asarray(
        fr.numpy())}, mor=jmor, mor_mode="kernel")
    got_l, _ = get_model(cfg).forward(tp, cfg, {"frames": fr}, mor=tmor,
                                      mor_mode="kernel")
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=TOL,
                               atol=TOL)


# -- the paged engine against JAX's ------------------------------------------

ENGINE_ARCHS = {
    # arch: (config overrides, trace of (unique prompt length, new tokens))
    "qwen2-7b": ({}, ((3, 4), (9, 3), (8, 4))),
    "granite-20b": ({}, ((5, 3), (8, 4), (2, 3))),
    "mixtral-8x7b": ({"moe_d_ff": 256}, ((14, 4), (21, 3), (9, 4))),
}


def _dead_odd_tiles(layer):
    """The calibrated MoR layer with its odd 128-column tiles statically
    dead, so that the predictor really skips (random weights leave every
    tile live)."""
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
def engine_models():
    out = {}
    for arch, (replace, shape) in ENGINE_ARCHS.items():
        jcfg, jparams, cfg, _ = _jax_model(arch, **replace)
        jb = _batches(cfg, 32, jnp.asarray)
        fwd = jget_model(jcfg).forward
        if cfg.family == "moe":
            jparams, jmor, _ = jcalibrate_moe(jparams, jcfg, fwd, iter(jb),
                                              2, inject_dead_frac=0.5)
            tmor = convert.mor_from_numpy(_np(jmor), device="cpu")
        else:
            jparams, jmor, _ = jcalibrate_lm(jparams, jcfg, fwd, iter(jb), 2)
            layer = _dead_odd_tiles(_np(jmor["layers"]))
            jmor = {"layers": {k: jnp.asarray(v) for k, v in layer.items()}}
            tmor = convert.mor_from_numpy({"layers": layer}, device="cpu")
        params = convert.params_from_numpy(cfg, _np(jparams), device="cpu")
        rng = np.random.default_rng(7)
        prefix = rng.integers(0, cfg.vocab_size, 16)
        reqs = [(np.concatenate([prefix, rng.integers(0, cfg.vocab_size, n)]
                                ).astype(np.int32), g) for n, g in shape]
        reqs.append((reqs[1][0].copy(), 3))
        out[arch] = (jcfg, jparams, jmor, cfg, params, tmor, reqs)
    return out


@pytest.mark.parametrize("mode", ["tiled", "kernel"])
@pytest.mark.parametrize("arch", sorted(ENGINE_ARCHS))
def test_paged_engine_matches_jax(engine_models, arch, mode):
    """Greedy tokens, dispatches, prefix counters and per-layer (for
    mixtral, (L, E)) tile fractions equal JAX's paged engine with the
    prefix cache on.  Mixtral keeps the reduced window of 16 (a ring of
    24 rows): its prompts of 25-37 tokens wrap the ring over shared
    pages and copy on write."""
    jcfg, jparams, jmor, cfg, params, tmor, reqs = engine_models[arch]
    kw = dict(n_slots=2, max_len=48, mor_mode=mode)
    jeng = JEngine(jcfg, jparams, mor=jmor, **kw)
    want = jeng.run(list(reqs))
    teng = Engine(cfg, params, mor=tmor, **kw)
    assert teng.run(list(reqs)) == want
    assert teng.counters["dispatches"] == jeng.counters["dispatches"]
    assert teng._prefix_counters() == jeng._prefix_counters()
    pc = teng._prefix_counters()
    assert pc["prefix_hits"] > 0
    if cfg.sliding_window:
        assert max(len(p) for p, _ in reqs) > cfg.sliding_window + 8
        assert pc["pages_cowed"] > 0
    jtel, ttel = jeng.telemetry.summary(), teng.telemetry.summary()
    groups = [g for g in ("mor_stats", "moe_mor_stats") if g in jtel]
    assert groups and all(g in ttel for g in groups)
    for g in groups:
        for name in ("frac_tiles_live", "frac_tiles_computed"):
            np.testing.assert_allclose(ttel[g][name], jtel[g][name],
                                       rtol=1e-12, err_msg=(g, name))
        assert np.max(ttel[g]["frac_tiles_computed"]) < 1.0


# -- the serve CLI ------------------------------------------------------------

def test_serve_cli_mixtral_on_cpu():
    from repro_torch.launch import serve
    rep = serve.main(["--arch", "mixtral-8x7b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--requests", "3",
                      "--prompt-min", "3", "--prompt-max", "20",
                      "--gen-len", "3", "--shared-prefix", "8", "--mor",
                      "kernel", "--compare"])
    assert rep["requests_finished"] == 3
    assert np.asarray(rep["per_layer_moe_frac_tiles_live"]).shape == (2, 4)
    assert rep["prefix_cache"]["prefix_hits"] > 0
    assert 0.0 <= rep["token_agreement_vs_dense"] <= 1.0


def test_serve_cli_refuses_the_encoder():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--reduced", "--device",
                    "cpu", "--mor", "kernel"])

