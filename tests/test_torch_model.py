"""The port's dense transformer and slotted cache against the JAX package
on reduced granite-3-2b (float32), with carried-across weights.

Tolerances: logits of a 2-layer float32 model computed by two frameworks
(different matmul and softmax summation orders) agree to rtol = atol =
2e-4, the bound the JAX package's own chunked-vs-batched prefill test
uses for the same model.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import get_model as jget_model
from repro.serving import kv_pool as jkv
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.models import get_model
from repro_torch.serving import kv_pool
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "granite-3-2b"
TOL = 2e-4


@pytest.fixture(scope="module")
def models():
    jcfg = jreduce_config(jget_config(ARCH))
    japi = jget_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0), jcfg)
    cfg = reduce_config(get_config(ARCH))
    params = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, japi, jparams, cfg, get_model(cfg), params


def test_forward_logits_and_taps_match_jax(models):
    jcfg, japi, jparams, cfg, api, params = models
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 13))
    want, waux = japi.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                              with_taps=True)
    got, gaux = api.forward(params, cfg, {"tokens": torch.as_tensor(toks)},
                            with_taps=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    # the binary taps are integers: equal wherever no activation sits at 0
    np.testing.assert_array_equal(gaux["taps"]["p_bin"].numpy(),
                                  np.asarray(waux["taps"]["p_bin"]))
    np.testing.assert_allclose(gaux["taps"]["p_base"].numpy(),
                               np.asarray(waux["taps"]["p_base"]),
                               rtol=TOL, atol=TOL)


def test_prefill_chunk_chain_matches_jax(models):
    """Mixed dispatches (a prefilling slot, an idle slot, a slot fed a
    partial chunk) chained over the slotted cache: logits allclose, the
    kv tags equal, and the idle slot's cache bit-identical."""
    jcfg, japi, jparams, cfg, api, params = models
    B, C, max_len = 3, 5, 24
    jcache = jkv.init(jcfg, B, max_len, C)
    cache = kv_pool.init(cfg, B, max_len, C, device="cpu")
    rng = np.random.default_rng(1)
    plan = [np.array([5, 0, 3]), np.array([5, 0, 1]), np.array([2, 0, 1])]
    for step, nv in enumerate(plan):
        toks = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
        idle_before = {k: v[:, 1].clone() for k, v in
                       cache["layers"].items()}
        want, jcache, _ = japi.prefill_chunk(
            jparams, jcfg, jnp.asarray(toks), jcache,
            n_valid=jnp.asarray(nv, jnp.int32))
        got, _ = api.prefill_chunk(params, cfg, torch.as_tensor(toks), cache,
                                   n_valid=torch.as_tensor(nv,
                                                           dtype=torch.int32))
        for b in range(B):
            np.testing.assert_allclose(got[b, :nv[b]].numpy(),
                                       np.asarray(want)[b, :nv[b]],
                                       rtol=TOL, atol=TOL)
        for k, v in cache["layers"].items():
            assert torch.equal(v[:, 1], idle_before[k]), (step, k)
        np.testing.assert_array_equal(cache["layers"]["pos"].numpy(),
                                      np.asarray(jcache["layers"]["pos"]))
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        np.testing.assert_allclose(cache["layers"]["k"].numpy(),
                                   np.asarray(jcache["layers"]["k"]),
                                   rtol=TOL, atol=TOL)


def test_reset_slots_matches_jax(models):
    jcfg, _, _, cfg, _, _ = models
    jcache = jkv.init(jcfg, 3, 16, 4)
    cache = kv_pool.init(cfg, 3, 16, 4, device="cpu")
    for c in (cache["layers"]["k"], cache["layers"]["v"]):
        c.fill_(1.0)
    cache["layers"]["pos"].fill_(7)
    cache["pos"].fill_(9)
    jcache = jax.tree_util.tree_map(
        lambda a: jnp.full_like(a, 9 if a.ndim == 1 else
                                (7 if a.dtype == jnp.int32 else 1)), jcache)
    slots = np.array([True, False, True])
    want = jkv.reset_slots(jcache, jnp.asarray(slots))
    got = kv_pool.reset_slots(cache, torch.as_tensor(slots))
    np.testing.assert_array_equal(got["pos"].numpy(), np.asarray(want["pos"]))
    for k in ("k", "v", "pos"):
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(want["layers"][k]))


def test_port_has_no_jax_imports():
    """The port package imports neither jax nor the JAX package."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1] / "src" / \
        "repro_torch"
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\s|\.|$)", re.M)
    offenders = [str(p) for p in root.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []


def test_engine_rejects_what_it_does_not_serve(models):
    from repro_torch.serving import Engine, RequestRejected
    _, _, _, cfg, _, params = models
    with pytest.raises(ValueError, match="takes that rank's group="):
        Engine(cfg, params, layout="paged-sharded")
    with pytest.raises(ValueError, match="layout='paged'"):
        Engine(cfg, params, layout="slotted", temperature=0.7, spec_k=2)
    eng = Engine(cfg, params, n_slots=2, max_len=16)
    for prompt, max_new, reason in (([], 4, "empty_prompt"),
                                    ([1, 2], 0, "nonpositive_max_new_tokens"),
                                    ([1] * 14, 4, "oversize"),
                                    ([cfg.vocab_size], 2, "bad_token")):
        with pytest.raises(RequestRejected) as ei:
            eng.submit(prompt, max_new)
        assert ei.value.reason == reason
    assert eng.counters["requests_rejected"] == 4


def test_serve_cli_runs_on_cpu(tmp_path):
    import json
    from repro_torch.launch import serve
    out = tmp_path / "serve.json"
    rep = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                      "--requests", "3", "--prompt-min", "3",
                      "--prompt-max", "9", "--gen-len", "3", "--mor",
                      "kernel", "--capacity", "0.5", "--compare",
                      "--out-json", str(out)])
    assert rep["requests_finished"] == 3
    assert len(rep["per_layer_frac_tiles_live"]) == 2
    assert 0.0 <= rep["token_agreement_vs_dense"] <= 1.0
    assert json.loads(out.read_text())["static_capacity"] == 0.5
