"""The port's self-speculative decoding and seeded sampling against the
JAX package (``repro.serving.spec``).

The pure functions (``sample_step``, ``accept_greedy``,
``accept_sampled``, ``emit_matrix``) take their random draws as
arguments: fed JAX's own draws (``jax.random.gumbel`` / ``uniform``
from the same keys ``jax.random.categorical`` and the reference's
``accept_sampled`` use), they must give JAX's tokens exactly.  The
engine draws its noise from a ``torch.Generator`` (the port's seeded
contract), so sampled streams are compared with themselves (seeded
reproducibility) and greedy streams with JAX's.

Engines run reduced float32 granite-3-2b, rwkv6-3b and zamba2-7b (cut
to 3 layers: one Mamba2 pair, the shared attention block, one tail
layer) on the JAX ``init`` weights and calibration (the odd 128-column
tiles made statically dead, so that the predictor skips), carried
across as numpy.
Integer results (tokens, acceptance counts, rounds, replays, block
tables) must be equal.  In dense mode greedy speculation must also give
vanilla decode's tokens; under tiled plans the live-tile mask of a
(K+1)-wide verify is not that of a 1-wide decode, so there the port is
held to JAX's speculative engine.  Float tolerances: the sampling
probabilities are one float32 softmax in both packages, 1e-6; the
rejection rule's first-token marginal over 8,000 trials, 0.03 (over 5
standard deviations at the largest mass).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core.deploy import calibrate_hybrid as jcalibrate_hybrid
from repro.core.deploy import calibrate_lm as jcalibrate_lm
from repro.models import get_model as jget_model
from repro.serving import Engine as JEngine
from repro.serving import spec as jspec
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.core.deploy import attach_plans
from repro_torch.core.executor import attach_draft_caps, map_plans
from repro_torch.data import pipeline as tpipe
from repro_torch.serving import Engine
from repro_torch.serving import spec
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("granite-3-2b", "rwkv6-3b", "zamba2-7b")
# per-arch config overrides: zamba2 at 3 layers keeps every part of the
# hybrid and halves its JAX compile and calibration time
REPLACE = {"zamba2-7b": dict(n_layers=3)}
TRACE = [(9, 12), (5, 7), (13, 16), (7, 1)]      # (prompt length, new tokens)
KW = dict(n_slots=2, max_len=64, telemetry=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# -- the pure functions against JAX's ------------------------------------------

def test_accept_greedy_and_emit_matrix_hand_rows():
    """The reference's hand rows (partial accept, immediate reject, full
    accept, a slot sitting the round out) in both packages."""
    drafts = [[5, 6, 7], [1, 2, 3], [9, 8, 7], [0, 0, 0]]
    targets = [[5, 6, 8, 4], [7, 1, 2, 3], [9, 8, 7, 2], [3, 1, 1, 1]]
    k_valid, n_valid = [3, 2, 3, 0], [4, 3, 4, 0]
    n_acc, corr = spec.accept_greedy(_t(drafts, torch.int32),
                                     _t(targets, torch.int32),
                                     _t(k_valid, torch.int32))
    assert n_acc.tolist() == [2, 0, 3, 0] and corr.tolist() == [8, 7, 2, 3]
    toks, n_emit = spec.emit_matrix(_t(drafts, torch.int32), n_acc, corr,
                                    _t(n_valid, torch.int32))
    assert n_emit.tolist() == [3, 1, 4, 0]
    assert toks[0, :3].tolist() == [5, 6, 8] and toks[1, :1].tolist() == [7]
    assert toks[2].tolist() == [9, 8, 7, 2]
    jn, jc = jspec.accept_greedy(jnp.asarray(drafts), jnp.asarray(targets),
                                 jnp.asarray(k_valid))
    jt, je = jspec.emit_matrix(jnp.asarray(drafts), jn, jc,
                               jnp.asarray(n_valid))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(n_emit.numpy(), np.asarray(je))


@pytest.mark.parametrize("seed", range(4))
def test_accept_greedy_and_emit_matrix_match_jax_on_random_batches(seed):
    """Random drafts drawn from a vocabulary of 3 (so that prefixes match
    often), random targets and drafted counts."""
    rng = np.random.default_rng(seed)
    B, K = 16, 4
    drafts = rng.integers(0, 3, (B, K)).astype(np.int32)
    targets = rng.integers(0, 3, (B, K + 1)).astype(np.int32)
    k_valid = rng.integers(0, K + 1, B).astype(np.int32)
    n_valid = np.where(rng.random(B) < 0.2, 0, k_valid + 1).astype(np.int32)
    n_acc, corr = spec.accept_greedy(_t(drafts), _t(targets), _t(k_valid))
    jn, jc = jspec.accept_greedy(drafts, targets, k_valid)
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(jc))
    toks, n_emit = spec.emit_matrix(_t(drafts), n_acc, corr, _t(n_valid))
    jt, je = jspec.emit_matrix(drafts, jn, jc, n_valid)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(n_emit.numpy(), np.asarray(je))


def _dists(rng, shape, V, peaked):
    logits = rng.normal(size=shape + (V,)) * (4.0 if peaked else 1.0)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", range(6))
def test_accept_sampled_matches_jax_on_jax_draws(seed):
    """``u = uniform(ku, (B, K))`` and ``g = gumbel(kr, (B, V))`` from
    ``jax.random.split(key)``, the draws the reference makes inside its
    ``accept_sampled``, fed to the port: ``n_accept`` and ``correction``
    equal JAX's.  Drafts are drawn from q, so that acceptances,
    rejections and full accepts (bonus tokens) all occur; odd seeds use a
    one-hot q (a greedy draft under a sampled target)."""
    rng = np.random.default_rng(seed)
    B, K, V = 32, 3, 11
    q = _dists(rng, (B, K), V, peaked=True)
    p = _dists(rng, (B, K + 1), V, peaked=seed % 3 == 0)
    drafts = np.stack([[rng.choice(V, p=q[b, i] / q[b, i].sum())
                        for i in range(K)] for b in range(B)]).astype(np.int32)
    if seed % 2:
        q = np.eye(V, dtype=np.float32)[drafts]
    k_valid = rng.integers(0, K + 1, B).astype(np.int32)
    key = jax.random.PRNGKey(100 + seed)
    jn, jc = jspec.accept_sampled(drafts, q, p, k_valid, key)
    ku, kr = jax.random.split(key)
    u = np.asarray(jax.random.uniform(ku, (B, K)))
    g = np.asarray(jax.random.gumbel(kr, (B, V)))
    n_acc, corr = spec.accept_sampled(_t(drafts), _t(q), _t(p), _t(k_valid),
                                      _t(u), _t(g))
    np.testing.assert_array_equal(n_acc.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(corr.numpy(), np.asarray(jc))
    assert 0 < int((n_acc.numpy() >= k_valid).sum()) < B


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 20),
                                               (1.3, 3)])
def test_sample_step_matches_jax_categorical(temperature, top_k):
    """Given ``jax.random.gumbel`` of the key, the port's Gumbel-max
    draws ``jax.random.categorical``'s tokens, and its probabilities are
    the reference's within 1e-6; at temperature 0 both take the
    argmax."""
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    B, V = 64, 97
    lg = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    key = jax.random.PRNGKey(top_k)
    jt, jp = jspec.sample_step(jnp.asarray(lg), temperature=temperature,
                               top_k=top_k, key=key, with_probs=True)
    g = np.asarray(jax.random.gumbel(key, (B, V)))
    t, p = spec.sample_step(_t(lg), temperature=temperature, top_k=top_k,
                            gumbel=_t(g), with_probs=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    g0, _ = spec.sample_step(_t(lg), temperature=0.0, top_k=0)
    j0, _ = jspec.sample_step(jnp.asarray(lg), temperature=0.0, top_k=0,
                              key=key)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(j0))
    # the port's own noise: Gumbel by construction from its uniforms
    u = torch.rand((4096,), generator=torch.Generator().manual_seed(0))
    z = spec.gumbel_from_uniform(u)
    assert abs(float(z.mean()) - 0.5772) < 0.05


def test_accept_sampled_first_token_marginal():
    """The rejection rule's guarantee: drafting from q and verifying
    against p emits a first token distributed as p, for any q, over
    8,000 vectorised trials with the port's own draws."""
    V, N = 5, 8000
    p = torch.tensor([0.44, 0.26, 0.14, 0.10, 0.06])
    q = torch.tensor([0.10, 0.20, 0.30, 0.25, 0.15])
    gen = torch.Generator().manual_seed(7)
    d = torch.multinomial(q, N, replacement=True, generator=gen).to(
        torch.int32)[:, None]
    tgt = torch.stack([p, torch.full((V,), 1.0 / V)])[None].expand(N, 2, V)
    u = torch.rand((N, 1), generator=gen)
    g = spec.gumbel_from_uniform(torch.rand((N, V), generator=gen))
    n_acc, corr = spec.accept_sampled(d, q.expand(N, 1, V), tgt,
                                      torch.ones(N, dtype=torch.int32), u, g)
    first = torch.where(n_acc > 0, d[:, 0], corr)
    emp = torch.bincount(first.long(), minlength=V).double() / N
    np.testing.assert_allclose(emp.numpy(), p.numpy(), atol=0.03)


def test_draft_caps_attach_as_the_budget_in_force():
    """``attach_draft_caps`` stores a dormant budget of cap_live's kind
    on every calibrated plan (an (L,) host array on a stack, a float on a
    hybrid's shared layer, an (L, E) tensor on an expert plan);
    ``as_draft()`` puts it in force, ``layer(l)`` slices it, and the
    shadow / scored twins carry both fields."""
    cfg = reduce_config(get_config("granite-3-2b"))
    rng = np.random.default_rng(0)
    N = cfg.d_ff
    layer = {"m": rng.normal(size=(2, N)).astype(np.float32),
             "enable": np.ones((2, N), bool)}
    plans = attach_plans({"layers": {k: torch.as_tensor(v)
                                     for k, v in layer.items()}},
                         cfg, "tiled", draft_cap=0.25)
    p = plans["layers"]
    assert p.active_cap is None and np.allclose(p.draft_cap, [0.25, 0.25])
    d = p.as_draft()
    assert d.draft and d.active_cap is p.draft_cap
    assert d.layer(1).active_cap == 0.25 and p.layer(1).active_cap is None
    assert d.as_scored().draft and d.as_shadow().active_cap is p.draft_cap
    experts = map_plans({"experts": p._replace(mor={
        "m": torch.zeros((2, 4, N))})},
        lambda q: q)
    e = attach_draft_caps(experts, 0.5)["experts"]
    assert torch.is_tensor(e.draft_cap) and tuple(e.draft_cap.shape) == (2, 4)
    shared = attach_draft_caps(p._replace(mor={"m": torch.zeros((N,))}), 0.5)
    assert shared.draft_cap == 0.5


# -- the engine against JAX's ----------------------------------------------------

def _calibrated(arch):
    jcfg = jreduce_config(jget_config(arch)).replace(**REPLACE.get(arch, {}))
    cfg = reduce_config(get_config(arch)).replace(**REPLACE.get(arch, {}))
    api = jget_model(jcfg)
    jparams = api.init(jax.random.PRNGKey(0), jcfg)
    bs = [{"tokens": jnp.asarray(tpipe.make_batch(cfg, 2, 32, seed=0,
                                                  step=i)["tokens"])}
          for i in range(2)]
    cal = jcalibrate_hybrid if cfg.family == "hybrid" else jcalibrate_lm
    jparams, jmor, _ = cal(jparams, jcfg, api.forward, iter(bs), 2)
    (group, layer), = _np(jmor).items()
    layer = {k: np.array(v) for k, v in layer.items()}
    dead = (np.arange(layer["m"].shape[-1]) // 128) % 2 == 1
    layer["bn_bias"] = np.where(dead, -1e3, layer["bn_bias"]).astype(
        np.float32)
    layer["enable"] = layer["enable"] | dead
    layer["is_proxy"] = layer["is_proxy"] & ~dead
    layer["proxy_slot"] = np.where(dead, -1, layer["proxy_slot"]).astype(
        np.int32)
    jmor = {group: {k: jnp.asarray(v) for k, v in layer.items()}}
    tmor = convert.mor_from_numpy({group: layer}, device="cpu")
    params = convert.params_from_numpy(cfg, _np(jparams), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, cfg.vocab_size, size=p).astype(np.int32), g)
            for p, g in TRACE]
    return jcfg, jparams, jmor, cfg, params, tmor, reqs


@pytest.fixture(scope="module")
def models():
    return {arch: _calibrated(arch) for arch in ARCHS}


def _both(m, mode="dense", **kw):
    jcfg, jparams, jmor, cfg, params, tmor, _ = m
    dense = mode == "dense"
    return (JEngine(jcfg, jparams, mor=None if dense else jmor,
                    mor_mode=mode, **KW, **kw),
            Engine(cfg, params, mor=None if dense else tmor, mor_mode=mode,
                   **KW, **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_dense_matches_jax_and_vanilla(models, arch):
    """Greedy drafts in dense mode (draft plans = target plans): tokens
    equal vanilla decode's and (granite, rwkv6) JAX's speculative
    engine's, and so do the spec counters and dispatch kinds (zamba2 is
    held to JAX's in tiled mode below); temperature-1.0 drafts (random
    proposals, rejections) still give the greedy tokens, and the
    recurrent families take the replay path."""
    reqs = models[arch][-1]
    cfg, params = models[arch][3:5]
    want = Engine(cfg, params, **KW).run(list(reqs))
    teng = Engine(cfg, params, spec_k=3, **KW)
    assert teng.run(list(reqs)) == want
    if arch != "zamba2-7b":
        jcfg, jparams = models[arch][:2]
        jeng = JEngine(jcfg, jparams, spec_k=3, **KW)
        assert jeng.run(list(reqs)) == want
        assert teng.spec.report() == jeng.spec.report()
        assert teng.scheduler.dispatch_kinds == \
            jeng.scheduler.dispatch_kinds
    assert teng.spec.counters["rounds"] > 0
    assert teng.report()["spec"]["acceptance_rate"] == 1.0
    hot = Engine(*models[arch][3:5], spec_k=3, spec_draft_temperature=1.0,
                 **KW)
    assert hot.run(list(reqs)) == want
    sp = hot.spec.report()
    assert sp["rounds"] > 0 and sp["aborts"] == 0
    assert sp["tokens_accepted"] < sp["tokens_drafted"]
    if arch != "granite-3-2b":
        assert sp["replays"] > 0, sp


@pytest.mark.parametrize("arch,draft_cap", [("granite-3-2b", 0.5),
                                            ("rwkv6-3b", 0.5),
                                            ("zamba2-7b", 0.5)])
def test_spec_tiled_draft_cap_matches_jax(models, arch, draft_cap):
    """MoR-capacitated drafts under tiled plans: the tokens, the spec
    counters and the dispatch kinds equal JAX's speculative engine's."""
    reqs = models[arch][-1]
    jeng, teng = _both(models[arch], "tiled", spec_k=3, draft_cap=draft_cap)
    assert teng.run(list(reqs)) == jeng.run(list(reqs))
    assert teng.spec.report() == jeng.spec.report()
    assert teng.scheduler.dispatch_kinds == jeng.scheduler.dispatch_kinds
    assert teng.spec.report()["draft_cap"] == draft_cap


# -- seeded sampling ----------------------------------------------------------------

def test_seeded_sampling_is_a_function_of_the_seed(models):
    """Sampled decoding, vanilla and speculative (the rejection rule end
    to end): the same ``sample_seed`` gives the same tokens on two
    engines, another seed other tokens; every token in the vocabulary
    and every request its budget."""
    _, _, _, cfg, params, _, reqs = models["granite-3-2b"]
    reqs = reqs[:2]
    for kw in (dict(top_k=20), dict(spec_k=3)):
        runs = [Engine(cfg, params, temperature=1.0, sample_seed=s, **kw,
                       **KW).run(list(reqs)) for s in (3, 3, 4)]
        assert runs[0] == runs[1] and runs[0] != runs[2]
        for r, (_, g) in enumerate(reqs):
            assert len(runs[0][r]) == g
            assert all(0 <= t < cfg.vocab_size for t in runs[0][r])
    eng = Engine(cfg, params, temperature=0.7, top_k=5, **KW)
    eng.run(list(reqs))
    assert eng.report()["sampling"]["top_k"] == 5


# -- the hot loop -------------------------------------------------------------------

def test_spec_hot_loop_reads_one_value_a_round(models, monkeypatch):
    """A speculative run reads back exactly one value a round, the emit
    counts (one ``tolist``), and nothing else before the flush; the
    rounds and the obs metrics block's drafted / accepted lanes agree
    with the host counters."""
    from repro_torch.obs import Observability
    _, _, _, cfg, params, tmor, reqs = models["rwkv6-3b"]
    eng = Engine(cfg, params, mor=tmor, mor_mode="kernel", spec_k=3,
                 spec_draft_temperature=1.0, draft_cap=0.5,
                 obs=Observability(), **KW)
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
    rounds = eng.spec.counters["rounds"]
    assert rounds > 0 and calls == ["tolist"] * rounds
    monkeypatch.undo()
    rep = eng.report()
    dm = rep["obs"]["device_metrics"]
    assert dm["tokens_drafted"] == eng.spec.counters["tokens_drafted"]
    assert dm["tokens_accepted"] == eng.spec.counters["tokens_accepted"]
    assert dm["dispatches"] == eng.counters["dispatches"]
    assert eng.spec.counters["replays"] > 0
    assert sorted(len(v) for v in eng.results.values()) == \
        sorted(g for _, g in reqs)


def test_serve_cli_spec_sampling_priority_stream_on_cpu(capsys):
    """``--spec-k 2 --temperature 0.7 --top-k 20 --policy priority
    --stream`` on reduced granite prints the spec report and the streamed
    tokens."""
    from repro_torch.launch import serve
    rep = serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                      "--requests", "3", "--prompt-min", "3",
                      "--prompt-max", "9", "--gen-len", "5", "--spec-k", "2",
                      "--temperature", "0.7", "--top-k", "20",
                      "--sample-seed", "1", "--policy", "priority",
                      "--prefill-budget", "6", "--stream"])
    assert rep["spec"]["k"] == 2 and rep["spec"]["rounds"] > 0
    assert rep["policy"] == "priority" and rep["prefill_budget"] == 6
    assert rep["sampling"]["temperature"] == 0.7
    assert rep["stream"]["tokens"] == 5
    out = capsys.readouterr().out
    assert "spec: k=2" in out and "--stream" in out
