"""The port's static-batch serving path, its long-sequence attention and
the ``masked_ffn`` entry points against the JAX package, on reduced
float32 configs.

Weights are the port's ``init`` from a torch seed, handed to both
packages as numpy (``repro_torch.convert`` for the port): the JAX
``init`` of these models costs seconds of compilation each.  The MoR
trees are the port's own calibration of them (``calibrate_lm`` on
granite with every odd 128-column tile made statically dead, so that the
predictor really skips; ``calibrate_moe`` with half of every expert's
columns injected dead on deepseek and mixtral, widened to moe_d_ff 256),
handed to JAX as numpy together with the permuted weights: both packages
run the same calibrated model.  Inputs come from numpy seeds.

Tolerances: integer results (greedy tokens, position tags, tile
counters, branch choices) must be equal; the telemetry's skip fractions
are averages of equal counts and agree to 1e-12.  One float32 attention
call summed in another order agrees to 1e-5; logits and layer outputs of
a float32 model to rtol = atol = 2e-4, as ``tests/test_models_smoke.py``
holds the JAX prefill to its forward.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core import masked_ffn as jffn
from repro.core import predictor as jpred
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import get_model as jget_model
from repro.models import supports_long_context as jlong
from repro.models.layers import attention as jattn
from repro.serving import kv_pool as jkv
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import masked_ffn as tffn
from repro_torch.core import predictor as tpred
from repro_torch.core.deploy import calibrate_lm, calibrate_moe
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import get_model, supports_long_context
from repro_torch.models import transformer as ttrans
from repro_torch.models.layers import attention as tattn
from repro_torch.models.transformer import layer_slice
from repro_torch.serving import kv_pool as tkv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = 2e-4
ATTN_TOL = 1e-5
ARCHS = ("granite-3-2b", "deepseek-v2-236b", "mixtral-8x7b")


def _j(tree):
    """A port tree (torch leaves) -> jnp leaves."""
    if isinstance(tree, dict):
        return {k: _j(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _batches(cfg, seed=0):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))}


def _dead_odd_tiles(layer):
    """Every odd 128-column tile statically dead: no proxy, the binary
    rookie enabled, an intercept far below zero."""
    n = layer["m"].shape[-1]
    dead = (torch.arange(n) // 128) % 2 == 1
    return dict(layer, bn_bias=torch.where(dead, -1e3, layer["bn_bias"]),
                enable=layer["enable"] | dead,
                is_proxy=layer["is_proxy"] & ~dead,
                proxy_slot=torch.where(dead, -1, layer["proxy_slot"]))


def _tnp(tree):
    if isinstance(tree, dict):
        return {k: _tnp(v) for k, v in tree.items()}
    return tree.numpy()


def _model(arch, **replace):
    """The reduced configs of both packages and the same seeded weights
    in each: (jcfg, JAX params, cfg, port params)."""
    jcfg = jreduce_config(jget_config(arch)).replace(**replace)
    cfg = reduce_config(get_config(arch)).replace(**replace)
    weights = _tnp(get_model(cfg).init(torch.Generator().manual_seed(0),
                                       cfg))
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, weights), cfg,
            convert.params_from_numpy(cfg, weights, device="cpu"))


def _calibrated(arch):
    widen = {} if arch == "granite-3-2b" else {"moe_d_ff": 256}
    jcfg, _, cfg, params = _model(arch, **widen)
    api = get_model(cfg)
    if cfg.family == "moe":
        params, mor, _ = calibrate_moe(params, cfg, api.forward,
                                       _batches(cfg), 2,
                                       inject_dead_frac=0.5)
    else:
        params, mor, _ = calibrate_lm(params, cfg, api.forward,
                                      _batches(cfg), 2)
        mor = {"layers": _dead_odd_tiles(mor["layers"])}
    return jcfg, _j(params), _j(mor), cfg, params, mor


@pytest.fixture(scope="module")
def calibrated():
    memo = {}

    def get(arch):
        if arch not in memo:
            memo[arch] = _calibrated(arch)
        return memo[arch]
    return get


# -- long-sequence attention -------------------------------------------------

def _qkv(seed, B, Sq, Skv, H=4, Hkv=2, D=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Skv, Hkv, D)).astype(np.float32))


@pytest.fixture
def small_chunks(monkeypatch):
    """Both packages at a 16-row chunk and a 32-position threshold."""
    for mod in (jattn, tattn):
        monkeypatch.setattr(mod, "_CHUNK", 16)
        monkeypatch.setattr(mod, "_FLASH_THRESHOLD", 32)


@pytest.mark.parametrize("Sq,window", [(40, 0), (40, 12), (1, 12), (7, 0)])
def test_flash_matches_jax(small_chunks, Sq, window):
    """The chunked softmax over 40 kv rows (chunks of 16, 16 and a last
    one padded with 8 rows of tag -1), causal, with and without a
    window, for a prompt, one decode row and a ragged tail of rows."""
    Skv = 40
    q, k, v = _qkv(Sq + window, 2, Sq, Skv)
    q_pos, kv_pos = np.arange(Skv - Sq, Skv), np.arange(Skv)
    want = jattn._flash(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                        True, window)
    got = tattn._flash(_t(q), _t(k), _t(v), _t(q_pos), _t(kv_pos), True,
                       window)
    _close(got, want, ATTN_TOL)


def test_banded_matches_jax(small_chunks):
    """The banded sliding window over three chunks of 16 (window 12:
    every chunk's span reaches into the one before)."""
    q, k, v = _qkv(5, 2, 48, 48)
    pos = np.arange(48)
    want = jattn._banded(q, k, v, jnp.asarray(pos), jnp.asarray(pos), 12)
    got = tattn._banded(_t(q), _t(k), _t(v), _t(pos), _t(pos), 12)
    _close(got, want, ATTN_TOL)
    with pytest.raises(AssertionError, match="seq % chunk"):
        tattn._banded(_t(q[:, :40]), _t(k[:, :40]), _t(v[:, :40]),
                      _t(pos[:40]), _t(pos[:40]), 12)


# (Sq, Skv, window) -> the branch both packages take at chunk 16 and
# threshold 32
BRANCHES = [((16, 16, 0), "_sdpa"), ((40, 40, 0), "_flash"),
            ((48, 48, 12), "_banded"), ((40, 40, 12), "_flash"),
            ((8, 8, 12), "_sdpa"), ((1, 40, 12), "_flash"),
            ((1, 32, 0), "_sdpa")]


def _first_branch(monkeypatch, mod):
    seen = []
    for name in ("_sdpa", "_flash", "_banded"):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            seen.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.mark.parametrize("shape,branch", BRANCHES)
def test_attend_takes_the_branch_jax_takes(small_chunks, monkeypatch, shape,
                                           branch):
    Sq, Skv, window = shape
    q, k, v = _qkv(Skv, 1, Sq, Skv)
    q_pos, kv_pos = np.arange(Skv - Sq, Skv), np.arange(Skv)
    jseen, tseen = (_first_branch(monkeypatch, m) for m in (jattn, tattn))
    want = jattn.attend(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                        causal=True, window=window)
    got = tattn.attend(_t(q), _t(k), _t(v), _t(q_pos), _t(kv_pos),
                       causal=True, window=window)
    assert jseen[0] == tseen[0] == branch
    _close(got, want, ATTN_TOL)


def test_flash_threshold_and_long_context():
    assert tattn._FLASH_THRESHOLD == jattn._FLASH_THRESHOLD
    assert tattn._CHUNK == jattn._CHUNK
    for arch in ARCHS + ("rwkv6-3b", "zamba2-7b", "qwen2-7b",
                         "hubert-xlarge"):
        assert supports_long_context(get_config(arch)) == \
            jlong(jget_config(arch)), arch


# -- the layers' prefill and decode ------------------------------------------

def _layer0(jp, tp, group):
    return (jax.tree_util.tree_map(lambda a: a[0], jp[group]["attn"]),
            layer_slice(tp[group]["attn"], 0))


def _caches(jcfg, cfg, layout, B, L):
    """Layer 0 of ``cache_init``'s cache or of the slot pool, in both
    packages, its kv rows filled with the same noise (rows past the
    prompt must stay as they were)."""
    if layout == "cache_init":
        jc = jget_model(jcfg).cache_init(jcfg, B, L, jnp.float32)
        tc = get_model(cfg).cache_init(cfg, B, L, torch.float32, "cpu")
    else:
        jc = jkv.init(jcfg, B, L)
        tc = tkv.init(cfg, B, L, device="cpu")
    group = "layers" if "layers" in jc else "dense_layers"
    jl = {k: v[0] for k, v in jc[group].items()}
    tl = layer_slice(tc["layers"], 0)
    rng = np.random.default_rng(L)
    for key in ("k", "v", "c_kv", "k_pe"):
        if key in tl:
            noise = rng.normal(size=tl[key].shape).astype(np.float32)
            jl[key] = jnp.asarray(noise)
            tl[key].copy_(_t(noise))
    return jl, tl


def _same_cache(tl, jl):
    for key, want in jl.items():
        if key == "pos":
            np.testing.assert_array_equal(tl[key].numpy(), np.asarray(want))
        else:
            _close(tl[key], want)


@pytest.mark.parametrize("layout", ["cache_init", "slot_pool"])
def test_gqa_prefill_matches_jax(calibrated, layout):
    """Output and cache contents: k / v rows [0, S) written, the rest
    untouched; the shared (Lr,) tag row or the per-slot (B, Lr) tags."""
    jcfg, jp, _, cfg, tp, _ = calibrated("granite-3-2b")
    jl, tl = _caches(jcfg, cfg, layout, 2, 10)
    assert tl["pos"].ndim == (1 if layout == "cache_init" else 2)
    jlp, tlp = _layer0(jp, tp, "layers")
    x = np.random.default_rng(1).normal(size=(2, 6, cfg.d_model)).astype(
        np.float32)
    want, jnew = jax.jit(lambda p, x, c: jattn.gqa_prefill(p, jcfg, x, c))(
        jlp, jnp.asarray(x), jl)
    got = tattn.gqa_prefill(tlp, cfg, _t(x), tl)
    _close(got, want)
    _same_cache(tl, jnew)
    with pytest.raises(ValueError, match="batched prefill of 12 tokens"):
        tattn.gqa_prefill(tlp, cfg, _t(np.zeros((2, 12, cfg.d_model),
                                                np.float32)), tl)


@pytest.mark.parametrize("layout", ["cache_init", "slot_pool"])
def test_mla_prefill_and_decode_match_jax(calibrated, layout):
    """``mla_prefill`` then two ``mla_decode`` steps on deepseek's layer
    0: outputs, the latent rows, and the position tags (written by the
    port wherever its cache carries them: JAX's ``cache_init`` has
    none)."""
    jcfg, jp, _, cfg, tp, _ = calibrated("deepseek-v2-236b")
    B, S, L = 2, 5, 9
    jl, tl = _caches(jcfg, cfg, layout, B, L)
    jlp, tlp = _layer0(jp, tp, "dense_layers")
    x = np.random.default_rng(2).normal(size=(B, S + 2, cfg.d_model)
                                        ).astype(np.float32)
    jprefill = jax.jit(lambda p, x, c: jattn.mla_prefill(p, jcfg, x, c))
    jdecode = jax.jit(lambda p, x, c, pos: jattn.mla_decode(p, jcfg, x, c,
                                                            pos))
    want, jl = jprefill(jlp, jnp.asarray(x[:, :S]), jl)
    got = tattn.mla_prefill(tlp, cfg, _t(x[:, :S]), tl)
    _close(got, want)
    _same_cache(tl, jl)
    for t in range(2):
        want, jnew = jdecode(jlp, jnp.asarray(x[:, S + t:S + t + 1]), jl,
                             jnp.int32(S + t))
        jl = dict(jl, **jnew)
        got = tattn.mla_decode(tlp, cfg, _t(x[:, S + t:S + t + 1]), tl,
                               torch.tensor(S + t))
        _close(got, want)
        _same_cache(tl, {k: v for k, v in jl.items() if k != "pos"})
    tags = np.full((B, L), -1, np.int32)
    tags[:, :S + 2] = np.arange(S + 2)
    np.testing.assert_array_equal(tl["pos"].numpy(), tags)


# -- prefill + decode_step of the model --------------------------------------

# every mode once at least, kernel mode on a GQA and on an MLA + MoE
# model (the generate cases below add mixtral's kernel mode and
# granite's tiled)
STATIC_CASES = [("granite-3-2b", m) for m in ("dense", "exact", "kernel")] \
    + [("deepseek-v2-236b", "kernel"), ("mixtral-8x7b", "tiled")]


def _stacked(jc, key):
    """JAX's per-group cache stacks as the port's one stack."""
    groups = [g for g in ("dense_layers", "moe_layers", "layers")
              if g in jc]
    return np.concatenate([np.asarray(jc[g][key]) for g in groups])


@pytest.mark.parametrize("arch,mode", STATIC_CASES)
def test_prefill_then_decode_step_match_jax(calibrated, arch, mode):
    """``api.prefill`` over an 8-token prompt, then two ``decode_step``s
    on ``cache_init``'s cache: last-position logits, every cache leaf
    (kv or latent rows, tags) and the position."""
    jcfg, jp, jmor, cfg, tp, tmor = calibrated(arch)
    japi, api = jget_model(jcfg), get_model(cfg)
    assert api.prefill is ttrans.prefill
    assert api.decode_step is ttrans.decode_step
    jmor, tmor = (None, None) if mode == "dense" else (jmor, tmor)
    B, P, steps = 2, 8, 2
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P + steps)).astype(np.int32)
    jc = japi.cache_init(jcfg, B, P + steps + 1, jnp.float32)
    tc = api.cache_init(cfg, B, P + steps + 1, torch.float32, "cpu")
    # jitted: one compiled program costs less here than eager dispatch
    jprefill = jax.jit(lambda p, t, c, m: japi.prefill(
        p, jcfg, t, c, mor=m, mor_mode=mode))
    jdecode = jax.jit(lambda p, t, c, m: japi.decode_step(
        p, jcfg, t, c, mor=m, mor_mode=mode))
    want, jc = jprefill(jp, jnp.asarray(toks[:, :P]), jc, jmor)
    got = api.prefill(tp, cfg, _t(toks[:, :P]), tc, mor=tmor,
                      mor_mode=mode)
    _close(got, want)
    for t in range(steps):
        tk = toks[:, P + t:P + t + 1]
        want, jc = jdecode(jp, jnp.asarray(tk), jc, jmor)
        got = api.decode_step(tp, cfg, _t(tk), tc, mor=tmor, mor_mode=mode)
        _close(got, want)
    assert int(tc["pos"]) == int(jc["pos"]) == P + steps
    for key, leaf in tc["layers"].items():
        if key == "pos" and cfg.mla:        # the port's own tags
            assert bool(torch.all(leaf[:, :, :P + steps] >= 0))
            continue
        want = _stacked(jc, key)
        if key == "pos":
            np.testing.assert_array_equal(leaf.numpy(), want)
        else:
            _close(leaf, want)


# -- the steps -----------------------------------------------------------------

@pytest.mark.parametrize("arch,P", [("rwkv6-3b", 11), ("zamba2-7b", 11),
                                    ("mixtral-8x7b", 21),
                                    ("granite-3-2b", 11)])
def test_make_prefill_step_routes_as_jax(monkeypatch, arch, P):
    """The recurrent families and a prompt past mixtral's window of 16
    go through fixed-shape chunk dispatches (ceil(P / chunk) of them,
    never the batched prefill); granite's prompt through one batched
    prefill.  The next tokens equal JAX's ``make_prefill_step``'s on its
    slot pool, and the caches' positions."""
    jcfg, jparams, cfg, params = _model(arch)
    calls = {"prefill": 0, "prefill_chunk": 0}
    mod = importlib.import_module(get_model(cfg).prefill_chunk.__module__)
    for name in calls:
        if hasattr(mod, name):
            def spy(*a, _orig=getattr(mod, name), _name=name, **k):
                calls[_name] += 1
                return _orig(*a, **k)
            monkeypatch.setattr(mod, name, spy)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, P)
                                             ).astype(np.int32)
    jnxt, jc = jsteps.make_prefill_step(jcfg)(
        jparams, jkv.init(jcfg, 2, 32), jnp.asarray(toks))
    cache = tkv.init(cfg, 2, 32, device="cpu")
    nxt, cache = tsteps.make_prefill_step(cfg)(params, cache, _t(toks))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jc["pos"]))
    chunks = -(-P // cfg.serve_chunk)
    if arch == "granite-3-2b":
        assert calls == {"prefill": 1, "prefill_chunk": 0}
    else:
        assert calls == {"prefill": 0, "prefill_chunk": chunks}


MIXED = [(3, 4), (9, 3), (6, 4)]               # (prompt length, new tokens)


@pytest.mark.parametrize("arch,mode", [("granite-3-2b", "kernel"),
                                       ("granite-3-2b", "tiled"),
                                       ("mixtral-8x7b", "kernel")])
def test_generate_matches_jax(calibrated, arch, mode):
    """The static-batch ``generate`` on a mixed trace left-padded with
    token 0 to its longest prompt (the padding attended): greedy tokens
    equal, and the per-layer skip fractions of the timed decode steps
    (mixtral: (L, E), JAX's per_expert_*)."""
    jcfg, jp, jmor, cfg, tp, tmor = calibrated(arch)
    rng = np.random.default_rng(5)
    prompts = tserve.left_pad([rng.integers(1, cfg.vocab_size, p)
                               for p, _ in MIXED], len(MIXED), 9)
    assert prompts[0, :6].tolist() == [0] * 6
    gen = max(g for _, g in MIXED)
    want, wst = jserve.generate(jcfg, jget_model(jcfg), jp,
                                jnp.asarray(prompts), gen, mor=jmor,
                                mor_mode=mode)
    got, gst = tserve.generate(cfg, get_model(cfg), tp, _t(prompts), gen,
                               mor=tmor, mor_mode=mode)
    np.testing.assert_array_equal(got, want)
    names = {"per_layer_": "per_layer_", "per_expert_": "per_layer_moe_"}
    fracs = {k: v for k, v in wst.items() if k.startswith("per_")}
    assert fracs
    for key, val in fracs.items():
        tkey = key.replace(*next((a, b) for a, b in names.items()
                                 if key.startswith(a)))
        np.testing.assert_allclose(gst[tkey], val, rtol=1e-12, err_msg=key)
    assert {k for k in gst if k.startswith("per_")} == {
        k.replace("per_expert_", "per_layer_moe_") for k in fracs}


def test_static_decode_loop_reads_nothing_back(calibrated, monkeypatch):
    """``generate`` in kernel mode moves no tensor to the host before
    its last decode step has been enqueued: every read-back (the tokens
    and the stats, once each) comes after it."""
    _, _, _, cfg, tp, tmor = calibrated("granite-3-2b")
    reads, steps = [], [0]
    orig_step = tserve.make_decode_step

    def counted_step(*a, **k):
        step = orig_step(*a, **k)

        def wrapped(*sa, **sk):
            steps[0] += 1
            return step(*sa, **sk)
        return wrapped
    monkeypatch.setattr(tserve, "make_decode_step", counted_step)
    for name in ("item", "tolist", "cpu", "numpy"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            reads.append((_name, steps[0]))
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    prompts = torch.randint(0, cfg.vocab_size, (2, 7),
                            generator=torch.Generator().manual_seed(0))
    toks, _ = tserve.generate(cfg, get_model(cfg), tp, prompts, 5, mor=tmor,
                              mor_mode="kernel")
    monkeypatch.undo()
    assert toks.shape == (2, 5) and steps[0] == 5
    assert reads and all(s == 5 for _, s in reads), reads


def test_static_batch_runs_generate_per_group(calibrated):
    """``static_batch`` (the CLI's ``--baseline``) is ``generate`` on
    each group of ``n_slots`` requests left-padded to the trace's
    longest prompt: a request's tokens are the prefill's token, then the
    decode steps', cut to its length (a short last group padded with
    empty rows)."""
    _, _, _, cfg, tp, _ = calibrated("granite-3-2b")
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(1, cfg.vocab_size, p), g)
            for p, g in ((5, 4), (8, 2), (3, 3))]
    tok_s, tokens, wall = tserve.static_batch(cfg, tp, reqs, n_slots=2,
                                              timed_passes=1)
    assert tok_s == pytest.approx(sum(len(p) + g for p, g in reqs) / wall)
    for lo, group in ((0, reqs[:2]), (2, reqs[2:])):
        prompts = tserve.left_pad([p for p, _ in group], 2, 8)
        toks, st = tserve.generate(cfg, get_model(cfg), tp, _t(prompts),
                                   max(g for _, g in group))
        full = np.concatenate([st["first_token"][:, None], toks], 1)
        for j, (_, g) in enumerate(group):
            assert tokens[lo + j] == full[j, :g].tolist()


def test_make_prefill_matches_jax(calibrated):
    """``make_prefill``: the greedy next token after the teacher-forced
    forward, in kernel mode."""
    jcfg, jp, jmor, cfg, tp, tmor = calibrated("granite-3-2b")
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 9)
                                             ).astype(np.int32)
    want = jax.jit(jsteps.make_prefill(jcfg, mor=jmor, mor_mode="kernel"))(
        jp, {"tokens": jnp.asarray(toks)})
    got = tsteps.make_prefill(cfg, mor=tmor, mor_mode="kernel")(
        tp, {"tokens": _t(toks)})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_make_serve_step_continues_generate(calibrated):
    """``make_serve_step`` over ``cache_init``'s cache after the batched
    prefill gives ``generate``'s greedy tokens (dense mode, float32:
    the same model on the shared-position cache)."""
    _, _, _, cfg, tp, _ = calibrated("granite-3-2b")
    api = get_model(cfg)
    prompts = torch.randint(0, cfg.vocab_size, (2, 7),
                            generator=torch.Generator().manual_seed(1))
    want, _ = tserve.generate(cfg, api, tp, prompts, 4)
    cache = api.cache_init(cfg, 2, 12, torch.float32, "cpu")
    nxt = torch.argmax(api.prefill(tp, cfg, prompts, cache), -1)
    step = tsteps.make_serve_step(cfg)
    got = []
    for _ in range(4):
        nxt, cache = step(tp, cache, nxt[:, None])
        got.append(nxt)
    np.testing.assert_array_equal(torch.stack(got, 1).numpy(), want)


# -- masked_ffn ------------------------------------------------------------------

def _ffn_case():
    """A relufied GLU at T 16, K 64, N 256 with a MoRLayer whose second
    tile is statically dead (no proxy, an intercept far below zero) and
    every column of the first its own proxy."""
    rng = np.random.default_rng(6)
    T, K, N = 16, 64, 256
    x = rng.normal(size=(T, K)).astype(np.float32)
    w = {k: (rng.normal(size=s) * s[0] ** -0.5).astype(np.float32)
         for k, s in (("w_gate", (K, N)), ("w_up", (K, N)),
                      ("w_down", (N, K)))}
    layer = {k: np.asarray(v) for k, v in
             jpred.make_identity_layer(N).items()}
    dead = np.arange(N) >= 128
    layer.update(m=rng.uniform(0.01, 0.05, N).astype(np.float32),
                 b=rng.normal(size=N).astype(np.float32),
                 bn_bias=np.where(dead, -1e3, 0.0).astype(np.float32),
                 enable=dead | (rng.random(N) < 0.5),
                 is_proxy=~dead,
                 proxy_slot=np.where(dead, -1, np.arange(N)).astype(np.int32))
    return x, w, layer


@pytest.mark.parametrize("mode", ["dense", "exact", "tiled", "kernel"])
def test_masked_ffn_matches_jax(mode):
    """``mor_relu_matmul`` (with a residual) and ``mor_ffn_apply`` (GLU)
    over a bare MoRLayer: outputs within 2e-4, the skip stats equal."""
    x, w, layer = _ffn_case()
    jl = {k: jnp.asarray(v) for k, v in layer.items()}
    tl = {k: _t(v) for k, v in layer.items()}
    res = np.random.default_rng(7).normal(size=(16, 256)).astype(np.float32)
    want, wst = jax.jit(lambda x, w, m, r: jffn.mor_relu_matmul(
        x, w, m, mode=mode, residual=r))(jnp.asarray(x),
                                         jnp.asarray(w["w_up"]), jl,
                                         jnp.asarray(res))
    got, gst = tffn.mor_relu_matmul(_t(x), _t(w["w_up"]), tl, mode=mode,
                                    residual=_t(res))
    _close(got, want)
    want2, wst2 = jax.jit(lambda x, u, d, m, g: jffn.mor_ffn_apply(
        x, u, d, m, activation="relu", mode=mode, w_gate=g))(
        jnp.asarray(x), jnp.asarray(w["w_up"]), jnp.asarray(w["w_down"]),
        jl, jnp.asarray(w["w_gate"]))
    got2, gst2 = tffn.mor_ffn_apply(
        _t(x), _t(w["w_up"]), _t(w["w_down"]), tl, activation="relu",
        mode=mode, w_gate=_t(w["w_gate"]))
    _close(got2, want2)
    for ws, gs in ((wst, gst), (wst2, gst2)):
        for key in ("frac_computed", "frac_tiles_live",
                    "frac_tiles_computed", "n_tiles", "tiles_skipped"):
            if key in ws:
                np.testing.assert_allclose(np.asarray(gs[key], np.float64),
                                           np.asarray(ws[key], np.float64),
                                           rtol=1e-6, err_msg=(mode, key))
    if mode != "dense":
        assert float(gst2["frac_tiles_computed"]) < 1.0


def test_make_identity_layer_matches_jax():
    want = jpred.make_identity_layer(300)
    got = tpred.make_identity_layer(300)
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == {np.dtype("float32"): torch.float32,
                                  np.dtype("int32"): torch.int32,
                                  np.dtype("bool"): torch.bool}[
            np.asarray(val).dtype], key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(val))
    import repro_torch.core as core
    assert core.make_identity_layer is tpred.make_identity_layer
    assert core.mor_ffn_apply is tffn.mor_ffn_apply


# -- the serve CLI -----------------------------------------------------------------

def test_serve_cli_static_baseline():
    """``--baseline`` times the static batch on the same trace beside
    the engine (kernel mode, reduced granite, on the CPU)."""
    rep = tserve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--requests", "3", "--prompt-min", "3",
                       "--prompt-max", "9", "--gen-len", "3", "--mor",
                       "kernel", "--baseline", "--layout", "slotted"])
    assert rep["static_batch_tokens_per_s"] > 0
    assert rep["engine_speedup_vs_static"] == pytest.approx(
        rep["tokens_per_s"] / rep["static_batch_tokens_per_s"])
    assert rep["requests_finished"] == 3


def test_serve_cli_ported_flags(tmp_path):
    """--seed, --prompt-len, --gen-min, --chunk, --calib-steps,
    --calibrate-capacity and --dims with the JAX CLI's meanings."""
    out = tmp_path / "rep.json"
    rep = tserve.main(["--reduced", "--device", "cpu", "--batch", "2",
                       "--requests", "3", "--prompt-len", "5",
                       "--gen-min", "2", "--gen-len", "4", "--chunk", "4",
                       "--calib-steps", "1", "--calibrate-capacity", "0.5",
                       "--dims", "128,256,3", "--seed", "2", "--mor",
                       "tiled", "--out-json", str(out)])
    trace = tserve.make_trace(reduce_config(get_config("granite-3-2b")), 3,
                              5, 5, 2, 4, 2)
    assert rep["prefill_tokens"] == sum(len(p) for p, _ in trace) == 15
    assert rep["decode_tokens"] == sum(g for _, g in trace) - 3
    assert len(rep["per_layer_frac_tiles_live"]) == 3
    assert set(rep["per_layer_capacity"]) == {"mor_stats"}
    assert len(rep["per_layer_capacity"]["mor_stats"]) == 3
    assert 0.0 <= rep["calibrated_token_agreement"] <= 1.0
    assert out.exists()
