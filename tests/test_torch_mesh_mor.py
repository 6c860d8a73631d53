"""MoR-active FFNs under tensor parallelism on the ``(data, model)``
mesh: each rank runs its own d_ff columns of an FFN whose plan is
active (``executor.MoRExecutionPlan.for_rank``), and its tile masks,
kept tiles and ``gather_matmul`` counters are one device's column
block, bit for bit.

The configs are reduced and float32, with ``d_ff`` 512 (two 128-column
tiles a rank at model 2) on both sides: granite-3-2b, hubert-xlarge's
ReLU FFN, zamba2-7b's shared MLP and rwkv6-3b's channel mix; granite
also at ``d_ff`` 384, which does not divide into whole tiles over model
2, so its FFN stays gathered whole.  Each is the port's own calibration
(``calibrate_lm`` / ``calibrate_hybrid``) with every odd tile
statically dead, and on granite's first layer one planted tile (tile 2,
on rank 1 at model 2) whose members all read ONE proxy held on rank 0
(the binary rookie forced to "zero"), that proxy's bias set so that its
ReLU input is negative on some 8-row tiles of the test batch and
positive on others: the tile's liveness then comes from the proxy
exchange alone.  The budgets: ``cap_live`` 0.34 (11 of granite's 32
tiles, mid-row), ``cfg.mor.capacity`` 0.75 beside it, 0.4 alone, and a
draft plan under ``draft_cap`` 0.34.

The port's side runs on 4 gloo rank processes spawned once for the
module: (1, 2) over ranks 0-1 and over ranks 2-3 side by side, (2, 2)
over all four, and (2, 1) over each pair.  The reference's
single-device tiled forwards of granite, hubert, zamba2 and rwkv6 run
in ONE JAX subprocess (``tests/mesh_mor_reference.py``) beside them,
and each config's tiled outputs on (1, 2) and (2, 2) are held to its.
Every other comparison is against the port's own single-device run,
which the port's other tests hold to the reference.

The batch is 4 x 16 tokens: 32 rows a data rank on (2, 2), whole 8-row
tiles, as the bit-equal checks need (one device's tile mixes two data
ranks' rows where a data rank's rows do not fill whole tiles: a limit
that ``test_data_ranks_rows_that_do_not_fill_tiles_differ`` pins).

Tolerances: masks, kept tiles, counters, tile counts, collective counts
and bytes and greedy tokens equal; float32 outputs within 1e-5 of
their largest magnitude (the tensor-parallel sums' order).
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(__file__))
from mesh_reference import _save  # noqa: E402
from test_torch_mesh_pod import _tree  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.distributed import collectives as co  # noqa: E402
from repro_torch.distributed import sharding_rules as sr  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import (HostMesh, PageGroup,  # noqa: E402
                                     make_host_mesh, run_ranks)
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.transformer import full_logits  # noqa: E402
from repro_torch.tree import paths  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (arch, d_ff, MoR group)
ARCHS = {"granite": ("granite-3-2b", 512, "layers"),
         "granite384": ("granite-3-2b", 384, "layers"),
         "hubert": ("hubert-xlarge", 512, "layers"),
         "zamba2": ("zamba2-7b", 512, "shared"),
         "rwkv6": ("rwkv6-3b", 512, "layers")}
B, S = 4, 16
CAP = 0.34
PLANTED_TILE = 2
# budget -> (cfg.mor.capacity, cap_live, draft_cap)
BUDGETS = {None: (1.0, None, None), "cap": (1.0, CAP, None),
           "cap75": (0.75, CAP, None), "frac40": (0.4, None, None),
           "draft": (1.0, None, CAP)}
MODES = ("exact", "tiled", "kernel", "shadow", "scored")
# the FFN leaves an active plan splits, by arch
_FFN = {"granite": {"mlp/w_gate", "mlp/w_up", "mlp/w_down"},
        "granite384": {"mlp/w_gate", "mlp/w_up", "mlp/w_down"},
        "hubert": {"mlp/w_up", "mlp/w_down"},
        "zamba2": {"shared/mlp/w_gate", "shared/mlp/w_up",
                   "shared/mlp/w_down"},
        "rwkv6": {"cm/w_up", "cm/w_down"}}
LAYOUT = {"rwkv6": "fsdp_tp"}            # the others' own: "contract_tp"
# the configs whose tiled forwards the reference runs (d_ff 512)
REF_NAMES = ("granite", "hubert", "zamba2", "rwkv6")

# (key, name, mesh, layout, sequence parallel, mode, budget): the
# forwards; "pair" is (1, 2) on ranks 0-1 (first list) or 2-3 (second)
PAIR_CASES = (
    [("modes", "granite", "1x2", None, False, m, None) for m in MODES]
    + [("modes", "granite", "1x2", None, False, "kernel", "draft"),
       ("modes", "granite", "1x2", None, False, "kernel", "cap"),
       ("modes", "granite", "1x2", None, True, "tiled", "cap")],
    [("arch", n, "1x2", None, False, m, None)
     for n in ("hubert", "zamba2", "rwkv6") for m in ("tiled", "kernel")]
    + [("arch", "granite384", "1x2", None, False, "kernel", None),
       ("arch", "zamba2", "1x2", None, False, "kernel", "cap")])
MESH22_CASES = (
    [("22", "granite", "2x2", lay, sp, m, None)
     for lay in ("fsdp_tp", "contract_tp") for sp in (False, True)
     for m in ("tiled", "kernel")]
    + [("22", "granite", "2x2", None, False, "kernel", b)
       for b in ("cap", "cap75", "frac40")]
    + [("22", "granite", "2x2", None, True, "tiled", "cap")]
    + [("22", n, "2x2", None, False, m, None)
       for n in ("hubert", "zamba2", "rwkv6") for m in ("tiled", "kernel")])
DATA_CASES = (
    [("21", "granite", "2x1", None, False, m, "cap")
     for m in ("tiled", "kernel")],
    [("21", "granite", "2x1", None, False, "kernel", "frac40")])
CASES = PAIR_CASES[0] + PAIR_CASES[1] + MESH22_CASES + DATA_CASES[0] \
    + DATA_CASES[1]


def _cfg(name, budget=None):
    arch, d_ff, _ = ARCHS[name]
    cfg = reduce_config(get_config(arch)).replace(d_ff=d_ff)
    return cfg.replace(mor=dataclasses.replace(
        cfg.mor, capacity=BUDGETS[budget][0]))


def _dead_odd_tiles(layer):
    """Every odd 128-column tile statically dead: no proxy, the binary
    rookie enabled, an intercept far below zero."""
    n = layer["m"].shape[-1]
    dead = (torch.arange(n) // 128) % 2 == 1
    return dict(layer, bn_bias=torch.where(dead, -1e3, layer["bn_bias"]),
                enable=layer["enable"] | dead,
                is_proxy=layer["is_proxy"] & ~dead,
                proxy_slot=torch.where(dead, -1, layer["proxy_slot"]))


def _plant(layer, pre):
    """Layer 0's tile ``PLANTED_TILE`` read from ONE proxy in tile 0: its
    members' binary rookie says "zero" (m 0, b -1e3, enabled), so the
    tile lives where that proxy's ReLU input does; the proxy's bias puts
    the input (``pre``, its (T,) pre-activations) above zero on half of
    the batch's 8-row tiles."""
    out = {k: v.clone() for k, v in layer.items()}
    p = int(torch.nonzero(layer["is_proxy"][0])[0])
    cols = slice(128 * PLANTED_TILE, 128 * (PLANTED_TILE + 1))
    out["m"][0, cols] = 0.0
    out["b"][0, cols] = -1e3
    out["enable"][0, cols] = True
    out["is_proxy"][0, cols] = False
    out["proxy_slot"][0, cols] = p
    tops = np.sort((pre * layer["bn_scale"][0, p]).reshape(-1, 8)
                   .amax(1).numpy())
    h = len(tops) // 2
    out["bn_bias"][0, p] = -float(tops[h - 1] + tops[h]) / 2
    return out


def _batch(cfg, b=B, s=S, seed=5):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"frames": torch.from_numpy(rng.normal(
            size=(b, s, cfg.d_model)).astype(np.float32))}
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32))}


def _calibrated(name):
    """-> (cfg, permuted params, the MoR group's modified tables)."""
    from repro_torch.core.deploy import calibrate_hybrid, calibrate_lm
    from repro_torch.launch.serve import calib_batches
    cfg = _cfg(name)
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    cal = calibrate_hybrid if cfg.family == "hybrid" else calibrate_lm
    params, mor, _ = cal(params, cfg, api.forward,
                         calib_batches(cfg, 4, "cpu"), 2)
    group = ARCHS[name][2]
    layer = _dead_odd_tiles(mor[group])
    if name == "granite":
        with torch.no_grad():
            taps = api.forward(params, cfg, _batch(cfg),
                               with_taps=True)[1]["taps"]
        p = int(torch.nonzero(layer["is_proxy"][0])[0])
        layer = _plant(layer, taps["p_base"][0][:, p])
    return cfg, params, layer


def _plans(name, layer, mode, budget):
    from repro_torch.core.deploy import attach_plans
    _, cap, draft = BUDGETS[budget]
    group = ARCHS[name][2]
    caps = None if cap is None else {group: cap}
    plans = attach_plans({group: layer}, _cfg(name, budget), mode,
                         capacities=caps, draft_cap=draft)
    if budget == "draft":
        from repro_torch.core.executor import map_plans
        plans = map_plans(plans, lambda p: p.as_draft())
    return plans


class _Predictions:
    """Every MoR plan's prediction while active: its neuron mask (or
    None), tile mask, kept tiles and ``gather_matmul``'s counters."""

    def __enter__(self):
        from repro_torch.core.executor import MoRExecutionPlan
        self._orig = orig = MoRExecutionPlan.predict
        self.seen = seen = []

        def predict(plan, *a, **k):
            p = orig(plan, *a, **k)
            seen.append(p)
            return p
        MoRExecutionPlan.predict = predict
        return self

    def __exit__(self, *exc):
        from repro_torch.core.executor import MoRExecutionPlan
        MoRExecutionPlan.predict = self._orig

        def arr(t):
            return None if t is None else t.numpy().copy()
        self.seen = [(arr(p.computed), arr(p.tiles), arr(p.kept),
                      None if p.kernel_counts is None else
                      tuple(int(c) for c in p.kernel_counts))
                     for p in self.seen]


def _np_stats(aux):
    st = aux.get("mor_stats") or {}
    return {k: v.numpy().copy() for k, v in st.items()}


def _forward(name, data, mesh, layout, sp, mode, budget, batch=None,
             fault=False):
    """One forward of ``name`` on one device and on ``mesh`` -> the
    case's record."""
    cfg0, params, layer = data[name]
    cfg = _cfg(name, budget)
    layout = layout or LAYOUT.get(name, "contract_tp")
    plans = _plans(name, layer, mode, budget)
    api = get_model(cfg)
    batch = batch or _batch(cfg)
    with torch.no_grad(), _Predictions() as one:
        out1, aux1 = api.forward(params, cfg, batch, mor=plans,
                                 mor_mode=mode)
    specs = steps.mesh_specs(cfg, mesh, layout)
    loc = sr.shard_tree(params, specs, mesh)
    rows = {k: steps.local_rows(v, mesh) for k, v in batch.items()}
    sr.model_gathers.clear()
    co.reset_counts()
    named, orig, count = {}, co.all_gather, co._count

    def tally(name, kind, x, group=None, n=0):
        named[name] = named.get(name, 0) + (n or x.numel() * x.element_size())
        count(name, kind, x, group, n)
    co._count = tally
    if fault:
        # the planted fault: every rank reads the proxy block from the
        # wrong rank (the gathered blocks in reverse rank order)
        def wrong(x, dim, group, name):
            out = orig(x, dim, group, name)
            if name != "mor_proxy":
                return out
            return torch.cat(out.chunk(group.size, dim)[::-1], dim)
        co.all_gather = wrong
    try:
        with torch.no_grad(), _Predictions() as split, \
                sr.activation_context(mesh, sp, specs=specs):
            out, aux = api.forward(loc, cfg, rows, mor=plans, mor_mode=mode)
            if cfg.vocab_size:
                out = full_logits(out, cfg)
    finally:
        co.all_gather, co._count = orig, count
    d, m = mesh.index("data"), mesh.index("model")
    n = out.shape[0]
    return {"one": one.seen, "split": split.seen,
            "out1": out1[d * n:(d + 1) * n].numpy(), "out": out.numpy(),
            "stats1": _np_stats(aux1), "stats": _np_stats(aux),
            "gathered": set(sr.model_gathers), "counts": dict(co.counts),
            "nbytes": named, "coords": (d, m),
            "shape": tuple(mesh.shape[a] for a in ("data", "model"))}


def _decode(name, data, mesh, mode, P=6, N=5):
    """Greedy tokens of ``make_serve_step`` (one step a prompt token) on
    one device and on ``mesh`` under the config's own layout, with the
    predictions of the mesh's steps and one device's."""
    cfg, params, layer = data[name]
    plans = _plans(name, layer, mode, None)
    g = torch.Generator().manual_seed(3)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g)
    layout = LAYOUT.get(name, "contract_tp")
    out = {}
    for key, msh in (("one", None), ("mesh", mesh)):
        p = params if msh is None else sr.shard_tree(
            params, steps.mesh_specs(cfg, msh, layout), msh)
        cache = steps.init_cache(cfg, B, P + N, "cpu", mesh=msh)
        serve = steps.make_serve_step(cfg, mor=plans, mor_mode=mode,
                                      mesh=msh, param_layout=layout)
        with torch.no_grad(), _Predictions() as seen:
            for t in range(P):
                nxt, cache = serve(p, cache, prompts[:, t:t + 1])
            toks = [nxt]
            for _ in range(N - 1):
                nxt, cache = serve(p, cache, nxt[:, None])
                toks.append(nxt)
        out[key] = (torch.stack(toks, 1).numpy(), seen.seen)
    return out


def _prefill(data, mesh):
    """Greedy next tokens of ``make_prefill`` (granite, kernel mode under
    ``cap_live``, sequence parallelism on) on one device and on
    ``mesh``."""
    cfg, params, layer = data["granite"]
    plans = _plans("granite", layer, "kernel", "cap")
    batch = _batch(cfg)
    loc = sr.shard_tree(params, steps.mesh_specs(cfg, mesh, "contract_tp"),
                        mesh)
    with torch.no_grad():
        one = steps.make_prefill(cfg, mor=plans, mor_mode="kernel")(
            params, batch)
        got = steps.make_prefill(cfg, mor=plans, mor_mode="kernel",
                                 mesh=mesh, sequence_parallel=True,
                                 param_layout="contract_tp")(loc, batch)
    return one.numpy(), got.numpy()


def _pair_mesh(mp, pairs):
    """The (2 / mp, mp) mesh over this rank's pair of world ranks (0-1
    or 2-3), laid out as ``make_host_mesh`` lays out a world of two."""
    me = dist.get_rank()
    lo = me // 2 * 2
    r, pg, ranks = me - lo, pairs[me // 2], (lo, lo + 1)
    cpu = torch.device("cpu")

    def grp(on):
        return (PageGroup(r, 2, pg, cpu, "gloo", ranks) if on
                else PageGroup(0, 1, None, cpu, "gloo", (me,)))
    return HostMesh(("data", "model"), {"data": 2 // mp, "model": mp},
                    rank=r, coords={"data": r if mp == 1 else 0,
                                    "model": r if mp == 2 else 0},
                    groups={"model": grp(mp == 2), "data": grp(mp == 1),
                            "world": grp(True)},
                    device=cpu, backend="gloo")


def _rank(group, src):
    torch.manual_seed(0)
    with np.load(src) as f:
        flat = {k: f[k] for k in f.files}
    data = {}
    for name in ARCHS:
        pre = name + "/"
        sub = {k[len(pre):]: v for k, v in flat.items() if k.startswith(pre)}
        tree = _tree(sub)
        data[name] = (_cfg(name), tree["params"], tree["mor"])
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    meshes = {"1x2": _pair_mesh(2, pairs), "2x1": _pair_mesh(1, pairs),
              "2x2": make_host_mesh(2, device="cpu")}
    me = dist.get_rank()
    out = {"rank": me}
    for case in PAIR_CASES[me // 2] + MESH22_CASES + DATA_CASES[me // 2]:
        out[case] = _forward(*case[1:2], data, meshes[case[2]], *case[3:])
    out["prefill"] = _prefill(data, meshes["2x2"])
    if me < 2:
        out["fault"] = _forward("granite", data, meshes["1x2"], None, False,
                                "kernel", None, fault=True)
        out["decode"] = _decode("granite", data, meshes["1x2"], "kernel")
        # the rows of a data rank that do not fill whole 8-row tiles
        cfg = data["granite"][0]
        out["ragged"] = _forward("granite", data, meshes["2x1"], None,
                                 False, "kernel", "cap",
                                 batch=_batch(cfg, 4, 3))
    else:
        out["decode"] = _decode("zamba2", data, meshes["1x2"], "kernel")
    return out


@pytest.fixture(scope="module")
def run():
    """-> (the reference's granite logits, the main process's data, the
    4 ranks' results): the calibrations here, then the reference's
    process and the ranks side by side."""
    data = {name: _calibrated(name) for name in ARCHS}
    with tempfile.TemporaryDirectory() as tmp:
        flat = {}
        for name, (_, params, layer) in data.items():
            for k, v in paths(params).items():
                flat[f"{name}/params/{k}"] = v.numpy()
            for k, v in layer.items():
                flat[f"{name}/mor/{k}"] = v.numpy()
        src = os.path.join(tmp, "in.npz")
        _save(src, flat)
        ref_in = {"names": np.array(REF_NAMES), "mode": np.str_("tiled")}
        for name in REF_NAMES:
            cfg, params, layer = data[name]
            arch, d_ff, group = ARCHS[name]
            ref_in.update({f"{name}/params/{k}": v.numpy()
                           for k, v in paths(params).items()})
            ref_in.update({f"{name}/mor/{group}/{k}": v.numpy()
                           for k, v in layer.items()})
            ref_in.update({f"{name}/batch/{k}": v.numpy()
                           for k, v in _batch(cfg).items()})
            ref_in.update({f"{name}/arch": np.str_(arch),
                           f"{name}/d_ff": np.int64(d_ff)})
        ref_src, ref_out = (os.path.join(tmp, f) for f in
                            ("ref_in.npz", "ref_out.npz"))
        _save(ref_src, ref_in)
        log = os.path.join(tmp, "ref.log")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, "tests",
                                              "mesh_mor_reference.py"),
                 ref_src, ref_out], env=env, stdout=f,
                stderr=subprocess.STDOUT)
        try:
            ranks = run_ranks(_rank, 4, "cpu", src)
            rc = proc.wait(timeout=600)
            with open(log) as f:
                text = f.read()
            assert rc == 0 and "MESH_MOR_REFERENCE_OK" in text, text[-3000:]
            with np.load(ref_out) as f:
                ref = {name: f[name] for name in REF_NAMES}
            yield ref, data, ranks
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _block(one, d, m, D, M):
    """Rank (d, m)'s block of one device's (rows, columns) mask."""
    r, c = one.shape[0] // D, one.shape[1] // M
    return one[d * r:(d + 1) * r, m * c:(m + 1) * c]


def _check_masks(rec, name):
    """Each rank's neuron masks, tile masks and kept tiles are its block
    of one device's (its rows' block where the FFN is gathered whole);
    its counters count its own block."""
    D, M = rec["shape"]
    if name == "granite384":
        M = 1
    d, m = rec["coords"]
    m = m if M > 1 else 0
    assert len(rec["split"]) == len(rec["one"]) > 0
    for (c, t, k, kc), (c1, t1, k1, kc1) in zip(rec["split"], rec["one"]):
        np.testing.assert_array_equal(t, _block(t1, d, m, D, M))
        np.testing.assert_array_equal(k, _block(k1, d, m, D, M))
        if c is not None:
            np.testing.assert_array_equal(c, _block(c1, d, m, D, M))
        if kc is not None:
            assert kc == (int(t.sum()), int(k.sum())), (kc, t, k)


def _summed_counters(recs):
    """One device's counters of each FFN call and the sums of the case's
    ranks' records ``recs``."""
    one = [kc for _, _, _, kc in recs[0]["one"]]
    tot = [tuple(sum(r["split"][i][3][j] for r in recs) for j in (0, 1))
           for i in range(len(one))]
    return one, tot


def _close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def _members(ranks, key):
    return [r[key] for r in ranks if key in r]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x) for x in c[1:]))
def test_masks_kept_and_counters_equal_one_device(run, case):
    """Every case: each rank's tile masks, kept tiles (and in exact /
    shadow / scored mode its neuron masks) are its block of one
    device's; summed over the mesh's ranks, ``gather_matmul``'s live and
    computed counters are one device's; the outputs are one device's
    within 1e-5 and their greedy tokens equal; the layer-stacked stats
    (summed over ``model`` in the plan) are one device's where the mesh
    has one data rank."""
    _, _, ranks = run
    name, mode = case[1], case[5]
    recs = _members(ranks, case)
    assert len(recs) == (4 if case[2] == "2x2" else 2)
    for rec in recs:
        _check_masks(rec, name)
        _close(rec["out"], rec["out1"])
        if get_config(ARCHS[name][0]).vocab_size:
            np.testing.assert_array_equal(rec["out"].argmax(-1),
                                          rec["out1"].argmax(-1))
        if rec["shape"][0] == 1:
            for k, v in rec["stats1"].items():
                if k == "shadow_err":
                    np.testing.assert_allclose(rec["stats"][k], v,
                                               rtol=1e-5, atol=1e-7)
                else:
                    np.testing.assert_array_equal(rec["stats"][k], v, k)
    if mode == "kernel" and name == "granite384":
        for rec in recs:                   # every rank the whole FFN
            assert [s[3] for s in rec["split"]] == \
                [o[3] for o in rec["one"]]
    elif mode == "kernel":
        one, tot = _summed_counters(recs)
        assert one == tot, (one, tot)


def test_tiles_depend_on_the_proxy_exchange(run):
    """The planted tile (layer 0, tile 2: rank 1's at model 2) is dead in
    some 8-row tiles of the batch and live in others, one device's and
    rank 1's alike; each budget bites mid-row; every odd tile is dead;
    and the planted fault (the proxy block read from the wrong rank)
    changes the masks."""
    _, _, ranks = run
    key = PAIR_CASES[0][2]                   # granite kernel on (1, 2)
    t1 = ranks[0][key]["one"][0][1]
    assert t1[:, PLANTED_TILE].any() and not t1[:, PLANTED_TILE].all()
    assert not t1[:, 1::2].any() and t1[:, 0::2].any()
    np.testing.assert_array_equal(ranks[1][key]["split"][0][1][:, 0],
                                  t1[:, PLANTED_TILE])
    for case in [c for c in CASES if c[6] in ("cap", "frac40", "draft")]:
        one = ranks[0 if case in ranks[0] else 2][case]["one"]
        assert any((k != t).any() for _, t, k, _ in one), case
        if case[6] != "frac40":
            assert any(k[i].any() and (k[i] != t[i]).any()
                       for _, t, k, _ in one for i in range(len(t))), case
    bad = ranks[1]["fault"]
    assert any((s[1] != _block(o[1], 0, 1, 1, 2)).any()
               for s, o in zip(bad["split"], bad["one"]))


def test_exchanges_counted_with_their_bytes(run):
    """Granite's kernel forward on (1, 2) and (2, 2): one "mor_proxy"
    all-gather a layer of each model rank's (T, min(N / MP, P)) float32
    block (P = the layer's largest ``proxy_slot`` + 1; on gloo the
    gathered buffer's bytes), one "mor_stats" all-reduce of two float64
    sums a layer, and no "mor_rows" without a budget; with ``cap_live``
    one "mor_rows" all-gather a layer of every rank's T / 8 int32 row
    counts, over the mesh's world; none of it where the FFN is gathered
    whole (``d_ff`` 384)."""
    _, data, ranks = run
    cfg, _, layer = data["granite"]
    L, n = cfg.n_layers, cfg.d_ff // 2
    P = (layer["proxy_slot"].amax(-1) + 1).tolist()
    for key, T, world in ((PAIR_CASES[0][2], B * S, 2),
                          (PAIR_CASES[0][-2], B * S, 2),
                          (MESH22_CASES[1], B * S // 2, 4),
                          (MESH22_CASES[8], B * S // 2, 4)):
        budget = key[6] is not None
        for rec in _members(ranks, key):
            c, nb = rec["counts"], rec["nbytes"]
            assert c["mor_proxy"] == c["mor_stats"] == L, c
            assert nb["mor_proxy"] == sum(2 * T * min(n, p) * 4 for p in P)
            assert nb["mor_stats"] == L * 2 * 8
            assert c.get("mor_rows", 0) == (L if budget else 0), c
            assert nb.get("mor_rows", 0) == (L * world * T // 8 * 4
                                              if budget else 0)
    whole = ranks[2][("arch", "granite384", "1x2", None, False, "kernel",
                      None)]
    assert not {"mor_proxy", "mor_rows", "mor_stats"} & set(whole["counts"])


def test_data_ranks_rows_that_do_not_fill_tiles_differ(run):
    """The limit of a data axis (queue C): granite on (2, 1) with 4 x 3
    tokens, 6 rows a data rank, which do not fill an 8-row tile, under
    ``cap_live``.  One device's first tile row holds data rank 0's six
    rows and data rank 1's first two, so no clip makes the kept tiles,
    expanded to rows, equal one device's.  Pinned: the first differing
    (layer, row, tile) is (0, 6, 2), data rank 1's first row, whose
    tile 2 one device keeps in its first tile row and data rank 1 drops
    from its own under the global budget."""
    _, _, ranks = run
    recs = [ranks[0]["ragged"], ranks[1]["ragged"]]
    first = None
    for l, o in enumerate(recs[0]["one"]):
        one = np.repeat(o[2], 8, 0)[:B * 3]
        mine = np.concatenate([np.repeat(r["split"][l][2], 8, 0)[:6]
                               for r in recs])
        diff = np.argwhere(one != mine)
        if len(diff) and first is None:
            first = (l, *map(int, diff[0]))
    assert first == (0, 6, 2), first


@pytest.mark.parametrize("name", list(ARCHS))
def test_model_gathers_name_no_split_ffn(run, name):
    """Where d_ff divides over model 2 in whole 128-column tiles, no
    MoR-active forward gathers its FFN's leaves over ``model``; granite
    at ``d_ff`` 384 gathers exactly them."""
    _, _, ranks = run
    for r in ranks:
        for key in [k for k in r if isinstance(k, tuple) and k[1] == name]:
            gathered = r[key]["gathered"]
            if name == "granite384":
                assert _FFN[name] <= gathered, (key, gathered)
            else:
                assert not gathered & _FFN[name], (key, gathered)


def _check_reference(run, name):
    """``name``'s tiled forwards without a budget on (1, 2) and (2, 2):
    each rank's outputs within 1e-5 of its rows of the reference's."""
    ref, _, ranks = run
    keys = [c for c in CASES if c[1] == name and c[5] == "tiled"
            and c[6] is None and c[2] in ("1x2", "2x2")]
    assert len(keys) == (5 if name == "granite" else 2), keys
    for key in keys:
        for rec in _members(ranks, key):
            d = rec["coords"][0]
            n = rec["out"].shape[0]
            _close(rec["out"], ref[name][d * n:(d + 1) * n])


def test_granite_tiled_logits_match_the_reference(run):
    """Granite's tiled forward on (1, 2) and on (2, 2) under both
    layouts and with sequence parallelism: its logits within 1e-5 of
    the reference's single-device tiled forward (the JAX subprocess),
    on the same calibrated tables."""
    _check_reference(run, "granite")


@pytest.mark.parametrize("name", REF_NAMES[1:])
def test_tiled_outputs_match_the_reference(run, name):
    """hubert's ReLU FFN, zamba2's shared MLP and rwkv6's channel mix
    split under the plan: each config's tiled forward on (1, 2) and on
    (2, 2), under its own layout, within 1e-5 of the reference's
    single-device tiled forward (logits, or hubert's hidden states), on
    the same calibrated tables."""
    _check_reference(run, name)


def test_static_decode_tokens_equal_one_device(run):
    """``make_serve_step`` in kernel mode on (1, 2): granite (ranks 0-1)
    and zamba2's shared MLP (ranks 2-3) split by column; the greedy
    tokens, tile masks, kept tiles and summed counters of every step
    are one device's."""
    _, _, ranks = run
    for pair in ((0, 1), (2, 3)):
        recs = [ranks[i]["decode"] for i in pair]
        for m, rec in enumerate(recs):
            (t1, one), (t, split) = rec["one"], rec["mesh"]
            np.testing.assert_array_equal(t, t1)
            assert len(split) == len(one) > 0
            for s, o in zip(split, one):
                np.testing.assert_array_equal(s[1], _block(o[1], 0, m, 1, 2))
                np.testing.assert_array_equal(s[2], _block(o[2], 0, m, 1, 2))
        for i, o in enumerate(recs[0]["one"][1]):
            assert tuple(sum(rec["mesh"][1][i][3][j] for rec in recs)
                         for j in (0, 1)) == o[3]


def test_make_prefill_tokens_equal_one_device(run):
    """``make_prefill`` on (2, 2) under "contract_tp" with sequence
    parallelism, granite in kernel mode under ``cap_live``: every rank
    returns one device's greedy next tokens for the whole batch."""
    _, _, ranks = run
    for r in ranks:
        one, got = r["prefill"]
        np.testing.assert_array_equal(got, one)


def test_capacity_clip_on_a_data_axis_is_one_devices(run):
    """Reduced granite on (2, 1), whose FFN runs whole on each data rank
    over its own 32 rows, with dead odd tiles and ``cap_live`` biting
    mid-row (tiled and kernel) or the static capacity 0.4 alone: each
    data rank keeps its rows' block of the tiles one device keeps over
    the global batch (the budget ranked over the global grid), and the
    data ranks' counters sum to one device's."""
    _, _, ranks = run
    for key in DATA_CASES[0] + DATA_CASES[1]:
        recs = _members(ranks, key)
        assert len(recs) == 2
        for rec in recs:
            _check_masks(rec, "granite")
        if key[5] == "kernel":
            one, tot = _summed_counters(recs)
            assert one == tot, (one, tot)
