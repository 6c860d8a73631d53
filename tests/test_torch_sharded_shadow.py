"""The page-sharded shadow step: ``Engine(layout="paged-sharded",
shadow_rate=0.25)`` on 2 gloo ranks (one spawn for the module) against
the JAX package's page-sharded engine (``tests/
sharded_shadow_reference.py``, ONE subprocess over 2 host devices, which
writes its calibrated weights first and its metrics blocks after), and
against the port's own single-device paged engine on a recurrent model.

Reduced granite-3-2b (odd 128-column tiles made statically dead, so
that the predictor skips) serves the reference's trace in tiled mode
(the in-step scored pass) and in kernel mode (the dense twin on the
view of each rank's shard).  Tokens and every integer lane of the
metrics block (dispatch and token counts, page edits, the shadow
dispatches, tiles, false skips and keeps) are equal; the fixed-point
lanes (rates and means: one rounding of ``frac * SCALE`` a dispatch)
within 1 / SCALE.  Shadow-on's tokens equal shadow-off's on every
rank, and the kernel twin issues one merge an attention layer a
sampled dispatch beside the primary step's.
"""
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import sharded_shadow_reference as R  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.distributed import collectives as co  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.obs import SCALE, Observability  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# held to the port's single-device paged engine: a state-only model (the
# twin's view of the sharded state pools) and an MLA + MoE one (the
# expert lanes)
SINGLE_HELD = ("rwkv6-3b", "deepseek-v2-236b")


def _nested(arrays, prefix):
    out = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return out


def _serve(cfg, params, mor, mode, reqs, group, **kw):
    """(shadow-off tokens, shadow-on tokens, the shadow run's metrics
    block read, its collectives, its dispatches)."""
    layout = {"layout": "paged-sharded", "group": group} if group else \
        {"layout": "paged"}
    kw = dict(mor_mode=mode, **layout, **kw)
    off = Engine(cfg, params, mor=mor, **kw).run(list(reqs))
    eng = Engine(cfg, params, mor=mor, obs=Observability(),
                 shadow_rate=R.SHADOW_RATE, **kw)
    co.reset_counts()
    on = eng.run(list(reqs))
    return (off, on, eng._last_device_metrics, dict(co.counts),
            eng.counters["dispatches"])


def _rank(group, weights):
    from repro_torch.launch.serve import calibrate, make_trace
    from repro_torch.models import get_model
    out = {"rank": group.rank}
    cfg = reduce_config(get_config(R.ARCH))
    params = convert.params_from_numpy(cfg, _nested(weights, "params"),
                                       device="cpu")
    mor = convert.mor_from_numpy({"layers": _nested(weights, "mor")},
                                 device="cpu")
    reqs = R.requests(cfg.vocab_size)
    for mode in R.MODES:
        out[mode] = _serve(cfg, params, mor, mode, reqs, group,
                           **R.ENGINE_KW)
    for arch in SINGLE_HELD:
        rcfg = reduce_config(get_config(arch))
        api = get_model(rcfg)
        rparams = api.init(torch.Generator().manual_seed(0), rcfg)
        rparams, rmor, _ = calibrate(rparams, rcfg, api, "cpu", 4, group)
        rreqs = make_trace(rcfg, 6, 4, 16, 5, 5, 0)
        out[arch] = _serve(rcfg, rparams, rmor, "kernel", rreqs, group,
                           n_slots=4, max_len=40)
        if group.rank == 0:
            out[(arch, "single")] = _serve(rcfg, rparams, rmor, "kernel",
                                           rreqs, None, n_slots=4,
                                           max_len=40)
    return out


@pytest.fixture(scope="module")
def run():
    """-> (the reference's outputs, the 2 ranks' results), the
    subprocess and the ranks side by side."""
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "weights.npz")
        opath = os.path.join(tmp, "out.npz")
        log = os.path.join(tmp, "reference.log")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

        def tail():
            with open(log) as f:
                return f.read()[-3000:]
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.join(
                    ROOT, "tests", "sharded_shadow_reference.py"), wpath,
                 opath], env=env, stdout=f, stderr=subprocess.STDOUT)
        try:
            t0 = time.time()
            while not os.path.exists(wpath):
                assert proc.poll() is None, tail()
                assert time.time() - t0 < 300, "no reference weights"
                time.sleep(0.2)
            with np.load(wpath) as f:
                weights = {k: f[k] for k in f.files}
            ranks = run_ranks(_rank, R.SHARDS, "cpu", weights)
            assert proc.wait(timeout=600) == 0, tail()
            assert "SHARDED_SHADOW_REFERENCE_OK" in tail()
            with np.load(opath) as f:
                ref = {k: f[k] for k in f.files}
            yield ref, ranks
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _blocks_equal(got, want):
    """Integer lanes equal, fixed-point lanes within 1 / SCALE."""
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, w in want.items():
        g = np.asarray(got[k])
        if np.asarray(w).dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1 / SCALE,
                                       err_msg=k)


@pytest.mark.parametrize("mode", R.MODES)
def test_sharded_shadow_tokens_equal_shadow_off(run, mode):
    """Every rank's shadow-on tokens equal its shadow-off tokens and the
    other rank's, and the reference's page-sharded engine's."""
    ref, ranks = run
    want = {int(k.rsplit("/", 1)[1]): ref[k].tolist() for k in ref
            if k.startswith(f"{mode}/tokens/")}
    for r in ranks:
        off, on = r[mode][:2]
        assert on == off
        assert {k: list(v) for k, v in on.items()} == want


@pytest.mark.parametrize("mode", R.MODES)
def test_sharded_shadow_counters_match_reference(run, mode):
    """The metrics block read at the flush (each rank's row gathered by
    the one existing collective) equals the reference's page-sharded
    engine's, lane for lane, on every rank; the shadow sampled 1 in 4
    dispatches and scored tiles."""
    ref, ranks = run
    want = {k[len(mode) + 1:]: v for k, v in ref.items()
            if k.startswith(mode + "/") and "/tokens/" not in k}
    for r in ranks:
        dm = r[mode][2]
        got = {k[len(mode) + 1:]: v
               for k, v in R.flat_block(dm, mode).items()}
        _blocks_equal(got, want)
        d = dm["dispatches"]
        assert dm["shadow_dispatches"] == (d + 3) // 4
        assert dm["groups"]["mor_stats"]["shadow_tiles"].sum() > 0


@pytest.mark.parametrize("mode", R.MODES)
def test_sharded_shadow_collectives(run, mode):
    """The kernel twin makes one merge an attention layer a sampled
    dispatch beside the primary step's (tiled scores in the step: no
    more merges); one block gather and one token check at the flush."""
    _, ranks = run
    L = reduce_config(get_config(R.ARCH)).n_layers
    for r in ranks:
        _, _, dm, counts, d = r[mode]
        twin = dm["shadow_dispatches"] if mode == "kernel" else 0
        assert counts == {"flash_merge": L * (d + twin), "obs_block": 1,
                          "check_tokens": 1}, counts


@pytest.mark.parametrize("arch", SINGLE_HELD)
def test_sharded_shadow_view_of_state_pools(run, arch):
    """Kernel mode against the single-device paged engine: rwkv6 (state
    only; the twin runs on each rank's view of its state shard, which no
    collective builds: its state gathers are the primary step's) and
    deepseek (MLA; the experts' (L, E) lanes): tokens equal shadow-off's
    and the block equals one device's lane for lane."""
    _, ranks = run
    off, on, dm, counts, d = ranks[0][(arch, "single")]
    for r in ranks:
        roff, ron, rdm, rcounts, rd = r[arch]
        assert ron == roff == on == off
        assert rd == d
        # the page edits are the shards' sum; the rest as one device's
        _blocks_equal(R.flat_block(rdm, "x"), R.flat_block(dm, "x"))
        twin = rdm["shadow_dispatches"]
        assert twin > 0
        if arch == "rwkv6-3b":
            assert rcounts["state_take"] % (d + twin) == 0, rcounts
            assert "flash_merge" not in rcounts
        else:
            assert rdm["groups"]["moe_mor_stats"]["shadow_tiles"].sum() > 0
            L = reduce_config(get_config(arch)).n_layers
            assert rcounts["flash_merge"] == L * (d + twin), rcounts
