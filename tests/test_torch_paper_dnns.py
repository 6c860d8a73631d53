"""The port's paper DNNs (TDS, CNN10, ResNet18, Darknet19) against the
JAX package, reduced, on the CPU.

Weights come from the JAX ``init`` and pass to the port as numpy
(``repro_torch.convert``); images and frames come from the numpy
generators both packages carry.  Integer results (the sign taps p_bin,
masks, permutations) must be equal.  Float tolerances: float32 results
of the same arithmetic summed in another order (XLA's conv against
PyTorch's, through up to 18 layers) agree to rtol = atol = 1e-4; one
conv or matmul to 1e-5.  JAX's kernel mode runs the Pallas kernels in
interpret mode, as its own tests do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.core import deploy as jdeploy
from repro.core import predictor as jpred
from repro.data import pipeline as jdata
from repro.models import cnn as jcnn
from repro.models import get_model as jget_model
from repro.models import tds as jtds
from repro_torch import convert
from repro_torch.configs import get_config, reduce_config
from repro_torch.core import deploy as tdeploy
from repro_torch.core import predictor as tpred
from repro_torch.data import pipeline as tdata
from repro_torch.kernels import gather_matmul as tgm
from repro_torch.kernels import mor_predict as tmp
from repro_torch.models import cnn, get_model, tds
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RTOL = ATOL = 1e-4          # through the whole network
RTOL1 = ATOL1 = 1e-5        # one conv / matmul
CNNS = ("paper-cnn10", "paper-resnet18", "paper-darknet19")
# a stride-2 net: channels grow at layer 1 (8 -> 16), as in the
# full-width CNNs, which the reduction (all 16 wide) does not keep
STRIDE2 = "stride2"
MODES = ("exact", "tiled", "kernel")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(arch):
    if arch == STRIDE2:
        kw = dict(cnn_channels=(3, 8, 16, 16, 16), n_layers=4)
        return (jreduce_config(jget_config("paper-resnet18")).replace(**kw),
                reduce_config(get_config("paper-resnet18")).replace(**kw))
    return jreduce_config(jget_config(arch)), reduce_config(get_config(arch))


def _force_enable(mors):
    """Every binary rookie on: random weights calibrate below T, and the
    predictor must really skip for the masks to say anything."""
    return [dict(m, enable=jnp.ones_like(m["enable"])) for m in mors]


@pytest.fixture(scope="module", params=CNNS + (STRIDE2,))
def cnn_setup(request):
    """JAX and port CNN side by side: params, BN state from two JAX
    train-mode forwards, JAX-calibrated MoR on two image batches."""
    arch = request.param
    jc, tc = _cfgs(arch)
    params = jcnn.init_params(jax.random.PRNGKey(0), jc)
    state = jcnn.init_state(jc)
    for k in range(2):
        im = jdata.synthetic_image_batch(jc, 4, seed=0, step=100 + k)
        _, state, _ = jcnn.forward(params, state, jc,
                                   jnp.asarray(im["images"]), train=True)
    batches = [jdata.synthetic_image_batch(jc, 4, seed=0, step=k)
               for k in range(2)]
    mors, rep = jdeploy.calibrate_cnn(
        params, state, jc, jcnn.forward,
        iter([{"images": jnp.asarray(b["images"])} for b in batches]), 2)
    images = jdata.synthetic_image_batch(jc, 4, seed=1, step=0)["images"]
    return dict(arch=arch, jc=jc, tc=tc, params=params, state=state,
                mors=mors, rep=rep, batches=batches, images=images,
                tparams=convert.params_from_numpy(tc, _np_tree(params),
                                                  "cpu"),
                tstate=convert.state_from_numpy(tc, _np_tree(state), "cpu"))


@pytest.fixture(scope="module")
def tds_setup():
    jc = jreduce_config(jget_config("paper-tds"))
    tc = reduce_config(get_config("paper-tds"))
    params = jtds.init_params(jax.random.PRNGKey(0), jc)
    batches = [jdata.synthetic_frames_batch(jc, 2, 32, seed=0, step=k)
               for k in range(2)]
    mors, rep = jdeploy.calibrate_tds(
        params, jc, jtds.forward,
        iter([{"frames": jnp.asarray(b["frames"])} for b in batches]), 2)
    frames = jdata.synthetic_frames_batch(jc, 2, 32, seed=1,
                                          step=0)["frames"]
    return dict(jc=jc, tc=tc, params=params, mors=mors, rep=rep,
                batches=batches, frames=frames,
                tparams=convert.params_from_numpy(tc, _np_tree(params),
                                                  "cpu"))


# -- configs, data, the model API --------------------------------------------

@pytest.mark.parametrize("arch", ("paper-tds",) + CNNS)
def test_reduced_config_matches_reference(arch):
    jc, tc = jreduce_config(jget_config(arch)), reduce_config(
        get_config(arch))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


@pytest.mark.parametrize("arch", ("paper-tds", "paper-darknet19"))
def test_synthetic_batches_are_bit_identical(arch):
    cfg = get_config(arch)
    for step in (0, 3):
        if cfg.family == "tds":
            a = jdata.synthetic_frames_batch(cfg, 3, 16, seed=2, step=step)
            b = tdata.synthetic_frames_batch(cfg, 3, 16, seed=2, step=step)
        else:
            a = jdata.synthetic_image_batch(cfg, 3, seed=2, step=step)
            b = tdata.synthetic_image_batch(cfg, 3, seed=2, step=step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], k)


def test_get_model_serves_the_paper_families():
    for arch, mod in (("paper-tds", tds), ("paper-cnn10", cnn)):
        api = get_model(get_config(arch))
        assert api.init is mod.init_params and api.forward is mod.forward
        assert not api.has_decode and api.prefill_chunk is None


def test_init_shapes_match_reference():
    """The port's own init from a torch.Generator gives the JAX layout:
    per-layer HWIO filters, BN gamma/beta, the head; TDS blocks."""
    for arch in ("paper-resnet18", "paper-tds"):
        jc, tc = jreduce_config(jget_config(arch)), reduce_config(
            get_config(arch))
        want = _np_tree(jget_model(jc).init(jax.random.PRNGKey(0), jc))
        got = get_model(tc).init(torch.Generator().manual_seed(0), tc)
        assert len(got["layers"]) == len(want["layers"])
        for lw, lg in zip(want["layers"], got["layers"]):
            flat_w = jax.tree_util.tree_flatten_with_path(lw)[0]
            for path, leaf in flat_w:
                g = lg
                for p in path:
                    g = g[p.key]
                assert tuple(g.shape) == leaf.shape and \
                    g.dtype == torch.float32, path
        assert tuple(got["head"].shape) == want["head"].shape


def test_params_conversion_checks_the_layer_list():
    tc = reduce_config(get_config("paper-cnn10"))
    jc = jreduce_config(jget_config("paper-cnn10"))
    p = _np_tree(jcnn.init_params(jax.random.PRNGKey(0), jc))
    with pytest.raises(ValueError, match="list of 10 layers"):
        convert.params_from_numpy(tc, dict(p, layers=p["layers"][:-1]),
                                  "cpu")
    with pytest.raises(ValueError, match="BN entries"):
        convert.state_from_numpy(tc, {"bn": []}, "cpu")


# -- trouble 1: SAME padding at stride 2 -------------------------------------

@pytest.mark.parametrize("size,stride", [(32, 2), (16, 2), (8, 1), (1, 2)])
def test_conv_pads_as_xla_same(size, stride):
    """``_conv`` pads as XLA's "SAME": at stride 2 on an even input that
    is (0, 1).  ``F.conv2d(padding=1)`` would pad (1, 1) and give other
    numbers; ``_im2col`` keeps the reference's (1, 1), one pixel off the
    conv it predicts, and equals the JAX ``_im2col``."""
    rng = np.random.default_rng(size + stride)
    x = rng.normal(size=(2, size, size, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 8)).astype(np.float32)
    want = np.asarray(jcnn._conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = cnn._conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL1, atol=ATOL1)
    sym = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride,
                   padding=1).permute(0, 2, 3, 1)
    cols_j = np.asarray(jcnn._im2col(jnp.asarray(x), 3, stride))
    cols_t = cnn._im2col(torch.from_numpy(x), 3, stride)
    np.testing.assert_array_equal(cols_t.numpy(), cols_j)
    via_cols = (cols_t @ cnn._wmat(torch.from_numpy(w))).reshape(got.shape)
    # the predictor's patches are the symmetric pad's
    np.testing.assert_allclose(via_cols.numpy(), sym.numpy(), rtol=RTOL1,
                               atol=ATOL1)
    if stride == 2 and size > 1:
        assert float((sym - got).abs().max()) > 1e-2
    else:
        np.testing.assert_allclose(sym.numpy(), want, rtol=RTOL1,
                                   atol=ATOL1)


# -- the CNNs ----------------------------------------------------------------

def test_cnn_eval_taps_match_reference(cnn_setup):
    """Eval-mode calibration taps per layer: p_bin (the sign conv over
    zero padding) equal, p_base and relu_in allclose."""
    s = cnn_setup
    lj, _, aj = jcnn.forward(s["params"], s["state"], s["jc"],
                             jnp.asarray(s["images"]), with_taps=True)
    lt, _, at = cnn.forward(s["tparams"], s["tstate"], s["tc"],
                            torch.from_numpy(s["images"]), with_taps=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)
    assert len(at["taps"]) == len(aj["taps"])
    for i, (tj, tt) in enumerate(zip(aj["taps"], at["taps"])):
        np.testing.assert_array_equal(tt["p_bin"].numpy(),
                                      np.asarray(tj["p_bin"]), f"layer {i}")
        for k in ("p_base", "relu_in"):
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(tj[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"layer {i} {k}")


def test_cnn_train_new_state_matches_reference(cnn_setup):
    """train=True: batch statistics with the population variance, the
    0.9 momentum update of every layer's running stats."""
    s = cnn_setup
    im = s["batches"][0]["images"]
    lj, sj, _ = jcnn.forward(s["params"], s["state"], s["jc"],
                             jnp.asarray(im), train=True)
    lt, st, _ = cnn.forward(s["tparams"], s["tstate"], s["tc"],
                            torch.from_numpy(im), train=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(_np_tree(sj)["bn"], st["bn"]):
        for k in ("mu", "var"):
            np.testing.assert_allclose(b[k].numpy(), a[k], rtol=RTOL,
                                       atol=ATOL)


def test_calibrate_cnn_matches_reference(cnn_setup):
    """Same weights, state and batches: enable, proxy_slot and perm equal
    per layer; m, b, the folded BN and the Pearson report allclose."""
    s = cnn_setup
    mors, rep = tdeploy.calibrate_cnn(s["tparams"], s["tstate"], s["tc"],
                                      cnn.forward, iter(s["batches"]), 2)
    assert len(mors) == len(s["mors"])
    for i, (mj, mt) in enumerate(zip(_np_tree(s["mors"]), mors)):
        for k in ("enable", "proxy_slot", "perm", "inv_perm", "is_proxy"):
            np.testing.assert_array_equal(mt[k].numpy(), mj[k],
                                          f"layer {i} {k}")
        for k in ("m", "b", "bn_scale", "bn_bias"):
            np.testing.assert_allclose(mt[k].numpy(), mj[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"layer {i} {k}")
    for k in ("pearson_mean", "enabled_frac"):
        np.testing.assert_allclose(rep[k], s["rep"][k], rtol=RTOL)
    np.testing.assert_allclose(rep["pearson_per_layer"],
                               s["rep"]["pearson_per_layer"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("forced", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cnn_mor_forward_matches_reference(cnn_setup, mode, forced):
    """MoR forwards: logits allclose and per-layer frac_computed equal,
    as calibrated and with every rookie enabled; the conv predictor
    takes no kernel branch, so every mode launches nothing (a kernel
    launch off the card would raise) and gives the same outputs."""
    s = cnn_setup
    mj = _force_enable(s["mors"]) if forced else s["mors"]
    mt = convert.mor_list_from_numpy(_np_tree(mj), "cpu")
    lj, _, aj = jcnn.forward(s["params"], s["state"], s["jc"],
                             jnp.asarray(s["images"]), mor=mj,
                             mor_mode=mode)
    tpred.reset_predictor_eval_count()
    lt, _, at = cnn.forward(s["tparams"], s["tstate"], s["tc"],
                            torch.from_numpy(s["images"]), mor=mt,
                            mor_mode=mode)
    assert tpred.predictor_eval_count() == len(mt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)
    fj = [float(x["frac_computed"]) for x in aj["mor_stats"]]
    ft = [float(x["frac_computed"]) for x in at["mor_stats"]]
    assert ft == fj
    if forced:
        assert min(ft) < 1.0                      # skipping happened
    le, _, ae = cnn.forward(s["tparams"], s["tstate"], s["tc"],
                            torch.from_numpy(s["images"]), mor=mt,
                            mor_mode="exact")
    assert torch.equal(le, lt)


def test_cnn_prediction_breakdown_matches_reference(cnn_setup):
    """Fig. 12 categories on each layer's true ReLU input and the forced
    predictor's mask (``conv_layer`` exposes both)."""
    s = cnn_setup
    mj = _force_enable(s["mors"])
    mt = convert.mor_list_from_numpy(_np_tree(mj), "cpu")
    x = torch.from_numpy(s["images"])
    strides = cnn._strides(s["tc"])
    lp, st = s["tparams"]["layers"][0], s["tstate"]["bn"][0]
    r = cnn.conv_layer(lp, st, s["tc"], x, strides[0], None, mor=mt[0],
                       mor_mode="exact")
    C = r["pre"].shape[-1]
    perm = mt[0]["perm"].long()
    true = r["relu_in"].reshape(-1, C)[:, perm]
    got = tpred.prediction_breakdown(true, r["computed"])
    want = jpred.prediction_breakdown(jnp.asarray(true.numpy()),
                                      jnp.asarray(r["computed"].numpy()))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-6, err_msg=k)
    assert abs(sum(float(v) for v in got.values()) - 1.0) < 1e-6


# -- TDS ---------------------------------------------------------------------

def test_tds_taps_match_reference(tds_setup):
    """Conv taps (the sign conv over the causal zero pad) and FC1 taps
    alternate; p_bin equal, p_base and relu_in allclose."""
    s = tds_setup
    lj, aj = jtds.forward(s["params"], s["jc"],
                          {"frames": jnp.asarray(s["frames"])},
                          with_taps=True)
    lt, at = tds.forward(s["tparams"], s["tc"],
                         {"frames": torch.from_numpy(s["frames"])},
                         with_taps=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)
    assert len(at["taps"]) == len(aj["taps"]) == 2 * s["tc"].n_layers
    for i, (tj, tt) in enumerate(zip(aj["taps"], at["taps"])):
        np.testing.assert_array_equal(tt["p_bin"].numpy(),
                                      np.asarray(tj["p_bin"]), f"tap {i}")
        for k in ("p_base", "relu_in"):
            np.testing.assert_allclose(tt[k].numpy(), np.asarray(tj[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"tap {i} {k}")


def test_calibrate_tds_matches_reference(tds_setup):
    """The FC taps are the odd ones; fc1_b folds in as bn_bias."""
    s = tds_setup
    mors, rep = tdeploy.calibrate_tds(s["tparams"], s["tc"], tds.forward,
                                      iter(s["batches"]), 2)
    for i, (mj, mt) in enumerate(zip(_np_tree(s["mors"]), mors)):
        for k in ("enable", "proxy_slot", "perm", "inv_perm", "is_proxy"):
            np.testing.assert_array_equal(mt[k].numpy(), mj[k],
                                          f"layer {i} {k}")
        for k in ("m", "b", "bn_scale", "bn_bias"):
            np.testing.assert_allclose(mt[k].numpy(), mj[k], rtol=RTOL,
                                       atol=ATOL, err_msg=f"layer {i} {k}")
    np.testing.assert_allclose(rep["pearson_mean"], s["rep"]["pearson_mean"],
                               rtol=RTOL)


def _sparse(mors):
    """Every rookie enabled; the last half of block 0's FC1 columns and
    all of the last block's dead (a folded bias far below zero, no
    proxy): the reduced FC1 is one 128-column tile wide, so the last
    block's tiles really skip."""
    out = []
    for i, m in enumerate(_np_tree(mors)):
        m = {k: np.array(v) for k, v in m.items()}
        n = m["m"].shape[0]
        dead = np.arange(n) >= (n if i == 0 else 0) // 2
        m["bn_bias"] = np.where(dead, -1e3, m["bn_bias"]).astype(np.float32)
        m["enable"] = np.ones(n, bool)
        m["is_proxy"] = m["is_proxy"] & ~dead
        m["proxy_slot"] = np.where(dead, -1, m["proxy_slot"]).astype(
            np.int32)
        out.append(m)
    return out


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_tds_mor_forward_matches_reference(tds_setup, mode, sparse):
    """FC1 through ``MoRExecutionPlan.relu_matmul``: logits allclose and
    the FC1 stats equal; kernel mode launches the predictor and the
    compacted product once a block (their plain versions here)."""
    s = tds_setup
    mors = _sparse(s["mors"]) if sparse else _np_tree(s["mors"])
    mj = [{k: jnp.asarray(v) for k, v in m.items()} for m in mors]
    mt = convert.mor_list_from_numpy(mors, "cpu")
    lj, aj = jtds.forward(s["params"], s["jc"],
                          {"frames": jnp.asarray(s["frames"])}, mor=mj,
                          mor_mode=mode)
    tpred.reset_predictor_eval_count()
    lt, at = tds.forward(s["tparams"], s["tc"],
                         {"frames": torch.from_numpy(s["frames"])}, mor=mt,
                         mor_mode=mode)
    assert tpred.predictor_eval_count() == s["tc"].n_layers
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)
    for sj, st in zip(aj["mor_stats"], at["mor_stats"]):
        assert set(st) == set(sj)
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]),
                                       rtol=1e-6, err_msg=k)
    if sparse:
        assert float(at["mor_stats"][-1]["frac_tiles_computed"]) == 0.0


def test_tds_kernel_mode_runs_the_plain_kernels_once_a_block(tds_setup):
    """On the CPU the wrappers run their plain versions and count no
    launch; the predictor runs once a block."""
    s = tds_setup
    mt = convert.mor_list_from_numpy(_sparse(s["mors"]), "cpu")
    before = (tmp.launches, tgm.launches)
    tpred.reset_predictor_eval_count()
    tds.forward(s["tparams"], s["tc"],
                {"frames": torch.from_numpy(s["frames"])}, mor=mt,
                mor_mode="kernel")
    assert (tmp.launches, tgm.launches) == before
    assert tpred.predictor_eval_count() == s["tc"].n_layers


def test_prediction_breakdown_matches_reference():
    rng = np.random.default_rng(9)
    true = rng.normal(size=(64, 128)).astype(np.float32)
    mask = rng.random((64, 128)) < 0.6
    got = tpred.prediction_breakdown(torch.from_numpy(true),
                                     torch.from_numpy(mask))
    want = jpred.prediction_breakdown(jnp.asarray(true), jnp.asarray(mask))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)
    assert got["correct_zero"].dtype == torch.float32
