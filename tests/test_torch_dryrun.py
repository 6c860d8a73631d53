"""The port's dry run against the JAX package's: the shape grid and
``input_specs``, ``param_shapes`` / ``cache_shapes`` on the meta device,
``dryrun.cell_status`` / ``run_cell`` and the grid sweep
``dryrun_all``.

Shapes, dtypes and byte counts are integers and are asserted equal.
One layout differs on purpose, and the test names it: the port's MLA
cache (deepseek) keeps a position tag a cached row, (L, B, max_len)
int32, which the reference's absorbed-latent cache does not hold.
"""
import contextlib
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs import get_config as jget_config
from repro.configs import input_specs as jinput_specs
from repro.configs import list_archs as jlist_archs
from repro.configs import reduce_config as jreduce_config
from repro.data import DataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.launch import steps as jsteps
from repro.launch.dryrun import cell_status as jcell_status
from repro.models import cache_shapes as jcache_shapes
from repro.models import get_model as jget_model
from repro.models import param_shapes as jparam_shapes
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import convert
from repro_torch.configs import (SHAPES, ShapeSpec, get_config, input_specs,
                                 list_archs, param_count, reduce_config)
from repro_torch.launch import dryrun, dryrun_all, steps
from repro_torch.models import cache_shapes, get_model, param_shapes
from repro_torch.models.layers import attention
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.tree import leaves, paths
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CELLS = [(a, s) for a in dryrun_all.ARCHS for s in dryrun_all.SHAPE_NAMES]
CACHE_B, CACHE_LEN = 8, 4096


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def test_shape_grid_and_archs_match_reference():
    assert len(CELLS) == 40
    assert list_archs() == jlist_archs()
    def grid(shapes):
        return {k: (v.seq_len, v.global_batch, v.kind)
                for k, v in shapes.items()}
    assert grid(SHAPES) == grid(JSHAPES)


def test_cell_status_matches_reference_on_every_cell():
    for arch, s in CELLS:
        assert dryrun.cell_status(get_config(arch), SHAPES[s]) == \
            jcell_status(jget_config(arch), JSHAPES[s]), (arch, s)
    assert sum(dryrun.cell_status(get_config(a), SHAPES[s]) == "run"
               for a, s in CELLS) == 32


def test_input_specs_match_reference_on_every_cell():
    for arch, s in CELLS:
        got = input_specs(get_config(arch), SHAPES[s])
        want = jinput_specs(jget_config(arch), JSHAPES[s])
        assert sorted(got) == sorted(want), (arch, s)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, s, k)
            assert _dtype_name(v.dtype) == str(want[k].dtype), (arch, s, k)


def test_input_specs_of_the_cnn_family():
    cfg, jcfg = get_config("paper-resnet18"), jget_config("paper-resnet18")
    for s in ("train_4k", "decode_32k"):
        got = input_specs(cfg, SHAPES[s], device="cpu")
        want = jinput_specs(jcfg, JSHAPES[s])
        assert {k: (tuple(v.shape), _dtype_name(v.dtype))
                for k, v in got.items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "cpu" for v in got.values())


def _np_zeros(sds_tree):
    return jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, dtype=s.dtype), sds_tree)


@pytest.mark.parametrize("arch", jlist_archs())
def test_param_shapes_match_reference_reduced(arch):
    """Every leaf's shape and dtype, through ``convert.params_from_numpy``'s
    name mapping of the reference's tree; nothing drawn, every leaf on
    the meta device."""
    jcfg = jreduce_config(jget_config(arch))
    cfg = reduce_config(get_config(arch))
    want = convert.params_from_numpy(cfg, _np_zeros(jparam_shapes(jcfg)),
                                     device="cpu")
    got = param_shapes(cfg)
    gp, wp = paths(got), paths(want)
    assert sorted(gp) == sorted(wp)
    for k, v in gp.items():
        assert v.device.type == "meta", k
        assert (tuple(v.shape), v.dtype) == (tuple(wp[k].shape),
                                             wp[k].dtype), k


def test_param_shapes_do_not_change_the_draws():
    """The meta path leaves the CPU's seeded weights as they were: the
    same generator gives the same tensors before and after a meta
    init."""
    cfg = reduce_config(get_config("zamba2-7b"))
    api = get_model(cfg)
    a = api.init(torch.Generator().manual_seed(3), cfg)
    param_shapes(cfg)
    b = api.init(torch.Generator().manual_seed(3), cfg)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _jbytes(tree) -> int:
    return sum(math.prod(l.shape) * l.dtype.itemsize
               for l in jax.tree_util.tree_leaves(tree))


def _tbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree))


@pytest.mark.parametrize("arch", jlist_archs())
def test_full_width_param_and_cache_bytes_match_reference(arch):
    """At the published widths: the params' bytes for every arch, and
    for the decoder archs ``cache_shapes``' bytes at (8, 4096)."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    assert _tbytes(param_shapes(cfg)) == _jbytes(jparam_shapes(jcfg))
    if jget_model(jcfg).cache_init is None:
        assert get_model(cfg).cache_init is None
        return
    got = cache_shapes(cfg, CACHE_B, CACHE_LEN)
    assert all(t.device.type == "meta" for t in leaves(got))
    want = _jbytes(jcache_shapes(jcfg, CACHE_B, CACHE_LEN))
    if cfg.mla:
        # the port's MLA cache tags each cached row with its position
        assert tuple(got["layers"]["pos"].shape) == (cfg.n_layers, CACHE_B,
                                                      CACHE_LEN)
        want += cfg.n_layers * CACHE_B * CACHE_LEN * 4
    assert _tbytes(got) == want


SMALL = {"train": ShapeSpec("train_s", 32, 4, "train"),
         "prefill": ShapeSpec("prefill_s", 32, 2, "prefill"),
         "decode": ShapeSpec("decode_s", 64, 2, "decode")}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_counts_equal_cpu_counts(kind):
    """A reduced granite cell (train at grad_accum 2 with remat, a
    prefill, a decode step): the same FLOPs, bytes, op table, peak
    live bytes and result bytes on the meta device as on the CPU."""
    cfg = reduce_config(get_config("granite-3-2b")).replace(
        grad_accum=2, remat="nothing_saveable")
    opt = OptConfig(moment_dtype="float32")
    meta, cpu = [dryrun.count_cell(cfg, SMALL[kind], opt_cfg=opt, device=d)
                 for d in ("meta", "cpu")]
    assert meta.args == cpu.args
    assert meta.results == cpu.results > 0
    assert meta.card is None and cpu.card is None
    assert meta.counter.flops == cpu.counter.flops > 0
    assert meta.counter.bytes == cpu.counter.bytes
    assert meta.counter.peak_live_bytes == cpu.counter.peak_live_bytes > 0
    assert dict(meta.counter.by_op) == dict(cpu.counter.by_op)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_result_bytes_are_what_the_step_must_write(kind):
    """The floor's results: a train step rewrites its params and AdamW
    state (and returns three float32 metrics), a prefill returns the
    int32 next token of each row, and a decode step the same, its
    cache (written one position a row) left out."""
    cfg = reduce_config(get_config("granite-3-2b"))
    opt = OptConfig(moment_dtype="float32")
    c = dryrun.count_cell(cfg, SMALL[kind], opt_cfg=opt)
    B = SMALL[kind].global_batch
    if kind == "train":
        # the int32 step counter is part of the state
        assert c.results == c.args["params"] + c.args["opt"] + 3 * 4
    else:
        assert c.results == B * 4


def test_encoder_train_step_matches_reference():
    """hubert-xlarge's train cell: its token embedding is a leaf the
    frames' loss never reads.  The reference's ``jax.grad`` gives it a
    zero gradient; so does the port's step (it raised before the dry run
    found it): the loss, the gradient norm and that leaf after one step
    (weight decay alone) equal the reference's."""
    jcfg = jreduce_config(jget_config("hubert-xlarge"))
    cfg = reduce_config(get_config("hubert-xlarge"))
    jparams = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    batch = jmake_batch(jcfg, JShapeSpec("t", 16, 2, "train"),
                        DataConfig(seed=0), 0)
    jo = JOptConfig(moment_dtype="float32")
    jp, _, jm = jax.jit(jsteps.make_train_step(jcfg, jo))(
        jparams, jadamw_init(jparams, jo), batch)
    params = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    opt = OptConfig(moment_dtype="float32")
    tp, _, tm = steps.make_train_step(cfg, opt)(
        params, adamw_init(params, opt),
        {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(tp["embed"].numpy(), np.asarray(jp["embed"]),
                               rtol=1e-6, atol=1e-7)


def test_granite_decode_32k_dryrun_is_ok_on_meta(tmp_path):
    """granite-3-2b at full width, decode_32k: the cell runs on meta,
    its argument bytes are the analytic params plus cache plus inputs,
    and the record says where it stands against one 80 GB card."""
    out = tmp_path / "cell.json"
    rec = dryrun.run_cell("granite-3-2b", "decode_32k", out_path=str(out))
    assert rec["status"] == "ok"
    cfg, shape = get_config("granite-3-2b"), SHAPES["decode_32k"]
    B, T = shape.global_batch, shape.seq_len
    L, hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    d = cfg.d_model
    # bf16 weights (the embedding tied to the head), float32 norm scales
    # (two a layer and the final one), which ``param_count`` leaves out
    params = param_count(cfg)[0] * 2 + (2 * L + 1) * d * 4
    # k and v rows, a position tag a ring row (shared by the batch), pos
    cache = L * B * T * 2 * hkv * hd * 2 + L * T * 4 + 4
    inputs = B * 4
    assert rec["argument_bytes_by_tree"] == {"params": params,
                                             "cache": cache,
                                             "inputs": inputs}
    assert rec["argument_bytes"] == params + cache + inputs
    assert rec["per_device_bytes"] == rec["argument_bytes"] + \
        rec["peak_temp_bytes"]
    assert rec["fits_80gb"] == (rec["per_device_bytes"] < 80 * 2 ** 30)
    rl = rec["roofline"]
    assert rl["dominant"] == "memory" and rl["bound_time_s"] > 0
    assert rl["model_flops_per_chip"] == 2 * param_count(cfg)[1] * B
    # the floor: the arguments read once and the B int32 tokens written
    assert rec["result_bytes"] == B * 4
    assert rl["floor_bytes"] == rec["argument_bytes"] + B * 4
    assert rl["floor_dominant"] == "memory"
    assert rl["floor_time_s"] == rl["floor_bytes"] / 3.35e12
    assert rl["floor_time_s"] < rl["bound_time_s"]
    assert json.loads(out.read_text())["status"] == "ok"


def test_run_cell_passes_the_flash_threshold_in_the_config(monkeypatch):
    """The dry run's attention threshold is the config's (deepseek's
    2048), or ``flash_threshold``'s override, carried by the config the
    step reads, as the train and serve paths read it."""
    seen = []

    def fake(cfg, shape, **kw):
        seen.append(cfg.flash_threshold)
        raise RuntimeError("stop here")
    monkeypatch.setattr(dryrun, "measure_cell", fake)
    rec = dryrun.run_cell("deepseek-v2-236b", "prefill_32k")
    assert seen == [2048] and rec["status"].startswith("error: Runtime")
    assert "traceback" in rec and rec["flash_threshold"] == 2048
    dryrun.run_cell("granite-3-2b", "prefill_32k", flash_threshold=1024)
    assert seen == [2048, 1024]
    assert attention._FLASH_THRESHOLD == 4096


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-236b"])
def test_attention_layers_take_the_config_threshold(arch, monkeypatch):
    """A model forward takes the chunked softmax exactly when its kv
    length passes ``cfg.flash_threshold`` (GQA and MLA), and gives the
    same logits either way."""
    calls = []
    flash = attention._flash

    def spy(*a, **kw):
        calls.append(a[1].shape[1])
        return flash(*a, **kw)
    monkeypatch.setattr(attention, "_flash", spy)
    cfg = reduce_config(get_config(arch))
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16),
                                     generator=torch.Generator()
                                     .manual_seed(1), dtype=torch.int32)}
    with torch.no_grad():
        full, _ = api.forward(params, cfg, batch)
        assert calls == []
        chunked, _ = api.forward(params, cfg.replace(flash_threshold=8),
                                 batch)
    assert calls and set(calls) == {16}
    np.testing.assert_allclose(chunked.float().numpy(),
                               full.float().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("argv,kw", [
    (["--mesh", "pod"], dict(mesh_kind="pod")),
    (["--mesh", "multipod"], dict(mesh_kind="multipod")),
    (["--no-seq-parallel"], dict(seq_parallel=False)),
    (["--param-layout", "fsdp_tp"], dict(layout="fsdp_tp")),
    (["--moe-sharding", "tp"], dict(moe_sharding="tp")),
    (["--moe-sharding", "ep_shmap"], dict(moe_sharding="ep_shmap"))])
def test_mesh_flags_raise_naming_queue_a7(argv, kw, monkeypatch):
    """The mesh flags the port refused until queue A 7's second part
    now run: ``main`` hands each to ``run_cell``, and ``run_cell``
    measures the cell on the production mesh's rank 0 for ``--mesh
    pod|multipod`` (the fake process group replaced here by a stand-in:
    a test worker may not hold it; tests/test_torch_mesh_pod.py runs the
    real one in a process of its own) with the layout, the expert mode
    and the sequence-parallel flag it was given, on one card for the
    others."""
    base = ["--arch", "granite-3-2b", "--shape", "decode_32k"]
    seen = []
    real_run_cell = dryrun.run_cell
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: seen.append(
        (a, k)) or {"status": "ok"})
    dryrun.main(base + argv)
    (args, got), = seen
    want = {"mesh_kind": "1xh100", "seq_parallel": True, "layout": None,
            "moe_sharding": None, **kw}
    assert args[2] == want.pop("mesh_kind")
    assert {k: got[k] for k in want} == want

    calls = []

    @contextlib.contextmanager
    def stand_in(shape, rank=0, backend="nccl"):
        calls.append((shape, backend))
        yield "mesh"

    def measure(cfg, shape, mor_mode="dense", on=None, **_):
        calls.append((cfg.expert_sharding, on))
        return {"per_device_gib": 1.0, "fits_80gb": True, "meta_s": 0.0,
                "roofline": {"dominant": "memory", "roofline_fraction": 0.0,
                             "t_collective_s": 0.0, "t_collective_ib_s": 0.0,
                             "floor_dominant": "memory",
                             "floor_time_s": 0.0}}
    monkeypatch.setattr(dryrun, "dry_mesh", stand_in)
    monkeypatch.setattr(dryrun, "measure_cell", measure)
    rec = real_run_cell("granite-3-2b", "decode_32k", **kw)
    assert rec["status"] == "ok", rec
    mesh_kind = kw.get("mesh_kind", "1xh100")
    assert rec["mesh"] == mesh_kind
    assert rec["layout"] == kw.get("layout", "contract_tp")
    assert rec["seq_parallel"] == kw.get("seq_parallel", True)
    assert rec["expert_sharding"] == kw.get("moe_sharding", "tp")
    if mesh_kind == "1xh100":
        assert calls == [(rec["expert_sharding"], None)]
    else:
        shape = dryrun.mesh_shape(mesh_kind)
        assert calls == [(shape, "nccl"), (rec["expert_sharding"],
                                           dryrun.MeshArgs("mesh", True,
                                                           "contract_tp"))]
        assert rec["mesh_shape"] == shape
        assert math.prod(shape.values()) == (512 if mesh_kind == "multipod"
                                             else 256)


def test_grid_sweep_records_failures_and_skips_cached_cells(
        tmp_path, monkeypatch):
    """``dryrun_all.sweep``: a skipped cell is recorded as such, a cell
    that fails is recorded with its error and the sweep goes on, and on
    a second sweep the OK and skipped cells are read back, the failed
    one run again."""
    calls = []

    def fake(cfg, shape, **kw):
        calls.append(cfg.name)
        if cfg.name == "granite-20b":
            raise ValueError("no meta kernel")
        return {"argument_bytes": 1, "peak_temp_bytes": 1,
                "per_device_bytes": 2, "per_device_gib": 0.0,
                "fits_80gb": True, "meta_s": 0.0,
                "roofline": {"dominant": "memory",
                             "roofline_fraction": 0.5,
                             "floor_dominant": "compute",
                             "floor_time_s": 0.25}}
    monkeypatch.setattr(dryrun, "measure_cell", fake)
    archs = ["granite-3-2b", "granite-20b", "rwkv6-3b"]
    lines = []
    out = dryrun_all.sweep(archs, ["long_500k"], out_dir=str(tmp_path),
                           log=lines.append)
    status = {a: out[(a, "long_500k")]["status"] for a in archs}
    assert status["granite-3-2b"].startswith("skip")
    assert status["granite-20b"].startswith("skip")
    assert status["rwkv6-3b"] == "ok"
    out = dryrun_all.sweep(["granite-20b"], ["decode_32k"],
                           out_dir=str(tmp_path), log=lines.append)
    rec = json.loads((tmp_path / "granite-20b_decode_32k_1xh100.json")
                     .read_text())
    assert rec["status"] == "error: ValueError: no meta kernel"
    out = dryrun_all.sweep(archs, ["long_500k", "decode_32k"],
                           out_dir=str(tmp_path), log=lines.append)
    assert calls == ["rwkv6-3b", "granite-20b", "granite-3-2b",
                     "granite-20b", "rwkv6-3b"]
    assert sum("cached" in ln for ln in lines) == 3
    assert len([ln for ln in lines if ln.startswith("[")]) == 3 + 1 + 6
