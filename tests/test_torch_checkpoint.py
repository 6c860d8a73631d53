"""The port's checkpoints (``repro_torch.checkpoint``) and their format
against the JAX package's (``repro.checkpoint``): a round trip with
bfloat16 leaves, atomic commit, keep-last-k, an async save whose
snapshot is taken before the call returns, and float32 train states
that each package writes and the other restores.  Restored leaves must
be bit-equal: nothing is computed between writing and reading.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.models import get_model as jget_model
from repro.optim import OptConfig as JOptConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.steps import init_train_state
from repro_torch.optim import OptConfig, adamw_init
from repro_torch.tree import paths, tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _state(seed=0, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    params = {"embed": torch.randn(16, 8, generator=g).to(dtype),
              "layers": {"w": torch.randn(2, 8, 8, generator=g).to(dtype),
                         "ln": {"scale": torch.ones(2, 8, dtype=dtype)}}}
    return {"params": params, "opt": adamw_init(params, OptConfig())}


def _equal(got, want):
    gp, wp = paths(got), paths(want)
    assert gp.keys() == wp.keys()
    for k in wp:
        assert gp[k].dtype == wp[k].dtype, k
        assert torch.equal(gp[k], wp[k]), k


def _template(state):
    return tree_map(torch.zeros_like, state)


def test_round_trip_with_bf16_leaves(tmp_path):
    """bf16 params and moments, the float32 master copy and the int32
    step restore bit for bit; the manifest is the reference's (keys over
    sorted paths, extra) plus the leaves' dtypes."""
    import json
    state = _state()
    state["opt"]["step"] += 7
    save_pytree(state, str(tmp_path / "s"), {"step": 3})
    got, extra = load_pytree(_template(state), str(tmp_path / "s"))
    assert extra == {"step": 3}
    _equal(got, state)
    meta = json.load(open(tmp_path / "s.json"))
    assert meta["keys"] == sorted(paths(state))
    assert "params/layers/ln/scale" in meta["keys"]
    assert "opt/master/embed" in meta["keys"]
    kinds = dict(zip(meta["keys"], meta["dtypes"]))
    assert kinds["params/embed"] == "bfloat16"
    assert kinds["opt/master/embed"] == "float32"
    assert kinds["opt/step"] == "int32"
    with np.load(tmp_path / "s.npz") as z:
        assert z[f"a{meta['keys'].index('params/embed')}"].dtype == np.uint16
    # a template of another dtype casts; of another shape raises
    f32 = {"params": {"embed": torch.zeros(16, 8)}}
    got, _ = load_pytree(f32, str(tmp_path / "s"))
    assert torch.equal(got["params"]["embed"],
                       state["params"]["embed"].float())
    with pytest.raises(ValueError):
        load_pytree({"params": {"embed": torch.zeros(8, 16)}},
                    str(tmp_path / "s"))
    with pytest.raises(KeyError):
        load_pytree({"params": {"nothing": torch.zeros(1)}},
                    str(tmp_path / "s"))


def test_partial_write_is_ignored(tmp_path):
    """A step directory without COMMIT (a crash before the rename) and a
    leftover ``.writing`` directory are not restore points."""
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _state()
    mgr.save(5, state)
    os.makedirs(tmp_path / "step_00000009")
    os.makedirs(tmp_path / "step_00000010.writing")
    (tmp_path / "step_00000010.writing" / "COMMIT").write_text("10")
    assert mgr.latest_step() == 5
    got, extra = mgr.restore(_template(state))
    assert extra["step"] == 5
    _equal(got, state)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    got, _ = mgr.restore(_template(_state()), step=3)
    _equal(got, _state(3))


def test_async_save_snapshots_before_returning(tmp_path):
    """The async save copies every leaf before it returns: updating the
    live tensors in place right after (as the train step does) does not
    reach the checkpoint; ``wait`` joins the writer."""
    mgr = CheckpointManager(str(tmp_path))
    state = _state(dtype=torch.float32)
    want = _template(state)
    for k, v in paths(state).items():
        paths(want)[k].copy_(v)
    mgr.save(1, state)
    for v in paths(state).values():
        v.add_(1)
    mgr.wait()
    assert mgr.latest_step() == 1
    got, _ = mgr.restore(_template(state))
    _equal(got, want)


@functools.lru_cache(maxsize=None)
def _jax_state():
    """The reference's float32 train state of reduced granite (its init
    compiled: the same draws, without the op-by-op dispatch)."""
    jcfg = jreduce_config(jget_config("granite-3-2b"))
    api = jget_model(jcfg)
    jp = jax.jit(lambda k: api.init(k, jcfg))(jax.random.PRNGKey(3))
    return jp, jadamw_init(jp, JOptConfig(moment_dtype="float32"))


def _port_template():
    cfg = reduce_config(get_config("granite-3-2b"))
    params, opt = init_train_state(torch.Generator().manual_seed(0), cfg,
                                   OptConfig(moment_dtype="float32"))
    return {"params": params, "opt": opt}


def test_jax_checkpoint_restores_in_port(tmp_path):
    """A float32 train state the reference wrote (params, AdamW moments
    after an update of the step counter, int32 step) restores into the
    port's own initialised tree."""
    jp, js = _jax_state()
    js = {**js, "step": js["step"] + 11,
          "mu": jax.tree_util.tree_map(lambda a: a + 0.5, js["mu"])}
    JCheckpointManager(str(tmp_path)).save(12, {"params": jp, "opt": js},
                                           block=True)
    got, extra = CheckpointManager(str(tmp_path)).restore(_port_template())
    assert extra["step"] == 12
    want = {k: np.asarray(v) for k, v in
            _flat_jax({"params": jp, "opt": js}).items()}
    gp = paths(got)
    assert gp.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(gp[k].numpy(), want[k], err_msg=k)


def _flat_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}


def test_port_checkpoint_restores_in_jax(tmp_path):
    """The port's float32 train state restores through the reference's
    reader (which ignores the extra ``dtypes`` key)."""
    state = _port_template()
    state["opt"]["step"] += 4
    CheckpointManager(str(tmp_path)).save(4, state, block=True)
    jp, js = _jax_state()
    tmpl = {"params": jp, "opt": js}
    got, extra = JCheckpointManager(str(tmp_path)).restore(tmpl)
    assert extra["step"] == 4
    want = paths(state)
    flat = _flat_jax(got)
    assert flat.keys() == want.keys()
    for k, v in flat.items():
        assert v.dtype == jnp.asarray(_flat_jax(tmpl)[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(v), want[k].numpy(),
                                      err_msg=k)
    # and into the JAX models: the port's params through convert agree
    cfg = reduce_config(get_config("granite-3-2b"))
    back = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, got["params"]), device="cpu")
    for k, v in paths(back).items():
        assert torch.equal(v, paths(state["params"])[k]), k
