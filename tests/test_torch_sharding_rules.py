"""The port's sharding rules, elastic plan, rank-local blocks and int8
gradient compression against the JAX package.

- ``param_sharding``: the port's spec of every leaf equals the
  reference's ``param_sharding(...).spec`` for the whole-width params of
  every config (the reference's from ``jax.eval_shape`` of its init, on
  ``jax.sharding.AbstractMesh``es of (2, 2) and (16, 16); the port's from
  ``param_shapes`` on the meta device), for both layouts and the
  ``moe_mode``s tp, ep and ep_shmap;
- ``batch_sharding`` and ``ElasticPlan`` (the reference test's three
  cases) against the reference's;
- on 4 gloo ranks as a (data 2, model 2) host mesh (one spawn for the
  module): ``shard_leaf`` / ``gather_leaf`` round trips over reduced
  granite's and deepseek's spec trees, bit-equal, and
  ``error_feedback_allreduce`` over the data axis: each rank's reduced
  gradient equals the mean of the reference's per-rank dequantised
  values and its residual the reference's (1e-6: float32 arithmetic of
  one rounding each);
- ``compress_int8``: payload bit-equal, scale equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.distributed import fault_tolerance as jft
from repro.distributed import sharding_rules as jsr
from repro.models import get_model as jget_model
from repro.optim import compression as jcomp
from repro_torch.configs import get_config, reduce_config
from repro_torch.distributed import sharding_rules as sr
from repro_torch.distributed.fault_tolerance import ElasticPlan
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     run_ranks)
from repro_torch.launch.steps import mesh_specs
from repro_torch.models import param_shapes
from repro_torch.optim import compression
from repro_torch.tree import paths
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MESHES = ((2, 2), (16, 16))
MODES = ("tp", "ep", "ep_shmap")
LAYOUTS = ("fsdp_tp", "contract_tp")


def _jspecs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s.spec) for path, s in flat}


def _tspecs(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tspecs(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tspecs(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", list_archs())
def test_param_sharding_equals_reference(arch):
    """Every leaf's spec, whole width, 2 meshes x 2 layouts x 3 expert
    modes (the modes matter to the moe configs only; all are run)."""
    jcfg = jget_config(arch)
    jshapes = jax.eval_shape(
        lambda: jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg))
    tshapes = param_shapes(get_config(arch))
    for shape in MESHES:
        jm = AbstractMesh(shape, ("data", "model"))
        tm = make_production_mesh() if shape == (16, 16) else None
        if tm is None:
            from repro_torch.launch.mesh import MeshShape
            tm = MeshShape(("data", "model"), {"data": 2, "model": 2})
        for layout in LAYOUTS:
            for mode in MODES:
                want = _jspecs(jsr.param_sharding(jshapes, jm, moe_mode=mode,
                                                  layout=layout))
                got = _tspecs(sr.param_sharding(tshapes, tm, moe_mode=mode,
                                                layout=layout))
                assert got == want, (arch, shape, layout, mode)


def test_production_mesh_shapes():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model") and m.size == 256
    mp = make_production_mesh(multi_pod=True)
    assert mp.axis_names == ("pod", "data", "model") and mp.size == 512
    assert dict(mp.shape) == {"pod": 2, "data": 16, "model": 16}


def test_batch_sharding_equals_reference():
    """The leading dim over the data axes where it divides, replicated
    otherwise (and for a scalar)."""
    batch = {"tokens": np.zeros((8, 4), np.int32),
             "odd": np.zeros((3, 2), np.float32),
             "scalar": np.zeros((), np.float32)}
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))):
        jm = AbstractMesh(shape, names)
        from repro_torch.launch.mesh import MeshShape
        tm = MeshShape(names, dict(zip(names, shape)))
        want = jax.tree_util.tree_map(
            lambda s: tuple(s.spec), jsr.batch_sharding(batch, jm))
        got = sr.batch_sharding({k: torch.from_numpy(v)
                                 for k, v in batch.items()}, tm)
        assert got == want, (shape, got, want)


@pytest.mark.parametrize("n,mp,gb", [(256, 16, 256), (240, 16, 256),
                                     (250, 16, 256), (512, 16, 512)])
def test_elastic_plan_equals_reference(n, mp, gb):
    """The reference test's three cases (the TP width kept, node loss
    absorbed by the data axis, a non-dividing count refused) and a
    multi-pod plan."""
    kw = {"multi_pod_size": 2} if n == 512 else {}
    try:
        want = jft.ElasticPlan.plan(n_devices=n, model_parallel=mp,
                                    global_batch=gb, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            ElasticPlan.plan(n_devices=n, model_parallel=mp,
                             global_batch=gb, **kw)
        return
    got = ElasticPlan.plan(n_devices=n, model_parallel=mp, global_batch=gb,
                           **kw)
    assert (got.n_devices, got.mesh_shape, got.axis_names,
            got.global_batch) == (want.n_devices, want.mesh_shape,
                                  want.axis_names, want.global_batch)


@pytest.mark.parametrize("seed", [0, 1])
def test_compress_int8_equals_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(33, 17)) * 10 ** rng.uniform(-3, 2)).astype(
        np.float32)
    jq, js = jcomp.compress_int8(jnp.asarray(x))
    q, s = compression.compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        compression.decompress_int8(q, s).numpy(),
        np.asarray(jcomp.decompress_int8(jq, js)))


# -- on 4 gloo ranks ----------------------------------------------------------

def _grads(rank):
    rng = np.random.default_rng(100 + rank)
    return {"a": rng.normal(size=(5, 7)).astype(np.float32),
            "b": {"c": (rng.normal(size=(11,)) * 1e-3).astype(np.float32)}}


def _rank(group):
    """Round trips and the compressed all-reduce on one rank."""
    mesh = make_host_mesh(2, device=group.device)
    out = {"coords": dict(mesh.coords), "trips": {}}
    for arch in ("granite-3-2b", "deepseek-v2-236b"):
        cfg = reduce_config(get_config(arch))
        full = get_model_init(cfg)
        specs = mesh_specs(cfg, mesh)
        loc = sr.shard_tree(full, specs, mesh)
        back = sr.gather_tree(loc, specs, mesh)
        out["trips"][arch] = {
            "equal": all(torch.equal(a, b) for a, b in zip(
                paths(full).values(), paths(back).values())),
            "local_shapes": {k: tuple(v.shape)
                             for k, v in paths(loc).items()}}
    g = {k: v for k, v in _grads(mesh.index("data")).items()}
    tg = {"a": torch.from_numpy(g["a"]),
          "b": {"c": torch.from_numpy(g["b"]["c"])}}
    res = compression.init_residuals(tg)
    red1, res1 = compression.error_feedback_allreduce(
        tg, res, mesh.group("data"))
    red2, res2 = compression.error_feedback_allreduce(
        tg, res1, mesh.group("data"))
    out["ef"] = [({k: v.numpy() for k, v in paths(r).items()},
                  {k: v.numpy() for k, v in paths(e).items()})
                 for r, e in ((red1, res1), (red2, res2))]
    return out


def get_model_init(cfg):
    from repro_torch.models import get_model
    return get_model(cfg).init(torch.Generator().manual_seed(0), cfg)


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank, 4, "cpu")


def test_ranks_take_row_major_coordinates(ranks):
    """rank = data index x model_parallel + model index, as
    ``jax.make_mesh`` lays out its devices."""
    assert [r["coords"] for r in ranks] == [
        {"data": i, "model": j} for i in range(2) for j in range(2)]


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-v2-236b"])
def test_shard_gather_round_trip(ranks, arch):
    """Every rank's blocks gather back to the whole tree bit for bit, and
    each block has the spec's shape (the whole dim over the mesh axes
    it is split on)."""
    cfg = reduce_config(get_config(arch))
    specs = _tspecs(mesh_specs(cfg, _shape22()))
    full = {k: tuple(v.shape) for k, v in paths(param_shapes(cfg)).items()}
    for r in ranks:
        trip = r["trips"][arch]
        assert trip["equal"]
        for k, shp in trip["local_shapes"].items():
            want = tuple(n // (2 if ax else 1)
                         for n, ax in zip(full[k], specs[k] +
                                          (None,) * len(full[k])))
            assert shp == want, (k, shp, want)


def _shape22():
    from repro_torch.launch.mesh import MeshShape
    return MeshShape(("data", "model"), {"data": 2, "model": 2})


def test_error_feedback_allreduce_matches_reference(ranks):
    """Two steps of error feedback over the data axis: the reduced
    gradient is the mean of the reference's per-rank dequantised values
    (no collective in the reference's call: ``axis_name=None``), and
    each rank's residual is the reference's."""
    per = {}
    for d in range(2):
        g = jax.tree_util.tree_map(jnp.asarray, _grads(d))
        r0 = jcomp.init_residuals(g)
        d1, e1 = jcomp.error_feedback_allreduce(g, r0, axis_name=None)
        d2, e2 = jcomp.error_feedback_allreduce(g, e1, axis_name=None)
        per[d] = [(d1, e1), (d2, e2)]
    for r in ranks:
        d = r["coords"]["data"]
        for step, (red, res) in enumerate(r["ef"]):
            for key in ("a", "b/c"):
                parts = [per[i][step][0] for i in range(2)]
                leaf = (lambda t: t["a"]) if key == "a" else \
                    (lambda t: t["b"]["c"])
                want = (np.asarray(leaf(parts[0])) +
                        np.asarray(leaf(parts[1]))) / 2
                np.testing.assert_allclose(red[key], want, rtol=1e-6,
                                           atol=1e-6)
                np.testing.assert_allclose(
                    res[key], np.asarray(leaf(per[d][step][1])),
                    rtol=1e-6, atol=1e-6)
