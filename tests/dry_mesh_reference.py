"""The JAX package's per-device shard shapes that
``tests/test_torch_dryrun_mesh.py`` holds the port's dry run against,
in ONE process over 16 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=16``, set before jax
is imported); no lowering (the reference's train step under an explicit
mesh does not compile on jax 0.9.0):

  PYTHONPATH=src python tests/dry_mesh_reference.py out.json

For every config, on each of ``dry_mesh_probe.SIZE_MESHES``, both param
layouts and the three expert modes: the bytes of one device's shards,
``NamedSharding(mesh, spec).shard_shape(shape)`` summed over the
reference's ``param_sharding`` of its params and its ``batch_sharding``
of ``input_specs(cfg, SHAPES["train_4k"])``.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"


def main(path):
    import jax
    import numpy as np
    from jax.sharding import NamedSharding
    from repro.configs import SHAPES, get_config, input_specs, list_archs
    from repro.distributed import sharding_rules as jsr
    from repro.models import get_model
    from dry_mesh_probe import LAYOUTS, MODES, SIZE_MESHES

    def shard_bytes(shapes, shardings):
        flat_s = jax.tree_util.tree_leaves(shapes)
        flat_sh = jax.tree_util.tree_leaves(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
        assert len(flat_s) == len(flat_sh)
        return sum(int(np.prod(sh.shard_shape(s.shape), dtype=np.int64))
                   * np.dtype(s.dtype).itemsize
                   for s, sh in zip(flat_s, flat_sh))

    devs = jax.devices()
    out = {}
    for mname, mshape in SIZE_MESHES.items():
        n = int(np.prod(list(mshape.values())))
        mesh = jax.make_mesh(tuple(mshape.values()), tuple(mshape),
                             devices=devs[:n])
        for arch in list_archs():
            cfg = get_config(arch)
            shapes = jax.eval_shape(
                lambda: get_model(cfg).init(jax.random.PRNGKey(0), cfg))
            data = input_specs(cfg, SHAPES["train_4k"])
            b = shard_bytes(data, jsr.batch_sharding(data, mesh))
            for layout in LAYOUTS:
                for mode in MODES:
                    p = shard_bytes(shapes, jsr.param_sharding(
                        shapes, mesh, moe_mode=mode, layout=layout))
                    out[f"{arch}|{mname}|{layout}|{mode}"] = [p, b]
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
    print("DRY_MESH_REFERENCE_OK")


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "..", "src"))
    sys.path.insert(0, here)
    main(sys.argv[1])
