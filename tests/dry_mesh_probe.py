"""The port's dry run on torch's fake process group, in a process of its
own (the fake group may not outlive a test worker's file): one task,
its results written as JSON to the path named on the command line.

  PYTHONPATH=src python tests/dry_mesh_probe.py sizes out.json
  PYTHONPATH=src python tests/dry_mesh_probe.py counts out.json
  PYTHONPATH=src python tests/dry_mesh_probe.py families out.json

``sizes``: rank 0's and the last rank's parameter and batch bytes under
``dryrun.rank_trees`` for every config, on the ``SIZE_MESHES``, both
param layouts and the three expert modes (``train_4k``'s batch).
``counts``: reduced float32 granite-3-2b and deepseek-v2-236b on a dry
(2, 2) mesh modelling gloo's collectives: each ``COUNT_CELLS`` step's
collective counts and bytes by kind, op_cost's FLOPs and its peak
temp, rank by rank, sequence parallelism on and off; granite under
"contract_tp" too (``CONTRACT_COUNT_ARCHS``).
``families``: the same for the tensor-parallel MLA, RWKV6 and Mamba2
families (``FAMILY_ARCHS``) on a dry (1, 2) mesh.
"""
import json
import os
import sys

SIZE_MESHES = {"4x4": {"data": 4, "model": 4},
               "2x2x2": {"pod": 2, "data": 2, "model": 2}}
LAYOUTS = ("fsdp_tp", "contract_tp")
MODES = ("tp", "ep", "ep_shmap")
COUNT_ARCHS = ("granite-3-2b", "deepseek-v2-236b")
# the archs ``counts`` also runs under "contract_tp" (its splits moved
# onto the forms' dims: ``sharding_rules.use``), keyed with a
# "|contract_tp" suffix
CONTRACT_COUNT_ARCHS = ("granite-3-2b",)
COUNT_MESH = {"data": 2, "model": 2}
FAMILY_ARCHS = ("deepseek-v2-236b", "rwkv6-3b", "zamba2-7b")
FAMILY_MESH = {"data": 1, "model": 2}
# (name, seq_len, global_batch, kind): S and B divide the (2, 2) mesh
COUNT_CELLS = (("train_16", 16, 4, "train"), ("prefill_16", 16, 4,
                                              "prefill"))


def count_cfg(configs, arch):
    """The reduced float32 config both sides run (deepseek at a lossless
    capacity, as ``tests/mesh_reference.py`` trains it)."""
    c = configs.reduce_config(configs.get_config(arch)).replace(
        dtype="float32", param_dtype="float32")
    if arch == "deepseek-v2-236b":
        c = c.replace(capacity_factor=float(c.n_experts) / c.top_k)
    return c


def sizes():
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dry_mesh
    from repro_torch.models import param_shapes
    tree_bytes = dryrun.tree_bytes
    shape = configs.SHAPES["train_4k"]
    out = {}
    for mname, mshape in SIZE_MESHES.items():
        world = 1
        for v in mshape.values():
            world *= v
        for rank in (0, world - 1):
            with dry_mesh(mshape, rank=rank) as mesh:
                for arch in configs.list_archs():
                    base = configs.get_config(arch)
                    params = param_shapes(base)
                    data = configs.input_specs(base, shape, device="meta")
                    for layout in LAYOUTS:
                        for mode in MODES:
                            cfg = base.replace(expert_sharding=mode)
                            p, b = dryrun.rank_trees(cfg, mesh, layout,
                                                     params, data)
                            out[f"{arch}|{mname}|{layout}|{mode}|{rank}"] = [
                                tree_bytes(p), tree_bytes(b)]
    return out


def counts(archs=COUNT_ARCHS, shape=COUNT_MESH):
    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import collectives as co
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import dry_mesh
    out = {}
    for rank in range(shape["data"] * shape["model"]):
        with dry_mesh(shape, rank=rank, backend="gloo") as mesh:
            for arch, layout in [(a, "fsdp_tp") for a in archs] + [
                    (a, "contract_tp") for a in archs
                    if a in CONTRACT_COUNT_ARCHS]:
                cfg = count_cfg(configs, arch)
                tag = "" if layout == "fsdp_tp" else "|" + layout
                for name, S, B, kind in COUNT_CELLS:
                    for sp in (False, True):
                        co.reset_counts()
                        c = dryrun.count_cell(
                            cfg, ShapeSpec(name, S, B, kind),
                            on=dryrun.MeshArgs(mesh, sp, layout))
                        out[f"{arch}|{name}|{sp}|{rank}{tag}"] = {
                            "counts": dict(co.counts),
                            "nbytes": dict(co.nbytes),
                            "flops": c.counter.flops,
                            "peak_temp": c.counter.peak_live_bytes,
                            "args": c.args}
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    task, path = sys.argv[1], sys.argv[2]
    res = {"sizes": sizes, "counts": counts,
           "families": lambda: counts(FAMILY_ARCHS, FAMILY_MESH)}[task]()
    with open(path + ".tmp", "w") as f:
        json.dump(res, f)
    os.replace(path + ".tmp", path)
    print("DRY_MESH_PROBE_OK")
