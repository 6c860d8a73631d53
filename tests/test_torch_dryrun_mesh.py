"""The dry run on the production mesh (``launch.dryrun --mesh
pod|multipod``: one rank of the mesh on torch's fake process group)
against the JAX package's shard shapes.

The fake group runs in processes of its own (``tests/
dry_mesh_probe.py`` and the CLI), never in a test worker; the
reference's shard shapes come from ONE JAX subprocess over 16 host
devices (``tests/dry_mesh_reference.py``, no lowering).  All three run
side by side.

- Every config, on a (4, 4) and a (2, 2, 2) mesh, both param layouts and
  the three expert modes: rank 0's and the last rank's parameter and
  batch bytes (``dryrun.rank_trees``) equal the sum of the reference's
  ``NamedSharding(mesh, spec).shard_shape`` over its ``param_sharding``
  and ``batch_sharding``, byte for byte.
- The CLI on the 256- and 512-rank meshes, with the mesh flags: the
  record's per-rank keys, its collective term split between NVLink and
  InfiniBand (every group of a 16-wide model row spans two 8-card
  nodes), and the decode cache leaves whose layout differs from the
  reference's heuristic named.
"""
import json
import os
import subprocess
import sys
import tempfile

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from dry_mesh_probe import LAYOUTS, MODES, SIZE_MESHES  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = {"pod": ["--arch", "granite-3-2b", "--shape", "decode_32k",
               "--mesh", "pod"],
       "multipod": ["--arch", "granite-3-2b", "--shape", "decode_32k",
                    "--mesh", "multipod", "--no-seq-parallel",
                    "--param-layout", "fsdp_tp", "--moe-sharding", "tp"],
       "deepseek": ["--arch", "deepseek-v2-236b", "--shape", "decode_32k",
                    "--mesh", "pod"]}


@pytest.fixture(scope="module")
def run():
    """-> (the probe's sizes, the reference's, {CLI case: record})."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        procs, outs = {}, {}
        for name, argv in (
                ("probe", [os.path.join(ROOT, "tests", "dry_mesh_probe.py"),
                           "sizes"]),
                ("reference", [os.path.join(ROOT, "tests",
                                            "dry_mesh_reference.py")])):
            outs[name] = os.path.join(tmp, f"{name}.json")
            procs[name] = argv + [outs[name]]
        for case, argv in CLI.items():
            outs[case] = os.path.join(tmp, f"{case}.json")
            procs[case] = ["-m", "repro_torch.launch.dryrun"] + argv + [
                "--out", outs[case]]
        running = {}
        try:
            for name, argv in procs.items():
                log = open(os.path.join(tmp, f"{name}.log"), "w")
                running[name] = (subprocess.Popen(
                    [sys.executable] + argv, env=env, stdout=log,
                    stderr=subprocess.STDOUT, cwd=tmp), log)
            for name, (p, log) in running.items():
                rc = p.wait(timeout=600)
                log.close()
                with open(os.path.join(tmp, f"{name}.log")) as f:
                    assert rc == 0, (name, f.read()[-3000:])
            res = {}
            for name, path in outs.items():
                with open(path) as f:
                    res[name] = json.load(f)
            yield res
        finally:
            for p, log in running.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()


@pytest.mark.parametrize("arch", list_archs())
def test_rank_bytes_equal_reference_shard_shapes(run, arch):
    """Parameter and batch bytes a rank, exact, on both meshes, both
    layouts, three expert modes, at both ends of the rank range."""
    got, want = run["probe"], run["reference"]
    n = 0
    for mname, mshape in SIZE_MESHES.items():
        world = 1
        for v in mshape.values():
            world *= v
        for layout in LAYOUTS:
            for mode in MODES:
                ref = want[f"{arch}|{mname}|{layout}|{mode}"]
                for rank in (0, world - 1):
                    key = f"{arch}|{mname}|{layout}|{mode}|{rank}"
                    assert got[key] == ref, (key, got[key], ref)
                    n += 1
    assert n == len(SIZE_MESHES) * len(LAYOUTS) * len(MODES) * 2


@pytest.mark.parametrize("case", list(CLI))
def test_dryrun_cli_on_the_production_mesh(run, case):
    """``python -m repro_torch.launch.dryrun ... --mesh pod|multipod``
    exits 0 without a card; its record is rank 0's: the chips, the
    argument and temp bytes, GiB a rank and the 80 GB fit, the roofline
    with its collective term split by node (the model rows span nodes:
    all on InfiniBand here) and the floor; the flags recorded."""
    rec = run[case]
    argv = CLI[case]
    assert rec["status"] == "ok", rec.get("traceback")
    multi = "multipod" in argv
    assert rec["n_chips"] == (512 if multi else 256)
    assert rec["mesh_shape"] == ({"pod": 2, "data": 16, "model": 16}
                                 if multi else {"data": 16, "model": 16})
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == rec["argument_bytes"] == sum(
        rec["argument_bytes_by_tree"].values())
    assert mem["temp_size_in_bytes"] == rec["peak_temp_bytes"] > 0
    assert rec["per_device_bytes"] == rec["argument_bytes"] + \
        rec["peak_temp_bytes"]
    assert rec["fits_80gb"] == (rec["per_device_bytes"] < 80 * 2 ** 30)
    rl = rec["roofline"]
    assert rl["wire_bytes_per_chip"] > 0
    assert rl["ib_wire_bytes_per_chip"] == rl["wire_bytes_per_chip"]
    assert rl["t_collective_s"] == pytest.approx(
        rl["t_collective_ib_s"] + rl["t_collective_nvlink_s"])
    assert rl["t_collective_ib_s"] > 0 and rl["floor_time_s"] > 0
    assert rec["collectives"]["ib_bytes_by_kind"] == \
        rec["collectives"]["bytes_by_kind"]
    assert rec["seq_parallel"] == ("--no-seq-parallel" not in argv)
    assert rec["layout"] == ("fsdp_tp" if "fsdp_tp" in argv
                             else "contract_tp" if case != "deepseek"
                             else "fsdp_tp")
    diff = rec["cache_layout_vs_reference"]
    if case == "deepseek":
        # the port's MLA latent cache is the data rank's whole rows; the
        # heuristic splits the sequence over model
        assert set(diff) == {"layers/c_kv", "layers/k_pe", "layers/pos"}
        assert diff["layers/c_kv"]["port"][2] == 16 * diff[
            "layers/c_kv"]["reference_heuristic"][2]
    elif multi:
        # the heuristic takes the tags' ring dim (dim 1) for a batch dim
        # and splits it over the 32 data-parallel ranks; the port's
        # tags follow their ring rows (over model, 16)
        assert set(diff) == {"layers/ring_lo", "layers/pos"}
        assert diff["layers/pos"]["port"][1] == 2 * diff["layers/pos"][
            "reference_heuristic"][1]
    else:
        # the sequence-sharded GQA ring agrees with the heuristic's
        # block (16 data ranks, 16 model ranks); its first row's tag is
        # the port's own
        assert set(diff) == {"layers/ring_lo"}
