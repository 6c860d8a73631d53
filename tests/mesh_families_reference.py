"""The JAX package's single-device outputs that
``tests/test_torch_mesh_families.py`` holds the port's tensor-parallel
MLA, RWKV6, Mamba2 and shared-block meshes against, computed in ONE
process and saved to the ``.npz`` named on the command line:

  PYTHONPATH=src python tests/mesh_families_reference.py weights.npz out.npz

The weights are the reference's own inits of the reduced float32
configs (``dry_mesh_probe.count_cfg``, PRNGKey(1)), written first to
``weights.npz`` so that the test's ranks can start on them while the
two train steps run (``make_loss_fn`` + ``jax.value_and_grad`` +
``adamw_update``, no ``activation_context``: jax 0.9.0 cannot train
under it); data parallelism as the mean over the data shards'
gradients (deepseek's expert capacity and load-balance loss are each
shard's).  Every input comes from a numpy seed (``train_batches``,
imported by the test too).
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from dry_mesh_probe import count_cfg  # noqa: E402
from mesh_reference import (TRAIN_B, TRAIN_LR, TRAIN_S, _flat,  # noqa: E402
                            _save)

ARCHS = ("deepseek-v2-236b", "rwkv6-3b", "zamba2-7b", "hubert-xlarge")
# the data-parallel widths each arch's reference runs at: (1, 2) and
# (2, 2) meshes; only deepseek's loss depends on the shards (its
# per-shard expert capacity), the others' mean over shards is the mean
DPS = {"deepseek-v2-236b": (1, 2)}


def family_cfg(configs, arch):
    """The reduced float32 config both sides run: ``count_cfg``, zamba2
    as reduced (5 layers, 4 SSM heads, 4 attention heads), hubert under
    ``"fsdp_tp"`` (its 4 heads over model 2)."""
    return count_cfg(configs, arch)


def train_batches(cfg):
    """The two train steps' global batches: tokens, or hubert's frames,
    and labels."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(2):
        b = {"labels": rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)
                                    ).astype(np.int32)}
        if cfg.frontend == "audio_stub":
            b["frames"] = rng.normal(size=(TRAIN_B, TRAIN_S, cfg.d_model)
                                     ).astype(np.float32)
        else:
            b["tokens"] = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)
                                       ).astype(np.int32)
        out.append(b)
    return out


def main(wpath, path):
    import jax
    from repro import configs as jc
    from repro.models import get_model

    cfgs = {a: family_cfg(jc, a) for a in ARCHS}
    params0 = {a: jax.jit(lambda k, c=c: get_model(c).init(k, c))(
        jax.random.PRNGKey(1)) for a, c in cfgs.items()}
    weights = {}
    for a, p in params0.items():
        _flat(a, p, weights)
    _save(wpath, weights)
    two_steps(cfgs, params0, path)


def two_steps(cfgs, params0, path):
    """The reference's two single-device steps of each ``cfgs[arch]``
    from ``params0[arch]``, at each data-parallel width of ``DPS``, to
    ``path``."""
    import jax
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro.optim import OptConfig, adamw_init, adamw_update
    from repro.optim.schedules import cosine_schedule

    out = {}
    opt_cfg = OptConfig(lr=TRAIN_LR, moment_dtype="float32")
    update = jax.jit(lambda p, g, o: adamw_update(
        p, g, o, opt_cfg, cosine_schedule(o["step"], 10000, 100)))
    for arch, cfg in cfgs.items():
        vg = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(cfg),
                                        has_aux=True))
        for dp in DPS.get(arch, (1,)):
            params, opt = params0[arch], adamw_init(params0[arch], opt_cfg)
            for s, b in enumerate(train_batches(cfg)):
                parts = [{k: jnp.asarray(a.reshape(dp, -1, *a.shape[1:])[i])
                          for k, a in b.items()} for i in range(dp)]
                res = [vg(params, p) for p in parts]
                loss = sum(r[0][0] for r in res) / dp
                grads = jax.tree_util.tree_map(lambda *g: sum(g) / dp,
                                               *[r[1] for r in res])
                params, opt, m = update(params, grads, opt)
                out[f"{arch}/dp{dp}/loss/{s}"] = np.asarray(loss)
                out[f"{arch}/dp{dp}/gnorm/{s}"] = np.asarray(m["grad_norm"])
                _flat(f"{arch}/dp{dp}/grads/{s}", grads, out)
            _flat(f"{arch}/dp{dp}/params", params, out)
    _save(path, out)
    print("MESH_FAMILIES_REFERENCE_OK")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1], sys.argv[2])
