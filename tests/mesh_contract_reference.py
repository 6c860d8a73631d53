"""The JAX package's single-device outputs that
``tests/test_torch_mesh_contract.py`` holds the port's ``"contract_tp"``
meshes against, for the archs named (the test runs two such processes,
each over half of ``ARCHS``), saved to the ``.npz`` named on the command
line:

  PYTHONPATH=src python tests/mesh_contract_reference.py \
      weights.npz out.npz [arch ...]

(the archs of ``ARCHS`` named, by default all of them).

The weights are the reference's own inits of the reduced float32
configs (``contract_cfg``, PRNGKey(1)), written first to
``weights.npz`` (one leaf a '/'-joined key path under the arch's name),
which the test's ranks wait for; the two train steps are then
``mesh_families_reference.two_steps``' (``make_loss_fn`` +
``jax.value_and_grad`` + ``adamw_update``, no ``activation_context``).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from dry_mesh_probe import count_cfg  # noqa: E402
from mesh_families_reference import two_steps  # noqa: E402
from mesh_reference import _flat, _save  # noqa: E402

# the configs whose param_layout is "contract_tp", reduced; "+kv1" is
# granite with one kv head, which does not divide over model 2
ARCHS = ("granite-3-2b", "granite-3-2b+kv1", "qwen2-7b", "zamba2-7b",
         "hubert-xlarge", "mixtral-8x7b")


def contract_cfg(configs, name):
    """The reduced float32 config both sides run (``count_cfg``), with
    ``n_kv_heads=1`` for a "+kv1" name."""
    arch, _, variant = name.partition("+")
    c = count_cfg(configs, arch)
    return c.replace(n_kv_heads=1) if variant == "kv1" else c


def main(wpath, path, archs=ARCHS):
    import jax
    from repro import configs as jc
    from repro.models import get_model

    cfgs = {a: contract_cfg(jc, a) for a in archs}
    params0 = {a: jax.jit(lambda k, c=c: get_model(c).init(k, c))(
        jax.random.PRNGKey(1)) for a, c in cfgs.items()}
    weights = {}
    for a, p in params0.items():
        _flat(a, p, weights)
    _save(wpath, weights)
    two_steps(cfgs, params0, path)


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1], sys.argv[2], tuple(sys.argv[3:]) or ARCHS)
