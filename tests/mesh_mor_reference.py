"""The JAX package's single-device tiled forwards that
``tests/test_torch_mesh_mor.py`` holds the port's MoR-active mesh runs
against:

  PYTHONPATH=src python tests/mesh_mor_reference.py in.npz out.npz

``in.npz`` holds, for each name in ``names``, the port's calibrated
reduced config (its arch under ``<name>/arch``, ``d_ff`` under
``<name>/d_ff``): its permuted weights under ``<name>/params/``, its
MoR tree under ``<name>/mor/`` (``layers/`` or hubert's and rwkv6's,
``shared/`` zamba2's), its batch under ``<name>/batch/`` (``tokens`` or
``frames``), and the plan's ``mode``.  The reference runs ``forward``
of each with that plan and writes its float32 outputs (the logits, or
hubert's hidden states) to ``out.npz`` under the name.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from mesh_reference import _save  # noqa: E402


def _nest(flat, prefix):
    import jax.numpy as jnp
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return out


def main(src, dst):
    from repro.configs import get_config, reduce_config
    from repro.models import get_model

    with np.load(src) as f:
        flat = {k: f[k] for k in f.files}
    out = {}
    for name in flat["names"]:
        name = str(name)
        cfg = reduce_config(get_config(str(flat[f"{name}/arch"]))).replace(
            d_ff=int(flat[f"{name}/d_ff"]))
        y, _ = get_model(cfg).forward(
            _nest(flat, f"{name}/params/"), cfg,
            _nest(flat, f"{name}/batch/"), mor=_nest(flat, f"{name}/mor/"),
            mor_mode=str(flat["mode"]))
        out[name] = np.asarray(y, np.float32)
    _save(dst, out)
    print("MESH_MOR_REFERENCE_OK")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1], sys.argv[2])
