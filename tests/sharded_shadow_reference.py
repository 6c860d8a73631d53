"""The JAX package's page-sharded engine with the shadow oracle on, the
reference ``tests/test_torch_sharded_shadow.py`` holds the port's
against, in ONE process over 2 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``, set before jax
is imported):

  PYTHONPATH=src python tests/sharded_shadow_reference.py weights.npz out.npz

It calibrates reduced granite-3-2b (``calibrate_lm`` on seeded batches,
every odd 128-column tile made statically dead so that the predictor
really skips), writes the weights and the MoR tree to ``weights.npz``
first (the test's ranks start on them), then serves ``TRACE`` with
``layout="paged-sharded"`` over a 2-shard page mesh at ``SHADOW_RATE``
in each of ``MODES`` and writes the metrics block's read (every lane)
and the tokens to ``out.npz``.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import numpy as np  # noqa: E402

ARCH = "granite-3-2b"
TRACE = [(3, 4), (9, 3), (5, 5), (12, 3), (7, 4), (4, 6)]
MODES = ("tiled", "kernel")
SHADOW_RATE = 0.25
SHARDS = 2
ENGINE_KW = dict(n_slots=2, max_len=24)


def dead_odd_tiles(layer):
    """Every odd 128-column tile statically dead (random-init weights
    alone leave every tile live)."""
    layer = {k: np.array(v) for k, v in layer.items()}
    dead = (np.arange(layer["m"].shape[-1]) // 128) % 2 == 1
    layer["bn_bias"] = np.where(dead, -1e3, layer["bn_bias"]).astype(
        np.float32)
    layer["enable"] = layer["enable"] | dead
    layer["is_proxy"] = layer["is_proxy"] & ~dead
    layer["proxy_slot"] = np.where(dead, -1, layer["proxy_slot"]).astype(
        np.int32)
    return layer


def requests(vocab):
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, p).astype(np.int32), g)
            for p, g in TRACE]


def flat_block(dm, prefix):
    """A metrics block's read -> {key: array}: the header as
    ``prefix/<field>``, the groups' lanes as ``prefix/groups/<g>/<k>``."""
    out = {}
    for k, v in dm.items():
        if k == "groups":
            for g, d in v.items():
                for kk, vv in d.items():
                    out[f"{prefix}/groups/{g}/{kk}"] = np.asarray(vv)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _save(path, arrays):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def main(wpath, path):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduce_config
    from repro.core.deploy import calibrate_lm
    from repro.launch.mesh import make_page_mesh
    from repro.models import get_model
    from repro.obs import Observability
    from repro.serving import Engine

    cfg = reduce_config(get_config(ARCH))
    api = get_model(cfg)
    params = api.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield {"tokens": jnp.asarray(
                rng.integers(0, cfg.vocab_size, (2, 32)), jnp.int32)}

    params, mor, _ = calibrate_lm(params, cfg, api.forward, batches(), 2)
    layer = dead_odd_tiles(jax.tree_util.tree_map(np.asarray,
                                                  mor["layers"]))
    weights = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    for p, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in p)
        weights[f"params/{key}"] = np.asarray(leaf)
    for k, v in layer.items():
        weights[f"mor/{k}"] = v
    _save(wpath, weights)
    jmor = {"layers": {k: jnp.asarray(v) for k, v in layer.items()}}
    reqs = requests(cfg.vocab_size)
    out = {}
    for mode in MODES:
        eng = Engine(cfg, params, mor=jmor, mor_mode=mode,
                     layout="paged-sharded", mesh=make_page_mesh(SHARDS),
                     obs=Observability(), shadow_rate=SHADOW_RATE,
                     **ENGINE_KW)
        toks = eng.run(list(reqs))
        for rid, t in toks.items():
            out[f"{mode}/tokens/{rid}"] = np.asarray(t, np.int32)
        out.update(flat_block(eng._last_device_metrics, mode))
    _save(path, out)
    print("SHARDED_SHADOW_REFERENCE_OK")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1], sys.argv[2])
