"""The JAX package's outputs that ``tests/test_torch_mesh.py`` holds the
port's mesh against, computed in ONE process over 8 host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before jax
is imported) and saved to the ``.npz`` named on the command line:

  PYTHONPATH=src python tests/mesh_reference.py weights.npz out.npz

Every input comes from a numpy seed (the constants and ``inputs`` below,
imported by the test too); the weights are the reference's own inits,
written first to ``weights.npz`` (for ``repro_torch.convert``), so that
the test's ranks can start on them while the outputs are computed.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402

# shapes and seeds shared with the test
COLL_P = (2, 3, 4)
PSUM_P = (2, 4)
COLL_X, COLL_W = (16, 24), (24, 8)
MOE_E, MOE_K = 4, 2
MOE_CF = {"lossless": float(MOE_E) / MOE_K, "lossy": 0.5}
MOE_X = (8, 4)                      # (B, S) tokens of d_model each
MOE_MODES = ("dense", "exact", "tiled", "kernel")
MOE_CAP = 0.25
FSLICE_E = 6                        # E 6 over model 4: f slicing
DEC_B, DEC_H, DEC_HKV, DEC_D, DEC_LR, DEC_POS = 4, 4, 2, 16, 16, 13
DEC_WINDOWS = (0, 6)
DEC_MESHES = ((1, 2), (2, 2))
GEN_B, GEN_P, GEN_N = 8, 6, 8
TRAIN_B, TRAIN_S = 4, 16
TRAIN_LR = 1e-3


def moe_cfg(cfg_mod, E, cf):
    """Reduced deepseek with E experts, top-2, (4, 16) MoR tiles and the
    capacity factor ``cf``; ``cfg_mod`` the configs package."""
    c = cfg_mod.reduce_config(cfg_mod.get_config("deepseek-v2-236b"))
    return c.replace(n_experts=E, top_k=MOE_K, capacity_factor=cf,
                     n_shared_experts=0,
                     mor=type(c.mor)(enabled=True, relufied=True, tile_m=4,
                                     tile_n=16))


def truth_proxy(f, E, tile_n=16):
    """(E,)-stacked MoRLayer whose skips are the true zeros, every odd
    column tile dead (``tests/test_torch_moe.py::_truth_proxy``)."""
    idx = np.arange(f, dtype=np.int32)
    bias = np.where((idx // tile_n) % 2 == 1, -1e3, 0.0).astype(np.float32)
    one = {"m": np.zeros(f, np.float32), "b": np.full(f, -1.0, np.float32),
           "enable": np.ones(f, bool), "proxy_slot": idx,
           "is_proxy": np.zeros(f, bool), "perm": idx, "inv_perm": idx,
           "bn_scale": np.ones(f, np.float32), "bn_bias": bias}
    return {k: np.broadcast_to(v[None], (E,) + v.shape).copy()
            for k, v in one.items()}


def f32_cfg(cfg_mod, arch, **kw):
    c = cfg_mod.reduce_config(cfg_mod.get_config(arch))
    return c.replace(dtype="float32", param_dtype="float32", **kw)


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    out = {"coll_x": rng.normal(size=COLL_X).astype(np.float32),
           "coll_w": rng.normal(size=COLL_W).astype(np.float32),
           "dec_q": rng.normal(size=(DEC_B, 1, DEC_H, DEC_D)
                               ).astype(np.float32),
           "dec_k": rng.normal(size=(DEC_B, DEC_LR, DEC_HKV, DEC_D)
                               ).astype(np.float32),
           "dec_v": rng.normal(size=(DEC_B, DEC_LR, DEC_HKV, DEC_D)
                               ).astype(np.float32)}
    tags = np.arange(DEC_LR, dtype=np.int32)
    tags[rng.random(DEC_LR) < 0.2] = -1
    tags[DEC_POS % DEC_LR] = DEC_POS
    out["dec_pos"] = tags
    return out


def train_batches(vocab):
    """The two train steps' global batches."""
    rng = np.random.default_rng(7)
    return [{k: rng.integers(0, vocab, (TRAIN_B, TRAIN_S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(2)]


def _flat(prefix, tree, out):
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[f"{prefix}/{key}"] = np.asarray(leaf)


def _save(path, arrays):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def main(wpath, path):
    import jax
    import jax.numpy as jnp
    from repro import configs as jc
    from repro.core.executor import MoRExecutionPlan
    from repro.distributed.collectives import (ag_matmul_overlapped,
                                               psum_scatter_matmul)
    from repro.distributed.sharding_rules import activation_context
    from repro.launch import steps as jsteps
    from repro.models import get_model
    from repro.models.layers import attention as jattn
    from repro.models.layers import moe as jmoe
    from repro.optim import OptConfig, adamw_init, adamw_update
    from repro.optim.schedules import cosine_schedule

    out = {}
    inp = inputs()
    devs = jax.devices()
    weights = {}
    moe_params = {}
    for E, tag in ((MOE_E, "a2a"), (FSLICE_E, "fslice")):
        base = moe_cfg(jc, E, MOE_CF["lossless"])
        moe_params[tag] = jmoe.moe_init(jax.random.PRNGKey(E), base)
        _flat(f"{tag}/params", moe_params[tag], weights)
    gcfg = f32_cfg(jc, "granite-3-2b")
    gen_params = get_model(gcfg).init(jax.random.PRNGKey(0), gcfg)
    _flat("granite/params", gen_params, weights)
    train_cfgs, train_params = {}, {}
    for arch in ("granite-3-2b", "deepseek-v2-236b"):
        kw = {}
        if arch == "deepseek-v2-236b":
            base = f32_cfg(jc, arch)
            kw = {"capacity_factor": float(base.n_experts) / base.top_k}
        train_cfgs[arch] = f32_cfg(jc, arch, **kw)
        train_params[arch] = get_model(train_cfgs[arch]).init(
            jax.random.PRNGKey(1), train_cfgs[arch])
        _flat(f"train/{arch}/params0", train_params[arch], weights)
    _save(wpath, weights)
    # -- the explicit-schedule matmuls
    x, w = jnp.asarray(inp["coll_x"]), jnp.asarray(inp["coll_w"])
    for p in COLL_P:
        mesh = jax.make_mesh((p,), ("model",), devices=devs[:p])
        out[f"ag/{p}"] = np.asarray(ag_matmul_overlapped(x, w, mesh))
    for p in PSUM_P:
        mesh = jax.make_mesh((p,), ("model",), devices=devs[:p])
        out[f"psum/{p}"] = np.asarray(psum_scatter_matmul(x, w, mesh))

    # -- moe_apply_a2a on (data 2, model 2), and f slicing on (1, 4)
    mesh22 = jax.make_mesh((2, 2), ("data", "model"), devices=devs[:4])
    for E, tag, mesh in ((MOE_E, "a2a", mesh22),
                         (FSLICE_E, "fslice",
                          jax.make_mesh((1, 4), ("data", "model"),
                                        devices=devs[:4]))):
        base = moe_cfg(jc, E, MOE_CF["lossless"]).replace(
            expert_sharding="ep_shmap")
        params = moe_params[tag]
        x = np.random.default_rng(E).normal(
            size=MOE_X + (base.d_model,)).astype(np.float32)
        out[f"{tag}/x"] = x
        em = jax.tree_util.tree_map(jnp.asarray,
                                    truth_proxy(base.moe_d_ff, E))
        dp = mesh.shape["data"]
        for cf_name, cf in MOE_CF.items():
            cfg = base.replace(capacity_factor=cf)
            modes = MOE_MODES if tag == "a2a" else ("dense",)
            with activation_context(mesh):
                for mode in modes:
                    mor = None if mode == "dense" else {"experts": em}
                    fn = jax.jit(lambda p_, x_, m_, cfg=cfg, mode=mode:
                                 jmoe.moe_apply_a2a(p_, cfg, x_, mor=m_,
                                                    mor_mode=mode)[0])
                    out[f"{tag}/{cf_name}/{mode}/y"] = np.asarray(
                        fn(params, jnp.asarray(x), mor))
                if tag == "a2a":
                    fn = jax.jit(lambda p_, x_, e_, cfg=cfg:
                                 jmoe.moe_apply_a2a(p_, cfg, x_, mor={
                                     "experts": MoRExecutionPlan(
                                         e_, mode="kernel", tile_m=4,
                                         tile_n=16, cap_live=jnp.full(
                                             (E,), MOE_CAP,
                                             jnp.float32))})[0])
                    out[f"{tag}/{cf_name}/capped/y"] = np.asarray(
                        fn(params, jnp.asarray(x), em))
            # each data shard's routing and slots at C_loc
            xs = x.reshape(dp, -1, base.d_model)
            T_loc = xs.shape[1]
            C_loc = max(int(cf * T_loc * MOE_K / E), 1)
            for i in range(dp):
                logits = jnp.asarray(xs[i]) @ params["router"]
                probs = jax.nn.softmax(logits.astype(jnp.float32), -1)
                _, top = jax.lax.top_k(probs, MOE_K)
                out[f"{tag}/{cf_name}/slot/{i}"] = np.asarray(
                    jmoe._dispatch_indices(top, E, C_loc))
                out[f"{tag}/{cf_name}/counts/{i}"] = np.asarray(
                    jnp.bincount(top.reshape(-1), length=E))

    # -- the decode's reference: jax 0.9.0 refuses the reference's
    # ``_tp_flash_decode`` under an explicit mesh (its output reshape of a
    # data-sharded batch raises ShardingTypeError), so the sequence-
    # sharded decode is held to the single-device attention
    q, k, v = (jnp.asarray(inp[n]) for n in ("dec_q", "dec_k", "dec_v"))
    kv_pos = jnp.asarray(inp["dec_pos"])
    # the single-device attention over the same ring
    for window in DEC_WINDOWS:
        out[f"dec/single/{window}"] = np.asarray(jattn.attend(
            q, k, v, jnp.full((1,), DEC_POS, jnp.int32), kv_pos,
            causal=True, window=window))

    # -- greedy tokens of reduced float32 granite, one device
    cfg = gcfg
    api = get_model(cfg)
    params = gen_params
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (GEN_B, GEN_P)).astype(np.int32)
    out["gen/prompts"] = prompts
    cache = api.cache_init(cfg, GEN_B, GEN_P + GEN_N + 2, jnp.float32)
    logits, cache = api.prefill(params, cfg, jnp.asarray(prompts), cache)
    toks = [jnp.argmax(logits, -1).astype(jnp.int32)]
    for _ in range(GEN_N - 1):
        logits, cache = api.decode_step(params, cfg, toks[-1][:, None],
                                        cache)
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    out["gen/tokens"] = np.asarray(jnp.stack(toks, 1))

    # -- two train steps, no activation_context (jax 0.9.0 cannot train
    # under it); data parallelism as the mean over the data shards'
    # gradients (each shard's own MoE capacity and load-balance loss)
    opt_cfg = OptConfig(lr=TRAIN_LR, moment_dtype="float32")
    for arch, dps in (("granite-3-2b", (1,)), ("deepseek-v2-236b", (1, 2))):
        cfg, params0 = train_cfgs[arch], train_params[arch]
        loss_fn = jsteps.make_loss_fn(cfg)
        vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        batches = train_batches(cfg.vocab_size)
        for dp in dps:
            params, opt = params0, adamw_init(params0, opt_cfg)
            for s, b in enumerate(batches):
                parts = [{k_: jnp.asarray(a.reshape(dp, -1, TRAIN_S)[i])
                          for k_, a in b.items()} for i in range(dp)]
                res = [vg(params, p) for p in parts]
                loss = sum(r[0][0] for r in res) / dp
                grads = jax.tree_util.tree_map(
                    lambda *g: sum(g) / dp, *[r[1] for r in res])
                lr_scale = cosine_schedule(opt["step"], 10000, 100)
                params, opt, m = adamw_update(params, grads, opt, opt_cfg,
                                              lr_scale)
                out[f"train/{arch}/dp{dp}/loss/{s}"] = np.asarray(loss)
                out[f"train/{arch}/dp{dp}/gnorm/{s}"] = np.asarray(
                    m["grad_norm"])
            _flat(f"train/{arch}/dp{dp}/params", params, out)
    _save(path, out)
    print("MESH_REFERENCE_OK")


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    main(sys.argv[1], sys.argv[2])
