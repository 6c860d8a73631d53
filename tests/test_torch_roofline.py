"""The port's measurement tooling against the JAX package and against
counts worked out by hand: ``launch/op_cost.py`` (the counterpart of
``repro.launch.hlo_cost``), the kernels' ``work()``, ``launch/roofline.py``
at the H100's rates, ``launch/timing.py``.

Exact integer counts are asserted equal.  ``op_cost``'s FLOPs on a
reduced granite forward and backward are held to the reference's
``hlo_cost.analyze`` of ``jax.value_and_grad(make_loss_fn(cfg))``,
compiled without ``activation_context``, within 2%: the reference
counts 314,703,872 there, 0.04% above the analytic 3 x forward products
that the port counts exactly (the reference's HLO adds a few small
dots).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduce_config as jreduce_config
from repro.launch import hlo_cost
from repro.launch import roofline as jroofline
from repro.launch import steps as jsteps
from repro.launch.dryrun_all import ARCHS as JARCHS
from repro.launch.dryrun_all import SHAPE_NAMES as JSHAPE_NAMES
from repro_torch import convert
from repro_torch.configs import SHAPES, get_config, reduce_config
from repro_torch.core.deploy import calibrate_lm
from repro_torch.distributed import collectives
from repro_torch.kernels import binary_dot as bd
from repro_torch.kernels import binary_dot_packed as bdp
from repro_torch.kernels import gather_matmul as gm
from repro_torch.kernels import masked_matmul as mm
from repro_torch.kernels import mor_predict as mp
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import dryrun_all, op_cost, roofline, steps, timing
from repro_torch.models import get_model
from repro_torch.serving.engine import Engine
from repro_torch.tree import leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FLOP_RTOL = 0.02
B, S = 4, 32


def _tanh_scan(a, ws):
    """The reference test's scanned matmul: a Python loop over the
    stack's layers, one slice a trip."""
    for w in ws.unbind(0):
        a = torch.tanh(a @ w)
    return a


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_trips_counted_exactly(device):
    """``test_system.py``'s scan trip count: a 10-trip loop counts 10x
    one trip's products."""
    a = torch.zeros((128, 256), device=device)
    ws = torch.zeros((10, 256, 256), device=device)
    res = op_cost.analyze(_tanh_scan, a, ws)
    assert res["flops"] == 10 * 2 * 128 * 256 * 256
    assert res["by_op"]["mm"]["calls"] == 10


def test_weight_stream_costs_one_pass_over_the_weights():
    """``test_system.py``'s weight streaming: a stack of L layers taken
    one slice a trip moves between one and six passes over the weights,
    not L x the stack."""
    L, D = 20, 128
    a = torch.zeros((8, D), device="meta")
    ws = torch.zeros((L, D, D), device="meta")
    res = op_cost.analyze(_tanh_scan, a, ws)
    w_bytes = L * D * D * 4
    assert w_bytes < res["bytes"] < 6 * w_bytes


def test_views_cost_nothing_and_copies_count():
    x = torch.zeros((64, 32), device="meta")

    def views():
        return x.t().reshape(32, 64)[1:].unsqueeze(0).expand(2, 31, 64)
    assert op_cost.analyze(views)["bytes"] == 0

    def copies():
        y = x.to(torch.bfloat16)          # read 8 KB, write 4 KB
        y.add_(1.0)                        # read and write 4 KB
        return y.clone()                   # read and write 4 KB
    n = 64 * 32
    assert op_cost.analyze(copies)["bytes"] == (4 * n + 2 * n) + \
        (2 * n + 2 * n) + (2 * n + 2 * n)


def test_peak_live_bytes_follows_frees():
    """Storages the step allocates are live until Python frees them;
    arguments are not counted."""
    x = torch.zeros((1024,), device="meta")        # 4 KB, an argument

    def step():
        a = x * 2                                   # 4 KB live
        b = a + 1                                   # 8 KB live
        del a
        c = b.view(32, 32) * 3                      # 8 KB: a freed
        return c.sum()                              # + 4 bytes
    with op_cost.OpCounter() as counter:
        step()
    assert counter.peak_live_bytes == 8192 + 4


def _granite_loss_grad(cfg, params, batch):
    loss_fn = steps.make_loss_fn(cfg)
    flat = leaves(params)

    def fb():
        for t in flat:
            t.requires_grad_(True)
        loss, _ = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, flat)
        for t in flat:
            t.requires_grad_(False)
        return grads
    return fb


def _granite_both():
    jcfg = jreduce_config(jget_config("granite-3-2b"))
    cfg = reduce_config(get_config("granite-3-2b"))
    from repro.models import get_model as jget_model
    jp = jget_model(jcfg).init(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tp = convert.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tb = {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(lab)}
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    return jcfg, jp, jb, cfg, tp, tb


def _analytic_train_flops(cfg):
    """3 x the forward's products (forward, and two products a product
    in the backward): QKV / O, the SwiGLU FFN, the (S, S) scores and
    p.v, the head."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = B * S
    per_layer = 2 * T * (d * h * hd + 2 * d * hkv * hd + h * hd * d
                         + 3 * d * cfg.d_ff) + 2 * 2 * B * h * S * S * hd
    return 3 * (cfg.n_layers * per_layer + 2 * T * d * cfg.vocab_size)


def test_flops_match_flop_counter_mode_and_hlo_cost():
    """A reduced granite forward and backward: ``op_cost`` equals
    PyTorch's own ``FlopCounterMode`` and the analytic count, and is
    within 2% of the reference's ``hlo_cost`` on the compiled
    ``value_and_grad`` of the same loss."""
    jcfg, jp, jb, cfg, tp, tb = _granite_both()
    fb = _granite_loss_grad(cfg, tp, tb)
    res = op_cost.analyze(fb)
    with FlopCounterMode(display=False) as fc:
        fb()
    assert res["flops"] == fc.get_total_flops()
    assert res["flops"] == _analytic_train_flops(cfg)
    comp = jax.jit(jax.value_and_grad(jsteps.make_loss_fn(jcfg),
                                      has_aux=True)).lower(jp, jb).compile()
    ref = hlo_cost.analyze(comp.as_text())
    assert abs(res["flops"] - ref["flops"]) <= FLOP_RTOL * ref["flops"], \
        (res["flops"], ref["flops"])


def test_remat_recomputation_is_counted():
    """nothing_saveable recomputes every block's forward in the
    backward, but for its last product: the down projection's result is
    needed by nothing in the backward, and the recomputation stops once
    it has rebuilt what is (``torch.utils.checkpoint``'s early stop)."""
    _, _, _, cfg, tp, tb = _granite_both()
    base = op_cost.analyze(_granite_loss_grad(cfg, tp, tb))["flops"]
    rcfg = cfg.replace(remat="nothing_saveable")
    remat = op_cost.analyze(_granite_loss_grad(rcfg, tp, tb))["flops"]
    head = 2 * B * S * cfg.d_model * cfg.vocab_size
    down = 2 * B * S * cfg.d_ff * cfg.d_model
    per_layer = (base / 3 - head) / cfg.n_layers
    assert remat == base + cfg.n_layers * (per_layer - down)


# -- the kernels' work() on hand-made masks ----------------------------------

def test_mor_tile_mask_work_by_hand():
    """Expert 0 has live rows 0-4 (one 8-row block), expert 1 none: one
    busy expert's weight and coef table, one block of x's rows, every
    proxy state, the tile bits out; 8 rows x 2 K N sign products."""
    E, M, K, N = 2, 16, 16, 256
    x = torch.zeros((E, M, K), dtype=torch.bfloat16)
    w = torch.zeros((E, K, N), dtype=torch.bfloat16)
    coef = torch.zeros((E, 6, N))
    pn = torch.full((E, M, N), 2, dtype=torch.int8)
    pn[0, :5] = 0
    pn[0, 3, 7] = 2                     # a row live through one column
    nbytes, ops, kind = mp.work(x, w, coef, pn)
    assert nbytes == (E * M * N + (K * N * 2 + 6 * N * 4) + 8 * K * 2
                      + E * 2 * 2 * 4)
    assert ops == 8 * 2 * K * N and kind == "int8"
    # one FFN, every row live, a float32 residual: the whole of x
    x2, w2 = torch.zeros((M, K)), torch.zeros((K, N))
    pn2 = torch.zeros((M, N), dtype=torch.int8)
    res = torch.zeros((M, N))
    nbytes, ops, _ = mp.work(x2, w2, coef[0], pn2, res)
    assert nbytes == (M * N + K * N * 4 + 6 * N * 4 + M * K * 4 + M * N * 4
                      + 2 * 2 * 4)
    assert ops == 2 * M * K * N


def test_gather_matmul_work_by_hand():
    """Mask [[1, 0, 1], [0, 1, 1]] at capacity 3 keeps (0, 0), (0, 2),
    (1, 1): three weight strips, both row blocks, the whole output."""
    M, K, N = 16, 32, 384
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    w = torch.zeros((K, N), dtype=torch.bfloat16)
    mask = torch.tensor([[1, 0, 1], [0, 1, 1]], dtype=torch.bool)
    nbytes, ops, kind = gm.work(x, w, mask, capacity=3)
    assert nbytes == 3 * K * 128 * 2 + 2 * 8 * K * 2 + M * N * 2
    assert ops == 3 * 2 * 8 * 128 * K and kind == "bf16"
    # the expert grid with per-expert budgets: expert 0 keeps 1 tile,
    # expert 1 its 2 live ones; float32
    xe = torch.zeros((2, M, K))
    we = torch.zeros((2, K, N))
    me = torch.stack([mask, torch.tensor([[0, 0, 0], [1, 0, 1]],
                                         dtype=torch.bool)])
    nbytes, ops, kind = gm.work(xe, we, me, capacity=3,
                                cap_live=torch.tensor([1, 5]))
    # strips: expert 0 col 0; expert 1 cols 0, 2; row blocks 1 + 1
    assert nbytes == 3 * K * 128 * 4 + 2 * 8 * K * 4 + 2 * M * N * 4
    assert ops == 3 * 2 * 8 * 128 * K and kind == "fp32"


def test_masked_matmul_kdim_work_by_hand():
    """Pairs [[1, 0], [1, 1]]: three (8 x 128) blocks of x, both k
    blocks' 128 weight rows, the output."""
    M, K, N = 16, 256, 64
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    w = torch.zeros((K, N), dtype=torch.bfloat16)
    mask = torch.tensor([[1, 0], [1, 1]])
    nbytes, ops, kind = mm.work_kdim(x, w, mask)
    assert nbytes == 3 * 8 * 128 * 2 + 2 * 128 * N * 2 + M * N * 2
    assert ops == 3 * 2 * 8 * 128 * N and kind == "bf16"


def test_masked_matmul_work_by_hand():
    """M 12 (row blocks of 8 and 4), N 200 (strips of 128 and 72),
    tiles [[1, 0], [0, 1]]: live outputs 8 x 128 + 4 x 72."""
    M, K, N = 12, 16, 200
    x, w = torch.zeros((M, K)), torch.zeros((K, N))
    tiles = torch.tensor([[1, 0], [0, 1]], dtype=torch.bool)
    nbytes, ops, kind = mm.work_masked(x, w, tiles)
    assert nbytes == (128 + 72) * K * 4 + (8 + 4) * K * 4 + M * N * 4
    assert ops == 2 * K * (8 * 128 + 4 * 72) and kind == "fp32"


def test_binary_dot_works_by_hand():
    M, K, N = 8, 64, 128
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    w = torch.zeros((K, N), dtype=torch.bfloat16)
    assert bd.work(x, w) == (M * K * 2 + K * N * 2 + M * N * 4,
                             2 * M * K * N, "int8")
    packed = bdp.pack_signs(w)
    assert bdp.work(x, packed) == (M * K * 2 + K * N // 8 + M * N * 4,
                                   2 * M * K * N, "int8")


def _pool(page=4, D=8, hkv=1):
    """Pages 1-3 of 4 rows: page 1 holds positions 0-3 and page 2
    positions 4, 5 of slot 0; page 3 positions 0-2 of slot 1."""
    tags = torch.full((4, page), -1, dtype=torch.int32)
    tags[1] = torch.tensor([0, 1, 2, 3])
    tags[2, :2] = torch.tensor([4, 5])
    tags[3, :3] = torch.tensor([0, 1, 2])
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    qpos = torch.tensor([[5], [2]], dtype=torch.int32)
    kv = torch.zeros((4, page, hkv, D), dtype=torch.bfloat16)
    return tags, table, qpos, kv


def test_gqa_paged_flash_work_by_hand():
    """Slot 0 at position 5 sees 6 keys, slot 1 at 2 sees 3: 9 keys x 2
    heads.  Under a window of 2 slot 0 sees positions 4, 5 and slot 1
    positions 1, 2: page 1 is no longer admitted."""
    tags, table, qpos, kv = _pool()
    q = torch.zeros((2, 1, 2, 8), dtype=torch.bfloat16)
    fixed = q.numel() * 2 * 2 + table.numel() * 4 + qpos.numel() * 4
    got = pa.gqa_work(q, kv, kv, tags, table, qpos)
    assert got == (3 * 4 * 2 * 8 * 2 + 3 * 4 * 4 + fixed, 9 * 2 * 4 * 8,
                   "bf16")
    got = pa.gqa_work(q, kv, kv, tags, table, qpos, window=2)
    assert got == (2 * 4 * 2 * 8 * 2 + 3 * 4 * 4 + fixed, 4 * 2 * 4 * 8,
                   "bf16")
    # the partial form over the window of pages [2, 4): pages 2 and 3
    # (local ids 0, 1), K and V of both, the float32 statistics out
    local = (tags[2:], kv[2:])
    got = pa.gqa_work(q, local[1], local[1], local[0], table, qpos, lo=2,
                      n_local=2, partial=True)
    stats = 2 * 2 * 1 * (8 + 2) * 4
    assert got == (2 * 4 * (2 * 8 * 2 + 4) + q.numel() * 2 + stats
                   + table.numel() * 4 + qpos.numel() * 4,
                   (2 + 3) * 2 * 4 * 8, "bf16")


def test_mla_paged_flash_work_by_hand():
    tags, table, qpos, _ = _pool()
    kr, rd, h = 16, 8, 2
    q_lat = torch.zeros((2, 1, h, kr), dtype=torch.bfloat16)
    q_pe = torch.zeros((2, 1, h, rd), dtype=torch.bfloat16)
    ck = torch.zeros((4, 4, kr), dtype=torch.bfloat16)
    cpe = torch.zeros((4, 4, rd), dtype=torch.bfloat16)
    got = pa.mla_work(q_lat, q_pe, ck, cpe, tags, table, qpos, scale=1.0)
    fixed = table.numel() * 4 + qpos.numel() * 4
    assert got == (3 * 4 * ((kr + rd) * 2 + 4)
                   + (q_lat.numel() + q_pe.numel()) * 2 + q_lat.numel() * 2
                   + fixed, 9 * h * 2 * (2 * kr + rd), "bf16")
    got = pa.mla_work(q_lat, q_pe, ck[2:], cpe[2:], tags[2:], table, qpos,
                      scale=1.0, lo=2, n_local=2, partial=True)
    assert got == (2 * 4 * ((kr + rd) * 2 + 4)
                   + (q_lat.numel() + q_pe.numel()) * 2
                   + 2 * h * 1 * (kr + 2) * 4 + fixed,
                   5 * h * 2 * (2 * kr + rd), "bf16")


def test_kernel_entries_charge_nothing_without_a_counter(monkeypatch):
    """With no counter active a kernel entry computes no work: nothing
    is read back."""
    def boom(*a, **k):
        raise AssertionError("work() ran without a counter")
    monkeypatch.setattr(mp, "work", boom)
    x = torch.randn((8, 16))
    w = torch.randn((16, 128))
    pn = torch.zeros((8, 128), dtype=torch.int8)
    mp.mor_tile_mask(x, w, torch.zeros((6, 128)), pn)


def _calibrated_granite():
    cfg = reduce_config(get_config("granite-3-2b"))
    api = get_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)

    def batches():
        while True:
            yield {"tokens": torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32))}
    params, mor, _ = calibrate_lm(params, cfg, api.forward, batches(), 2)
    return cfg, params, mor


def test_kernel_mode_engine_charges_each_kernel_per_launch():
    """A kernel-mode paged engine on reduced granite under the counter:
    each kernel is charged once a call, as often as its launch counter
    counts on the card (``chip_smoke.py``'s per-dispatch count: a layer
    launches the predictor, two compacted products, the down product
    and the paged attention once), and its aten ops are not counted."""
    cfg, params, mor = _calibrated_granite()
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), 3)
            for n in (5, 11, 7)]
    eng = Engine(cfg, params, mor=mor, mor_mode="kernel", n_slots=2,
                 max_len=48, layout="paged")
    with op_cost.OpCounter() as counter:
        eng.run(list(reqs))
    D, L = eng.counters["dispatches"], cfg.n_layers
    calls = {k: v["calls"] for k, v in counter.kernels.items()}
    assert calls == {"mor_tile_mask": L * D, "gather_matmul": 2 * L * D,
                     "masked_matmul_kdim": L * D, "gqa_paged_flash": L * D}
    for name, rec in counter.kernels.items():
        assert rec["bytes"] > 0 and rec["ops"] > 0, name


def test_a_kernel_entry_counts_its_work_and_hides_its_plain_ops():
    """On the CPU the entry runs the plain version (a float32 matmul);
    under the counter only the kernel's work is counted, and its result
    is live."""
    x = torch.randn((16, 256))
    w = torch.randn((256, 64))
    mask = torch.tensor([[1, 0], [1, 1]])
    with op_cost.OpCounter() as counter:
        out = mm.masked_matmul_kdim(x, w, mask)
    nbytes, ops, _ = mm.work_kdim(x, w, mask)
    assert (counter.flops, counter.bytes) == (ops, nbytes)
    assert dict(counter.by_op) == {}
    assert counter.kernels["masked_matmul_kdim"]["calls"] == 1
    assert counter.peak_live_bytes >= out.numel() * 4


# -- roofline ---------------------------------------------------------------

def test_roofline_terms_dominance():
    cost = {"flops": 989e12, "bytes accessed": 3.35e12 * 2}
    t = roofline.roofline_terms(cost, {"total_wire_bytes": 0.0})
    assert t["dominant"] == "memory"
    assert abs(t["t_compute_s"] - 1.0) < 1e-9
    assert abs(t["t_memory_s"] - 2.0) < 1e-9
    t = roofline.roofline_terms({"flops": 989e12 * 3, "bytes accessed": 0},
                                {"total_wire_bytes": 450e9})
    assert t["dominant"] == "compute" and t["bound_time_s"] == 3.0
    assert abs(t["t_collective_s"] - 1.0) < 1e-9


def test_bound_ms_picks_the_larger_time():
    assert roofline.bound_ms(3.35e9, 0, "bf16") == (1.0, "bytes")
    ms, by = roofline.bound_ms(0, 1979e9, "int8")
    assert abs(ms - 1.0) < 1e-12 and by == "operations"
    assert roofline.bound_ms(1.0, 67e12, "fp32")[1] == "operations"


def test_collective_wire_bytes_ring_factors():
    """``collectives`` records each all-reduce's buffer; the wire carries
    it about twice (the reference's factor)."""
    collectives.reset_counts()
    collectives._count("flash_merge", "all-reduce", torch.zeros(10))
    collectives._count("obs_block", "all-reduce",
                       torch.zeros(5, dtype=torch.int32))
    assert collectives.nbytes == {"all-reduce": 60}
    wire = roofline.collective_wire_bytes(collectives.nbytes)
    assert wire == {"all-reduce": 120.0, "total_wire_bytes": 120.0}
    collectives.reset_counts()
    assert collectives.nbytes == {} and collectives.counts == {}


@pytest.mark.parametrize("n_chips", [1, 4, 256])
def test_model_flops_match_reference_on_every_cell(n_chips):
    assert dryrun_all.ARCHS == JARCHS and \
        dryrun_all.SHAPE_NAMES == JSHAPE_NAMES
    for arch in JARCHS:
        for s in JSHAPE_NAMES:
            got = roofline.model_flops(get_config(arch), SHAPES[s], n_chips)
            want = jroofline.model_flops(jget_config(arch), JSHAPES[s],
                                         n_chips)
            assert got == want, (arch, s)


def test_summarize_fields():
    cost = {"flops": 2e12, "bytes": 6.7e12, "coll_bytes_by_type": {}}
    cfg = get_config("granite-3-2b")
    s = roofline.summarize(cost, cfg, SHAPES["decode_32k"])
    assert s["dominant"] == "memory"
    assert math.isclose(s["bound_time_s"], 2.0)
    assert math.isclose(s["useful_flop_ratio"],
                        s["model_flops_per_chip"] / 2e12)
    assert math.isclose(s["roofline_fraction"],
                        s["model_flops_per_chip"] / 989e12 / 2.0)
    assert s["bytes_counted"] == "eager op stream"
    assert "floor_time_s" not in s


@pytest.mark.parametrize("floor_bytes,dominant", [(3.35e12, "memory"),
                                                  (0.0, "compute")])
def test_summarize_floor(floor_bytes, dominant):
    """The floor reads the bytes every implementation must move and the
    model FLOPs, not the op stream: here 1 s of bytes, or none against
    the model FLOPs' time at peak (a decode step's: under 1 s)."""
    cost = {"flops": 2e12, "bytes": 6.7e12, "coll_bytes_by_type": {}}
    cfg = get_config("granite-3-2b")
    s = roofline.summarize(cost, cfg, SHAPES["decode_32k"],
                           floor_bytes=floor_bytes)
    t_comp = s["model_flops_per_chip"] / 989e12
    assert math.isclose(s["t_floor_memory_s"], floor_bytes / 3.35e12)
    assert math.isclose(s["t_floor_compute_s"], t_comp)
    assert s["floor_dominant"] == dominant
    assert s["floor_time_s"] == max(s["t_floor_memory_s"], t_comp)
    assert s["floor_bytes"] == floor_bytes


def test_timing_raises_without_a_card():
    flush = torch.empty(16, dtype=torch.uint8)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.device_ms(lambda: None, flush)
    with pytest.raises(RuntimeError, match="CUDA device"):
        timing.host_ms(lambda: None)
