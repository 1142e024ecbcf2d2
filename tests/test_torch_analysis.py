"""The op-stream counter and its roofline (``repro_torch.analysis``) on the
CPU, held against the reference's HLO counter (``repro.analysis``).

  * Dot FLOPs: the port's counter on torch functions against the
    reference's ``analyze_text`` on the same functions in jnp (a matmul, a
    batched dot, a loop of 24 layers), and on the smoke qwen3-4b and
    rwkv6-1.6b one-device train steps.  The steps differ where the two
    compute different things, each term stated in its test.
  * Bytes: the write-once model's analytic counts (XLA fuses what eager
    does not, so bytes are not compared with the reference).
  * A region counted once at its trip count's weight equals the loop
    counted in full (``scale=True`` against ``scale=False``), and a step
    counts the same on ``cpu`` and ``meta``.
  * K1 and K3 declare their work (``chip_smoke``'s bound formulas) and
    count the same on ``cpu`` and ``meta``; a launch with no declared work
    raises.
  * ``hlo.Roofline.row()`` has the reference's keys; the constants are an
    H100's; ``autotune.cost.xla_cost``.
  * The dry run's ``roofline`` at a small mesh (counted on ``meta`` with
    counting groups) against one real tensor-parallel step counted on two
    gloo ranks (``tests/_analysis_ranks.py``): the same FLOPs, bytes and
    collectives.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import _analysis_ranks as R
from repro.analysis import hlo as jhlo
from repro.analysis.hlo_counter import HloModule, _shape_list
from repro.analysis.hlo_counter import analyze_text as janalyze
from repro.configs import smoke_config as jsmoke
from repro.models.transformer import Model as JModel
from repro.train import step as jstep
from repro_torch.analysis import hlo, hlo_counter
from repro_torch.autotune import cost
from repro_torch.configs import smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, rmsnorm
from repro_torch.launch import dryrun
from repro_torch.models.transformer import Model
from repro_torch.testing import ranks
from repro_torch.train import step as tstep


def _compiled_text(f, *sds):
    return jax.jit(f).lower(*sds).compile().as_text()


def _ref_dot_flops(text: str) -> float:
    """The reference counter's dot FLOPs alone (its ``totals`` without the
    elementwise and reduce terms): 2 x prod(result) x prod(contracting)
    per dot, while bodies times their trip counts."""
    mod = HloModule(text)
    memo = {}

    def total(name):
        if name in memo:
            return memo[name]
        comp, f = mod.computations.get(name), 0.0
        memo[name] = 0.0
        for ins in (comp.instrs if comp else ()):
            if ins.op == "dot":
                out = math.prod(d for _, dims in _shape_list(ins.type_str)
                                for d in dims)
                lhs = _shape_list(comp.symbols[ins.operands()[0]])[0][1]
                f += 2.0 * out * math.prod(
                    lhs[c] for c in ins.attr_list("lhs_contracting_dims"))
            if ins.op == "while":
                f += total(ins.attr("body")) * mod._trip_count(
                    ins.attr("condition"))
            elif ins.op == "fusion":
                f += total(ins.attr("calls"))
            elif ins.op == "call":
                f += total(ins.attr("to_apply"))
        memo[name] = f
        return f
    return total(mod.entry)


# ---------------------------------------------------------------------------
# dot FLOPs against the reference
# ---------------------------------------------------------------------------

def test_plain_matmul_flops_equal_the_references():
    a = jax.ShapeDtypeStruct((256, 512), jnp.float32)
    b = jax.ShapeDtypeStruct((512, 128), jnp.float32)
    want = janalyze(_compiled_text(lambda x, y: x @ y, a, b)).flops
    c = hlo_counter.count(lambda x, y: x @ y, torch.ones(256, 512),
                          torch.ones(512, 128))[1]
    assert c.dot_flops == c.totals.flops == want == 2 * 256 * 512 * 128


def test_batched_dot_flops_equal_the_references():
    a = jax.ShapeDtypeStruct((8, 64, 32), jnp.float32)
    b = jax.ShapeDtypeStruct((8, 32, 16), jnp.float32)
    want = _ref_dot_flops(_compiled_text(
        lambda x, y: jnp.einsum("bik,bkj->bij", x, y), a, b))
    c = hlo_counter.count(lambda x, y: torch.einsum("bik,bkj->bij", x, y),
                          torch.ones(8, 64, 32), torch.ones(8, 32, 16))[1]
    assert c.dot_flops == want == 2 * 8 * 64 * 32 * 16


def test_an_out_dtype_product_counts_as_its_dot():
    """``bmm`` / ``mm`` of bf16 operands kept in fp32 (``out_dtype``: the
    card's decode attention, ``models.attention._bmm_f32``, which the dry
    run counts on ``meta``; the CPU backend has no such overload) count
    the plain product's 2 M N K FLOPs."""
    device = "meta"
    a = torch.ones(8, 4, 32, dtype=torch.bfloat16, device=device)
    b = torch.ones(8, 32, 16, dtype=torch.bfloat16, device=device)
    c = hlo_counter.count(lambda x, y: torch.bmm(x, y,
                                                 out_dtype=torch.float32),
                          a, b)[1]
    assert c.dot_flops == 2 * 8 * 4 * 32 * 16
    c = hlo_counter.count(lambda x, y: torch.mm(x, y,
                                                out_dtype=torch.float32),
                          a[0], b[0])[1]
    assert c.dot_flops == 2 * 4 * 32 * 16


@pytest.mark.parametrize("scale", [True, False])
def test_layer_loop_multiplies_by_trip_count(scale):
    """The reference's scan of 24 layers against the port's loop through
    ``hlo_counter.layers``: counted once at weight 24, or in full."""
    def f(x, ws):
        return jax.lax.scan(lambda c, w: (c @ w, None), x, ws)[0]
    want = _ref_dot_flops(_compiled_text(
        f, jax.ShapeDtypeStruct((128, 128), jnp.float32),
        jax.ShapeDtypeStruct((24, 128, 128), jnp.float32)))
    ws = list(torch.ones(24, 128, 128) / 128)
    c = hlo_counter.count(
        lambda x: hlo_counter.layers(lambda w, h: h @ w, ws, x),
        torch.ones(128, 128), scale=scale)[1]
    assert c.dot_flops == want == 24 * 2 * 128 ** 3
    assert c.ops == (1 if scale else 24)


def _ref_step_text(arch, b, s):
    cfg = jsmoke(arch)
    model = JModel(cfg)
    state = jstep.make_train_state(model, jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    _, jit_with, _ = jstep.make_train_step(model, mesh, donate=False,
                                           **R.STEP)
    tok = np.zeros((b, s), np.int32)
    return jit_with(jstep.state_specs(state, mesh, cfg)).lower(
        state, {"tokens": tok, "labels": tok}).compile().as_text()


def _port_step(arch, b, s, device="meta", scale=True, **kw):
    cfg = smoke_config(arch, **kw)
    model = Model(cfg)
    state = tstep.make_train_state(model, torch.Generator().manual_seed(0),
                                   device=device)
    return hlo_counter.count(tstep.make_train_step(model, **R.STEP), state,
                             R.batch(cfg, b, s), scale=scale)[1]


def test_qwen3_step_dot_flops_equal_the_references():
    """The smoke qwen3-4b step (remat): every projection's dot the
    reference's; the reference's attention is an einsum over all s^2
    (query, key) pairs (QK^T and PV forward, again in remat's recompute,
    four dots in the backward: 16 b h s^2 hd FLOPs a layer), where the
    port's is K3 (declared apart, on the causal pairs)."""
    b, s = 2, 16
    cfg = smoke_config("qwen3_4b")
    want = _ref_dot_flops(_ref_step_text("qwen3_4b", b, s))
    c = _port_step("qwen3_4b", b, s)
    attention = cfg.n_layers * 16 * b * cfg.n_heads * s * s * cfg.hd
    assert c.dot_flops + attention == want
    pairs = s * (s + 1) // 2
    # K1: ln1, q_norm, k_norm, ln2 a layer and ln_f, remat's recompute
    # all but ln_f again
    assert c.kernels == {"rmsnorm": 2 * (4 * cfg.n_layers + 1) - 1,
                         "rmsnorm_bwd": 4 * cfg.n_layers + 1,
                         "flash_attention": 2 * cfg.n_layers,
                         "flash_attention_bwd": cfg.n_layers}
    assert pairs == hlo_counter.causal_pairs(s, s)


def test_rwkv6_step_dot_flops_equal_the_references():
    """The smoke rwkv6-1.6b step (remat, 2 layers, 16 time steps): the
    projections and the recurrence's batched mat-vec (the reference's
    einsum ``bhi,bhij->bhj``) are dots in both; of the three the
    reference computes a time step (forward, remat's recompute, and the
    backward's), XLA's CPU simplifier rewrites one as a multiply and a
    reduce, which its counter counts as elementwise: 2 b nh hd^2 FLOPs a
    time step and layer."""
    b, s = 2, 16
    cfg = smoke_config("rwkv6_1_6b")
    want = _ref_dot_flops(_ref_step_text("rwkv6_1_6b", b, s))
    c = _port_step("rwkv6_1_6b", b, s)
    nh = cfg.d_model // 64
    assert c.dot_flops == want + cfg.n_layers * s * 2 * b * nh * 64 * 64
    assert "flash_attention" not in c.kernels


# ---------------------------------------------------------------------------
# the traffic model, trip counts, devices
# ---------------------------------------------------------------------------

def test_bytes_are_the_write_once_count():
    """A dot charges its operands and its result; an elementwise op its
    result; views are free."""
    n = 1 << 16
    t = hlo_counter.analyze_text(lambda x, y: x @ y, torch.ones(64, 32),
                                 torch.ones(32, 16))
    assert t.bytes == t.bytes_min == (64 * 32 + 32 * 16 + 64 * 16) * 4
    x = torch.ones(n)
    t = hlo_counter.analyze_text(lambda a, b, c: a * b + c, x, x, x)
    assert t.bytes == 2 * n * 4 and t.bytes_min == 0 and t.flops == 2 * n
    t = hlo_counter.analyze_text(
        lambda a: a.view(256, 256).t().reshape(-1)[:10], x)
    assert t == hlo_counter.Totals()


@pytest.mark.parametrize("arch", ["qwen3_4b", "rwkv6_1_6b", "zamba2_2_7b"])
def test_scaled_count_equals_the_full_count(arch):
    """Layers (hybrid groups) and time steps counted once at their trip
    counts' weight against every iteration counted, and the same step on
    ``cpu`` and ``meta``: FLOPs, bytes and the fused floor exactly."""
    got = {(dev, scale): _port_step(arch, 2, 16, dev, scale).totals
           for dev in ("cpu", "meta") for scale in (True, False)}
    want = got[("cpu", False)]
    for key, t in got.items():
        assert (t.flops, t.bytes, t.bytes_min) == (
            want.flops, want.bytes, want.bytes_min), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_declare_their_work_alike_on_cpu_and_meta(dtype):
    """K1 and K3, forward and backward: the declared FLOPs and bytes
    (``chip_smoke``'s bounds), none of the plain version's own ops, the
    same on ``cpu`` and ``meta``."""
    rows, d = 24, 64
    bh, bkv, sq, hd = 8, 2, 16, 32
    got = {}
    for dev in ("cpu", "meta"):
        def run():
            x = torch.ones(rows, d, dtype=dtype, device=dev,
                           requires_grad=True)
            w = torch.ones(d, dtype=dtype, device=dev, requires_grad=True)
            q = torch.ones(bh, sq, hd, dtype=dtype, device=dev,
                           requires_grad=True)
            kv = torch.ones(bkv, sq, hd, dtype=dtype, device=dev,
                            requires_grad=True)
            y = rmsnorm.rmsnorm(x, w).sum() + fa.flash_attention(
                q, kv, kv).float().sum()
            torch.autograd.grad(y, (x, w, q, kv))
        c = hlo_counter.count(run)[1]
        got[dev] = (c.totals, c.kernels)
    assert got["cpu"] == got["meta"]
    t, kernels = got["cpu"]
    assert kernels == {"rmsnorm": 1, "rmsnorm_bwd": 1, "flash_attention": 1,
                       "flash_attention_bwd": 1}
    e, pairs = dtype.itemsize, sq * (sq + 1) // 2
    declared = (4 * rows * d + 10 * rows * d + 4 * bh * hd * pairs
                + 10 * bh * hd * pairs)
    nbytes = ((2 * rows * d + d) * e + (3 * rows * d + 2 * d) * e
              + (2 * bh + 2 * bkv) * sq * hd * e + 4 * bh * sq
              + (4 * bh + 4 * bkv) * sq * hd * e + 4 * bh * sq)
    # the rest: the two sums and the grad of their sum (elementwise)
    assert declared < t.flops < declared + 4 * (rows * d + bh * sq * hd)
    assert nbytes <= t.bytes_min < nbytes + 8 * (rows * d + bh * sq * hd)


def test_an_undeclared_launch_raises():
    """A CUDA graph's replay (``ops.add_launches``), a K4 program's launch
    (``hlo_counter.launched``) and a cost estimate of such a call raise
    inside a count; outside one they count as before."""
    with pytest.raises(hlo_counter.UndeclaredKernel, match="cuda_graph"):
        hlo_counter.count(ops.add_launches, {("rmsnorm", None): 1})
    with pytest.raises(hlo_counter.UndeclaredKernel, match="dpia_cuda"):
        hlo_counter.count(hlo_counter.launched, "dpia_cuda:scal")
    with pytest.raises(hlo_counter.UndeclaredKernel):
        cost.xla_cost(hlo_counter.launched, ("dpia_cuda:scal",))
    before = ops.launch_counts()["rmsnorm"]
    ops.add_launches({("rmsnorm", None): 1})
    ops.add_launches({("rmsnorm", None): 1}, times=-1)
    assert ops.launch_counts()["rmsnorm"] == before
    hlo_counter.launched("rmsnorm")      # no count running: nothing


def test_xla_cost_is_the_roofline_of_the_count():
    a, b = torch.ones(128, 64), torch.ones(64, 32)
    for hw in cost.HW_PRESETS.values():
        t = hlo_counter.analyze_text(torch.mm, a, b)
        assert cost.xla_cost(torch.mm, (a, b), hw) == max(
            t.flops / hw.peak_flops, t.bytes / hw.hbm_bw)
    assert cost.xla_cost(torch.mm, (a, a)) is None     # the call fails


def test_roofline_row_has_the_references_keys_and_h100_constants():
    coll = hlo.CollectiveStats({"all-reduce": 100}, {"all-reduce": 2})
    row = hlo.Roofline(1e12, 1e9, coll, 4, bytes_min=5e8,
                       model_flops=6e11).finalize().row()
    jrow = jhlo.Roofline(1e12, 1e9, jhlo.CollectiveStats(), 4).finalize(
    ).row()
    assert set(row) == set(jrow)
    assert row["compute_s"] == 1e12 / (4 * 989.4e12)
    assert row["memory_s"] == 1e9 / (4 * 3.35e12)
    assert row["collective_s"] == 100 / (4 * hlo.NVLINK_BW)
    assert row["useful_frac"] == 0.6 and row["xla_flops_raw"] is None
    assert (hlo.PEAK_FLOPS, hlo.HBM_BW) == (989.4e12, 3.35e12)
    assert hlo.link_bw(16) == hlo.FABRIC_BW < hlo.link_bw(8)
    assert hlo.FABRIC_BW == 400e9 / 8        # a 400 Gb/s NDR port
    for tpu in (jhlo.PEAK_FLOPS, jhlo.HBM_BW, jhlo.ICI_BW):
        assert tpu not in (hlo.PEAK_FLOPS, hlo.HBM_BW, hlo.NVLINK_BW)
    assert "H100" in hlo.CARD and "700.00 W" in hlo.CARD


# ---------------------------------------------------------------------------
# the dry run's roofline against a real step on two gloo ranks
# ---------------------------------------------------------------------------

CASES = {"qwen3_m2": ("qwen3_4b", {}, (1, 2), (2, 16)),
         "rwkv6_m2": ("rwkv6_1_6b", {"d_model": 256}, (1, 2), (2, 16)),
         "qwen3_fsdp": ("qwen3_4b", {"fsdp": True}, (2, 1), (4, 16))}


@pytest.fixture(scope="module")
def gloo_counts():
    return ranks.spawn(R.rank_work, 2, args=(CASES,), timeout=300)


@pytest.mark.parametrize("scale", [True, False])
@pytest.mark.parametrize("name", list(CASES))
def test_dry_run_roofline_equals_a_real_step(gloo_counts, name, scale):
    """``dryrun.train_roofline`` (one rank's step on ``meta``, counting
    groups, times the chips) against rank 0's count of the same step on a
    real 2-rank gloo mesh: FLOPs, bytes and every collective's bytes.  The
    ranks issue the same collectives; their arithmetic differs a little
    (the rank at index 0 of an axis adds the squares of the leaves whole
    over it to the gradient norm), and the dry run counts rank 0."""
    arch, kw, shape, (b, s) = CASES[name]
    cfg = smoke_config(arch, **kw)
    real = [r[(name, scale)] for r in gloo_counts]
    assert real[0]["totals"][3:] == real[1]["totals"][3:]
    assert real[0]["coll_calls"] == real[1]["coll_calls"]
    flops, nbytes, bmin, cbytes, ccount, by_kind = real[0]["totals"]
    assert cbytes > 0 and ccount == sum(real[0]["coll_calls"].values())
    row = dryrun.train_roofline(Model(cfg), {"seq": s, "batch": b,
                                             "kind": "train"},
                                {"data": shape[0], "model": shape[1]},
                                scale=scale)
    assert row["flops"] == 2 * flops and row["bytes"] == 2 * nbytes
    assert row["bytes_min"] == 2 * bmin
    assert row["coll_bytes"] == 2 * cbytes
    assert row["coll_count"] == ccount
    assert row["model_flops"] == 6.0 * cfg.active_param_count() * b * s


# ---------------------------------------------------------------------------
# a serving step on a model axis against the reference's lowered step
# ---------------------------------------------------------------------------

# (arch, config fields): the smoke configs; rwkv6 at d_model 256, whose
# 4 heads split over model=2 as a served rwkv6's do (the smoke config's
# one head runs whole on every rank)
SERVE_ARCHS = (("qwen3_4b", {}), ("dbrx_132b", {}),
               ("rwkv6_1_6b", {"d_model": 256}), ("zamba2_2_7b", {}))

SERVE_FLOPS_SCRIPT = "SERVE_ARCHS = " + repr(SERVE_ARCHS) + r"""
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
from repro.analysis import hlo
from repro.configs import smoke_config
from repro.sharding import ctx, rules
from repro.models.transformer import Model
import dataclasses
out = {}
for arch, fields in SERVE_ARCHS:
    cfg = dataclasses.replace(smoke_config(arch), **fields)
    model = Model(cfg)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    ctx.set_mesh(mesh)
    named = lambda spec: jax.tree_util.tree_map(
        lambda s: NamedSharding(mesh, s), spec,
        is_leaf=lambda x: isinstance(x, PS))
    params = jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))
    cache = jax.eval_shape(lambda: model.init_cache(2, cfg.max_seq))
    ps = named(rules.params_specs(params, mesh, cfg))
    cs = named(rules.cache_specs(cfg, mesh, cache))
    pre = jax.jit(lambda p, t, c: model.prefill(p, t, c),
                  in_shardings=(ps, named(PS("data")), cs),
                  out_shardings=(None, cs)).lower(
        params, jax.ShapeDtypeStruct((2, 16), jnp.int32), cache)
    dec = jax.jit(lambda p, t, c, pos: model.decode_step(p, t, c, pos),
                  in_shardings=(ps, named(PS("data")), cs, None),
                  out_shardings=(None, cs)).lower(
        params, jax.ShapeDtypeStruct((2, 1), jnp.int32), cache,
        jax.ShapeDtypeStruct((), jnp.int32))
    for kind, low in (("prefill", pre), ("decode", dec)):
        out[f"{arch}|{kind}"] = hlo.analyze(low.compile(), chips=2,
                                            model_flops=1.0).row()["flops"]
    ctx.set_mesh(None)
print("FLOPS", json.dumps(out))
"""

# the share by which a serving step's counted FLOPs may pass the
# reference's on (1, 2): every rank of the port repeats the head's matmul
# over the whole vocab (2 b d vocab a rank; GSPMD's partitioned module
# keeps it row-parallel), and the port's prefill attention (K3) counts the
# causal pairs where the reference's einsum counts every pair
SERVE_FLOPS_SHARE = 0.15


def _repeated_gate_flops(cfg, kind, b, m):
    """rwkv6's decode step (SP off) gates the channel-mix on every rank of
    ``model`` alike, as the train step does with SP off: ``xr @ cw_r``
    whole on each, 2 b d^2 a layer repeated ``m - 1`` times, where GSPMD
    splits ``cw_r``'s columns.  A prefill whose prompt ``model`` divides
    gates the rank's rows alone."""
    if cfg.family != "ssm" or kind != "decode":
        return 0
    return (m - 1) * cfg.n_layers * 2 * b * cfg.d_model ** 2


def test_serving_step_flops_against_the_references_lowered_step(
        forced_devices):
    """``dryrun.serving_roofline`` of the smoke qwen3-4b, dbrx-132b,
    rwkv6-1.6b (at d_model 256) and zamba2-2.7b prefill (2 x 16 tokens)
    and decode step (a cache of ``max_seq``) on ``data=1, model=2``
    against the reference's ``hlo.analyze`` of its ``prefill`` /
    ``decode_step`` lowered with ``params_specs`` and ``cache_specs`` on
    two forced devices: the FLOPs of both chips within
    ``SERVE_FLOPS_SHARE`` of each other, rwkv6's decode with its repeated
    gate added to the reference's (:func:`_repeated_gate_flops`).  The
    reference's serving steps count rwkv6's batched mat-vec as a dot
    (unlike its train step's, of which XLA's CPU simplifier rewrites one:
    ``test_rwkv6_step_dot_flops_equal_the_references``), so no exception
    is taken for it here."""
    import json
    r = forced_devices(SERVE_FLOPS_SCRIPT, n=2, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("FLOPS ")]
    assert line, r.stdout + r.stderr
    want = json.loads(line[0][6:])
    for arch, fields in SERVE_ARCHS:
        cfg = smoke_config(arch, **fields)
        for kind in ("prefill", "decode"):
            info = {"seq": 16 if kind == "prefill" else cfg.max_seq,
                    "batch": 2, "kind": kind}
            got = dryrun.serving_roofline(Model(cfg), info,
                                          {"data": 1, "model": 2})["flops"]
            w = want[f"{arch}|{kind}"] + _repeated_gate_flops(cfg, kind, 2,
                                                              2)
            assert abs(got - w) <= SERVE_FLOPS_SHARE * w, (arch, kind, got,
                                                           w)
