"""The port on the card: each kernel against its plain PyTorch version (the
backward kernels of K1 and K3 too), the serving path's launches and
tokens, and training's gradients and steps.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
decision is made in a fixture, never at import).  The module imports
neither JAX nor the reference package, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import time

import pytest
import torch

from repro_torch.compiler import Program
from repro_torch.configs import smoke_config
from repro_torch.core.dpia import stage3_cuda
from repro_torch.kernels import dpia_blas
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import matmul as mm_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import (BatchedEngine, ContinuousEngine,
                                      Request, sample_tokens)

# kernel against plain version: fp32 differs by summation order only; bf16
# by at most one bf16 rounding (2**-8 relative)
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [
    (800, 2560), (25600, 128), (4, 2560), (3, 5, 64),
    # the rest of the main path's shapes (prefill of 4 x 200 tokens, one
    # decode step), then ragged ones: rows past the last full block, lanes
    # masked off, one element an access (200-byte rows), block per row,
    # a row read in two passes
    (6400, 128), (128, 128), (32, 128), (1, 1), (37, 128), (9, 24),
    (5, 2560), (2, 100), (2, 9000), (1, 20000), (4, 8192)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g,
                               device=cuda_device)).to(dtype)
    variant = rms_mod.plan(x.numel() // shape[-1], shape[-1], dtype).variant
    before = rms_mod.launches
    by_variant = dict(rms_mod.launches_by_variant)
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rms_mod.launches == before + 1
    by_variant[variant] += 1
    assert rms_mod.launches_by_variant == by_variant
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, w).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(ops.rmsnorm(x, w), got)       # a fixed order of sums


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_misaligned_view_takes_scalar_accesses(cuda_device,
                                                              dtype):
    """Rows taken from a flat buffer one element in: not 16-byte aligned,
    so the plan takes one element an access; the same values."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    flat = torch.randn(1 + 6400 * 128, generator=g,
                       device=cuda_device).to(dtype)
    x = flat[1:].view(6400, 128)
    w = (1 + 0.1 * torch.randn(128, generator=g,
                               device=cuda_device)).to(dtype)
    assert x.data_ptr() % 16
    p = rms_mod.plan(6400, 128, dtype, aligned=False)
    assert not p.vector and p.variant == "warp"
    before = rms_mod.launches_by_variant["warp"]
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rms_mod.launches_by_variant["warp"] == before + 1
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, w).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,s,d_model_variant", [(1, 140, "warp"),
                                                  (2, 8, "block")])
def test_rmsnorm_launches_by_variant_in_a_qwen3_4b_pass(cuda_device, b, s,
                                                        d_model_variant):
    """One prefill of qwen3-4b at full width (bf16, 36 layers): the 72
    qk_norms of 128-wide rows a pass take ``packed``; the 73 d_model norms
    take ``warp`` over 140 rows, ``block`` over 16 (too few rows to give
    every SM a warp)."""
    from repro_torch.configs import config
    cfg = config("qwen3_4b")
    model = Model(cfg)
    params = model.init_params(
        torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    tokens = torch.randint(0, cfg.vocab, (b, s), device=cuda_device)
    ops.reset_launch_counts()
    with torch.inference_mode():
        cache = model.init_cache(b, s, device=cuda_device)
        model.prefill(params, tokens, cache,
                      lengths=torch.full((b,), s, device=cuda_device))
    torch.cuda.synchronize()
    want = {"packed": 72, "warp": 0, "block": 0}
    want[d_model_variant] = 73
    assert (2 * cfg.n_layers, 2 * cfg.n_layers + 1) == (72, 73)
    assert ops.launch_counts_by_variant()["rmsnorm"] == want


def test_rmsnorm_kernel_launch_failure_raises(cuda_device, monkeypatch):
    """A launch the C entry point has no kernel for (here 3 vectors a lane,
    not an instance) is refused, and the call raises."""
    x = torch.zeros((4, 64), device=cuda_device, dtype=torch.bfloat16)
    p = rms_mod.plan(4, 64, torch.bfloat16)
    monkeypatch.setattr(rms_mod, "plan", lambda *a, **k: p._replace(
        variant="warp", threads_per_row=32, vectors_per_thread=3))
    before = dict(rms_mod.launches_by_variant)
    with pytest.raises(RuntimeError, match="rmsnorm \\(warp\\).*launch "
                       "failed"):
        ops.rmsnorm(x, torch.ones(64, device=cuda_device,
                                  dtype=torch.bfloat16))
    assert rms_mod.launches_by_variant == before


@pytest.mark.parametrize("bh,bkv,sq,sk,d,causal,q_offset", [
    (128, 32, 200, 200, 128, True, 0),
    (128, 32, 100, 100, 128, False, 0),
    (128, 32, 1, 200, 128, True, 199),
    (8, 2, 33, 33, 64, True, 0),
    (8, 4, 10, 10, 16, True, 0),
    (8, 4, 65, 65, 32, False, 0),
    (4, 2, 37, 200, 64, True, 163),
    # head dim 80 (zamba2's shared attention): its static prefill, a
    # batch-1 continuation chunk, non-causal GQA
    (128, 128, 200, 200, 80, True, 0),
    (32, 32, 72, 200, 80, True, 128),
    (8, 2, 65, 65, 80, False, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda_device, bh, bkv, sq, sk, d, causal,
                                    q_offset, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = (0.5 * torch.randn((bh, sq, d), generator=g,
                           device=cuda_device)).to(dtype)
    k = (0.5 * torch.randn((bkv, sk, d), generator=g,
                           device=cuda_device)).to(dtype)
    v = torch.randn((bkv, sk, d), generator=g, device=cuda_device).to(dtype)
    before = fa_mod.launches
    by_variant = dict(fa_mod.launches_by_variant)
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    want_variant = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert fa_mod.variant(dtype) == want_variant
    by_variant[want_variant] += 1
    assert fa_mod.launches_by_variant == by_variant
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _attention_f64(q, k, v, causal, q_offset):
    """Attention in float64 (GQA, causal on absolute positions)."""
    group = q.shape[0] // k.shape[0]
    k64 = k.double().repeat_interleave(group, dim=0)
    v64 = v.double().repeat_interleave(group, dim=0)
    s = q.double() @ k64.transpose(1, 2) / q.shape[-1] ** 0.5
    if causal:
        rows = torch.arange(q.shape[1], device=q.device)[:, None]
        keys = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(keys > q_offset + rows, float("-inf"))
    return torch.softmax(s, dim=-1) @ v64


@pytest.mark.parametrize("bh,bkv,sq,sk,q_offset", [
    (128, 32, 200, 200, 0),       # the serving prefill
    (32, 8, 72, 200, 128),        # a batch-1 chunk: the last 72 of 200
])
def test_flash_fp32_keeps_fp32_error(cuda_device, bh, bkv, sq, sk, q_offset):
    """The fp32 forward (tf32x3) against a float64 attention: within 2 x
    the plain fp32 version's error.  The guard of the tensor core's
    truncating adds, which the CPU emulation rounds to nearest."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q = 0.5 * torch.randn((bh, sq, 128), generator=g, device=cuda_device)
    k = 0.5 * torch.randn((bkv, sk, 128), generator=g, device=cuda_device)
    v = torch.randn((bkv, sk, 128), generator=g, device=cuda_device)
    before = fa_mod.launches_by_variant["tf32x3"]
    got = ops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    assert fa_mod.launches_by_variant["tf32x3"] == before + 1
    want = ref.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    exact = _attention_f64(q, k, v, True, q_offset)
    err = (got.double() - exact).abs().max().item()
    plain = (want.double() - exact).abs().max().item()
    assert err <= 2 * plain, (err, plain)


@pytest.mark.parametrize("source", ["zero_div", "bits"])
def test_flash_fp32_keeps_nan(cuda_device, source):
    """A NaN in q (one row's scores) and in v (one column of every row's
    P.V), both split to 3xTF32: the output is NaN where the plain
    version's is (non-causal, so that neither skips a masked tile), and
    close elsewhere."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = (torch.randn((n, 200, 64), generator=g, device=cuda_device)
               for n in (8, 2, 2))
    q[3, 17, 5] = _card_nan(source, cuda_device)
    v[1, 90, 9] = _card_nan(source, cuda_device)
    got = ops.flash_attention(q, k, v, causal=False)
    want = ref.flash_attention(q, k, v, causal=False)
    assert torch.isnan(want[3, 17]).all() and torch.isnan(want[4:, :, 9]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_takes_misaligned_views(cuda_device, dtype):
    """The forward stages rows by 16-byte cp.async copies: contiguous q, k
    and v taken one element into flat buffers are copied to aligned
    buffers first, and the output and lse are those of aligned operands,
    bit for bit."""
    g = torch.Generator(device=cuda_device).manual_seed(8)

    def misaligned(*shape):
        n = 1
        for s in shape:
            n *= s
        flat = torch.randn(n + 1, generator=g, device=cuda_device).to(dtype)
        return flat[1:].view(shape)
    q, k, v = misaligned(8, 70, 64), misaligned(2, 70, 64), misaligned(
        2, 70, 64)
    assert all(t.is_contiguous() and t.data_ptr() % 16 for t in (q, k, v))
    before = fa_mod.launches
    got = fa_mod._launch(q, k, v, causal=True, scale=None, q_offset=0,
                         with_lse=True)
    assert fa_mod.launches == before + 1
    want = fa_mod._launch(q.clone(), k.clone(), v.clone(), causal=True,
                          scale=None, q_offset=0, with_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("args", [
    dict(shape=(2, 4, 48), match="head dim"),
    dict(shape=(3, 4, 64), match="multiple"),
])
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device, args):
    q = torch.zeros(args["shape"], device=cuda_device)
    k = torch.zeros((2,) + args["shape"][1:], device=cuda_device)
    with pytest.raises(ValueError, match=args["match"]):
        ops.flash_attention(q, k, k)


def test_rmsnorm_kernel_rejects_mixed_dtypes(cuda_device):
    x = torch.zeros((4, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtypes"):
        ops.rmsnorm(x, torch.ones(64, device=cuda_device))


def test_engine_on_card_launches_kernels_and_matches_cpu(cuda_device):
    """Smoke qwen3-4b in float32 (TF32 off): the engine on the card goes
    through both kernels, 2 * 4 + 1 RMSNorms per forward pass and one
    flash attention per layer per prefill, and its greedy tokens equal the
    CPU's plain run with the same weights."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("qwen3_4b", use_flash=True)
    model = Model(cfg)
    p_cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    p_gpu = _to(p_cpu, cuda_device)
    reqs = [Request(prompt=list(range(1, 1 + n)), max_new_tokens=7)
            for n in (12, 5, 9)]
    want = BatchedEngine(model, p_cpu, max_seq=32, chunk=3).run(reqs)
    engine = BatchedEngine(model, p_gpu, max_seq=32, chunk=3)
    ops.reset_launch_counts()
    got = engine.run(reqs)
    assert got == want
    steps = engine.stats()["decode_steps"]
    assert ops.launch_counts() == {
        "flash_attention": cfg.n_layers,
        "rmsnorm": (cfg.n_layers * 4 + 1) * (1 + steps),
        "matmul": 0, "dpia_cuda": 0, "rmsnorm_bwd": 0,
        "flash_attention_bwd": 0}


def test_decode_step_and_sampling_never_sync_the_host(cuda_device):
    """The engine syncs once per decode chunk, when it reads the chunk's
    tokens; a decode step and its sampling, per-slot positions included,
    must queue work without waiting for the device."""
    cfg = smoke_config("qwen3_4b", use_flash=True)
    model = Model(cfg)
    params = model.init_params(
        torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    cache = model.init_cache(2, 16, device=cuda_device)
    tok = torch.tensor([[3], [4]], device=cuda_device)
    pos = torch.tensor([5, 16], device=cuda_device)      # slot 1 drops
    gens = [torch.Generator(device=cuda_device).manual_seed(i)
            for i in range(2)]
    model.decode_step(params, tok, cache, pos)           # compiles K1
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, _ = model.decode_step(params, tok, cache, pos)
        sample_tokens(logits, gens, [0.0, 0.8], [0, 5])
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _to(node, device):
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to(v, device) for v in node]
    return None if node is None else node.to(device)


# ---------------------------------------------------------------------------
# K2 matmul and K4 generated programs
# ---------------------------------------------------------------------------

# K2: fp32 sums over K in another order than cuBLAS, inputs scaled so
# |C| ~ 1; bf16 output: one rounding of nearly the same fp32 value
MM_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _mm_inputs(m, k, n, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    s = k ** -0.25
    a = (s * torch.randn((m, k), generator=g, device=device)).to(dtype)
    b = (s * torch.randn((k, n), generator=g, device=device)).to(dtype)
    return a, b


# (m, k, n, bf16 variant, fp32 variant): the bf16 projection shapes take
# wgmma, ragged rows mma; fp32 takes skinny up to 16 rows, tf32x3 above
MM_CASES = [(800, 2560, 4096, "wgmma", "tf32x3"),
            (4, 2560, 9728, "wgmma", "skinny"),
            (37, 100, 75, "mma", "tf32x3"), (129, 8, 130, "mma", "tf32x3"),
            (1, 1, 1, "mma", "skinny"), (129, 64, 136, "wgmma", "tf32x3"),
            (300, 72, 520, "wgmma", "tf32x3")]


@pytest.mark.parametrize("m,k,n,bf16_variant,fp32_variant", MM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(cuda_device, m, k, n, bf16_variant,
                                     fp32_variant, dtype):
    a, b = _mm_inputs(m, k, n, dtype, cuda_device)
    p = mm_mod.plan(m, n, k, dtype)
    assert p.variant == (bf16_variant if dtype == torch.bfloat16
                         else fp32_variant)
    before = mm_mod.launches
    by_variant = dict(mm_mod.launches_by_variant)
    got = ops.matmul(a, b, impl="cuda")
    torch.cuda.synchronize()
    assert mm_mod.launches == before + p.launches and got.dtype == dtype
    by_variant[p.variant] += 1
    if p.split > 1:
        by_variant[mm_mod._REDUCE[p.variant]] += 1
    assert mm_mod.launches_by_variant == by_variant
    torch.testing.assert_close(got.float(), ref.matmul(a, b).float(),
                               rtol=MM_TOL[dtype], atol=MM_TOL[dtype])
    out32 = ops.matmul(a, b, impl="cuda", out_dtype=torch.float32)
    assert out32.dtype == torch.float32


@pytest.mark.parametrize("m,k,n", [(800, 2560, 4096), (4, 2560, 4096),
                                   (129, 64, 136)])
def test_matmul_bf16_in_fp32_out_through_wgmma(cuda_device, m, k, n):
    """bf16 inputs, fp32 output: the wgmma kernel's fp32 epilogue (no bf16
    rounding of the result), against the fp32 plain version: fp32 sums in
    another order."""
    a, b = _mm_inputs(m, k, n, torch.bfloat16, cuda_device)
    assert mm_mod.plan(m, n, k, torch.bfloat16).variant == "wgmma"
    before = mm_mod.launches_by_variant["wgmma"]
    got = ops.matmul(a, b, impl="cuda", out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert mm_mod.launches_by_variant["wgmma"] == before + 1
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, ref.matmul(a, b, out_dtype=torch.float32),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,k,n", [(4, 2560, 4096), (1, 64, 8)])
def test_matmul_split_k_path(cuda_device, m, k, n):
    """Below one wave of tiles K is split as the plan says: (4, 2560, 4096)
    into 4 parts plus the reduction (2 launches); (1, 64, 8) has one k tile
    and stays one launch.  The partials are summed in a fixed order, so two
    runs agree bit for bit."""
    a, b = _mm_inputs(m, k, n, torch.bfloat16, cuda_device)
    p = mm_mod.plan(m, n, k, torch.bfloat16)
    assert p.variant == "wgmma"
    assert p.split == (4 if (m, k, n) == (4, 2560, 4096) else 1)
    before = (mm_mod.launches, mm_mod.launches_by_variant["splitk_reduce"])
    first = ops.matmul(a, b, impl="cuda")
    torch.cuda.synchronize()
    assert mm_mod.launches == before[0] + p.launches
    assert mm_mod.launches_by_variant["splitk_reduce"] == \
        before[1] + (p.split > 1)
    torch.testing.assert_close(first.float(), ref.matmul(a, b).float(),
                               rtol=MM_TOL[torch.bfloat16],
                               atol=MM_TOL[torch.bfloat16])
    for _ in range(3):
        assert torch.equal(ops.matmul(a, b, impl="cuda"), first)


@pytest.mark.parametrize("m,k,n", [(4, 2560, 4096), (16, 700, 300),
                                   (3, 1100, 75)])
def test_matmul_skinny_split_path(cuda_device, m, k, n):
    """fp32 rows <= 16: K split as the plan says plus the reduction (2
    launches), 16-byte or one-element loads of B; fixed-order sums, so
    repeated runs agree bit for bit."""
    a, b = _mm_inputs(m, k, n, torch.float32, cuda_device)
    p = mm_mod.plan(m, n, k, torch.float32)
    assert p.variant == "skinny" and p.split > 1
    before = (mm_mod.launches, mm_mod.launches_by_variant["skinny_reduce"])
    first = ops.matmul(a, b, impl="cuda")
    torch.cuda.synchronize()
    assert mm_mod.launches == before[0] + 2
    assert mm_mod.launches_by_variant["skinny_reduce"] == before[1] + 1
    torch.testing.assert_close(first, ref.matmul(a, b), rtol=1e-4,
                               atol=1e-4)
    for _ in range(3):
        assert torch.equal(ops.matmul(a, b, impl="cuda"), first)


@pytest.mark.parametrize("block_n", [64, 128])
@pytest.mark.parametrize("m,k,n", [(800, 2560, 4096), (150, 37, 203)])
def test_matmul_tf32x3_keeps_fp32_error(cuda_device, monkeypatch, m, k, n,
                                        block_n):
    """Both tf32x3 tiles (64 x 64 and 128 x 128) against a float64
    product: the error of fp32 sums (1e-4 as for the plain version), where
    one TF32 product per term (torch.matmul with TF32 allowed) is ~100 x
    further off.  The only guard of the tensor core's truncating adds,
    which the CPU emulation rounds to nearest."""
    a, b = _mm_inputs(m, k, n, torch.float32, cuda_device)
    p = mm_mod.plan(m, n, k, torch.float32)
    monkeypatch.setattr(mm_mod, "plan", lambda *args: p._replace(
        block_m=block_n, block_n=block_n))
    got = ops.matmul(a, b, impl="cuda")
    want = a.double() @ b.double()
    err = (got.double() - want).abs().max().item()
    torch.testing.assert_close(got.double(), want, rtol=1e-4, atol=1e-4)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = (torch.matmul(a, b).double() - want).abs().max().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert err * 20 < tf32


def _card_nan(source, device):
    """A NaN made on the card by 0/0, or 0x7fffffff (the bits the card's
    fp32 arithmetic gives it) written directly."""
    if source == "zero_div":
        z = torch.zeros((), device=device)
        return z / z
    return torch.tensor(0x7FFFFFFF, dtype=torch.int32).view(
        torch.float32).to(device)


@pytest.mark.parametrize("source", ["zero_div", "bits"])
@pytest.mark.parametrize("m,k,n", [(150, 37, 203), (40, 2560, 4096)])
def test_matmul_tf32x3_keeps_nan(cuda_device, m, k, n, source):
    """A NaN in A (row 3) and in B (column 7): tf32x3's output is NaN
    exactly where the plain version's is, at both tiles; 3xTF32's split
    turns no NaN into a finite value."""
    a, b = _mm_inputs(m, k, n, torch.float32, cuda_device)
    a[3, k // 2] = _card_nan(source, cuda_device)
    b[k - 1, 7] = _card_nan(source, cuda_device)
    assert mm_mod.plan(m, n, k, torch.float32).variant == "tf32x3"
    got, want = ops.matmul(a, b, impl="cuda"), ref.matmul(a, b)
    assert torch.isnan(want[3]).all() and torch.isnan(want[:, 7]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.parametrize("source", ["zero_div", "bits"])
def test_flash_attention_bwd_fp32_keeps_nan(cuda_device, source):
    """A NaN in dO reaches D, dP and dS, which the tf32x3 kernels split:
    dQ, dK and dV are NaN where the plain version's are (non-causal, so
    that neither skips a masked tile), finite and close elsewhere."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((n, 200, 64), generator=g, device=cuda_device)
               for n in (8, 2, 2))
    o, lse = fa_mod._launch(q, k, v, causal=False, scale=None, q_offset=0,
                            with_lse=True)
    do = torch.randn((8, 200, 64), generator=g, device=cuda_device)
    do[5, 70, 9] = _card_nan(source, cuda_device)
    got = fa_mod._launch_bwd(q, k, v, o, lse, do, causal=False, scale=None)
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    for x, w in zip(got, want):
        assert torch.isnan(w).any()
        assert torch.equal(torch.isnan(x), torch.isnan(w))
        fin = ~torch.isnan(w)
        _close_bwd(x[fin], w[fin], torch.float32)


def test_matmul_kernel_launch_failure_raises(cuda_device, monkeypatch):
    """A wgmma launch the kernel refuses (here a tile width it has no
    instance for) raises; nothing is computed in its place."""
    a, b = _mm_inputs(256, 64, 256, torch.bfloat16, cuda_device)
    p = mm_mod.plan(256, 256, 64, torch.bfloat16)
    monkeypatch.setattr(mm_mod, "plan",
                        lambda *args: p._replace(block_n=64))
    before = dict(mm_mod.launches_by_variant)
    with pytest.raises(RuntimeError, match="matmul \\(wgmma\\).*launch failed"):
        ops.matmul(a, b, impl="cuda")
    assert mm_mod.launches_by_variant == before


def test_matmul_wgmma_build_failure_raises(cuda_device, monkeypatch):
    """The wgmma source built without CUTLASS's headers fails to compile,
    and the call raises; matmul.cu's mma regime does not stand in."""
    from repro_torch.kernels import _build
    monkeypatch.setitem(_build.SOURCE_FLAGS, "matmul_wgmma",
                        ("-I", "/nonexistent"))
    monkeypatch.delitem(_build._LIBS, "matmul_wgmma", raising=False)
    mm_mod._wgmma_entry.cache_clear()
    a, b = _mm_inputs(128, 64, 128, torch.bfloat16, cuda_device)
    before = dict(mm_mod.launches_by_variant)
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ops.matmul(a, b, impl="cuda")
    finally:
        mm_mod._wgmma_entry.cache_clear()
    assert mm_mod.launches_by_variant == before


def test_flash_kernel_launch_failure_raises(cuda_device, monkeypatch):
    """A head dim the C entry point has no instance for is refused at
    launch, and the call raises."""
    monkeypatch.setattr(fa_mod, "SUPPORTED_HEAD_DIMS", (16, 32, 48, 64, 128))
    q = torch.zeros((2, 8, 48), device=cuda_device, dtype=torch.bfloat16)
    before = dict(fa_mod.launches_by_variant)
    with pytest.raises(RuntimeError, match="flash_attention \\(mma\\).*launch "
                       "failed"):
        ops.flash_attention(q, q, q)
    assert fa_mod.launches_by_variant == before


def test_matmul_kernel_rejects_mixed_dtypes(cuda_device):
    a = torch.zeros((4, 8), device=cuda_device)
    with pytest.raises(ValueError, match="dtypes"):
        ops.matmul(a, a.T.contiguous().to(torch.bfloat16), impl="cuda")


GENERATED = {
    "scal": (lambda: dpia_blas.strategy_scal(1 << 16, 2048), [(), (1 << 16,)]),
    "asum": (lambda: dpia_blas.strategy_asum(1 << 16, 2048), [(1 << 16,)]),
    "dot": (lambda: dpia_blas.strategy_dot(1 << 16, 2048),
            [(1 << 16,), (1 << 16,)]),
    "gemv": (lambda: dpia_blas.strategy_gemv(512, 300), [(512, 300), (300,)]),
    "rmsnorm": (lambda: dpia_blas.strategy_rmsnorm(64, 2560),
                [(64, 2560), (2560,)]),
    "softmax": (lambda: dpia_blas.strategy_softmax(256, 200), [(256, 200)]),
    "matmul": (lambda: dpia_blas.strategy_matmul(256, 256, 384, 64, 32),
               [(256, 256), (256, 384)]),
    "matmul_big_acc": (lambda: dpia_blas.strategy_matmul(128, 128, 2560),
                       [(128, 128), (128, 2560)]),
    # dotBlock's register-tiled product with ragged panels and k, and with
    # its tiles shrunk beside a 192 KB accumulator in shared memory
    "matmul_ragged": (lambda: dpia_blas.strategy_matmul(130, 74, 150, 130, 37),
                      [(130, 74), (74, 150)]),
    "matmul_shrunk": (lambda: dpia_blas.strategy_matmul(8, 100, 6000, 8, 100),
                      [(8, 100), (100, 6000)]),
    "naive_dot": (lambda: dpia_blas.naive_dot(4096), [(4096,), (4096,)]),
    "naive_matmul": (lambda: dpia_blas.naive_matmul(16, 24, 8),
                     [(16, 24), (24, 8)]),
}


@pytest.mark.parametrize("name", sorted(GENERATED))
def test_generated_program_matches_torch_stage3(cuda_device, name):
    """Each generated program against the plain version (the torch Stage
    III) on the same CUDA tensors; one launch per stage per call.  Sums run
    in another order: tolerance 1e-4 of the operands' scale."""
    build, shapes = GENERATED[name]
    prog = Program.from_builder(build, name=name).check().lower()
    fn = prog.compile("cuda")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    args = [torch.randn(s, generator=g, device=cuda_device) * 0.5
            for s in shapes]
    before = (fn.launches, stage3_cuda.launches)
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches - before[0] == len(fn.stages)
    assert stage3_cuda.launches - before[1] == len(fn.stages)
    want = prog.compile("torch")(*args)
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


@pytest.mark.parametrize("name", ["asum", "dot", "matmul", "matmul_big_acc"])
def test_generated_program_is_bitwise_deterministic(cuda_device, name):
    """asum and dot sum in the strategy's fixed order (a block tree per
    grid block, then one thread's fold over the partials) and matmul in one
    FMA chain per output: two calls on the same inputs agree bit for
    bit."""
    build, shapes = GENERATED[name]
    fn = Program.from_builder(build, name=name).check().lower().compile(
        "cuda")
    g = torch.Generator(device=cuda_device).manual_seed(1)
    args = [torch.randn(s, generator=g, device=cuda_device) for s in shapes]
    first = fn(*args)
    second = fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("op,args", [
    ("scal", [(), (8192,)]), ("asum", [(8192,)]), ("dot", [(8192,), (8192,)]),
    ("gemv", [(256, 64), (64,)]), ("rmsnorm", [(40, 256), (256,)]),
    ("softmax", [(24, 200)]), ("matmul", [(64, 96), (96, 32)])])
def test_dpia_cuda_rows_launch_and_match_plain(cuda_device, op, args):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    xs = [torch.randn(s, generator=g, device=cuda_device) for s in args]
    ops.reset_launch_counts()
    got = getattr(ops, op)(*xs, impl="dpia-cuda")
    torch.cuda.synchronize()
    assert ops.launch_counts()["dpia_cuda"] >= 1
    want = getattr(ops, op)(*xs, impl="plain")
    scale = max(1.0, want.abs().max().item())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


def test_generated_build_failure_raises(cuda_device):
    """A program whose build fails raises; nothing is computed instead."""
    fn = Program.from_builder(lambda: dpia_blas.strategy_dot(4096, 512),
                              name="broken").check().lower().compile("cuda")
    fn._fn.source += "\n#error this build is made to fail\n"
    x = torch.ones(4096, device=cuda_device)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fn(x, x)
    assert fn.launches == 0


# ---------------------------------------------------------------------------
# serving: the decode chunk as a CUDA graph, paged KV on the card
# ---------------------------------------------------------------------------

def _smoke(device, dtype):
    cfg = smoke_config("qwen3_4b", use_flash=True, dtype=dtype)
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=device).manual_seed(0),
                               device)
    return cfg, model, params


def _traffic(n=5):
    """Mixed lengths (one over the prefill chunk of 16), budgets, and one
    sampled top-k request."""
    lens, new = (9, 37, 4, 20, 13)[:n], (6, 5, 9, 4, 7)[:n]
    return [Request(prompt=[(7 * i + 3 * j) % 256 for j in range(lens[i])],
                    max_new_tokens=new[i],
                    temperature=0.8 if i == 1 else 0.0,
                    top_k=20 if i == 1 else 0) for i in range(n)]


def _engines(model, params, kind, graph):
    if kind == "static":
        return BatchedEngine(model, params, max_seq=64, chunk=4, graph=graph)
    return ContinuousEngine(model, params, max_seq=64, slots=2, chunk=4,
                            min_bucket=8, prefill_chunk=16, graph=graph,
                            kv_layout=kind, block_size=16)


@pytest.mark.parametrize("kind", ["static", "dense", "paged"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_tokens_equal_eager_tokens(cuda_device, kind, dtype):
    """The chunk replayed as a CUDA graph gives the eager chunk's tokens bit
    for bit, the sampled top-k request included; in fp32 the continuous
    engine gives the static engine's tokens (in bf16 the two round
    different computations: another prefill batch, attention path and
    decode width)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, model, params = _smoke(cuda_device, dtype)
    reqs = _traffic()
    graph = _engines(model, params, kind, True)
    eager = _engines(model, params, kind, False)
    want = eager.run(reqs, seed=3)
    assert graph.run(reqs, seed=3) == want
    assert graph.run(reqs, seed=3) == want            # replays only
    st = graph.stats()
    assert st["captures"] >= 1 and "captures" not in eager.stats()
    assert [len(o) for o in want] == [r.max_new_tokens for r in reqs]
    if dtype == "float32" and kind != "static":
        static = _engines(model, params, "static", False).run(reqs, seed=3)
        assert want == static


def test_paged_tokens_equal_dense_tokens_on_the_card(cuda_device):
    """Paged decode is the dense computation on a gathered view of the
    same shape, and paged prefill the dense one: bf16 tokens agree bit for
    bit, sampled request included."""
    _, model, params = _smoke(cuda_device, "bfloat16")
    reqs = _traffic()
    assert _engines(model, params, "dense", True).run(reqs, seed=1) == \
        _engines(model, params, "paged", True).run(reqs, seed=1)


def test_no_recapture_after_warm(cuda_device, caplog):
    """A continuous engine captures at most (slots, chunk, greedy) and
    (slots, chunk, sampled); new traffic of the same shapes replays.  A key
    first met after warm-up is captured, counted and named in a warning."""
    _, model, params = _smoke(cuda_device, "bfloat16")
    engine = _engines(model, params, "paged", True)
    engine.run(_traffic(), seed=0)
    first = engine.stats()
    assert first["recaptures_after_warm"] == 0
    assert sorted(first["graph_keys"]) == [(2, 4, False), (2, 4, True)]
    engine.run(list(reversed(_traffic(4))), seed=5)
    second = engine.stats()
    assert second["captures"] == first["captures"]
    assert second["recaptures_after_warm"] == 0
    greedy_only = _engines(model, params, "dense", True)
    greedy_only.run([_traffic()[0]], seed=0)          # warm on greedy alone
    with caplog.at_level("WARNING", logger="repro_torch.serve.engine"):
        greedy_only.run(_traffic(2), seed=0)          # a sampled request
    assert greedy_only.stats()["recaptures_after_warm"] == 1
    assert "(2, 4, True)" in caplog.text


def test_graph_launch_counts_are_exact_with_replays(cuda_device):
    """K1 counts every launch once per replay: (2 x 4 + 1) x (prefills +
    decode steps) for the smoke model; K3 once a layer per admission."""
    cfg, model, params = _smoke(cuda_device, "bfloat16")
    engine = _engines(model, params, "dense", True)
    engine.run(_traffic(), seed=0)                    # captures
    before = engine.stats()
    ops.reset_launch_counts()
    engine.run(_traffic(), seed=0)                    # replays only
    torch.cuda.synchronize()
    after = engine.stats()
    prefills = after["prefills"] - before["prefills"]
    steps = after["decode_steps"] - before["decode_steps"]
    admits = (after["scheduler"]["admits"]
              - before["scheduler"]["admits"])
    assert after["captures"] == before["captures"]
    assert ops.launch_counts() == {
        "rmsnorm": (4 * cfg.n_layers + 1) * (prefills + steps),
        "flash_attention": cfg.n_layers * admits,
        "matmul": 0, "dpia_cuda": 0, "rmsnorm_bwd": 0,
        "flash_attention_bwd": 0}


@pytest.mark.parametrize("kind", ["static", "dense", "paged"])
def test_counted_launches_are_the_kernels_the_card_ran(cuda_device, kind):
    """The counts a replay adds on the host against torch.profiler's trace
    of the card: every K1 and K3 kernel the graphs ran, counted once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _, model, params = _smoke(cuda_device, "bfloat16")
    engine = _engines(model, params, kind, True)
    engine.run(_traffic(), seed=0)                    # captures
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run(_traffic(), seed=0)                # replays only
        torch.cuda.synchronize()
        time.sleep(0.2)       # the last kernels' records land in the window
    ran = {"rmsnorm": 0, "flash_attention": 0}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name, kernel in (("rmsnorm", "rmsnorm_kernel"),
                                 ("flash_attention", "flash_fwd")):
                ran[name] += e.count if kernel in e.key else 0
    counts = ops.launch_counts()
    assert ran == {k: counts[k] for k in ran} and ran["rmsnorm"] > 0


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("sampled", [False, True])
def test_decode_chunk_never_syncs_the_host(cuda_device, kind, sampled):
    """The chunk a graph captures, run eagerly under the sync detector:
    decode steps, the paged view and sampling queue work without waiting
    for the card."""
    _, model, params = _smoke(cuda_device, "bfloat16")
    engine = _engines(model, params, kind, False)
    engine.run(_traffic(2), seed=0)                   # builds K1 / K3
    rid = engine.submit(_traffic(1)[0])
    engine.step_chunk()                               # admitted, decoding
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            engine._chunk_fn(engine.st, sampled)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    engine.cancel(rid)


def test_parked_lane_never_writes_a_live_lanes_page_on_the_card(cuda_device):
    """As the CPU test: a parked lane whose clamped write would alias a
    live lane's (page, offset) in the same index_put_ writes the trash page
    instead, whatever token it decodes."""
    cfg, model, params = _smoke(cuda_device, "float32")
    nb, bs, max_seq = 10, 8, 32
    live_pos = 2 * bs + max_seq % bs
    bt = torch.tensor([[0, 1, nb - 1, nb], [nb] * 4], device=cuda_device)
    pos = torch.tensor([live_pos, max_seq], device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    shape = (cfg.n_layers, nb + 1, bs, cfg.n_kv_heads, cfg.hd)
    k0 = torch.randn(shape, generator=g, device=cuda_device)
    v0 = torch.randn(shape, generator=g, device=cuda_device)
    runs = []
    for parked_tok in (7, 11):
        cache = KVCache(k0.clone(), v0.clone())
        tok = torch.tensor([[5], [parked_tok]], device=cuda_device)
        logits, _ = model.decode_step(params, tok, cache, pos,
                                      block_tables=bt)
        runs.append((logits, cache))
    (l0, c0), (l1, c1) = runs
    assert torch.equal(l0[0], l1[0])
    assert torch.equal(c0.k[:, :nb], c1.k[:, :nb])
    assert not torch.equal(c0.k[:, nb], c1.k[:, nb])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_attention_on_the_card_matches_the_upcast_form(cuda_device,
                                                              dtype):
    """The card's decode attention (the cache read in its own dtype, fp32
    accumulation, probabilities rounded to the cache dtype) against the
    plain version's fp32 upcast on the same inputs: the same products summed
    in another order, so within fp32 rounding, plus one rounding of the
    output to ``dtype`` (bf16: 2**-8 relative)."""
    cfg = smoke_config("qwen3_4b", n_heads=32, n_kv_heads=8, head_dim=128,
                       d_model=256, dtype=str(dtype).split(".")[-1])
    g = torch.Generator(device=cuda_device).manual_seed(0)
    b, t = 4, 256
    q = torch.randn((b, 1, 32, 128), generator=g, device=cuda_device)
    k = torch.randn((b, t, 8, 128), generator=g, device=cuda_device)
    v = torch.randn((b, t, 8, 128), generator=g, device=cuda_device)
    q, k, v = (0.3 * q).to(dtype), (0.3 * k).to(dtype), v.to(dtype)
    wo = torch.eye(32 * 128, device=cuda_device)      # fp32, as x_dtype
    pos = torch.tensor([0, 17, 200, 255], device=cuda_device)
    got = attn_mod._attend_token(cfg, q, k, v, pos, True, torch.float32, wo)
    want = attn_mod._attend_token(cfg, q.cpu(), k.cpu(), v.cpu(), pos.cpu(),
                                  True, torch.float32, wo.cpu())
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# options scopes and the AOT store on the card
# ---------------------------------------------------------------------------

def test_ops_under_options_launch_the_kernel_their_impl_names(cuda_device):
    """No impl=: the default options keep rmsnorm on K1 and attention on K3;
    options(backend="cuda") takes matmul to K2; options(backend=
    "dpia-cuda") takes the DPIA ops to K4 (one launch per stage), and K3
    still serves attention; options(backend="plain") launches nothing."""
    from repro_torch import compiler
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((64, 256), generator=g, device=cuda_device)
    w = torch.ones(256, device=cuda_device)
    b = torch.randn((256, 128), generator=g, device=cuda_device)
    q = torch.randn((2, 64, 64), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    v = torch.randn(4096, generator=g, device=cuda_device)

    def counts(fn):
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return ops.launch_counts()

    zero = {"rmsnorm": 0, "matmul": 0, "flash_attention": 0, "dpia_cuda": 0,
            "rmsnorm_bwd": 0, "flash_attention_bwd": 0}
    assert counts(lambda: ops.rmsnorm(x, w)) == {**zero, "rmsnorm": 1}
    assert counts(lambda: ops.flash_attention(q, q, q)) == {
        **zero, "flash_attention": 1}
    assert counts(lambda: ops.matmul(x, b)) == zero
    with compiler.options(backend="cuda"):
        p = mm_mod.plan(64, 128, 256, torch.float32)
        assert counts(lambda: ops.matmul(x, b)) == {**zero,
                                                    "matmul": p.launches}
    with compiler.options(backend="dpia-cuda", autotune=False):
        fn = ops.compiled("asum", "cuda", n=4096)
        got = {}
        assert counts(lambda: got.setdefault("asum", ops.asum(v))) == {
            **zero, "dpia_cuda": len(fn.stages)}
        assert counts(lambda: ops.flash_attention(q, q, q)) == {
            **zero, "flash_attention": 1}
    torch.testing.assert_close(got["asum"], v.abs().sum(), rtol=1e-5,
                               atol=1e-5 * v.abs().sum().item())
    with compiler.options(backend="plain"):
        assert counts(lambda: (ops.rmsnorm(x, w),
                               ops.flash_attention(q, q, q))) == zero


def test_aot_reload_on_the_card_builds_nothing(cuda_device, tmp_path):
    """Executors saved to the AOT store and loaded into a fresh cache find
    the libraries already built (the same generated sources): no nvcc
    runs, and the outputs are bitwise the first executors'."""
    from repro_torch import compiler
    from repro_torch.compiler import executors
    from repro_torch.kernels import _build
    ops.clear_caches()
    g = torch.Generator(device=cuda_device).manual_seed(1)
    a = torch.randn((256, 128), generator=g, device=cuda_device)
    x = torch.randn(128, generator=g, device=cuda_device)
    with compiler.options(backend="dpia-cuda"):
        want = [ops.gemv(a, x), ops.dot(x, x)]
    torch.cuda.synchronize()
    compiler.executor_cache().save_aot(str(tmp_path))
    fresh = executors.ExecutorCache()
    runs = _build.nvcc_runs
    assert fresh.load_aot(str(tmp_path)) == 2
    by_kernel = {fn.program.kernel: fn for fn in fresh.values()}
    got = [by_kernel["gemv"](a, x), by_kernel["dot"](x, x)]
    torch.cuda.synchronize()
    assert _build.nvcc_runs == runs
    for gt, w in zip(got, want):
        assert torch.equal(gt, w)
    ops.clear_caches()


@pytest.mark.parametrize("kernel,shape", [
    ("dot", {"n": 1 << 16}), ("matmul", {"m": 128, "k": 256, "n": 128}),
    ("softmax", {"rows": 256, "d": 200})])
def test_measured_tune_on_the_card(cuda_device, tmp_path, kernel, shape):
    """``tune(backend="cuda", measure=True)`` compiles each picked
    candidate with K4, builds them in one batch and times them on the
    card; nothing is dropped; the winner, run through the op table under
    the tuned options, matches its plain version (the torch Stage III on
    the same card tensors); a second call is a cache hit."""
    from repro_torch import autotune, compiler
    from repro_torch.autotune import measure, space
    ops.clear_caches()
    path = str(tmp_path / "t.json")
    dropped = {}
    res = autotune.tune(kernel, backend="cuda", cache=path, top_k=3,
                        iters=3, verify=True, dropped=dropped, **shape)
    assert res.source == "measured" and dropped == {}
    assert len(res.timings) >= 2
    assert all(t > 0 for t in res.timings.values())
    cand = space.candidate_from_params(kernel, res.params, **shape)
    fn, args = measure.compile_candidate(cand, "cuda")
    plain = cand.program().check().lower().compile("torch")
    got, want = fn(*args), plain(*args)
    torch.cuda.synchronize()
    tol = 1e-4 * float(want.abs().max()) if kernel == "dot" else 1e-4
    torch.testing.assert_close(got, want, rtol=1e-4, atol=tol)
    with compiler.options(backend="dpia-cuda", autotune=True,
                          tuning_cache=path):
        op = getattr(ops, kernel)(*args)
        (key,) = compiler.executor_cache().keys()
    assert torch.equal(op, got) and key.endswith(res.params_key())
    assert autotune.tune(kernel, backend="cuda", cache=path,
                         **shape).source == "cache"
    ops.clear_caches()


# ---------------------------------------------------------------------------
# serving resilience under the graph
# ---------------------------------------------------------------------------

def _syncs(fn) -> int:
    """The host syncs ``fn()`` makes: the sync detector in warn mode."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_a_decode_boundary_reads_the_host_once(cuda_device, kind):
    """With the NaN guard on, a boundary that only decodes (a replay)
    makes one device-to-host read: the tokens and the guard's flags
    together."""
    _, model, params = _smoke(cuda_device, "bfloat16")
    engine = _engines(model, params, kind, True)
    engine.run(_traffic(2), seed=0)                   # captures
    assert engine.resilience.nan_guard
    rid = engine.submit(Request(prompt=list(range(9)), max_new_tokens=30))
    engine.step_chunk()                               # admitted, decoding
    assert _syncs(engine.step_chunk) == 1
    assert engine.stats()["recaptures_after_warm"] == 0
    engine.cancel(rid)


def _drill(engine, reqs, spec_of):
    from repro_torch.testing import faults
    rids = [engine.submit(r, stream=i) for i, r in enumerate(reqs)]
    with faults.inject(spec_of(rids)):
        while not engine.sched.idle:
            engine.step_chunk()
    return [engine.take_result(rid) for rid in rids]


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_nan_guard_quarantines_inside_the_replayed_chunk(cuda_device, kind):
    """The flag is computed by the captured graph: a poisoned lane fails,
    the other requests keep the fault-free tokens (the sampled one
    included), no capture; paged, the trash page stays finite."""
    _, model, params = _smoke(cuda_device, "bfloat16")
    reqs = _traffic()
    engine = _engines(model, params, kind, True)
    want = engine.run(reqs, seed=0)                   # captures both keys
    res = _drill(engine, reqs,
                 lambda rids: f"serve.nan_decode(req_id={rids[2]})")
    assert [r.state for r in res] == ["ok", "ok", "failed", "ok", "ok"]
    assert [list(r.tokens) for r in res if r.ok] == [
        w for i, w in enumerate(want) if i != 2]
    st = engine.stats()
    assert st["resilience"]["nan_quarantines"] == 1
    assert st["recaptures_after_warm"] == 0
    if kind == "paged":
        k, v = engine.st.cache
        assert torch.isfinite(k[:, engine.kv_blocks]).all()
        assert torch.isfinite(v[:, engine.kv_blocks]).all()


def test_chunk_failure_rebuild_keeps_the_graphs_buffers(cuda_device):
    """Past the retry budget the in-flight requests fail and the buffers
    are rebuilt in place: the same tensors, no capture, and the queued
    requests replay the graph to the fault-free tokens."""
    _, model, params = _smoke(cuda_device, "bfloat16")
    reqs = _traffic()
    engine = _engines(model, params, "paged", True)
    want = engine.run(reqs, seed=0)
    st = engine.st
    ptrs = [t.data_ptr() for t in (*st.cache, st.tokens, st.pos, st.out,
                                   st.block_tables)]
    captures = engine.stats()["captures"]
    res = _drill(engine, reqs, lambda rids: "serve.chunk_error(times=3)")
    failed = [i for i, r in enumerate(res) if r.state == "failed"]
    assert failed and len(failed) < len(reqs)
    assert all(list(r.tokens) == want[i] for i, r in enumerate(res)
               if r.ok)
    assert engine.st is st and ptrs == [
        t.data_ptr() for t in (*st.cache, st.tokens, st.pos, st.out,
                               st.block_tables)]
    stats = engine.stats()
    assert stats["captures"] == captures
    assert stats["recaptures_after_warm"] == 0
    assert stats["resilience"]["chunk_quarantines"] == 1


def test_degradation_captures_the_dense_chunk_anew(cuda_device):
    """paged -> dense drops the paged chunk's graphs (they read the page
    pools) and captures the dense chunk: not a re-capture after warm-up;
    requests admitted after it get the fault-free (paged = dense) tokens."""
    from repro_torch import obs
    _, model, params = _smoke(cuda_device, "bfloat16")
    reqs = _traffic()
    engine = _engines(model, params, "paged", True)
    want = engine.run(reqs, seed=0)
    graphs = engine._graphs
    obs.clear_decisions()
    res = _drill(engine, reqs, lambda rids: "serve.pool_corrupt(after=1)")
    assert engine.kv_layout == "dense" and engine._graphs is not graphs
    assert engine._graphs.captures >= 1
    assert any(r.ok for r in res) and any(r.state == "failed" for r in res)
    assert all(list(r.tokens) == want[i] for i, r in enumerate(res)
               if r.ok)
    assert [d.origin for d in obs.decisions()].count(
        "degraded(paged->dense)") == 1
    assert engine.run(reqs, seed=0) == want           # dense, replays
    assert engine.stats()["recaptures_after_warm"] == 0


def test_nan_guard_changes_no_token(cuda_device):
    """The guard is pure observation: static and continuous engines give
    the same tokens with it on and off."""
    _, model, params = _smoke(cuda_device, "bfloat16")
    from repro_torch.serve.resilience import ResilienceConfig
    off = ResilienceConfig(nan_guard=False)
    reqs = _traffic()
    for kind in ("static", "paged"):
        on = _engines(model, params, kind, True).run(reqs, seed=2)
        eng = (BatchedEngine(model, params, max_seq=64, chunk=4,
                             resilience=off) if kind == "static" else
               ContinuousEngine(model, params, max_seq=64, slots=2, chunk=4,
                                min_bucket=8, prefill_chunk=16,
                                kv_layout="paged", block_size=16,
                                resilience=off))
        assert eng.run(reqs, seed=2) == on


# ---------------------------------------------------------------------------
# training: the backward kernels of K1 and K3, and the train step
# ---------------------------------------------------------------------------

# backward kernel against its plain version, |err| <= atol * max(1,
# max|plain|) + rtol * |plain|: fp32 another order of sums; bf16 one
# rounding of each gradient (chip_smoke phase 13a's tolerances).  The floor
# of 1: dx is a difference of terms of order 1 (r * dn and x * r^3 *
# mean(dn * x)), which cancel to ~1e-6 for a row of one element.
BWD_TOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (1e-2, 1e-2)}


def _close_bwd(got, want, dtype):
    atol, rtol = BWD_TOL[dtype]
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= atol * max(1.0, w.abs().max().item())
            + rtol * w.abs()).all(), (g - w).abs().max().item()


@pytest.mark.parametrize("shape", [(1, 1), (3, 24), (37, 128), (200, 2560),
                                   (5000, 128), (2, 9000), (2, 9001),
                                   (2048, 2560), (65536, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_matches_plain(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x, dy = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
             for _ in range(2))
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g,
                               device=cuda_device)).to(dtype)
    before = rms_mod.backward.launches
    dx, dw = rms_mod._launch_bwd(x, w, dy, 1e-6)
    torch.cuda.synchronize()
    assert rms_mod.backward.launches == before + 1
    for got, want in zip((dx, dw), ref.rmsnorm_bwd(x, w, dy)):
        _close_bwd(got, want, dtype)
    again = rms_mod._launch_bwd(x, w, dy, 1e-6)      # a fixed order of sums
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.parametrize("bh,bkv,s,d,causal", [
    (2, 1, 37, 16, True), (8, 2, 70, 64, True), (4, 4, 33, 128, False),
    (32, 8, 128, 128, True), (8, 2, 200, 32, True), (128, 32, 512, 128, True),
    # head dim 80: the D kernels' rows on 16 (bf16) or 32 (fp32) lanes
    (64, 64, 512, 80, True), (8, 2, 70, 80, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, bh, bkv, s, d,
                                                  causal, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q = (0.5 * torch.randn((bh, s, d), generator=g,
                           device=cuda_device)).to(dtype)
    k = (0.5 * torch.randn((bkv, s, d), generator=g,
                           device=cuda_device)).to(dtype)
    v = torch.randn((bkv, s, d), generator=g, device=cuda_device).to(dtype)
    do = torch.randn((bh, s, d), generator=g, device=cuda_device).to(dtype)
    o, lse = fa_mod._launch(q, k, v, causal=causal, scale=None, q_offset=0,
                            with_lse=True)
    want_o, want_lse = ref.flash_attention(q, k, v, causal=causal,
                                           return_lse=True)
    torch.testing.assert_close(o.float(), want_o.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    before = fa_mod.backward.launches
    by_variant = dict(fa_mod.backward.launches_by_variant)
    got = fa_mod._launch_bwd(q, k, v, o, lse, do, causal=causal, scale=None)
    torch.cuda.synchronize()
    assert fa_mod.backward.launches == before + 1
    by_variant["mma" if dtype == torch.bfloat16 else "tf32x3"] += 1
    assert fa_mod.backward.launches_by_variant == by_variant
    want = ref.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    for a, b in zip(got, want):
        _close_bwd(a, b, dtype)
    again = fa_mod._launch_bwd(q, k, v, o, lse, do, causal=causal,
                               scale=None)              # no atomics
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_takes_a_misaligned_view(cuda_device, dtype):
    """The backward stages rows by 16-byte cp.async copies: a contiguous
    dO taken one element into a flat buffer is copied to an aligned buffer
    first, and the gradients are those of an aligned dO, bit for bit."""
    bh, s, d = 2, 16, 64
    q, k, v = (torch.randn((bh, s, d), device=cuda_device).to(dtype)
               for _ in range(3))
    o, lse = fa_mod._launch(q, k, v, causal=True, scale=None, q_offset=0,
                            with_lse=True)
    do = torch.randn(bh * s * d + 1, device=cuda_device).to(dtype)[1:]
    do = do.view(bh, s, d)
    assert do.is_contiguous() and do.data_ptr() % 16
    before = fa_mod.backward.launches
    got = fa_mod._launch_bwd(q, k, v, o, lse, do, causal=True, scale=None)
    assert fa_mod.backward.launches == before + 1
    want = fa_mod._launch_bwd(q, k, v, o, lse, do.clone(), causal=True,
                              scale=None)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_backward_sets_every_gradient_on_the_card(cuda_device, dtype):
    """loss.backward() through K1, K3 and their backward kernels (remat on):
    every parameter's gradient is set and finite, each backward kernel
    launched once a forward launch, and the card's gradients agree with
    the CPU's (plain versions) in fp32."""
    from repro_torch.optim import adamw
    cfg, model, params = _smoke(cuda_device, dtype)
    assert cfg.remat
    for _, p in adamw.leaves(params):
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab, (2, 24), generator=g)
             for k in ("tokens", "labels")}
    ops.reset_launch_counts()
    loss = model.loss(params, {k: v.to(cuda_device)
                               for k, v in batch.items()})
    loss.backward()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    per_pass = 4 * cfg.n_layers + 1
    assert counts["rmsnorm_bwd"] == per_pass
    assert counts["rmsnorm"] == 2 * per_pass - 1       # remat's recompute
    assert counts["flash_attention_bwd"] == cfg.n_layers
    assert counts["flash_attention"] == 2 * cfg.n_layers
    leaves = adamw.leaves(params)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for _, p in leaves)
    if dtype == "float32":
        cpu = adamw.tree_map(lambda t: t.detach().cpu().requires_grad_(),
                             params)
        model.loss(cpu, batch).backward()
        for (path, p), (_, c) in zip(leaves, adamw.leaves(cpu)):
            torch.testing.assert_close(p.grad.cpu(), c.grad, rtol=1e-4,
                                       atol=1e-5, msg=str(path))


def test_inference_launches_no_backward_and_no_function(cuda_device):
    """Grad disabled (or no input requiring grad): the forward alone, K1 /
    K3 counts those of a forward pass, no backward launch; the continuous
    engine re-captures nothing after warm-up."""
    cfg, model, params = _smoke(cuda_device, "bfloat16")
    tokens = torch.randint(0, cfg.vocab, (2, 12), device=cuda_device)
    ops.reset_launch_counts()
    with torch.no_grad():
        out = model.forward(params, tokens)
    assert out.grad_fn is None
    per_pass = 4 * cfg.n_layers + 1
    assert ops.launch_counts() == {
        "rmsnorm": per_pass, "flash_attention": cfg.n_layers, "matmul": 0,
        "dpia_cuda": 0, "rmsnorm_bwd": 0, "flash_attention_bwd": 0}
    engine = _engines(model, params, "dense", True)
    engine.run(_traffic(), seed=0)
    captures = engine.stats()["captures"]
    ops.reset_launch_counts()
    engine.run(_traffic(), seed=0)
    counts = ops.launch_counts()
    assert counts["rmsnorm_bwd"] == counts["flash_attention_bwd"] == 0
    assert counts["rmsnorm"] > 0 and counts["flash_attention"] > 0
    assert engine.stats()["captures"] == captures
    assert engine.stats()["recaptures_after_warm"] == 0


def test_a_missing_backward_kernel_raises(cuda_device):
    """A CUDA tensor whose backward has no kernel raises; nothing falls
    back to the plain version: rows longer than the backward's shared
    memory holds (the forward takes them), a gradient through K3 at
    q_offset > 0."""
    x = torch.randn(2, rms_mod.BWD_MAX_D + 64, device=cuda_device,
                    requires_grad=True)
    w = torch.ones(x.shape[-1], device=cuda_device, requires_grad=True)
    y = ops.rmsnorm(x, w)
    with pytest.raises(ValueError, match="rmsnorm_bwd"):
        y.sum().backward()
    q = torch.randn(2, 3, 16, device=cuda_device, requires_grad=True)
    kv = torch.randn(2, 9, 16, device=cuda_device)
    with pytest.raises(ValueError, match="q_offset 0"):
        ops.flash_attention(q, kv, kv, q_offset=6)


def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Two steps of the smoke config (fp32, TF32 off) from one state on
    the card and on the CPU: the losses, and the state after step 1."""
    import copy

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_state, make_train_step
    cfg = smoke_config("qwen3_4b")
    model = Model(cfg)
    cpu = make_train_state(model, torch.Generator().manual_seed(0),
                           device="cpu")
    card = adamw.tree_map(lambda t: t.detach().to(cuda_device)
                          .requires_grad_(t.requires_grad), cpu)
    step = make_train_step(model, base_lr=1e-3, warmup=2)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4))
    for i in range(2):
        batch = data.global_batch_at(i)
        cpu, m_cpu = step(cpu, batch)
        card, m_card = step(card, copy.deepcopy(batch))
        np_tol = dict(rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(torch.tensor(m_card["loss"]),
                                   torch.tensor(m_cpu["loss"]), **np_tol)
        if i == 0:
            for (path, a), (_, b) in zip(adamw.leaves(card),
                                         adamw.leaves(cpu)):
                a, b = a.detach().cpu(), b.detach()
                assert ((a - b).abs() <= 1e-5 * b.abs().max()
                        + 1e-4 * b.abs()).all(), path


def _mesh_one_rank(rank, world, n, rows, d):
    """One NCCL rank: mesh_dot and mesh_rmsnorm on a ``data=1`` mesh, each
    shard's body through K4, against the plain versions."""
    from repro_torch import mesh
    from repro_torch.launch.mesh import make_mesh
    m = make_mesh((1,), ("data",))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, generator=g, device="cuda")
    y = torch.randn(n, generator=g, device="cuda")
    xr = torch.randn(rows, d, generator=g, device="cuda")
    w = 1 + 0.1 * torch.randn(d, generator=g, device="cuda")
    out = {}
    for name, term, args, want in [
            ("dot", mesh.mesh_dot(n, "data", 1), (x, y), ref.dot(x, y)),
            ("rmsnorm", mesh.mesh_rmsnorm(rows, d, axis="data", shards=1),
             (xr, w), ref.rmsnorm(xr, w))]:
        fn = Program(*term).compile("shardmap", mesh=m, inner="cuda")
        before = fn.launches
        got = fn(*args).to_local()
        torch.cuda.synchronize()
        out[name] = (fn.launches - before, len(fn.shard.stages),
                     float((got - want).abs().max()))
    out["dot_scale"] = float((x * y).abs().sum())
    return out


def test_mesh_programs_on_one_nccl_rank(cuda_device):
    """The shardmap backend over NCCL (one rank: NCCL refuses two ranks on
    one card), each shard's body generated CUDA."""
    from repro_torch.testing import ranks
    res = ranks.spawn(_mesh_one_rank, 1, args=(1 << 20, 800, 2560),
                      backend="nccl", device="cuda", timeout=300)[0]
    for name in ("dot", "rmsnorm"):
        launches, stages, _ = res[name]
        assert launches == stages >= 1, (name, res[name])
    assert res["dot"][2] <= 1e-5 * res["dot_scale"]
    assert res["rmsnorm"][2] <= 2 * TOL[torch.float32]


def test_capture_failure_raises(cuda_device, monkeypatch):
    """A chunk that cannot be captured (here: a host sync inside it) raises
    from the engine; it never quietly runs eagerly."""
    _, model, params = _smoke(cuda_device, "bfloat16")
    engine = _engines(model, params, "dense", True)
    real = model.decode_step

    def syncing(*a, **kw):
        out = real(*a, **kw)
        out[0].sum().item()                   # a host sync
        return out
    monkeypatch.setattr(model, "decode_step", syncing)
    with pytest.raises(RuntimeError):
        engine.run(_traffic(2), seed=0)
    assert engine.stats()["captures"] == 0


# ---------------------------------------------------------------------------
# sharded serving: two gloo ranks sharing the card
# ---------------------------------------------------------------------------

def _greedy_traffic():
    return [Request(prompt=[(5 * i + 2 * j) % 256 for j in range(n)],
                    max_new_tokens=6) for i, n in enumerate((9, 21, 4, 13))]


LOSS = "mesh.host_lost(host=1, after=1)"
# (run, kv layout, fault plan, route): the groups' own backend, or, "as
# nccl", the groups taken for NCCL's while the gathers run over gloo
SHARDED_RUNS = (("clean", "dense", [], "own"),
                ("loss", "dense", [LOSS], "own"),
                ("loss_paged", "paged", [LOSS], "own"),
                ("as_nccl", "dense", [LOSS], "as_nccl"),
                ("as_nccl_paged", "paged", [LOSS], "as_nccl"))


def _sharded_card_rank(rank, world, runs):
    """Smoke qwen3-4b in float32 through ``ShardedEngine`` on a ``data=2``
    mesh with ``hosts=2``, the weights made on the CPU from seed 0: each
    of ``runs`` (:data:`SHARDED_RUNS`) on a fresh engine, recording its
    tokens, launches, descriptor and, taken as NCCL's, every gather's
    devices (``tests/_sharded_ranks.exchange_as_nccl``)."""
    import contextlib

    from _sharded_ranks import exchange_as_nccl
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ShardedEngine
    from repro_torch.testing import faults
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(smoke_config("qwen3_4b", use_flash=True))
    params = _to(model.init_params(torch.Generator().manual_seed(0), "cpu"),
                 "cuda")
    mesh = make_mesh((world,), ("data",))
    out = {}
    for name, layout, plan, route in runs:
        seen = []
        with (exchange_as_nccl(seen) if route == "as_nccl"
              else contextlib.nullcontext()):
            eng = ShardedEngine(model, params, max_seq=64, slots=4, chunk=4,
                                min_bucket=8, prefill_chunk=16, mesh=mesh,
                                hosts=2, kv_layout=layout)
            ops.reset_launch_counts()
            with faults.inject(*plan):
                toks = eng.run(_greedy_traffic(), seed=3)
        torch.cuda.synchronize()
        st = eng.stats()
        out[name] = {"tokens": toks, "launches": ops.launch_counts(),
                     "descriptor": st["mesh"]["descriptor"],
                     "left": eng.left, "gathers": seen,
                     "host_losses": st["resilience"]["host_losses"]}
    return out


@pytest.fixture(scope="module")
def sharded_want():
    """The single-process engine's greedy tokens on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    model = Model(smoke_config("qwen3_4b", use_flash=True))
    p_cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    return ContinuousEngine(model, p_cpu, max_seq=64, slots=4, chunk=4,
                            min_bucket=8, prefill_chunk=16).run(
        _greedy_traffic(), seed=3)


@pytest.fixture(scope="module")
def sharded_on_card(sharded_want):
    """Every run of :data:`SHARDED_RUNS` on two gloo ranks sharing the
    card (NCCL refuses two ranks on one GPU)."""
    from repro_torch.testing import ranks
    return ranks.spawn(_sharded_card_rank, 2, backend="gloo",
                       device="cuda", timeout=300, args=(SHARDED_RUNS,))


def _check_loss(res, name, want):
    """Host 1 lost at the second boundary: rank 0 serves every request on
    ``data=1`` to the fault-free tokens, rank 1 leaves."""
    assert res[0][name]["tokens"] == want
    assert res[0][name]["descriptor"] == "data=1"
    assert res[0][name]["host_losses"] == 1
    assert res[1][name]["tokens"] is None and res[1][name]["left"]


def test_sharded_engine_on_two_gloo_ranks_matches_cpu(sharded_on_card,
                                                      sharded_want):
    """Two ranks share the card over gloo: each launches K1 and K3 for its
    own slots, and the greedy tokens equal the single-process engine's on
    the CPU; after host 1 is lost, rank 0 serves every request on
    ``data=1`` to the same tokens, dense and paged."""
    for r in sharded_on_card:
        assert r["clean"]["tokens"] == sharded_want
        assert r["clean"]["descriptor"] == "data=2"
        counts = r["clean"]["launches"]
        assert counts["rmsnorm"] > 0 and counts["flash_attention"] > 0
    for name in ("loss", "loss_paged"):
        _check_loss(sharded_on_card, name, sharded_want)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sharded_engine_hands_an_nccl_group_card_tensors(sharded_on_card,
                                                         sharded_want,
                                                         layout):
    """With the groups taken for NCCL's (which takes no host tensor),
    every gather, the host-loss re-placement's included, gets its input
    and outputs on the card, and the loss ends token-identical."""
    name = "as_nccl" if layout == "dense" else "as_nccl_paged"
    for r in sharded_on_card:
        assert r[name]["gathers"]
        for device, outs, _, _ in r[name]["gathers"]:
            assert (device, outs) == ("cuda", ["cuda"])
    _check_loss(sharded_on_card, name, sharded_want)


def test_sharded_engine_over_nccl_survives_a_host_loss(sharded_want):
    """Two ranks on two cards over NCCL: the clean run and the host-loss
    drill, dense and paged, end with the CPU's tokens."""
    from repro_torch.testing import ranks
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (NCCL takes one rank a GPU)")
    runs = [r for r in SHARDED_RUNS if r[3] == "own"]
    res = ranks.spawn(_sharded_card_rank, 2, backend="nccl", device="cuda",
                      timeout=300, args=(runs,))
    for r in res:
        assert r["clean"]["tokens"] == sharded_want
    for name in ("loss", "loss_paged"):
        _check_loss(res, name, sharded_want)


# ---- training on the data axes ---------------------------------------------

TRAIN_KW = dict(base_lr=1e-3, warmup=1, total_steps=10)
COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather_single",
               "reduce_scatter_tensor", "reduce_scatter_single")


def _launches_a_step(cfg):
    per_pass = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    return {"rmsnorm": 2 * per_pass - 1, "rmsnorm_bwd": per_pass,
            "flash_attention": 2 * cfg.n_layers,
            "flash_attention_bwd": cfg.n_layers}


def _state_bytes(state):
    from repro_torch.optim import adamw
    return sum(t.numel() * t.element_size()
               for _, leaf in adamw.leaves(state)
               for t in (leaf if isinstance(leaf, adamw.QTensor) else (leaf,)))


def _sharded_train_card_rank(rank, world):
    """Smoke qwen3-4b (DP) and smoke yi-9b made FSDP (head dim 16), fp32,
    on ``world`` gloo ranks sharing the card, with the groups taken for NCCL's
    (``dist.get_backend`` reads ``"nccl"``): 2 steps each, every step's K1
    / K3 launches on this rank, every tensor handed to a collective
    (device type, by collective), and a checkpoint saved and restored on
    the mesh."""
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ctx
    from repro_torch.train.step import (make_train_state, make_train_step,
                                        state_specs)
    torch.backends.cuda.matmul.allow_tf32 = False
    seen = []
    saved = {n: getattr(dist, n) for n in COLLECTIVES + ("get_backend",)
             if hasattr(dist, n)}

    def wrap(name, fn):
        def call(*args, **kw):
            seen.append((name, sorted({a.device.type for a in args
                                       if torch.is_tensor(a)})))
            return fn(*args, **kw)
        return call
    for n, fn in saved.items():
        if n != "get_backend":
            setattr(dist, n, wrap(n, fn))
    dist.get_backend = lambda group=None: "nccl"
    out = {}
    try:
        mesh = make_mesh((world, 1), ("data", "model"))
        for name, cfg in (
                ("dp", smoke_config("qwen3_4b")),
                # K3 takes head dims 16-128: the smoke config's 8 -> 16
                ("fsdp", smoke_config("yi_9b", fsdp=True, head_dim=16))):
            model = Model(cfg)
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                          global_batch=4))
            state = make_train_state(
                model, torch.Generator(device="cuda").manual_seed(0),
                mesh=mesh)
            step = make_train_step(model, mesh, **TRAIN_KW)
            rows = []
            for i in range(2):
                ops.reset_launch_counts()
                state, m = step(state, data.global_batch_at(i))
                torch.cuda.synchronize()
                rows.append((m, ops.launch_counts(),
                             ops.launch_counts_by_variant()))
            specs = state_specs(make_train_state(
                model, torch.Generator(), device="meta"), mesh, cfg)
            with tempfile.TemporaryDirectory() as d:
                d = os.path.join(d, "ckpt")  # every rank's own temp dir
                mgr = CheckpointManager(d, mesh=mesh, specs=specs,
                                        async_save=False)
                mgr.save(2, state)
                dist.barrier()
            out[name] = {"rows": rows, "state_bytes": _state_bytes(state),
                         "collectives": dict(step.placement.group.counts)}
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
        ctx.set_mesh(None)
    out["seen"] = seen
    return out


@pytest.fixture(scope="module")
def sharded_train_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.testing import ranks
    return ranks.spawn(_sharded_train_card_rank, 2, backend="gloo",
                       device="cuda", timeout=300)


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_sharded_train_launches_k1_k3_on_every_rank(sharded_train_on_card,
                                                    mode):
    """Each rank runs K1 and K3, forward and backward, on its shard of the
    batch: the exact count of a remat step, K3 all ``tf32x3`` (fp32), and
    every rank reports the same loss and norm."""
    cfg = smoke_config("qwen3_4b" if mode == "dp" else "yi_9b")
    want = _launches_a_step(cfg)        # counts depend on layers, qk_norm
    metrics = []
    for r in sharded_train_on_card:
        for m, counts, by_variant in r[mode]["rows"]:
            assert m["applied"] == 1
            assert {k: counts[k] for k in want} == want
            assert by_variant["flash_attention"]["tf32x3"] == \
                want["flash_attention"]
            assert by_variant["flash_attention_bwd"]["tf32x3"] == \
                want["flash_attention_bwd"]
        metrics.append([(m["loss"], m["grad_norm"])
                        for m, _, _ in r[mode]["rows"]])
    assert metrics[0] == metrics[1]
    counts = sharded_train_on_card[0][mode]["collectives"]
    assert counts["all_reduce"] > 0
    assert (counts.get("all_gather", 0) > 0) == (mode == "fsdp")


def test_sharded_train_hands_an_nccl_group_card_tensors(
        sharded_train_on_card):
    """With the groups taken for NCCL's (which takes no host tensor), every
    tensor the step, its FSDP gathers and the mesh checkpoint hand to a
    collective is on the card."""
    for r in sharded_train_on_card:
        kinds = {name for name, _ in r["seen"]}
        assert "all_reduce" in kinds and len(kinds) >= 3, kinds
        for name, devices in r["seen"]:
            assert devices == ["cuda"], (name, devices)


def _fsdp_full_rank(rank, world, steps, batch):
    """yi-9b at full width and depth, bf16, remat, FSDP over every card:
    ``steps`` steps of ``batch`` x 512; per rank its metrics, state bytes,
    peak memory and step times."""
    import time as _time

    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ctx
    from repro_torch.train.step import make_train_state, make_train_step
    cfg = config("yi_9b")
    model = Model(cfg)
    mesh = make_mesh((world, 1), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model,
                             torch.Generator(device="cuda").manual_seed(0),
                             mesh=mesh)
    step = make_train_step(model, mesh, **TRAIN_KW)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                  global_batch=batch))
    rows = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        state, m = step(state, data.global_batch_at(i))
        torch.cuda.synchronize()
        rows.append({**m, "s": _time.perf_counter() - t0})
    ctx.set_mesh(None)
    return {"rows": rows, "state_bytes": _state_bytes(state),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "collectives": dict(step.placement.group.counts)}


def test_fsdp_yi_9b_full_width_and_depth_over_nccl():
    """FSDP over every card present (NCCL, one rank a card): yi-9b at full
    width and depth (8.83 B params: 88 GB of bf16 params and fp32 moments,
    more than one card holds), bf16, remat, 2 steps.  Every rank reports
    the same loss and norm and applies both steps; each rank's state
    bytes are the dry run's."""
    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.testing import ranks
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (NCCL takes one rank a GPU)")
    world = torch.cuda.device_count()
    batch = 2 * world
    res = ranks.spawn(_fsdp_full_rank, world, backend="nccl", device="cuda",
                      timeout=900, args=(2, batch))
    want = dryrun.reckon(config("yi_9b"), {"seq": 512, "batch": batch,
                                          "kind": "train"},
                         {"data": world, "model": 1})["memory"]["state_bytes"]
    for r in res:
        assert [m["applied"] for m in r["rows"]] == [1, 1]
        assert [(m["loss"], m["grad_norm"]) for m in r["rows"]] == \
            [(m["loss"], m["grad_norm"]) for m in res[0]["rows"]]
        assert r["state_bytes"] == want
    print(f"yi-9b FSDP over {world} H100s (NCCL), batch {batch} x 512: "
          f"per rank peak GiB {[round(r['peak_gib'], 2) for r in res]}, "
          f"step s {[[round(m['s'], 3) for m in r['rows']] for r in res]}, "
          f"state bytes {want}, collectives a run {res[0]['collectives']}")


# ---- the model axis in training: tensor and sequence parallelism -----------

def _tp_train_card_rank(rank, world):
    """Smoke yi-9b with qk_norm (head dim 16, fp32) on ``data=1, model=2``,
    ``world`` gloo ranks sharing the card with the groups taken for NCCL's:
    the one-device step first (each rank alone), then 2 mesh steps with SP
    (seq 32) and 2 without (seq 31, which ``model`` does not divide): each
    step's metrics and K1 / K3 launches on this rank, and every tensor
    handed to a collective (device type, by collective)."""
    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ctx
    from repro_torch.train.step import make_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("yi_9b", qk_norm=True, head_dim=16)
    model = Model(cfg)
    out = {}
    for seq in (32, 31):
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                      global_batch=4))
        state = make_train_state(
            model, torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(model, **TRAIN_KW)
        out[f"one_{seq}"] = [step(state, data.global_batch_at(i))[1]
                             for i in range(2)]
    seen = []
    saved = {n: getattr(dist, n) for n in COLLECTIVES + ("get_backend",)
             if hasattr(dist, n)}

    def wrap(name, fn):
        def call(*args, **kw):
            seen.append((name, sorted({a.device.type for a in args
                                       if torch.is_tensor(a)})))
            return fn(*args, **kw)
        return call
    for n, fn in saved.items():
        if n != "get_backend":
            setattr(dist, n, wrap(n, fn))
    dist.get_backend = lambda group=None: "nccl"
    try:
        mesh = make_mesh((1, world), ("data", "model"))
        for seq in (32, 31):
            data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                          global_batch=4))
            state = make_train_state(
                model, torch.Generator(device="cuda").manual_seed(0),
                mesh=mesh)
            step = make_train_step(model, mesh, **TRAIN_KW)
            rows = []
            for i in range(2):
                ops.reset_launch_counts()
                state, m = step(state, data.global_batch_at(i))
                torch.cuda.synchronize()
                rows.append((m, ops.launch_counts(),
                             ops.launch_counts_by_variant()))
            out[f"mesh_{seq}"] = {
                "rows": rows, "sp": step.placement.tensor_parallel(seq).sp,
                "collectives": dict(step.placement.model.counts)}
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)
        ctx.set_mesh(None)
    out["seen"] = seen
    return out


@pytest.fixture(scope="module")
def tp_train_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from repro_torch.testing import ranks
    return ranks.spawn(_tp_train_card_rank, 2, backend="gloo",
                       device="cuda", timeout=300)


@pytest.mark.parametrize("seq", [32, 31])
def test_tp_train_launches_k1_k3_on_every_rank(tp_train_on_card, seq):
    """Each rank of ``model=2`` runs K1 and K3, forward and backward, on
    its sequence rows and its heads: the one-device step's exact counts,
    K3 all ``tf32x3``; its loss and norm the one-device step's within
    1e-5, with SP (seq 32) and without (31)."""
    cfg = smoke_config("yi_9b", qk_norm=True)
    want = _launches_a_step(cfg)
    for r in tp_train_on_card:
        mesh = r[f"mesh_{seq}"]
        assert mesh["sp"] == (seq % 2 == 0)
        for (m, counts, by_variant), one in zip(mesh["rows"],
                                                r[f"one_{seq}"]):
            assert m["applied"] == 1
            assert {k: counts[k] for k in want} == want
            assert by_variant["flash_attention"]["tf32x3"] == \
                want["flash_attention"]
            assert by_variant["flash_attention_bwd"]["tf32x3"] == \
                want["flash_attention_bwd"]
            for key in ("loss", "grad_norm"):
                assert m[key] == pytest.approx(one[key], rel=1e-5)
        # two steps: SP reduce-scatters each block's partial sums; without
        # SP only the head's gradient is reduce-scattered, once a step
        counts = mesh["collectives"]
        assert counts["all_reduce"] > 0 and counts["all_gather"] > 0
        assert (counts["reduce_scatter"] > 2) == (seq % 2 == 0)


def test_tp_train_hands_an_nccl_group_card_tensors(tp_train_on_card):
    """With the groups taken for NCCL's, every tensor the tensor-parallel
    step hands a collective (SP's gathers and scatters, the Megatron
    all-reduces, the head's gather, the world's reduction) is on the
    card."""
    for r in tp_train_on_card:
        kinds = {name for name, _ in r["seen"]}
        assert "all_reduce" in kinds and len(kinds) >= 3, kinds
        for name, devices in r["seen"]:
            assert devices == ["cuda"], (name, devices)


def test_tp_17a_over_nccl_on_two_cards():
    """chip_smoke's 17a cell (qwen3-4b at full width cut to 4 layers, fp32,
    ``model=2``, batch 4 x 512) as two NCCL ranks, a card each, held to
    the one-device step on every rank as phase 17 holds it."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs (NCCL takes one rank a GPU)")
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from repro_torch.configs import config
    launches, took = chip_smoke.tp_cell(
        torch.cuda.get_device_name(0), "17a", "qwen3_4b", (1, 2),
        backend="nccl")
    want = chip_smoke._train_launches_a_step(config(
        "qwen3_4b", n_layers=chip_smoke.SHARDED_TRAIN_LAYERS,
        dtype="float32"))
    assert launches == [want, want]
    print(f"17a over NCCL on two cards: {took:.1f} s with the processes")


def _fsdp_tp_full_rank(rank, world, steps, batch):
    """yi-9b at full width and depth, bf16, remat, FSDP + TP on ``data=2,
    model=2`` (a card a rank): ``steps`` steps of ``batch`` x 512; per rank
    its metrics, state bytes, peak memory, step times and collectives by
    group."""
    import time as _time

    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ctx
    from repro_torch.train.step import make_train_state, make_train_step
    cfg = config("yi_9b")
    model = Model(cfg)
    mesh = make_mesh((2, world // 2), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model,
                             torch.Generator(device="cuda").manual_seed(0),
                             mesh=mesh)
    step = make_train_step(model, mesh, **TRAIN_KW)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                  global_batch=batch))
    rows = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        state, m = step(state, data.global_batch_at(i))
        torch.cuda.synchronize()
        rows.append({**m, "s": _time.perf_counter() - t0})
    ctx.set_mesh(None)
    place = step.placement
    return {"rows": rows, "state_bytes": _state_bytes(state),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "collectives": {"data": dict(place.group.counts),
                            "model": dict(place.model.counts),
                            "world": dict(place.world.counts)}}


def test_fsdp_tp_yi_9b_full_width_and_depth_over_nccl():
    """FSDP + TP on four cards (NCCL, ``data=2, model=2``): yi-9b at full
    width and depth, bf16, remat, batch 8 x 512, 2 steps.  Every rank
    applies both steps with a finite loss, the same on every rank; each
    rank's state bytes are the dry run's.  Step time and peak memory are
    printed, to read beside FSDP alone on the same cards
    (``test_fsdp_yi_9b_full_width_and_depth_over_nccl``)."""
    import math as _math

    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.testing import ranks
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (NCCL takes one rank a GPU)")
    batch = 8
    res = ranks.spawn(_fsdp_tp_full_rank, 4, backend="nccl", device="cuda",
                      timeout=900, args=(2, batch))
    want = dryrun.reckon(config("yi_9b"), {"seq": 512, "batch": batch,
                                          "kind": "train"},
                         {"data": 2, "model": 2})["memory"]["state_bytes"]
    for r in res:
        assert [m["applied"] for m in r["rows"]] == [1, 1]
        assert all(_math.isfinite(m["loss"]) for m in r["rows"])
        assert [(m["loss"], m["grad_norm"]) for m in r["rows"]] == \
            [(m["loss"], m["grad_norm"]) for m in res[0]["rows"]]
        assert r["state_bytes"] == want
    print(f"yi-9b FSDP + TP on data=2, model=2 (4 H100s, NCCL), batch "
          f"{batch} x 512: per rank peak GiB "
          f"{[round(r['peak_gib'], 2) for r in res]}, step s "
          f"{[[round(m['s'], 3) for m in r['rows']] for r in res]}, state "
          f"bytes {want}, collectives a run {res[0]['collectives']}")


# ---------------------------------------------------------------------------
# the transformer families (moe, vlm, audio, two more dense configs)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["stablelm_1_6b", "qwen1_5_32b", "chameleon_34b",
                "musicgen_large", "dbrx_132b", "grok_1_314b"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_smoke_on_the_card_matches_the_cpu(cuda_device, arch):
    """Each new config's smoke size in fp32 (TF32 off), the same weights
    on the card and on the CPU: the loss (the MoE aux included) within
    1e-4, every gradient within 1e-4 of its leaf's largest, K1 / K3 and
    their backward kernels launched on the card.  chameleon-34b's smoke
    heads of 8 take 16 here: K3 takes head dims 16, 32, 64 and 128 (the
    full config's is 128)."""
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(arch)
    if cfg.hd < 16:
        cfg = smoke_config(arch, head_dim=16)
    model = Model(cfg)
    p_cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    extra = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16) + extra,
                                     generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    out = {}
    for dev in ("cpu", "cuda"):
        params = {k: v for k, v in (p_cpu if dev == "cpu" else _to_device(
            p_cpu, cuda_device)).items()}
        flat = [t.detach().clone().requires_grad_(True)
                for _, t in adamw.leaves(params)]
        ops.reset_launch_counts()
        b = {k: v.to(params["embed"].device) for k, v in batch.items()}
        loss = model.loss(adamw.unflatten(params, flat), b)
        grads = torch.autograd.grad(loss, flat)
        out[dev] = (float(loss.detach()), [gr.cpu() for gr in grads],
                    dict(ops.launch_counts()))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-30)
    counts = out["cuda"][2]
    assert counts["flash_attention"] > 0 and counts["rmsnorm"] > 0
    assert counts["flash_attention_bwd"] > 0 and counts["rmsnorm_bwd"] > 0


def _to_device(node, device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to_device(v, device) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, device) for v in node]
    return node


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("arch", ["dbrx_132b", "musicgen_large"])
def test_moe_and_audio_decode_chunk_never_syncs_the_host(cuda_device, arch,
                                                         kind):
    """The MoE's routing, dispatch and combine and the codebook broadcast
    inside the decode chunk queue work without waiting for the card (the
    chunk a CUDA graph captures)."""
    cfg = smoke_config(arch, dtype="bfloat16")
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=cuda_device)
                               .manual_seed(0), cuda_device)
    engine = _engines(model, params, kind, False)
    extra = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,) + extra),
                    max_new_tokens=6) for n in (9, 21)]
    engine.run(reqs, seed=0)                          # builds K1 / K3
    rid = engine.submit(reqs[0])
    engine.step_chunk()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            engine._chunk_fn(engine.st, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    engine.cancel(rid)


@pytest.mark.parametrize("arch", ["dbrx_132b", "musicgen_large"])
def test_moe_and_audio_graph_chunks_repeat_bitwise(cuda_device, arch):
    """bf16 on the card: a continuous engine with its decode chunk a CUDA
    graph gives the eager chunk's tokens, and a second run its first's."""
    cfg = smoke_config(arch, dtype="bfloat16")
    model = Model(cfg)
    params = model.init_params(torch.Generator(device=cuda_device)
                               .manual_seed(0), cuda_device)
    extra = (cfg.n_codebooks,) if cfg.n_codebooks else ()
    g = torch.Generator().manual_seed(2)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,) + extra,
                                         generator=g), max_new_tokens=8)
            for n in (9, 37, 4, 20)]
    graph = _engines(model, params, "dense", True)
    first = graph.run(reqs, seed=0)
    assert graph.run(reqs, seed=0) == first
    assert _engines(model, params, "dense", False).run(reqs, seed=0) == first


def _ep_rank(rank, world, arch):
    """Two gloo ranks sharing the card, the smoke config in fp32 (TF32
    off), capacity factor 2: rank 0's step on a one-rank ``(1, 1)`` mesh,
    then both ranks' on ``model=2``; each rank's metrics and all-to-alls."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ctx
    from repro_torch.train.step import make_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(arch, moe_capacity_factor=2.0)
    model = Model(cfg)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16,
                                  global_batch=4))
    batches = [data.global_batch_at(i) for i in range(2)]
    out = {}
    meshes = [("mesh", make_mesh((1, 2), ("data", "model")))]
    if rank == 0:
        meshes.insert(0, ("one", DeviceMesh(
            "cuda", torch.tensor([[0]]), mesh_dim_names=("data", "model"),
            _init_backend=False)))
    for name, mesh in meshes:
        if name == "mesh":
            dist.barrier()
        state = make_train_state(
            model, torch.Generator(device="cuda").manual_seed(0), mesh=mesh)
        step = make_train_step(model, mesh, **TRAIN_KW)
        rows = []
        for b in batches:
            step.placement.model.counts.clear()
            state, m = step(state, b)
            rows.append({**m, "model": dict(step.placement.model.counts)})
        out[name] = rows
        ctx.set_mesh(None)
    return out


@pytest.mark.parametrize("arch", ["dbrx_132b", "grok_1_314b"])
def test_moe_ep_on_two_gloo_ranks_sharing_the_card(cuda_device, arch):
    """Expert parallelism on the card: every all-to-all a CUDA tensor over
    gloo; the two ranks' loss and grad norm those of the one-rank step,
    whose model group of one exchanges nothing."""
    from repro_torch.testing import ranks
    res = ranks.spawn(_ep_rank, 2, device="cuda", timeout=600,
                      args=(arch,))
    want = res[0]["one"]
    for r in res:
        for x, y in zip(r["mesh"], want):
            assert x["applied"] == y["applied"] == 1
            for key in ("loss", "grad_norm"):
                assert abs(x[key] - y[key]) <= 1e-5 * abs(y[key])
            assert x["model"]["all_to_all"] == 8 * 2       # 2 layers
            assert "all_to_all" not in y["model"]


def _dbrx_fsdp_ep_rank(rank, world, layers, steps, batch):
    """dbrx-132b at full width cut to ``layers``, bf16, remat, 8-bit
    moments, FSDP + EP on ``data=2, model=2`` (a card a rank): per rank
    its metrics, state bytes, peak memory, step times and collectives."""
    import time as _time

    from repro_torch.configs import config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import ctx
    from repro_torch.train.step import make_train_state, make_train_step
    cfg = config("dbrx_132b", n_layers=layers)
    model = Model(cfg)
    mesh = make_mesh((2, world // 2), ("data", "model"))
    torch.cuda.reset_peak_memory_stats()
    state = make_train_state(model,
                             torch.Generator(device="cuda").manual_seed(0),
                             mesh=mesh, use_8bit=cfg.opt_8bit)
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(model, mesh, **TRAIN_KW)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=512,
                                  global_batch=batch))
    rows = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = _time.perf_counter()
        state, m = step(state, data.global_batch_at(i))
        torch.cuda.synchronize()
        rows.append({**m, "s": _time.perf_counter() - t0})
    ctx.set_mesh(None)
    place = step.placement
    return {"rows": rows, "state_bytes": _state_bytes(state),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "init_peak_gib": init_peak,
            "collectives": {"data": dict(place.group.counts),
                            "model": dict(place.model.counts),
                            "world": dict(place.world.counts)}}


def test_dbrx_fsdp_ep_full_width_over_nccl():
    """FSDP + EP on four cards (NCCL, ``data=2, model=2``): dbrx-132b at
    full width (d_model 6144, 16 experts top-4, 8 of them a rank) cut to
    the 8 layers that fit a card (the init draws the global bf16 params,
    54.6 GB, before cutting them), bf16, remat, 8-bit moments, batch 8 x
    512, 2 steps.  Every rank applies both steps with a finite loss, the
    same on every rank; each rank's state bytes are the dry run's.  State
    bytes, step time and peak memory are printed."""
    import math as _math

    from repro_torch.configs import config
    from repro_torch.launch import dryrun
    from repro_torch.testing import ranks
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (NCCL takes one rank a GPU)")
    layers, batch = 8, 8
    res = ranks.spawn(_dbrx_fsdp_ep_rank, 4, backend="nccl", device="cuda",
                      timeout=900, args=(layers, 2, batch))
    want = dryrun.reckon(config("dbrx_132b", n_layers=layers),
                         {"seq": 512, "batch": batch, "kind": "train"},
                         {"data": 2, "model": 2})["memory"]["state_bytes"]
    for r in res:
        assert [m["applied"] for m in r["rows"]] == [1, 1]
        assert all(_math.isfinite(m["loss"]) for m in r["rows"])
        assert [(m["loss"], m["grad_norm"]) for m in r["rows"]] == \
            [(m["loss"], m["grad_norm"]) for m in res[0]["rows"]]
        assert r["state_bytes"] == want
        assert r["collectives"]["model"]["all_to_all"] == 2 * 8 * layers
    print(f"dbrx-132b FSDP + EP on data=2, model=2 (4 H100s, NCCL), "
          f"{layers} layers, batch {batch} x 512: state bytes a rank "
          f"{res[0]['state_bytes']} (reckon {want}), per rank peak GiB "
          f"{[round(r['peak_gib'], 2) for r in res]} (init "
          f"{[round(r['init_peak_gib'], 2) for r in res]}), step s "
          f"{[[round(m['s'], 3) for m in r['rows']] for r in res]}, "
          f"collectives a run {res[0]['collectives']}")


# ---- the recurrent families ------------------------------------------------

RECURRENT = ["rwkv6_1_6b", "zamba2_2_7b"]


def _leaves(node):
    if isinstance(node, torch.Tensor):
        return [node]
    if isinstance(node, dict):
        return [t for k in sorted(node) for t in _leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [t for x in node for t in _leaves(x)]
    return []


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_smoke_on_the_card_matches_the_cpu(cuda_device, arch):
    """The smoke config in fp32 (TF32 off), the same weights on the card
    and on the CPU: the loss within 1e-4, every gradient within 1e-4 of
    its leaf's largest, K1 and its backward launched on the card (K3 and
    its backward too for the hybrid's shared attention)."""
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config(arch)
    model = Model(cfg)
    p_cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 16), generator=g),
             "labels": torch.randint(0, cfg.vocab, (2, 16), generator=g)}
    out = {}
    for dev in ("cpu", "cuda"):
        params = p_cpu if dev == "cpu" else _to_device(p_cpu, cuda_device)
        flat = [t.detach().clone().requires_grad_(True)
                for _, t in adamw.leaves(params)]
        ops.reset_launch_counts()
        b = {k: v.to(dev) for k, v in batch.items()}
        loss = model.loss(adamw.unflatten(params, flat), b)
        grads = torch.autograd.grad(loss, flat)
        out[dev] = (float(loss.detach()), [gr.cpu() for gr in grads],
                    dict(ops.launch_counts()))
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-30)
    counts = out["cuda"][2]
    assert counts["rmsnorm"] > 0 and counts["rmsnorm_bwd"] > 0
    hybrid = cfg.family == "hybrid"
    assert (counts["flash_attention"] > 0) == hybrid
    assert (counts["flash_attention_bwd"] > 0) == hybrid


def _recurrent_smoke(device, arch, dtype="bfloat16"):
    model = Model(smoke_config(arch, dtype=dtype))
    params = model.init_params(torch.Generator(device=device).manual_seed(0),
                               device)
    return model, params


def _read_rows_equal(graph, eager, lanes):
    """The cache rows an engine reads again are equal bit for bit: each
    slot-indexed leaf's rows of ``lanes``, and every pool page but the
    trash page.  Parked lanes write their dropped tokens to the trash
    page, racing one another, and the hybrid's attention reads that back,
    so a parked lane's rows are garbage in both engines (admission
    overwrites them; a reused page is scrubbed)."""
    pairs = zip(_leaves(graph._slot_state()), _leaves(eager._slot_state()),
                graph._row_axes)
    for a, b, axis in pairs:
        for lane in lanes:
            assert torch.equal(a.select(axis, lane), b.select(axis, lane))
    if graph.kv_layout == "paged":
        kv_g, _ = graph.model.split_paged_cache(graph.st.cache)
        kv_e, _ = eager.model.split_paged_cache(eager.st.cache)
        for a, b in zip(_leaves(kv_g), _leaves(kv_e)):
            assert torch.equal(a.narrow(1, 0, graph.kv_blocks),
                               b.narrow(1, 0, graph.kv_blocks))


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_graph_chunk_writes_its_state_in_place(cuda_device, arch,
                                                         kind):
    """bf16: the decode chunk replayed as a CUDA graph gives the eager
    chunk's tokens (the sampled request's included) and, chunk by chunk,
    the eager engine's cache rows bit for bit (those read again:
    :func:`_read_rows_equal`), in the buffers it was captured on: every
    recurrent update is a copy into the cache's own tensors, so a replay
    never reads a stale state."""
    model, params = _recurrent_smoke(cuda_device, arch)
    reqs = _traffic()
    graph = _engines(model, params, kind, True)
    eager = _engines(model, params, kind, False)
    ptrs = [t.data_ptr() for t in _leaves(graph.st.cache)]
    want = eager.run(reqs, seed=3)
    assert graph.run(reqs, seed=3) == want
    assert graph.run(reqs, seed=3) == want            # replays only
    assert eager.run(reqs, seed=3) == want
    assert graph.stats()["captures"] >= 1
    # once more in lockstep, the rows compared at every chunk boundary
    rids = []
    for eng in (graph, eager):
        eng._run_seed = 3
        rids.append([eng.submit(r, stream=i) for i, r in enumerate(reqs)])
    chunks = 0
    while not graph.sched.idle:
        before = graph.st.pos < graph.max_seq
        graph.step_chunk()
        eager.step_chunk()
        live = (before | (graph.st.pos < graph.max_seq)).nonzero()
        _read_rows_equal(graph, eager, live.flatten().tolist())
        chunks += 1
    assert eager.sched.idle and chunks > 1
    for eng, ids in zip((graph, eager), rids):
        assert [list(eng.take_result(i).tokens) for i in ids] == want
    assert graph.stats()["recaptures_after_warm"] == 0
    assert [t.data_ptr() for t in _leaves(graph.st.cache)] == ptrs
    if kind == "dense":
        # no trash page: the parked lanes' rows agree too
        for a, b in zip(_leaves(graph.st.cache), _leaves(eager.st.cache)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_decode_chunk_never_syncs_the_host(cuda_device, arch):
    """The time-mix / mamba recurrences inside the decode chunk queue work
    without waiting for the card (the chunk a CUDA graph captures)."""
    model, params = _recurrent_smoke(cuda_device, arch)
    engine = _engines(model, params, "paged", False)
    reqs = _traffic(2)
    engine.run(reqs, seed=0)                          # builds K1 / K3
    rid = engine.submit(reqs[0])
    engine.step_chunk()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            engine._chunk_fn(engine.st, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    engine.cancel(rid)


def _recurrent_sharded_rank(rank, world):
    """rwkv6's smoke config in fp32 through ``ShardedEngine`` on a
    ``data=1`` mesh of one NCCL rank, dense and paged, the weights made on
    the CPU from seed 0."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import ShardedEngine
    torch.backends.cuda.matmul.allow_tf32 = False
    model = Model(smoke_config("rwkv6_1_6b"))
    params = _to(model.init_params(torch.Generator().manual_seed(0), "cpu"),
                 "cuda")
    mesh = make_mesh((world,), ("data",))
    out = {}
    for layout in ("dense", "paged"):
        eng = ShardedEngine(model, params, max_seq=64, slots=4, chunk=4,
                            min_bucket=8, prefill_chunk=16, mesh=mesh,
                            kv_layout=layout)
        ops.reset_launch_counts()
        out[layout] = {"tokens": eng.run(_greedy_traffic(), seed=3),
                       "launches": ops.launch_counts(),
                       "descriptor": eng.stats()["mesh"]["descriptor"]}
    return out


def test_recurrent_sharded_engine_on_one_nccl_rank(cuda_device):
    """rwkv6's state through ``ShardedEngine`` on one NCCL rank: the greedy
    tokens of the single-process engine on the CPU, dense and paged, K1
    launched on the card."""
    from repro_torch.testing import ranks
    model = Model(smoke_config("rwkv6_1_6b"))
    p_cpu = model.init_params(torch.Generator().manual_seed(0), "cpu")
    want = ContinuousEngine(model, p_cpu, max_seq=64, slots=4, chunk=4,
                            min_bucket=8, prefill_chunk=16).run(
        _greedy_traffic(), seed=3)
    res = ranks.spawn(_recurrent_sharded_rank, 1, backend="nccl",
                      device="cuda", timeout=300)[0]
    for layout in ("dense", "paged"):
        assert res[layout]["tokens"] == want
        assert res[layout]["descriptor"] == "data=1"
        assert res[layout]["launches"]["rmsnorm"] > 0


# ---- serving with the params split over model ------------------------------

SERVE_TP_PROMPTS = (200, 151, 64, 23)
# bf16 over 36 layers, the rank's collectives summing in other orders: of
# the largest logit's magnitude
SERVE_TP_BF16_TOL = 5e-2


def _serve_tp_card_rank(rank, world, arch="qwen3_4b", decode=False):
    """``arch`` at full width and depth, bf16, on ``data=1, model=world``
    over NCCL: rank 0's one-card prefill of phase 4's prompts first (the
    others wait), then every rank's prefill of them through
    ``sharding.serving.ServingStep`` (the params cut to the rank's pieces
    from the same seed-0 draw); the first step's logits on the host, and
    with ``decode`` a decode step's after it (each row's one-card argmax
    at its own position), rank 0's also from the same weights in fp32 on
    one card (the bf16 step's own rounding)."""
    import torch.distributed as dist

    from repro_torch.configs import config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.serving import ServingStep
    cfg = config(arch)
    model = Model(cfg)
    b, max_seq = len(SERVE_TP_PROMPTS), 256
    lens = torch.tensor(SERVE_TP_PROMPTS, device="cuda")
    tokens = torch.randint(
        0, cfg.vocab, (b, max(SERVE_TP_PROMPTS)), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(21))
    out = {}
    nxt = torch.zeros((b, 1), dtype=torch.long, device="cuda")
    if rank == 0:
        params = model.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        with torch.no_grad():
            logits, cache = model.prefill(params, tokens,
                                          model.init_cache(b, max_seq),
                                          lengths=lens)
            out["one"] = logits.float().cpu().numpy()
            nxt = logits.argmax(-1)[:, None]
            if decode:
                logits, _ = model.decode_step(params, nxt, cache, lens)
                out["one_decode"] = logits.float().cpu().numpy()
                f32 = Model(dataclasses.replace(cfg, dtype="float32"))
                params = _cast_tree(params, torch.float32)
                logits, cache = f32.prefill(params, tokens,
                                            f32.init_cache(b, max_seq),
                                            lengths=lens)
                out["f32"] = logits.cpu().numpy()
                logits, _ = f32.decode_step(params, nxt, cache, lens)
                out["f32_decode"] = logits.cpu().numpy()
        del params, cache
        torch.cuda.empty_cache()
    dist.barrier()
    dist.broadcast(nxt, 0)
    serve = ServingStep(model, make_mesh((1, world), ("data", "model")), b,
                        max_seq)
    whole = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    params = serve.shard_params(whole)
    del whole
    torch.cuda.empty_cache()
    logits, cache = serve.prefill(
        params, tokens, serve.shard_cache(model.init_cache(b, max_seq)),
        lengths=lens)
    out["tp"] = logits.float().cpu().numpy()
    if decode:
        logits, _ = serve.decode_step(params, nxt, cache, lens)
        out["tp_decode"] = logits.float().cpu().numpy()
    out["layout"] = serve.kv["layout"] if serve.kv else None
    return out


def test_serving_qwen3_4b_on_four_cards_over_nccl():
    """qwen3-4b at full width and depth, bf16, its params split over
    ``model=4`` (one NCCL rank a card, the kv heads over ``model``): every
    rank's first-step logits the same, and within SERVE_TP_BF16_TOL of
    the largest of the one-card step's."""
    import numpy as np

    from repro_torch.testing import ranks
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (NCCL takes one rank a GPU)")
    res = ranks.spawn(_serve_tp_card_rank, 4, backend="nccl", device="cuda",
                      timeout=900)
    one = res[0]["one"]
    scale = float(np.abs(one).max())
    for r in res:
        assert r["layout"] == "heads"
        np.testing.assert_array_equal(r["tp"], res[0]["tp"])
    err = float(np.abs(res[0]["tp"] - one).max())
    print(f"qwen3-4b bf16 prefill on model=4 (NCCL) against one card: max "
          f"abs err {err} of the largest {scale}; argmax agree "
          f"{(res[0]['tp'].argmax(-1) == one.argmax(-1)).tolist()}")
    assert err <= SERVE_TP_BF16_TOL * scale


def _cast_tree(node, dtype):
    """Every floating tensor of a params tree (dicts, lists) in ``dtype``."""
    if isinstance(node, dict):
        return {k: _cast_tree(v, dtype) for k, v in node.items()}
    if isinstance(node, list):
        return [_cast_tree(v, dtype) for v in node]
    return node.to(dtype) if node.is_floating_point() else node


def test_serving_rwkv6_on_four_cards_over_nccl():
    """rwkv6-1.6b at full width and depth (24 layers), bf16, its params
    split over ``model=4`` (one NCCL rank a card: the time-mix on 8 of 32
    heads, the state moved between the rules' layout and the mixers'
    heads each layer): every rank's prefill and decode-step logits the
    same, and each row's argmax the one card's.  The model axis's bf16
    logits lie within twice the one card's own bf16 rounding (its
    distance to the same weights' fp32 step) of the one card's: each
    rank's row-parallel partial sums are rounded to bf16 before their sum,
    which adds rounding of that size, not more, where nothing else
    differs.  (Over 24 recurrent layers and 200 time steps the bf16 step
    itself lies about 0.5 from fp32's logits of about 5: a four-card run
    on H100s found the model axis 0.508 from the one card there,
    beyond qwen3-4b's SERVE_TP_BF16_TOL.)"""
    import numpy as np

    from repro_torch.testing import ranks
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs (NCCL takes one rank a GPU)")
    res = ranks.spawn(_serve_tp_card_rank, 4, backend="nccl", device="cuda",
                      timeout=900, args=("rwkv6_1_6b", True))
    for key in ("tp", "tp_decode"):
        one = res[0]["one" + key[2:]]
        rounding = float(np.abs(one - res[0]["f32" + key[2:]]).max())
        for r in res:
            assert r["layout"] is None
            np.testing.assert_array_equal(r[key], res[0][key])
        err = float(np.abs(res[0][key] - one).max())
        agree = (res[0][key].argmax(-1) == one.argmax(-1)).tolist()
        print(f"rwkv6-1.6b bf16 {key} on model=4 (NCCL) against one card: "
              f"max abs err {err} of the largest {float(np.abs(one).max())}"
              f"; the one card's bf16 against its fp32 {rounding}; argmax "
              f"agree {agree}")
        assert err <= 2 * rounding
        assert all(agree)
