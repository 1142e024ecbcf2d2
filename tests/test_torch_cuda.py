"""The port on the card: each kernel against its plain PyTorch version, and
the serving path's launches and tokens.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
decision is made in a fixture, never at import).  The module imports
neither JAX nor the reference package, so it runs on a machine with only
PyTorch and the CUDA toolkit:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""
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
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import BatchedEngine, Request, sample_tokens

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
    want_variant = "mma" if dtype == torch.bfloat16 else "simt"
    assert fa_mod.variant(dtype) == want_variant
    by_variant[want_variant] += 1
    assert fa_mod.launches_by_variant == by_variant
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


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
        "matmul": 0, "dpia_cuda": 0}


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


# (m, k, n, bf16 variant): the bf16 projection shapes take wgmma, ragged
# rows the SIMT kernel; fp32 always takes the SIMT kernel
MM_CASES = [(800, 2560, 4096, "wgmma"), (4, 2560, 9728, "wgmma"),
            (37, 100, 75, "simt"), (129, 8, 130, "simt"), (1, 1, 1, "simt"),
            (129, 64, 136, "wgmma"), (300, 72, 520, "wgmma")]


@pytest.mark.parametrize("m,k,n,bf16_variant", MM_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(cuda_device, m, k, n, bf16_variant,
                                     dtype):
    a, b = _mm_inputs(m, k, n, dtype, cuda_device)
    p = mm_mod.plan(m, n, k, dtype)
    assert p.variant == (bf16_variant if dtype == torch.bfloat16 else "simt")
    before = mm_mod.launches
    by_variant = dict(mm_mod.launches_by_variant)
    got = ops.matmul(a, b, impl="cuda")
    torch.cuda.synchronize()
    assert mm_mod.launches == before + p.launches and got.dtype == dtype
    by_variant[p.variant] += 1
    by_variant["splitk_reduce"] += p.split > 1
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
    and the call raises; the SIMT kernel does not stand in."""
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
