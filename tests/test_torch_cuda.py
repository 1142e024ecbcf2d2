"""The port on the card: each kernel against its plain PyTorch version, and
the serving path's launches and tokens.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU (the
decision is made in a fixture, never at import).  The module imports
neither JAX nor the reference package, so it runs on a machine with only
PyTorch, Triton and the CUDA toolkit:

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


@pytest.mark.parametrize("shape", [(800, 2560), (25600, 128), (4, 2560),
                                   (3, 5, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    w = (1 + 0.1 * torch.randn(shape[-1], generator=g,
                               device=cuda_device)).to(dtype)
    before = rms_mod.launches
    got = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rms_mod.launches == before + 1
    torch.testing.assert_close(got.float(), ref.rmsnorm(x, w).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


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
    got = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
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


@pytest.mark.parametrize("m,k,n", [(800, 2560, 4096), (4, 2560, 9728),
                                   (37, 100, 75), (129, 8, 130), (1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(cuda_device, m, k, n, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    s = k ** -0.25
    a = (s * torch.randn((m, k), generator=g, device=cuda_device)).to(dtype)
    b = (s * torch.randn((k, n), generator=g, device=cuda_device)).to(dtype)
    before = mm_mod.launches
    got = ops.matmul(a, b, impl="cuda")
    torch.cuda.synchronize()
    assert mm_mod.launches == before + 1 and got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.matmul(a, b).float(),
                               rtol=MM_TOL[dtype], atol=MM_TOL[dtype])
    out32 = ops.matmul(a, b, impl="cuda", out_dtype=torch.float32)
    assert out32.dtype == torch.float32


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
