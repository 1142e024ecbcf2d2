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

from repro_torch.configs import smoke_config
from repro_torch.kernels import flash_attention as fa_mod
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
        "rmsnorm": (cfg.n_layers * 4 + 1) * (1 + steps)}


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
