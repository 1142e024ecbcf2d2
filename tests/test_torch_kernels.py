"""The port's kernels (repro_torch.kernels) held against the reference's
Pallas kernels and oracles (repro.kernels).

On the CPU the port's wrappers compute their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode, as test_kernels.py
does.  Inputs are made with numpy from a seed and handed to both.
test_torch_cuda.py holds the kernels against the plain versions on the
card.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro_torch.kernels import ops, ref

# f32: both sides compute in fp32 and differ only in summation order.
# bf16: both round the normalised row to bf16 before * w; a one-ulp flip of
# a value near 4 is 2**-6, so 3e-2 covers it (as test_kernels.py does).
RMS_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# f32 flash: online softmax over tiles against one full softmax
FA_TOL = 1e-5


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (bf16 rounds identically on both sides: round to nearest even)."""
    return jnp.asarray(a, dtype), torch.tensor(a).to(getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# K1 rmsnorm: plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d,br", [(64, 128, 16), (100, 64, 32),
                                       (8, 512, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_pallas(rng, rows, d, br, dtype):
    xa, wa = rng.randn(rows, d), rng.randn(d)
    jx, tx = _pair(xa, dtype)
    jw, tw = _pair(wa, dtype)
    want = jax_rmsnorm(jx, jw, block_rows=br, interpret=True)
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    tol = RMS_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_rmsnorm_leading_dims_match_reference(rng):
    """Any leading dims, as the qk_norm call sites give (b, s, heads, hd)."""
    xa, wa = rng.randn(2, 5, 4, 16), rng.randn(16)
    want = jref.rmsnorm(jnp.asarray(xa, "float32"), jnp.asarray(wa, "float32"))
    got = ops.rmsnorm(torch.tensor(xa, dtype=torch.float32),
                      torch.tensor(wa, dtype=torch.float32))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


def test_rmsnorm_rounding_order_in_bf16(rng):
    """The row is rounded to bf16 BEFORE * w: the plain version equals the
    reference bit for bit, and differs from multiplying in fp32."""
    xa, wa = rng.randn(16, 64), rng.randn(64) * 3
    jx, tx = _pair(xa, "bfloat16")
    jw, tw = _pair(wa, "bfloat16")
    got = _np(ops.rmsnorm(tx, tw))
    np.testing.assert_array_equal(got, _np(jref.rmsnorm(jx, jw)))
    x32 = tx.float()
    fused = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
             * tw.float()).to(torch.bfloat16)
    assert not np.array_equal(got, _np(fused))


# ---------------------------------------------------------------------------
# K3 flash attention: plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,bkv,s,d,bq,bk_", [
    (4, 4, 128, 64, 64, 64),     # MHA
    (8, 2, 256, 64, 64, 128),    # GQA 4:1
    (4, 1, 128, 32, 128, 32),    # MQA
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_pallas(rng, bh, bkv, s, d, bq, bk_, causal):
    qa = rng.randn(bh, s, d) * 0.3
    ka = rng.randn(bkv, s, d) * 0.3
    va = rng.randn(bkv, s, d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (qa, ka, va))
    want = jax_flash(jq, jk, jv, causal=causal, bq=bq, bk=bk_, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FA_TOL, atol=FA_TOL)


def test_flash_decode_offset_matches_pallas(rng):
    """The decode shape: one query row at q_offset = Sk - 1."""
    qa = rng.randn(4, 1, 64) * 0.3
    ka = rng.randn(2, 256, 64) * 0.3
    va = rng.randn(2, 256, 64)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (qa, ka, va))
    want = jax_flash(jq, jk, jv, causal=True, q_offset=255, bq=1, bk=64,
                     interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True, q_offset=255)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FA_TOL, atol=FA_TOL)


@pytest.mark.parametrize("sq,sk,q_offset", [(100, 100, 0), (200, 200, 0),
                                            (1, 200, 199), (37, 200, 163)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_matches_reference(rng, sq, sk, q_offset, causal):
    """Sq/Sk that no 64/128 tile divides: the Pallas kernel asserts, the
    port masks; held against the reference oracle."""
    qa = rng.randn(8, sq, 32) * 0.3
    ka = rng.randn(2, sk, 32) * 0.3
    va = rng.randn(2, sk, 32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, "float32") for a in (qa, ka, va))
    want = jref.flash_attention(jq, jk, jv, causal=causal, q_offset=q_offset)
    got = ops.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), _np(want), rtol=FA_TOL, atol=FA_TOL)


@pytest.mark.parametrize("name", ["scal", "asum", "dot", "gemv", "matmul",
                                  "softmax"])
def test_blas_refs_match_reference(rng, name):
    a, x, y = rng.randn(16, 8), rng.randn(8), rng.randn(8)
    args = {"scal": (2.5, x), "asum": (x,), "dot": (x, y), "gemv": (a, x),
            "matmul": (a, a.T), "softmax": (a,)}[name]
    j = [v if isinstance(v, float) else jnp.asarray(v, "float32")
         for v in args]
    t = [v if isinstance(v, float) else torch.tensor(v, dtype=torch.float32)
         for v in args]
    np.testing.assert_allclose(_np(getattr(ref, name)(*t)),
                               _np(getattr(jref, name)(*j)),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch: CPU -> plain version; no fallback for other devices
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_and_count_nothing(rng):
    ops.reset_launch_counts()
    x = torch.tensor(rng.randn(4, 32), dtype=torch.float32)
    w = torch.ones(32)
    torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm(x, w),
                               rtol=0, atol=0)
    q = torch.tensor(rng.randn(4, 8, 16), dtype=torch.float32)
    k = torch.tensor(rng.randn(2, 8, 16), dtype=torch.float32)
    torch.testing.assert_close(ops.flash_attention(q, k, k),
                               ref.flash_attention(q, k, k), rtol=0, atol=0)
    assert ops.launch_counts() == {"rmsnorm": 0, "matmul": 0,
                                   "flash_attention": 0, "dpia_cuda": 0,
                                   "rmsnorm_bwd": 0,
                                   "flash_attention_bwd": 0}
    assert ops.launch_counts_by_variant() == {
        "rmsnorm": {"packed": 0, "warp": 0, "block": 0},
        "matmul": {"wgmma": 0, "splitk_reduce": 0, "skinny": 0,
                   "skinny_reduce": 0, "tf32x3": 0, "mma": 0},
        "flash_attention": {"mma": 0, "tf32x3": 0},
        "flash_attention_bwd": {"mma": 0, "tf32x3": 0}}


def test_non_cpu_tensor_without_kernel_raises():
    """A tensor that is not on the CPU never reaches a plain version."""
    x = torch.empty((4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.rmsnorm(x, torch.empty((32,), device="meta"))
    q = torch.empty((4, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.flash_attention(q, q[:2], q[:2])


def test_kernel_modules_import_without_triton_or_nvcc():
    """Importing the kernels builds nothing and needs neither Triton nor the
    CUDA toolkit (both are reached only when a kernel launches)."""
    code = ("import sys, subprocess\n"
            "calls = []\n"
            "subprocess.Popen = lambda *a, **k: calls.append(a)\n"
            "import repro_torch.kernels.ops, repro_torch.models.transformer\n"
            "assert 'triton' not in sys.modules, 'triton imported'\n"
            "assert not calls, 'a build started at import'\n"
            "print('ok')")
    env = dict(os.environ, PYTHONPATH="src")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr


def test_build_target_is_keyed_by_source():
    from repro_torch.kernels import _build
    assert _build.sources() == ["flash_attention", "matmul", "matmul_wgmma",
                                "rmsnorm"]
    t = _build.target("flash_attention")
    assert t.parent == _build.BUILD_DIR and t.suffix == ".so"
    assert t == _build.target("flash_attention")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_build_flags_are_per_source_and_keyed(monkeypatch):
    """Only the wgmma source takes CUTLASS's include path, and a source's
    flags are part of its library's key."""
    from repro_torch.kernels import _build
    assert _build.flags("matmul") == _build.NVCC_FLAGS
    assert _build.flags("flash_attention") == _build.NVCC_FLAGS
    assert _build.flags("rmsnorm") == _build.NVCC_FLAGS
    extra = _build.flags("matmul_wgmma")[len(_build.NVCC_FLAGS):]
    assert extra == ("-I", "/usr/local/cutlass/include")
    before = _build.target("matmul_wgmma")
    monkeypatch.setitem(_build.SOURCE_FLAGS, "matmul_wgmma",
                        ("-I", "/elsewhere"))
    assert _build.target("matmul_wgmma") != before
    assert _build.target("matmul") == _build.target("matmul")


# ---------------------------------------------------------------------------
# the dispatch rules: K2's plan, K3's variant (pure functions of dtype and
# shape; the card tests check that the launches follow them)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,dtype,want", [
    (800, 2560, 4096, torch.bfloat16, "wgmma"),
    (4, 2560, 4096, torch.bfloat16, "wgmma"),
    (1, 64, 8, torch.bfloat16, "wgmma"),
    (800, 2560, 4096, torch.float32, "tf32x3"),    # 3xTF32, not TF32
    (37, 100, 75, torch.bfloat16, "mma"),          # N % 8: no TMA rows
    (16, 12, 64, torch.bfloat16, "mma"),           # K % 8
    (5, 0, 8, torch.bfloat16, "mma"),              # no k tile
])
def test_matmul_plan_variant_by_dtype_and_alignment(m, k, n, dtype, want):
    from repro_torch.kernels import matmul as mm
    p = mm.plan(m, n, k, dtype)
    assert p.variant == want
    if want == "mma":
        assert (p.grid, p.split, p.workspace_bytes, p.block_n) == (
            (-(-n // 64), -(-m // 64), 1), 1, 0, 64)
    if want == "tf32x3":
        assert (p.grid, p.split, p.workspace_bytes, p.block_m) == (
            (-(-n // p.block_n), -(-m // 128), 1), 1, 0, 128)


@pytest.mark.parametrize("m,k,n,dtype,want", [
    (4, 2560, 4096, torch.float32, "skinny"),      # a decode step's rows
    (16, 2560, 9728, torch.float32, "skinny"),
    (17, 2560, 4096, torch.float32, "tf32x3"),
    (37, 100, 75, torch.float32, "tf32x3"),
    (1, 1, 1, torch.float32, "skinny"),
    (4, 2560, 4096, torch.bfloat16, "wgmma"),      # bf16 rows stay wgmma
    (37, 100, 75, torch.bfloat16, "mma"),
])
def test_matmul_plan_regime_by_dtype_and_rows(m, k, n, dtype, want):
    """fp32 takes skinny up to 16 rows and tf32x3 above; bf16 takes wgmma
    where TMA can describe the rows and mma elsewhere, whatever M."""
    from repro_torch.kernels import matmul as mm
    assert mm.plan(m, n, k, dtype).variant == want


def test_matmul_plan_skinny_splits_k_to_a_wave_at_the_decode_shape():
    """(4, 2560) x (2560, 4096) fp32: 32 panels of 128 columns, K split 8
    ways (320 rows a part) so that 256 blocks cover the 132 SMs; the
    partials take an fp32 (8, 4, 4096) workspace and a second launch."""
    from repro_torch.kernels import matmul as mm
    p = mm.plan(4, 4096, 2560, torch.float32)
    assert (p.variant, p.block_n, p.split) == ("skinny", 128, 8)
    assert p.grid == (32, 8, 1)
    assert p.grid[0] * p.grid[1] >= mm.SMS > p.grid[0] * p.grid[1] // 2
    assert p.workspace_bytes == 8 * 4 * 4096 * 4
    assert p.launches == 2
    # too few rows of K to split: one part, no workspace, one launch
    p = mm.plan(4, 200, 64, torch.float32)
    assert (p.grid, p.split, p.workspace_bytes, p.launches) == (
        (2, 1, 1), 1, 0, 1)


@pytest.mark.parametrize("m,k,n", [(1, 2560, 4096), (4, 2560, 9728),
                                   (16, 9728, 2560), (3, 1100, 75),
                                   (8, 100, 100000), (2, 64, 8)])
def test_matmul_plan_skinny_grid_is_panels_times_split(m, k, n):
    """The skinny grid: panels x split blocks; split a power of two that
    stops doubling at one wave or at 64 rows of K a part; workspace
    split x M x N fp32 when split > 1."""
    from repro_torch.kernels import matmul as mm
    p = mm.plan(m, n, k, torch.float32)
    panels = -(-n // 128)
    assert p.variant == "skinny" and p.grid == (panels, p.split, 1)
    assert p.split & (p.split - 1) == 0
    assert p.split == 1 or k // p.split >= mm.SKINNY_MIN_ROWS
    assert panels * p.split >= mm.SMS or k // (2 * p.split) < \
        mm.SKINNY_MIN_ROWS
    assert p.workspace_bytes == (p.split * m * n * 4 if p.split > 1 else 0)


def test_matmul_plan_tf32x3_tile_by_rows():
    """tf32x3 tiles by M alone: 64 x 64 up to 64 rows, 128 x 128 above
    (the prefill projections among them), split 1, no workspace."""
    from repro_torch.kernels import matmul as mm
    for m, n in [(800, 4096), (800, 9728), (200, 2560), (4096, 4096),
                 (130, 129), (65, 8000)]:
        p = mm.plan(m, n, 2560, torch.float32)
        assert (p.variant, p.block_m, p.block_n) == ("tf32x3", 128, 128)
        assert (p.grid, p.split, p.workspace_bytes) == (
            (-(-n // 128), -(-m // 128), 1), 1, 0)
    for m, n in [(37, 75), (17, 4096), (64, 9728)]:
        p = mm.plan(m, n, 100, torch.float32)
        assert (p.block_m, p.block_n, p.grid) == (64, 64, (-(-n // 64), 1, 1))


def test_matmul_plan_splits_k_at_the_decode_shape():
    """(4, 2560) x (2560, 4096): 32 tiles of 128 x 128 fill a quarter of the
    132 SMs, so K (40 tiles of 64) is split 4 ways into an fp32 (4, 4,
    4096) workspace, and the call launches the reduction too."""
    from repro_torch.kernels import matmul as mm
    p = mm.plan(4, 4096, 2560, torch.bfloat16)
    assert (p.variant, p.block_n, p.split) == ("wgmma", 128, 4)
    assert p.grid == (32, 1, 4)
    assert p.workspace_bytes == 4 * 4 * 4096 * 4
    assert p.launches == 2
    # one k tile cannot be split: the grid stays one block
    p = mm.plan(1, 8, 64, torch.bfloat16)
    assert (p.grid, p.split, p.workspace_bytes, p.launches) == (
        (1, 1, 1), 1, 0, 1)


@pytest.mark.parametrize("m,k,n", [(800, 2560, 4096), (800, 2560, 9728),
                                   (4, 2560, 9728), (4, 2560, 4096),
                                   (1024, 2560, 2560), (130, 64, 8),
                                   (4096, 4096, 4096), (1, 64, 8),
                                   (3, 520, 264), (256, 128, 33000)])
def test_matmul_plan_grid_is_tiles_times_split(m, k, n):
    from repro_torch.kernels import matmul as mm
    p = mm.plan(m, n, k, torch.bfloat16)
    tiles = -(-m // 128) * -(-n // p.block_n)
    assert p.grid[0] * p.grid[1] * p.grid[2] == tiles * p.split
    assert p.grid[2] == p.split and p.block_n in (128, 256)
    k_tiles = -(-k // 64)
    assert 1 <= p.split <= max(1, k_tiles // 4)
    if p.split > 1:
        assert p.block_n == 128 and tiles * p.split <= mm.SMS
        assert p.workspace_bytes == p.split * m * n * 4
    else:
        assert p.workspace_bytes == 0 and p.launches == 1


def test_matmul_plan_tile_width_follows_the_wave_rule():
    """Wide tiles when their waves, weighted by a wide tile's cost, undercut
    the narrow grid's waves."""
    from repro_torch.kernels import matmul as mm
    for m, n in [(800, 4096), (800, 9728), (1024, 2560), (4096, 4096)]:
        narrow = -(-m // 128) * -(-n // 128)
        wide = -(-m // 128) * -(-n // 256)
        want = 256 if (-(-wide // 132) * mm.WIDE_TILE_COST
                       < -(-narrow // 132)) else 128
        assert mm.plan(m, n, 2560, torch.bfloat16).block_n == want


# K1's main-path shapes: qwen3-4b at batch 4, prefill of 200 tokens (d_model
# rows, then q and k rows of the qk_norm) and one decode step
K1_MAIN = [((800, 2560), "warp"), ((25600, 128), "packed"),
           ((6400, 128), "packed"), ((4, 2560), "block"),
           ((128, 128), "packed"), ((32, 128), "packed")]


@pytest.mark.parametrize("shape,variant", K1_MAIN)
def test_rmsnorm_plan_at_the_main_path_shapes(shape, variant):
    """bf16 d_model rows a warp each, 10 vectors a lane, or a block each
    (one vector a thread) when the rows are too few to give every SM a
    warp; 128-wide rows packed two a warp, 16 lanes a row; the grid covers
    every row and, where there are rows enough, the 132 SMs."""
    from repro_torch.kernels import rmsnorm as rms
    rows, d = shape
    p = rms.plan(rows, d, torch.bfloat16)
    assert p.variant == variant and p.vector
    want = {"warp": (32, 10), "packed": (16, 1), "block": (320, 1)}[variant]
    assert (p.threads_per_row, p.vectors_per_thread) == want
    assert p.threads == p.rows_per_block * p.threads_per_row
    assert p.threads % 32 == 0
    assert p.threads <= (1024 if variant == "block" else 256)
    assert p.grid * p.rows_per_block >= rows > (p.grid - 1) * p.rows_per_block
    one_warp = max(1, 32 // p.threads_per_row)
    if -(-rows // one_warp) >= rms.SMS:       # the rows can fill the SMs
        assert p.grid >= rms.SMS
    elif variant == "packed":                 # else fewer, fuller blocks
        assert p.threads == 32 * rms.FEW_ROWS_WARPS


def test_rmsnorm_plan_spreads_800_rows_over_the_sms():
    """(800, 2560) must not run on 100 blocks of 8 rows."""
    from repro_torch.kernels import rmsnorm as rms
    p = rms.plan(800, 2560, torch.bfloat16)
    assert (p.rows_per_block, p.grid) == (4, 200)
    assert rms.plan(25600, 128, torch.bfloat16)[4:] == (16, 256, 1600)
    # rows that cannot give 132 blocks of one warp: blocks of four warps
    assert rms.plan(128, 128, torch.bfloat16)[4:] == (8, 128, 16)
    assert rms.plan(64, 128, torch.float32)[4:] == (4, 128, 16)


@pytest.mark.parametrize("rows,d,dtype,aligned,vector,variant,tpr,vpt", [
    (200, 2560, torch.float32, True, True, "warp", 32, 20),
    (6400, 128, torch.float32, True, True, "warp", 32, 1),
    (37, 64, torch.float32, True, True, "packed", 16, 1),
    (9, 24, torch.bfloat16, True, True, "packed", 4, 1),
    (1, 1, torch.bfloat16, True, False, "packed", 1, 1),
    (200, 100, torch.bfloat16, True, False, "warp", 32, 4),  # 200 bytes
    (150, 128, torch.bfloat16, False, False, "warp", 32, 4),  # misaligned
    # fewer rows than SMs: a block a row, one access a thread
    (2, 100, torch.bfloat16, True, False, "block", 128, 1),
    (37, 128, torch.bfloat16, False, False, "block", 128, 1),
    (4, 2560, torch.bfloat16, True, True, "block", 320, 1),
    (2, 2560, torch.float32, True, True, "block", 640, 1),
    (131, 264, torch.bfloat16, True, True, "block", 64, 1),
    (132, 264, torch.bfloat16, True, True, "warp", 32, 2),
    (4, 128, torch.float32, True, True, "warp", 32, 1),      # 32 accesses
    (800, 2560, torch.bfloat16, False, False, "block", 640, 4),
    (2, 9000, torch.bfloat16, True, True, "block", 288, 4),
    (2, 9000, torch.float32, True, True, "block", 576, 4),
    (4, 8192, torch.bfloat16, True, True, "block", 1024, 1),
    (200, 8192, torch.bfloat16, True, True, "block", 256, 4),
    (1, 20000, torch.float32, True, True, "block", 1024, 4),
])
def test_rmsnorm_plan_variant_and_accesses(rows, d, dtype, aligned, vector,
                                           variant, tpr, vpt):
    """Odd row bytes or a misaligned pointer take one element an access
    and never raise; long rows take a block each."""
    from repro_torch.kernels import rmsnorm as rms
    p = rms.plan(rows, d, dtype, aligned=aligned)
    assert (p.vector, p.variant, p.threads_per_row,
            p.vectors_per_thread) == (vector, variant, tpr, vpt)
    per = (16 // (4 if dtype == torch.float32 else 2)) if vector else 1
    if variant == "block":
        assert (p.rows_per_block, p.threads, p.grid) == (1, tpr, rows)
        # the fewest warps that hold the row, or a whole block and passes
        assert tpr * vpt * per >= d or tpr == rms.BLOCK_MAX
        assert (tpr - 32) * vpt * per < d or tpr == 256
    else:
        assert tpr * vpt * per >= d


def test_rmsnorm_plan_refuses_other_dtypes():
    from repro_torch.kernels import rmsnorm as rms
    with pytest.raises(ValueError, match="no kernel"):
        rms.plan(4, 128, torch.float16)


# K1's backward plan: (rows, d, dtype, aligned) -> (vector, threads a row,
# accesses a thread, blocks).  A train step's shapes (2048 d_model rows,
# 65536 / 16384 qk_norm rows): 128 blocks of 16 rows for the d_model rows
# (a row in ~235 registers a thread: one block an SM), up to 5 x 132 for
# the light qk_norm rows; short rows lanes of a warp, long ones up to the
# block; one element an access where the row or a pointer forbids 16 bytes
@pytest.mark.parametrize("rows,d,dtype,aligned,want", [
    (2048, 2560, torch.bfloat16, True, (True, 32, 10, 128)),
    (65536, 128, torch.bfloat16, True, (True, 16, 1, 656)),
    (16384, 128, torch.bfloat16, True, (True, 16, 1, 656)),
    (2048, 2560, torch.float32, True, (True, 64, 10, 128)),
    (65536, 128, torch.float32, True, (True, 32, 1, 656)),
    (37, 128, torch.bfloat16, True, (True, 16, 1, 3)),
    (4300, 8, torch.bfloat16, True, (True, 1, 1, 17)),
    (1, 1, torch.float32, True, (False, 1, 1, 1)),
    (140, 100, torch.bfloat16, True, (False, 32, 4, 18)),
    (140, 2560, torch.bfloat16, False, (False, 256, 10, 140)),
    (3, 1000, torch.bfloat16, True, (True, 32, 4, 1)),
    (2, 9000, torch.bfloat16, True, (True, 128, 10, 1)),
    (2, 9000, torch.float32, True, (True, 256, 10, 2)),
    (2, 9001, torch.bfloat16, True, (False, 256, 40, 2)),
])
def test_rmsnorm_bwd_plan(rows, d, dtype, aligned, want):
    """A row is held whole, by the fewest threads of a launchable
    instance; the grid never exceeds the rows' slots nor 8 x 132 blocks,
    and every block has rows."""
    from repro_torch.kernels import rmsnorm as rms
    p = rms.bwd_plan(rows, d, dtype, aligned=aligned)
    assert tuple(p) == want
    per = (16 // (4 if dtype == torch.float32 else 2)) if p.vector else 1
    assert p.threads_per_row * p.vectors_per_thread * per >= d
    slots = rms.BWD_THREADS // p.threads_per_row
    assert p.blocks <= min(-(-rows // slots), 8 * rms.SMS)
    assert (p.blocks - 1) * -(-rows // p.blocks) < rows


def test_rmsnorm_bwd_plan_refuses_rows_past_its_registers():
    from repro_torch.kernels import rmsnorm as rms
    assert rms.bwd_plan(1, rms.BWD_MAX_D, torch.float32).threads_per_row \
        == 256
    with pytest.raises(ValueError, match="rmsnorm_bwd"):
        rms.bwd_plan(1, rms.BWD_MAX_D + 1, torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel"):
        rms.bwd_plan(4, 128, torch.float16)


def test_flash_attention_variant_by_dtype():
    from repro_torch.kernels import flash_attention as fa
    assert fa.variant(torch.bfloat16) == "mma"
    assert fa.variant(torch.float32) == "tf32x3"
    with pytest.raises(ValueError, match="no kernel"):
        fa.variant(torch.float16)


def test_flash_attention_bwd_variant_by_dtype():
    """The backward's own variant: bf16 on mma.m16n8k16, fp32 in 3xTF32
    (as the forward's)."""
    from repro_torch.kernels import flash_attention as fa
    assert fa.bwd_variant(torch.bfloat16) == "mma"
    assert fa.bwd_variant(torch.float32) == "tf32x3"
    assert set(fa.backward.launches_by_variant) == {"mma", "tf32x3"}
    with pytest.raises(ValueError, match="no kernel"):
        fa.bwd_variant(torch.float16)


# ---------------------------------------------------------------------------
# K2 matmul: plain version against the Pallas kernel and the oracle
# ---------------------------------------------------------------------------

# f32: fp32 products summed in another order; bf16 output: one bf16 rounding
# of nearly the same fp32 value (as RMS_TOL)
MM_TOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("m,k,n,tile", [(64, 128, 64, 32), (128, 64, 32, 32),
                                        (32, 32, 128, 16)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_matches_pallas(rng, m, k, n, tile, dtype):
    from repro.kernels.matmul import matmul as jax_matmul
    (ja, ta), (jb, tb) = (_pair(rng.randn(*s) * 0.3, dtype)
                          for s in ((m, k), (k, n)))
    want = jax_matmul(ja, jb, bm=tile, bn=tile, bk=tile, interpret=True)
    got = ops.matmul(ta, tb, impl="cuda")
    assert got.dtype == ta.dtype and got.shape == (m, n)
    tol = MM_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("m,k,n", [(37, 100, 75), (1, 7, 3), (130, 20, 129)])
@pytest.mark.parametrize("out_dtype", [None, "float32", "bfloat16"])
def test_matmul_ragged_matches_reference(rng, m, k, n, out_dtype):
    """Shapes no tile divides: the Pallas kernel asserts, the port masks."""
    (ja, ta), (jb, tb) = (_pair(rng.randn(*s), "bfloat16")
                          for s in ((m, k), (k, n)))
    want = jref.matmul(ja, jb, out_dtype=out_dtype and getattr(jnp, out_dtype))
    got = ops.matmul(ta, tb, impl="cuda",
                     out_dtype=out_dtype and getattr(torch, out_dtype))
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2, atol=3e-2)


# ---------------------------------------------------------------------------
# the impl table: every row on a CPU tensor equals the reference's row
# ---------------------------------------------------------------------------

ROWS = {"plain": "xla", "cuda": "pallas", "dpia-torch": "dpia-jnp",
        "dpia-cuda": "dpia-pallas"}

# op -> (argument shapes, keyword arguments); small shapes, so the
# reference's interpret-mode Pallas rows stay quick
OP_CASES = {
    "scal": ([(), (4096,)], {}),
    "asum": ([(4096,)], {}),
    "dot": ([(4096,), (4096,)], {}),
    "gemv": ([(128, 32), (32,)], {}),
    "matmul": ([(32, 64), (64, 16)], {}),
    "rmsnorm": ([(16, 64), (64,)], {"eps": 1e-6}),
    "softmax": ([(16, 64)], {}),
    "flash_attention": ([(4, 16, 16), (2, 16, 16), (2, 16, 16)],
                        {"causal": True}),
}


def _op_rows():
    for op in OP_CASES:
        for impl in ops.impls(op):
            yield op, impl


@pytest.mark.parametrize("op,impl", list(_op_rows()))
def test_op_rows_match_reference_rows(rng, op, impl):
    from repro import compiler as jcompiler
    from repro.kernels import ops as jops
    shapes, kw = OP_CASES[op]
    vals = [np.float32(rng.randn()) if not s
            else (rng.randn(*s) * 0.5).astype(np.float32) for s in shapes]
    with jcompiler.options(autotune=False, interpret=True, jit=False):
        want = getattr(jops, op)(*[jnp.asarray(v) for v in vals],
                                 impl=ROWS[impl], **kw)
    ops.reset_launch_counts()
    got = getattr(ops, op)(*[torch.tensor(v) for v in vals], impl=impl, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    assert set(ops.launch_counts().values()) == {0}


def test_op_table_rows():
    """Kernel rows exist where a hand-written kernel does; DPIA rows for
    every op (flash_attention's take its 'cuda' row)."""
    for op in OP_CASES:
        want = {"plain", "dpia-torch", "dpia-cuda"}
        if op in ("matmul", "rmsnorm", "flash_attention"):
            want.add("cuda")
        assert set(ops.impls(op)) == want, op


@pytest.mark.parametrize("op", sorted(OP_CASES))
def test_unknown_impl_raises_naming_the_valid_ones(op):
    shapes, kw = OP_CASES[op]
    args = [torch.zeros(s) for s in shapes]
    with pytest.raises(ValueError, match="valid impls.*plain"):
        getattr(ops, op)(*args, impl="pallas", **kw)


def _kernel_rows():
    for op in OP_CASES:
        for impl in ("cuda", "dpia-cuda"):
            if impl in ops.impls(op):
                yield op, impl


@pytest.mark.parametrize("op,impl", list(_kernel_rows()))
def test_kernel_rows_on_a_non_cpu_tensor_raise(op, impl):
    """A kernel row given a tensor that is not on the CPU launches its
    kernel or raises; it never computes a plain version."""
    shapes, kw = OP_CASES[op]
    args = [torch.empty(s, device="meta") for s in shapes]
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="no kernel"):
        getattr(ops, op)(*args, impl=impl, **kw)
    assert set(ops.launch_counts().values()) == {0}


def test_dpia_programs_are_memoised_per_shape():
    ops.clear_caches()
    x = torch.ones(4096)
    ops.asum(x, impl="dpia-cuda")
    ops.asum(x, impl="dpia-cuda")
    ops.asum(torch.ones(2048), impl="dpia-cuda")
    ops.asum(x, impl="dpia-torch")
    from repro_torch import compiler
    assert compiler.executor_cache().stats() == {
        "entries": 3, "hits": 1, "builds": 3, "aot_loads": 0}
    fn = ops.compiled("asum", "cuda", n=4096)
    assert fn.plan.grids == [(2,), (1,)]
    assert fn.program.name == ops.program_name("asum", n=4096) == "asum_4096"
