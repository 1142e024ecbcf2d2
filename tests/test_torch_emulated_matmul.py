"""K2's CUDA source (csrc/matmul.cu: the skinny, tf32x3 and mma regimes)
on the CPU under tests/cuda_emu.h, against its plain version.

K2's wgmma + TMA kernel (csrc/matmul_wgmma.cu) has no CPU emulation: it is
tested on the card only (tests/test_torch_cuda.py).
"""
import ctypes

import pytest
import torch

from _emulation import _cuda_nan, _emulated, gxx  # noqa: F401
from repro_torch.kernels import _build
from repro_torch.kernels import ref

# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k2(gxx):
    from repro_torch.kernels import matmul as mm
    lib = gxx("k2_matmul", _emulated((_build.CSRC / "matmul.cu").read_text()))
    fn = lib.repro_matmul
    fn.argtypes = mm._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _k2_run(k2, a, b, out_dtype, tile=None):
    """One emulated ``repro_matmul`` as ``matmul._launch`` makes it, into an
    output that starts as NaN: ``(c, plan)``.  A bf16 shape the plan gives
    to wgmma (not in this source) runs the source's bf16 regime, ``mma``,
    which takes any bf16 shape; ``tile`` overrides a tf32x3 tile (square:
    rows and columns)."""
    from repro_torch.kernels import matmul as mm
    (m, k), n = a.shape, b.shape[1]
    p = mm.plan(m, n, k, a.dtype)
    if p.variant == "wgmma":
        p = mm.Plan("mma", (-(-n // 64), -(-m // 64), 1), 1, 0, 64, 64)
    if tile is not None:
        p = p._replace(block_m=tile, block_n=tile)
    c = torch.full((m, n), float("nan"), dtype=out_dtype)
    work = torch.full((max(1, p.workspace_bytes // 4),), float("nan"))
    codes = {torch.float32: 0, torch.bfloat16: 1}
    assert k2(a.data_ptr(), b.data_ptr(), c.data_ptr(),
              work.data_ptr() if p.split > 1 else None, m, n, k,
              codes[a.dtype], codes[out_dtype], mm._VARIANT_CODES[p.variant],
              p.block_m, p.block_n, p.split, None) == 0
    return c, p


def _k2_inputs(m, k, n, dtype):
    g = torch.Generator().manual_seed(m * 1000 + n)
    a = torch.randn((m, k), generator=g).to(dtype)
    b = torch.randn((k, n), generator=g).to(dtype)
    return a, b


# (m, k, n): the skinny regime with K split (3 x 1100 x 75: 16 parts of 69
# rows, B read one element at a time; 16 x 700 x 256: 8 parts of 88 rows
# over chunks of 256, 16 rows, 16-byte loads), tf32x3 (fp32) with ragged
# edges (130 x 20 x 129: 128 x 128 tiles; 37 x 100 x 75: 64 x 64 tiles, B's
# rows by 4-byte copies; 40 x 45 x 132: A's), and K = 0
MM_SOURCE_CASES = [(37, 100, 75), (130, 20, 129), (4, 64, 200), (5, 0, 3),
                   (3, 1100, 75), (16, 700, 256), (40, 45, 132)]
# the regime each case takes in fp32 and in bf16
MM_SOURCE_REGIMES = {
    (37, 100, 75): ("tf32x3", "mma"), (130, 20, 129): ("tf32x3", "mma"),
    (4, 64, 200): ("skinny", "mma"), (5, 0, 3): ("skinny", "mma"),
    (3, 1100, 75): ("skinny", "mma"), (16, 700, 256): ("skinny", "mma"),
    (40, 45, 132): ("tf32x3", "mma")}


@pytest.mark.parametrize("m,k,n", MM_SOURCE_CASES)
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_matmul_source_matches_plain(k2, m, k, n, dtype, out_dtype):
    """K2's regimes, masked ragged edges and splits, in every dtype pair:
    fp32 sums in another order, in 3xTF32 for tf32x3 (1e-4); a bf16
    output may round one ulp apart (2**-8 relative)."""
    a, b = _k2_inputs(m, k, n, dtype)
    c, p = _k2_run(k2, a, b, out_dtype)
    assert p.variant == MM_SOURCE_REGIMES[(m, k, n)][dtype == torch.bfloat16]
    if dtype == torch.float32 and (m, k, n) in ((3, 1100, 75),
                                                (16, 700, 256)):
        assert p.split == (16 if m == 3 else 8)
    tol = 1e-4 if out_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(c.float(), ref.matmul(a, b, out_dtype=out_dtype)
                               .float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("block_n", [64, 128])
def test_matmul_tf32x3_source_at_both_tile_widths(k2, block_n):
    """Both tf32x3 tiles, 64 x 64 (the plan's for M <= 64) and 128 x 128,
    at one shape ragged in every dimension, against the plain version
    (1e-4)."""
    a, b = _k2_inputs(150, 37, 200, torch.float32)
    c, p = _k2_run(k2, a, b, torch.float32, tile=block_n)
    assert p.variant == "tf32x3" and (p.block_m, p.block_n) == (block_n,
                                                                block_n)
    torch.testing.assert_close(c, ref.matmul(a, b), rtol=1e-4, atol=1e-4)


# 0x7fffffff: the NaN the card's fp32 arithmetic makes (0/0, Inf - Inf),


@pytest.mark.parametrize("m,k,n", [(37, 100, 75), (130, 20, 129)])
def test_matmul_tf32x3_source_keeps_nan(k2, m, k, n):
    """A NaN in A (row 3) and in B (column 7), both 0x7fffffff: the
    output's NaNs are the plain version's, row 3 and column 7, at both
    tiles; 3xTF32 turns no NaN into a finite value."""
    a, b = _k2_inputs(m, k, n, torch.float32)
    a[3, k // 2] = _cuda_nan()
    b[k - 1, 7] = _cuda_nan()
    c, p = _k2_run(k2, a, b, torch.float32)
    assert p.variant == "tf32x3"
    want = ref.matmul(a, b)
    assert torch.isnan(want[3]).all() and torch.isnan(want[:, 7]).all()
    assert torch.equal(torch.isnan(c), torch.isnan(want))
    fin = ~torch.isnan(want)
    torch.testing.assert_close(c[fin], want[fin], rtol=1e-4, atol=1e-4)


def test_matmul_skinny_source_split_is_bitwise_repeatable(k2):
    """The skinny regime's partials meet in a fixed order (warps, then
    parts): two runs give the same bits."""
    a, b = _k2_inputs(16, 700, 256, torch.float32)
    (x, p), (y, _) = (_k2_run(k2, a, b, torch.float32) for _ in range(2))
    assert p.variant == "skinny" and p.split > 1
    assert torch.equal(x, y)
