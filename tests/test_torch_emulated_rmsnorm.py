"""K1's CUDA source (csrc/rmsnorm.cu: every variant, in both dtypes and
both access widths, forward and backward) on the CPU under
tests/cuda_emu.h, against its plain version.
"""
import ctypes

import pytest
import torch

from _emulation import _emulated, gxx  # noqa: F401
from repro_torch.kernels import _build
from repro_torch.kernels import ref

# ---------------------------------------------------------------------------
# K1 (csrc/rmsnorm.cu): every variant, both dtypes, both access widths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def k1(gxx):
    from repro_torch.kernels import rmsnorm as rms
    lib = gxx("k1_rmsnorm", _emulated((_build.CSRC / "rmsnorm.cu")
                                      .read_text()))
    fn = lib.repro_rmsnorm
    fn.argtypes = rms._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _k1_run(k1, x, w, eps=1e-6):
    """One launch of the emulated K1 as ``rmsnorm._launch`` makes it, into
    an output that starts as NaN; returns the output and the plan."""
    from repro_torch.kernels import rmsnorm as rms
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.full(x.shape, float("nan"), dtype=x.dtype)
    p = rms.plan(rows, d, x.dtype,
                 aligned=not (x.data_ptr() | w.data_ptr()) & 15)
    assert k1(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, eps,
              int(x.dtype == torch.bfloat16), p.vector, p.threads_per_row,
              p.vectors_per_thread, p.threads, p.grid, None) == 0
    return y, p


def _assert_k1_close(got, want):
    """bf16: within one bf16 ulp of the plain version (the row sums run in
    another order, which may flip one rounding); fp32: 1e-6 relative."""
    assert torch.isfinite(got.float()).all(), "an element was never written"
    if want.dtype == torch.bfloat16:
        want = want.float()
        ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 8)
        err = (got.float() - want).abs()
        assert (err <= ulp).all(), f"max err {err.max()} beyond one ulp"
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


# (rows, d): packed (1, 1), (37, 64), (9, 24) -- lanes of a group masked
# off --, (3, 128) and (37, 128) (rows past the last full block); warp
# (140, 2560) and (140, 100) (bf16: one element an access); fewer rows
# than SMs, a block a row: (5, 2560) and (2, 100) (bf16: one element an
# access; fp32: 25 accesses, a warp); long rows (2, 9000) and a row read
# twice (1, 20000)
K1_SHAPES = [(1, 1), (3, 128), (37, 128), (37, 64), (9, 24), (140, 2560),
             (140, 100), (5, 2560), (2, 100), (2, 9000), (1, 20000)]
K1_VARIANTS = {torch.bfloat16: ["packed", "packed", "packed", "packed",
                                "packed", "warp", "warp", "block", "block",
                                "block", "block"],
               torch.float32: ["packed", "warp", "warp", "packed", "packed",
                               "warp", "warp", "block", "warp", "block",
                               "block"]}


@pytest.mark.parametrize("shape", K1_SHAPES,
                         ids=[f"{r}x{d}" for r, d in K1_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_source_matches_plain(k1, shape, dtype):
    """Each variant's lane groups, masks and reductions against the plain
    version; the planned variant as K1_VARIANTS says."""
    variant = K1_VARIANTS[dtype][K1_SHAPES.index(shape)]
    g = torch.Generator().manual_seed(shape[0] * 10007 + shape[1])
    x = torch.randn(shape, generator=g).to(dtype)
    w = (1 + 0.5 * torch.randn(shape[-1], generator=g)).to(dtype)
    got, p = _k1_run(k1, x, w)
    assert p.variant == variant
    assert p.vector == ((shape[-1] * x.element_size()) % 16 == 0)
    _assert_k1_close(got, ref.rmsnorm(x, w))


@pytest.mark.parametrize("rows,variant", [(37, "block"), (140, "warp")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_source_misaligned_view_takes_scalar_accesses(k1, dtype, rows,
                                                              variant):
    """Rows cut from a flat buffer one element in: no 16-byte accesses,
    the same values."""
    g = torch.Generator().manual_seed(5)
    flat = torch.randn(1 + rows * 128, generator=g).to(dtype)
    x = flat[1:].view(rows, 128)
    w = (1 + 0.5 * torch.randn(128, generator=g)).to(dtype)
    got, p = _k1_run(k1, x, w)
    assert not p.vector and p.variant == variant
    _assert_k1_close(got, ref.rmsnorm(x, w))


def test_rmsnorm_source_is_bitwise_repeatable(k1):
    """A fixed order of additions: two runs give the same bits."""
    g = torch.Generator().manual_seed(6)
    x = torch.randn(3, 9000, generator=g)
    w = torch.randn(9000, generator=g)
    a, _ = _k1_run(k1, x, w)
    b, _ = _k1_run(k1, x, w)
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def k1_bwd(gxx):
    from repro_torch.kernels import rmsnorm as rms
    lib = gxx("k1_rmsnorm_bwd", _emulated((_build.CSRC / "rmsnorm.cu")
                                          .read_text()))
    fn = lib.repro_rmsnorm_bwd
    fn.argtypes = rms._BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _k1_bwd_run(k1_bwd, x, w, dy, eps=1e-6):
    """One emulated ``repro_rmsnorm_bwd`` as ``rmsnorm._launch_bwd`` makes
    it, outputs starting as NaN: ``(dx, dw)`` and the plan."""
    from repro_torch.kernels import rmsnorm as rms
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.full(x.shape, float("nan"), dtype=x.dtype)
    dw = torch.full((d,), float("nan"), dtype=x.dtype)
    ptrs = x.data_ptr() | w.data_ptr() | dy.data_ptr() | dx.data_ptr()
    p = rms.bwd_plan(rows, d, x.dtype, aligned=not ptrs & 15)
    partial = torch.full((p.blocks, d), float("nan"))
    assert k1_bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                  dw.data_ptr(), partial.data_ptr(), rows, d, eps,
                  int(x.dtype == torch.bfloat16), p.vector,
                  p.threads_per_row, p.vectors_per_thread, p.blocks,
                  None) == 0
    return (dx, dw), p


def _assert_k1_bwd_close(got, want, rows):
    """fp32: the same arithmetic in another order (dw sums up to 4300
    rows).  bf16: each gradient is one rounding of nearly the same fp32
    value (2**-8 relative), dw's row sums growing with the rows."""
    (dx, dw), (want_dx, want_dw) = got, want
    tol = 1e-5 if dx.dtype == torch.float32 else 1e-2
    assert torch.isfinite(dx.float()).all() and torch.isfinite(dw.float()).all()
    torch.testing.assert_close(dx.float(), want_dx.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(dw.float(), want_dw.float(), rtol=tol,
                               atol=tol * rows ** 0.5)


# K1's backward against its plain version, with the layout bwd_plan()
# gives (threads a row, accesses a thread; bf16 / fp32): lanes masked off
# (24: 4 / 8 lanes; 100: one element an access in bf16, 32 x 4), a d_model
# row (2560: 32 x 10 / 64 x 10, two warps' sums through shared memory),
# two rows a warp (128 bf16: 16 lanes), one row, several blocks of
# several passes each (4300 x 8: 1 / 2 lanes a row, 17 / 34 blocks; 600 x
# 2560: 75 / 132 blocks), rows of 128 / 256 threads (9000) and one
# element an access past 2560 (9001: 256 x 40).
K1_BWD_SHAPES = [(1, 1), (3, 24), (37, 128), (5, 2560), (140, 100),
                 (4300, 8), (600, 2560), (2, 9000), (2, 9001)]


@pytest.mark.parametrize("shape", K1_BWD_SHAPES,
                         ids=[f"{r}x{d}" for r, d in K1_BWD_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_source_matches_plain(k1_bwd, shape, dtype):
    g = torch.Generator().manual_seed(shape[0] * 31 + shape[1])
    x = torch.randn(shape, generator=g).to(dtype)
    w = (1 + 0.5 * torch.randn(shape[-1], generator=g)).to(dtype)
    dy = torch.randn(shape, generator=g).to(dtype)
    got, p = _k1_bwd_run(k1_bwd, x, w, dy)
    assert p.vector == ((shape[-1] * x.element_size()) % 16 == 0)
    _assert_k1_bwd_close(got, ref.rmsnorm_bwd(x, w, dy), shape[0])


@pytest.mark.parametrize("rows,d", [(37, 128), (140, 2560)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_source_misaligned_view_takes_scalar_accesses(
        k1_bwd, dtype, rows, d):
    """Rows cut from a flat buffer one element in: one element an access
    (d_model: 256 threads x 10), the same values."""
    g = torch.Generator().manual_seed(9)
    flat = torch.randn(2, 1 + rows * d, generator=g).to(dtype)
    x, dy = flat[0, 1:].view(rows, d), flat[1, 1:].view(rows, d)
    w = (1 + 0.5 * torch.randn(d, generator=g)).to(dtype)
    got, p = _k1_bwd_run(k1_bwd, x, w, dy)
    assert not p.vector
    _assert_k1_bwd_close(got, ref.rmsnorm_bwd(x, w, dy), rows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_source_is_bitwise_repeatable(k1_bwd, dtype):
    """dw is a fixed-order column sum over several blocks of several
    passes: two runs give the same bits."""
    g = torch.Generator().manual_seed(8)
    x, dy = (torch.randn(600, 96, generator=g).to(dtype) for _ in range(2))
    w = torch.randn(96, generator=g).to(dtype)
    (a, p), (b, _) = (_k1_bwd_run(k1_bwd, x, w, dy) for _ in range(2))
    assert p.blocks > 1
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.parametrize("shape", [(37, 128), (140, 2560), (5, 2560),
                                   (2, 9000)])
def test_rmsnorm_source_rounds_in_the_reference_order(k1, shape):
    """Integer rows sum exactly in any order, so the kernel's bf16 output
    equals the plain version bit for bit: the row is rounded to bf16
    before ``* w``; rounding only the product would differ."""
    g = torch.Generator().manual_seed(7)
    x = torch.randint(-4, 5, shape, generator=g).to(torch.bfloat16)
    w = (3 * torch.randn(shape[-1], generator=g)).to(torch.bfloat16)
    got, _ = _k1_run(k1, x, w)
    want = ref.rmsnorm(x, w)
    assert torch.equal(got, want)
    x32 = x.float()
    fused = (x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
             * w.float()).to(torch.bfloat16)
    assert not torch.equal(got, fused)
