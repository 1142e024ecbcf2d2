"""Each emulated tensor-core primitive of csrc/tc_sm80.cuh (ldmatrix,
mma.sync in bf16 and tf32, cvt.rna.tf32, cp.async, bf16x2 packing) in
tests/cuda_emu.h, against numpy: the emulation the K1 / K2 / K3 source
tests stand on.
"""
import ctypes

import numpy as np
import pytest
import torch

from _emulation import CUDA_NAN, gxx  # noqa: F401

# ---------------------------------------------------------------------------
# the tensor-core primitives (csrc/tc_sm80.cuh) and K3
# ---------------------------------------------------------------------------

PRIMITIVES = r"""
#include "cuda_emu.h"
// one warp; matrix i of the x4 loads is the 8 x 8 quadrant of a 16 x 16
// b16 tile at rows 8 (i % 2), columns 8 (i / 2)
extern "C" void ldm(const uint16_t* tile, uint32_t* plain, uint32_t* trans) {
  emu_launch(dim3(1), 32, [&] {
    const int lane = threadIdx.x, i = lane / 8, r = lane % 8;
    const uint16_t* p = tile + (8 * (i % 2) + r) * 16 + 8 * (i / 2);
    ldmatrix_x4(plain + 4 * lane, p);
    ldmatrix_x4_trans(trans + 4 * lane, p);
  });
}
extern "C" void mma(const uint32_t* a, const uint32_t* b, float* d) {
  emu_launch(dim3(1), 32, [&] {
    const int l = threadIdx.x;
    mma_16816_bf16(d + 4 * l, a + 4 * l, b + 2 * l);
  });
}
extern "C" void cpa(const char* src, char* dst, int n, const int* bytes) {
  emu_launch(dim3(1), 32, [&] {
    for (int c = threadIdx.x; c < n; c += 32)
      cp_async_16(dst + 16 * c, src + 16 * c, bytes[c]);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  });
}
extern "C" uint32_t pack(float lo, float hi) { return pack_bf16x2(lo, hi); }
extern "C" void tf32(const float* x, uint32_t* hi, uint32_t* lo, int n) {
  for (int i = 0; i < n; ++i) split_tf32(x[i], hi[i], lo[i]);
}
// one warp: d += A.B by mma.m16n8k8 tf32 (threes = 0) or by the 3xTF32
// triple from fp32 fragments split in the lanes (threes = 1)
extern "C" void mma8(const uint32_t* a, const uint32_t* b, float* d,
                     int threes) {
  emu_launch(dim3(1), 32, [&] {
    const int l = threadIdx.x;
    if (!threes) { mma_1688_tf32(d + 4 * l, a + 4 * l, b + 2 * l); return; }
    uint32_t ah[4], al[4], bh[2], bl[2];
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(a[4 * l + i]), ah[i], al[i]);
    for (int i = 0; i < 2; ++i) split_tf32(__uint_as_float(b[2 * l + i]), bh[i], bl[i]);
    mma_1688_3xtf32(d + 4 * l, ah, al, bh, bl);
  });
}
"""


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 values (already bf16-representable) as their bf16 bits."""
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16
            ).astype(np.uint32)


def _pair(lo, hi):
    """Two bf16 bit patterns in one register, ``lo`` in the low half."""
    return lo | hi << 16


@pytest.fixture(scope="module")
def prims(gxx):
    return gxx("tc_primitives", PRIMITIVES)


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def test_emulated_ldmatrix_layouts(prims):
    """ldmatrix.x4 (and .trans): lane l's register i holds row l // 4,
    columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i (of its transpose)."""
    tile = np.arange(256, dtype=np.uint16).reshape(16, 16)
    plain = np.zeros((32, 4), np.uint32)
    trans = np.zeros((32, 4), np.uint32)
    prims.ldm(_ptr(tile), _ptr(plain), _ptr(trans))
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        for i in range(4):
            q = tile[8 * (i % 2):8 * (i % 2) + 8, 8 * (i // 2):8 * (i // 2) + 8]
            q = q.astype(np.uint32)
            assert plain[lane, i] == _pair(q[g, c], q[g, c + 1])
            assert trans[lane, i] == _pair(q[c, g], q[c + 1, g])


def test_emulated_mma_16816_matches_numpy(prims, rng):
    """mma.m16n8k16 on fragments laid out as the PTX ISA documents them
    (A row major, B k-down, C / D by rows g and g + 8): D = A.B + C."""
    def bf16(*s):
        return torch.tensor(rng.randn(*s), dtype=torch.float32).to(
            torch.bfloat16).float().numpy()
    A, B, C = bf16(16, 16), bf16(16, 8), bf16(16, 8)
    a = np.zeros((32, 4), np.uint32)
    b = np.zeros((32, 2), np.uint32)
    d = np.zeros((32, 4), np.float32)
    Ab, Bb = _bf16_bits(A), _bf16_bits(B)
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        for i, (r, k) in enumerate([(g, c), (g + 8, c), (g, c + 8),
                                    (g + 8, c + 8)]):
            a[lane, i] = _pair(Ab[r, k], Ab[r, k + 1])
        b[lane] = [_pair(Bb[c, g], Bb[c + 1, g]),
                   _pair(Bb[c + 8, g], Bb[c + 9, g])]
        d[lane] = [C[g, c], C[g, c + 1], C[g + 8, c], C[g + 8, c + 1]]
    prims.mma(_ptr(a), _ptr(b), _ptr(d))
    want = A.astype(np.float64) @ B + C
    for lane in range(32):
        g, c = lane // 4, 2 * (lane % 4)
        np.testing.assert_allclose(
            d[lane], [want[g, c], want[g, c + 1], want[g + 8, c],
                      want[g + 8, c + 1]], rtol=1e-6, atol=1e-6)


def test_emulated_cp_async_copies_or_zero_fills(prims, rng):
    src = rng.randint(1, 255, size=(40, 16)).astype(np.uint8)
    dst = np.full((40, 16), 7, np.uint8)
    nbytes = np.where(np.arange(40) % 3 == 0, 0, 16).astype(np.int32)
    prims.cpa(_ptr(src), _ptr(dst), 40, _ptr(nbytes))
    want = np.where((nbytes == 16)[:, None], src, 0)
    np.testing.assert_array_equal(dst, want)


@pytest.mark.parametrize("lo,hi", [(1.0, -2.5), (1.00390625, 3.0e-3),
                                   (1.01171875, -65504.0), (0.0, 1e30)])
def test_emulated_pack_bf16x2_rounds_like_torch(prims, lo, hi):
    prims.pack.restype = ctypes.c_uint32
    prims.pack.argtypes = [ctypes.c_float, ctypes.c_float]
    bits = torch.tensor([lo, hi]).to(torch.bfloat16).view(torch.int16)
    want = [int(x) & 0xffff for x in bits]
    assert prims.pack(lo, hi) == _pair(want[0], want[1])


def _tf32_rna(x: float) -> float:
    """x rounded to tf32 (11 significant bits), to nearest with ties away
    from zero, in float64: independent of the bit trick under test."""
    m, e = np.frexp(np.float64(x))               # |m| in [0.5, 1)
    scaled = np.ldexp(m, 11)
    r = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return float(np.ldexp(r, int(e) - 11))


def _split(prims, x):
    x = np.ascontiguousarray(x, np.float32)
    hi = np.zeros(x.shape, np.uint32)
    lo = np.zeros(x.shape, np.uint32)
    prims.tf32(_ptr(x), _ptr(hi), _ptr(lo), x.size)
    return hi, lo


def test_emulated_cvt_rna_tf32_rounds_to_nearest_ties_away(prims, rng):
    """cvt.rna.tf32.f32 bit for bit: the low 13 bits cleared, ties (low
    bits exactly 0x1000) away from zero for either sign, a carry into the
    exponent, NaN and Inf kept; random normal values against a float64
    rounding to 11 significant bits."""
    cases = {0x3F801000: 0x3F802000, 0xBF801000: 0xBF802000,   # ties
             0x3F802FFF: 0x3F802000, 0x3F803000: 0x3F804000,   # below; tie
             0x3F800FFF: 0x3F800000, 0xBF800FFF: 0xBF800000,   # below
             0x3F801001: 0x3F802000, 0xC0001001: 0xC0002000,   # above
             0x3FFFFFFF: 0x40000000, 0x7F800000: 0x7F800000,   # carry; Inf
             0xFF800000: 0xFF800000, 0x00000000: 0x00000000}
    bits = np.array(list(cases), np.uint32)
    hi, _ = _split(prims, bits.view(np.float32))
    assert [hex(h) for h in hi] == [hex(v) for v in cases.values()]
    nan, _ = _split(prims, np.array([np.nan], np.float32))
    assert np.isnan(nan.view(np.float32)[0])
    x = (rng.randn(2000) * np.exp2(rng.randint(-60, 60, 2000))).astype(
        np.float32)
    hi, _ = _split(prims, x)
    assert not (hi & 0x1FFF).any()
    np.testing.assert_array_equal(hi.view(np.float32).astype(np.float64),
                                  [_tf32_rna(v) for v in x])


def test_emulated_cvt_rna_tf32_of_a_nan_clears_the_low_bits(prims):
    """hi of a NaN is cvt.rna's (as the card gives it): the NaN with its low
    13 bits cleared, so 0x7fffffff (the card's 0/0) and the NaNs of the
    highest mantissas, whose rounding by an add would carry into the sign,
    stay NaN; only a payload wholly in the low 13 bits becomes Inf.  Inf
    gives hi = Inf."""
    nans = np.array([CUDA_NAN, 0xFFFFFFFF, 0x7FFFF000, 0xFFFFF000,
                     0x7FC00000, 0x7F800001, 0xFF801000], np.uint32)
    hi, _ = _split(prims, nans.view(np.float32))
    assert [hex(h) for h in hi] == [hex(v & 0xFFFFE000) for v in nans]
    assert np.isnan(hi[:5].view(np.float32)).all()
    inf = np.array([np.inf, -np.inf], np.float32)
    hi, _ = _split(prims, inf)
    np.testing.assert_array_equal(hi.view(np.float32), inf)


def test_emulated_split_tf32_hi_plus_lo_is_x_to_2_pow_minus_22(prims, rng):
    """hi + lo recovers x to 2**-22 relative (both halves tf32: low 13
    bits clear); hi alone only to 2**-11."""
    x = (rng.randn(5000) * np.exp2(rng.randint(-40, 40, 5000))).astype(
        np.float32)
    hi, lo = _split(prims, x)
    assert not ((hi | lo) & 0x1FFF).any()
    h = hi.view(np.float32).astype(np.float64)
    l_ = lo.view(np.float32).astype(np.float64)
    err = np.abs(x.astype(np.float64) - h - l_) / np.abs(x)
    assert err.max() <= 2.0 ** -22
    assert (np.abs(x - h) / np.abs(x)).max() > 2.0 ** -14


def _tf32_fragments(A, B, C):
    """m16n8k8 tf32 fragments of A (16 x 8), B (8 x 8, k down) and C (16 x
    8) as the PTX ISA lays them out: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
    a3 (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g); C as m16n8k16's."""
    a = np.zeros((32, 4), np.uint32)
    b = np.zeros((32, 2), np.uint32)
    d = np.zeros((32, 4), np.float32)
    Ab = np.ascontiguousarray(A, np.float32).view(np.uint32)
    Bb = np.ascontiguousarray(B, np.float32).view(np.uint32)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        a[lane] = [Ab[g, t], Ab[g + 8, t], Ab[g, t + 4], Ab[g + 8, t + 4]]
        b[lane] = [Bb[t, g], Bb[t + 4, g]]
        d[lane] = [C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t],
                   C[g + 8, 2 * t + 1]]
    return a, b, d


def _c_fragment(d):
    """The 16 x 8 matrix a C / D fragment holds."""
    out = np.zeros((16, 8), np.float64)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out[g, 2 * t], out[g, 2 * t + 1] = d[lane, 0], d[lane, 1]
        out[g + 8, 2 * t], out[g + 8, 2 * t + 1] = d[lane, 2], d[lane, 3]
    return out


def test_emulated_mma_1688_tf32_matches_numpy(prims, rng):
    """mma.m16n8k8 tf32 on fragments laid out as the PTX ISA documents
    them: D = A.B + C (tf32 inputs: the products are exact in fp32)."""
    def tf32(*s):
        return np.vectorize(_tf32_rna)(rng.randn(*s)).astype(np.float32)
    A, B, C = tf32(16, 8), tf32(8, 8), tf32(16, 8)
    a, b, d = _tf32_fragments(A, B, C)
    prims.mma8(_ptr(a), _ptr(b), _ptr(d), 0)
    np.testing.assert_allclose(_c_fragment(d),
                               A.astype(np.float64) @ B + C, rtol=1e-6,
                               atol=1e-6)


def test_emulated_3xtf32_keeps_fp32_level_error(prims, rng):
    """fp32 operands through the 3xTF32 triple: within a few 2**-22 of
    sum |a b| of the float64 product, where one tf32 product is ~1000 x
    further off."""
    A = rng.randn(16, 8).astype(np.float32)
    B = rng.randn(8, 8).astype(np.float32)
    want = A.astype(np.float64) @ B
    scale = np.abs(A).astype(np.float64) @ np.abs(B)
    a, b, d = _tf32_fragments(A, B, np.zeros((16, 8), np.float32))
    prims.mma8(_ptr(a), _ptr(b), _ptr(d), 1)
    assert (np.abs(_c_fragment(d) - want) / scale).max() <= 4 * 2.0 ** -22
    d1 = np.zeros((32, 4), np.float32)
    prims.mma8(_ptr(a), _ptr(b), _ptr(d1), 0)      # hi bits only: tf32
    assert (np.abs(_c_fragment(d1) - want) / scale).max() > 2.0 ** -14


def test_emulated_c_fragment_is_an_a_fragment_under_permuted_k(prims, rng):
    """A C fragment of X (16 x 8) reused as an A fragment, a = {c0, c2, c1,
    c3} (slot t is column 2t, slot t + 4 column 2t + 1), times B loaded
    in the same order (b0 from row 2t, b1 from row 2t + 1) is X.Y; B in
    the natural order (rows t, t + 4) is not."""
    def tf32(*s):
        return np.vectorize(_tf32_rna)(rng.randn(*s)).astype(np.float32)
    X, Y = tf32(16, 8), tf32(8, 8)
    _, _, c = _tf32_fragments(np.zeros((16, 8)), np.zeros((8, 8)), X)
    cb = c.view(np.uint32)
    a = np.ascontiguousarray(cb[:, [0, 2, 1, 3]])
    Yb = Y.view(np.uint32)
    want = X.astype(np.float64) @ Y
    for permuted in (True, False):
        b = np.zeros((32, 2), np.uint32)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            b[lane] = ([Yb[2 * t, g], Yb[2 * t + 1, g]] if permuted
                       else [Yb[t, g], Yb[t + 4, g]])
        d = np.zeros((32, 4), np.float32)
        prims.mma8(_ptr(a), _ptr(b), _ptr(d), 0)
        close = np.allclose(_c_fragment(d), want, rtol=1e-6, atol=1e-6)
        assert close == permuted
