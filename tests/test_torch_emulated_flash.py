"""K3's CUDA source (csrc/flash_attention.cu: the bf16 tensor-core kernels
and the fp32 3xTF32 forward and backward) on the CPU under
tests/cuda_emu.h, against its plain version.
"""
import ctypes

import pytest
import torch

from _emulation import _cuda_nan, _emulated, gxx  # noqa: F401
from repro_torch.kernels import _build
from repro_torch.kernels import ref

@pytest.fixture(scope="module")
def k3_lib(gxx):
    return gxx("k3_flash", _emulated((_build.CSRC / "flash_attention.cu")
                                     .read_text()))


@pytest.fixture(scope="module")
def k3(k3_lib):
    from repro_torch.kernels import flash_attention as fa
    fn = k3_lib.repro_flash_attention
    fn.argtypes = fa._ARGTYPES
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def k3_bwd(k3_lib):
    from repro_torch.kernels import flash_attention as fa
    fn = k3_lib.repro_flash_attention_bwd
    fn.argtypes = fa._BWD_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


# K3 under emulation against its plain version.  fp32 (the tf32x3
# kernel): fp32 sums in another order, each product in 3xTF32 (within
# about 3 x 2**-22 relative of fp32's).  bf16 (the mma kernel): P rounded
# to bf16 before P.V adds at most 2**-9 relative per term, under the
# output's own bf16 rounding (2**-8).
K3_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# one key tile and several (bf16 takes 64 keys a tile, fp32 32), D 16 /
# 64, causal or not; a q_offset chunk; Sk below Sq; D 128; a q_offset
# chunk at D 128 whose ragged Sk (130) ends two keys past the last full tile
# of either variant; D 80 (zamba2's shared attention: 10 n8 blocks a row,
# 5 k16 steps) over two tiles and as a q_offset chunk
K3_CASES = ([(2, 1, s, s, d, causal, 0) for s in (1, 37, 70)
             for d in (16, 64) for causal in (True, False)]
            + [(4, 2, 5, 70, 64, True, 65), (2, 2, 66, 3, 32, False, 0),
               (2, 1, 70, 70, 128, True, 0), (4, 2, 5, 130, 128, True, 125),
               (2, 2, 70, 70, 80, True, 0), (4, 2, 5, 70, 80, True, 65)])


@pytest.mark.parametrize("bh,bkv,sq,sk,d,causal,q_offset", K3_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_source_matches_plain(k3, bh, bkv, sq, sk, d, causal,
                                              q_offset, dtype):
    g = torch.Generator().manual_seed(sq * 100 + d)
    q = (0.5 * torch.randn((bh, sq, d), generator=g)).to(dtype)
    k = (0.5 * torch.randn((bkv, sk, d), generator=g)).to(dtype)
    v = torch.randn((bkv, sk, d), generator=g).to(dtype)
    o = torch.full((bh, sq, d), float("nan"), dtype=dtype)
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert k3(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None,
              code, bh, bkv, sq, sk, d, 1.0 / d ** 0.5, int(causal),
              q_offset, None) == 0
    want = ref.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    tol = K3_TOL[dtype]
    torch.testing.assert_close(o.float(), want.float(), rtol=tol, atol=tol)


def _k3_inputs(bh, bkv, sq, sk, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    q = (0.5 * torch.randn((bh, sq, d), generator=g)).to(dtype)
    k = (0.5 * torch.randn((bkv, sk, d), generator=g)).to(dtype)
    v = torch.randn((bkv, sk, d), generator=g).to(dtype)
    return q, k, v, g


# the row log-sum-exp both variants write when asked: fp32 against the
# plain version's, from the same inputs (bf16: the same bf16 inputs; the
# kernel's exp2 in the log2 domain and another order of sums)
@pytest.mark.parametrize("bh,bkv,sq,sk,d,causal,q_offset",
                         [(2, 1, 37, 37, 16, True, 0),
                          (4, 2, 70, 70, 64, False, 0),
                          (4, 2, 5, 70, 32, True, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_source_writes_lse(k3, bh, bkv, sq, sk, d, causal,
                                           q_offset, dtype):
    q, k, v, _ = _k3_inputs(bh, bkv, sq, sk, d, dtype, sq + d)
    o = torch.full((bh, sq, d), float("nan"), dtype=dtype)
    lse = torch.full((bh, sq), float("nan"))
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert k3(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), code, bh, bkv, sq, sk, d, 1.0 / d ** 0.5,
              int(causal), q_offset, None) == 0
    want_o, want_lse = ref.flash_attention(q, k, v, causal=causal,
                                           q_offset=q_offset, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    tol = K3_TOL[dtype]
    torch.testing.assert_close(o.float(), want_o.float(), rtol=tol, atol=tol)


def _k3_run(k3, q, k, v, causal):
    """One emulated ``repro_flash_attention`` with ``lse``, outputs starting
    as NaN: ``(o, lse)``."""
    bh, sq, d = q.shape
    bkv, sk, _ = k.shape
    o = torch.full(q.shape, float("nan"), dtype=q.dtype)
    lse = torch.full((bh, sq), float("nan"))
    code = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]
    assert k3(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              lse.data_ptr(), code, bh, bkv, sq, sk, d, 1.0 / d ** 0.5,
              int(causal), 0, None) == 0
    return o, lse


def test_flash_attention_tf32x3_source_is_bitwise_repeatable(k3):
    """The fp32 forward sums in a fixed order: two runs (five key tiles,
    a ragged edge, a GQA group of 2) give the same output and lse bits."""
    q, k, v, _ = _k3_inputs(4, 2, 150, 150, 32, torch.float32, 7)
    a = _k3_run(k3, q, k, v, True)
    b = _k3_run(k3, q, k, v, True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("nan_in", ["q", "v"])
def test_flash_attention_tf32x3_source_keeps_nan(k3, nan_in):
    """A NaN (0x7fffffff) in q reaches one row's scores, in v one column of
    every row's P.V, both split to 3xTF32: the output is NaN where the
    plain version's is (non-causal, so that neither skips a masked tile),
    and agrees with it elsewhere."""
    q, k, v, _ = _k3_inputs(4, 2, 70, 70, 32, torch.float32, 11)
    if nan_in == "q":
        q[1, 40, 3] = _cuda_nan()
    else:
        v[0, 20, 5] = _cuda_nan()
    o, _ = _k3_run(k3, q, k, v, False)
    want = ref.flash_attention(q, k, v, causal=False)
    assert torch.isnan(want).any()
    assert torch.equal(torch.isnan(o), torch.isnan(want))
    fin = ~torch.isnan(want)
    tol = K3_TOL[torch.float32]
    torch.testing.assert_close(o[fin], want[fin], rtol=tol, atol=tol)


# K3's backward under emulation against its plain version, from the plain
# forward's output and lse.  fp32 (the tf32x3 kernels): fp32 sums in
# another order (over up to 130 keys and a GQA group), each product in
# 3xTF32 (within about 3 x 2**-22 relative of fp32's).
# bf16 (the mma kernels): S, dP and every sum in fp32 from the same bf16
# inputs; P rounded to bf16 before dV's product and dS before dK's and
# dQ's add at most 2**-9 relative to each term, under the gradients' own
# rounding (2**-8 relative) of values of order 1.
K3_BWD_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (bh, bkv, s, d, causal): one tile; three 64-tiles with a ragged edge
# (130); a GQA group of 4 at D = 128; non-causal over two tiles; D 80,
# whose D kernels take a row on 16 (bf16) or 32 (fp32) lanes, 10 or 20 of
# them working
K3_BWD_CASES = [(2, 1, 37, 16, True), (4, 2, 70, 32, True),
                (2, 2, 33, 64, False), (2, 1, 5, 128, True),
                (4, 1, 64, 16, True), (2, 1, 130, 32, True),
                (4, 1, 70, 128, True), (2, 1, 100, 16, False),
                (2, 2, 70, 80, True), (2, 1, 37, 80, False)]


def _k3_bwd_run(k3_bwd, bh, bkv, s, d, causal, dtype, nan_in=None):
    """One emulated ``repro_flash_attention_bwd`` from the plain forward's
    output and lse, outputs starting as NaN: ``(grads, inputs)``.
    ``nan_in`` ("q" or "do") puts 0x7fffffff at one element of that
    input (q's before the forward)."""
    q, k, v, g = _k3_inputs(bh, bkv, s, s, d, dtype, 3 * s + d)
    if nan_in == "q":
        q[1, s // 2, 3] = _cuda_nan()
    o, lse = ref.flash_attention(q, k, v, causal=causal, return_lse=True)
    do = torch.randn((bh, s, d), generator=g).to(dtype)
    if nan_in == "do":
        do[0, s // 3, 5] = _cuda_nan()
    outs = [torch.full(t.shape, float("nan"), dtype=dtype) for t in (q, k, v)]
    delta = torch.full((bh, s), float("nan"))
    code = {torch.float32: 0, torch.bfloat16: 1}[dtype]
    assert k3_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), do.data_ptr(),
                  *[t.data_ptr() for t in outs], delta.data_ptr(), code, bh,
                  bkv, s, s, d, 1.0 / d ** 0.5, int(causal), None) == 0
    return outs, (q, k, v, o, lse, do)


@pytest.mark.parametrize("bh,bkv,s,d,causal", K3_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_source_matches_plain(k3_bwd, bh, bkv, s, d,
                                                  causal, dtype):
    outs, inputs = _k3_bwd_run(k3_bwd, bh, bkv, s, d, causal, dtype)
    want = ref.flash_attention_bwd(*inputs, causal=causal)
    tol = K3_BWD_TOL[dtype]
    for name, got, w in zip(("dq", "dk", "dv"), outs, want):
        assert torch.isfinite(got.float()).all(), f"{name} never written"
        torch.testing.assert_close(got.float(), w.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"{name}: {m}")


def test_flash_attention_bwd_mma_source_is_bitwise_repeatable(k3_bwd):
    """No atomics, sums in a fixed order: two runs of the bf16 kernels
    (three tiles, a ragged edge, a GQA group of 2) give the same bits."""
    a, _ = _k3_bwd_run(k3_bwd, 4, 2, 150, 32, True, torch.bfloat16)
    b, _ = _k3_bwd_run(k3_bwd, 4, 2, 150, 32, True, torch.bfloat16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_bwd_tf32x3_source_is_bitwise_repeatable(k3_bwd):
    """The fp32 (3xTF32) kernels likewise: no atomics, every sum in a fixed
    order, so two runs give the same bits."""
    a, _ = _k3_bwd_run(k3_bwd, 4, 2, 150, 32, True, torch.float32)
    b, _ = _k3_bwd_run(k3_bwd, 4, 2, 150, 32, True, torch.float32)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("nan_in", ["do", "q"])
def test_flash_attention_bwd_tf32x3_source_keeps_nan(k3_bwd, nan_in):
    """A NaN (0x7fffffff) in dO or in q reaches D, dP and dS, which the fp32
    kernels split to 3xTF32 (dS^T as a C fragment reused as an A
    fragment): dQ, dK and dV are NaN where the plain version's are
    (non-causal, so that neither skips a masked tile), and agree with it
    elsewhere."""
    outs, inputs = _k3_bwd_run(k3_bwd, 2, 1, 70, 32, False, torch.float32,
                               nan_in=nan_in)
    want = ref.flash_attention_bwd(*inputs, causal=False)
    for name, got, w in zip(("dq", "dk", "dv"), outs, want):
        assert torch.isnan(w).any(), name
        assert torch.equal(torch.isnan(got), torch.isnan(w)), name
        fin = ~torch.isnan(w)
        tol = K3_BWD_TOL[torch.float32]
        torch.testing.assert_close(got[fin], w[fin], rtol=tol, atol=tol)
