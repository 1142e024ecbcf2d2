"""Gradients of K1 (RMSNorm) and K3 (flash attention) in the port, on the
CPU: the plain backward versions (``ref.rmsnorm_bwd``,
``ref.flash_attention_bwd``) against autograd of the plain forwards
(``gradcheck`` in fp64, and fp32 directly), against ``jax.vjp`` of the
reference's jnp oracles (``repro.kernels.ref``), and the two
``autograd.Function``s (``_RMSNormFn``, ``_FlashAttentionFn``), which run
those plain versions on a CPU tensor, against autograd of the plain
forwards.  The backward kernels themselves run under
``tests/cuda_emu.h`` (``test_torch_emulated_rmsnorm.py``,
``test_torch_emulated_flash.py``) and on the card
(``test_torch_cuda.py``).

Tolerances: fp64 ``gradcheck`` at its defaults (finite differences);
fp32 against autograd and against JAX, 1e-5 absolute and relative (the
same math in another summation order; values of order 1); bf16 Functions
against autograd of the plain forward in bf16, 2e-2 (autograd rounds
``dy * w`` and the products to bf16 where the plain backward keeps fp32;
each gradient is one bf16 rounding apart, 2**-8 relative, of values of
order 1, summed over up to 24 rows for dw)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rms

TOL32 = 1e-5

RMS_SHAPES = [(3, 8), (2, 5, 32), (24, 128)]
# (bh, bkv, s, d, causal): GQA groups of 1, 2 and 4, a ragged length
FA_CASES = [(2, 2, 7, 8, True), (4, 2, 9, 16, True), (4, 1, 6, 8, False),
            (8, 2, 33, 16, True)]


def _rms_inputs(shape, dtype, seed=0):
    g = np.random.RandomState(seed)
    x = g.randn(*shape)
    w = 1 + 0.5 * g.randn(shape[-1])
    dy = g.randn(*shape)
    return x, w, dy


def _fa_inputs(bh, bkv, s, d, seed=0):
    g = np.random.RandomState(seed)
    return (0.5 * g.randn(bh, s, d), 0.5 * g.randn(bkv, s, d),
            g.randn(bkv, s, d), g.randn(bh, s, d))


def _t(a, dtype=torch.float64, grad=False):
    return torch.tensor(a, dtype=dtype, requires_grad=grad)


# ---- the plain backward versions --------------------------------------------

@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_bwd_plain_gradcheck_fp64(shape):
    """The Function on CPU tensors is the plain forward and backward: its
    gradient against finite differences of the plain forward."""
    x, w, _ = _rms_inputs(shape, np.float64)
    assert torch.autograd.gradcheck(
        lambda a, b: rms.rmsnorm(a, b, eps=1e-6),
        (_t(x, grad=True), _t(w, grad=True)))


@pytest.mark.parametrize("bh,bkv,s,d,causal", FA_CASES[:3])
def test_flash_attention_bwd_plain_gradcheck_fp64(bh, bkv, s, d, causal):
    q, k, v, _ = _fa_inputs(bh, bkv, s, d)
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, causal=causal),
        (_t(q, grad=True), _t(k, grad=True), _t(v, grad=True)))


@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_bwd_plain_matches_autograd_fp32(shape):
    x, w, dy = (_t(a, torch.float32) for a in _rms_inputs(shape, 0))
    x.requires_grad_(True)
    w.requires_grad_(True)
    want = torch.autograd.grad(ref.rmsnorm(x, w), (x, w), dy)
    got = ref.rmsnorm_bwd(x.detach(), w.detach(), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL32, atol=TOL32)


@pytest.mark.parametrize("bh,bkv,s,d,causal", FA_CASES)
def test_flash_attention_bwd_plain_matches_autograd_fp32(bh, bkv, s, d,
                                                         causal):
    q, k, v, do = (_t(a, torch.float32) for a in _fa_inputs(bh, bkv, s, d))
    for t in (q, k, v):
        t.requires_grad_(True)
    o = ref.flash_attention(q, k, v, causal=causal)
    want = torch.autograd.grad(o, (q, k, v), do)
    o2, lse = ref.flash_attention(q.detach(), k.detach(), v.detach(),
                                  causal=causal, return_lse=True)
    torch.testing.assert_close(o2, o.detach(), rtol=0, atol=0)
    got = ref.flash_attention_bwd(q.detach(), k.detach(), v.detach(), o2,
                                  lse, do, causal=causal)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL32, atol=TOL32)


@pytest.mark.parametrize("shape", RMS_SHAPES)
def test_rmsnorm_bwd_plain_matches_jax_vjp(shape):
    """Against ``jax.vjp`` of the reference's jnp ``rmsnorm``."""
    x, w, dy = (a.astype(np.float32) for a in _rms_inputs(shape, 0))
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b, eps=1e-6),
                     jnp.asarray(x), jnp.asarray(w))
    want = vjp(jnp.asarray(dy))
    got = ref.rmsnorm_bwd(*(torch.tensor(a) for a in (x, w, dy)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL32,
                                   atol=TOL32)


@pytest.mark.parametrize("bh,bkv,s,d,causal", FA_CASES)
def test_flash_attention_bwd_plain_matches_jax_vjp(bh, bkv, s, d, causal):
    """Against ``jax.vjp`` of the reference's jnp attention oracle (the
    function its einsum path, ``use_flash=False``, computes)."""
    q, k, v, do = (a.astype(np.float32) for a in _fa_inputs(bh, bkv, s, d))
    _, vjp = jax.vjp(lambda a, b, c: jref.flash_attention(a, b, c,
                                                          causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.tensor(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    got = ref.flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL32,
                                   atol=TOL32)


def test_flash_attention_lse_matches_logsumexp():
    q, k, v, _ = (torch.tensor(a, dtype=torch.float32)
                  for a in _fa_inputs(4, 2, 9, 16))
    _, lse = ref.flash_attention(q, k, v, causal=True, return_lse=True)
    s = torch.einsum("bqd,bkd->bqk", q, k.repeat_interleave(2, 0)) / 4.0
    s = s.masked_fill(torch.ones(9, 9).triu(1).bool(), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=TOL32,
                               atol=TOL32)


# ---- the autograd.Functions ---------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL32),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("via", ["module", "ops"])
def test_rmsnorm_function_matches_autograd_of_plain(shape, dtype, tol, via):
    x, w, dy = (torch.tensor(a, dtype=torch.float32).to(dtype)
                for a in _rms_inputs(shape, 1))
    fn = rms.rmsnorm if via == "module" else ops.rmsnorm
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = fn(xa, wa)
    assert type(y.grad_fn).__name__ == "_RMSNormFnBackward"
    got = torch.autograd.grad(y, (xa, wa), dy)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    yb = ref.rmsnorm(xb, wb)
    torch.testing.assert_close(y.detach(), yb.detach(), rtol=0, atol=0)
    want = torch.autograd.grad(yb, (xb, wb), dy)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL32),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bh,bkv,s,d,causal", FA_CASES)
@pytest.mark.parametrize("via", ["module", "ops"])
def test_flash_attention_function_matches_autograd_of_plain(
        bh, bkv, s, d, causal, dtype, tol, via):
    q, k, v, do = (torch.tensor(a, dtype=torch.float32).to(dtype)
                   for a in _fa_inputs(bh, bkv, s, d, 2))
    fn = fa.flash_attention if via == "module" else ops.flash_attention
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fn(*ins, causal=causal)
    assert type(o.grad_fn).__name__ == "_FlashAttentionFnBackward"
    got = torch.autograd.grad(o, ins, do)
    ins_b = [t.clone().requires_grad_() for t in (q, k, v)]
    ob = ref.flash_attention(*ins_b, causal=causal)
    want = torch.autograd.grad(ob, ins_b, do)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


def test_only_what_needs_a_gradient_goes_through_the_functions():
    """Grad mode off, or no input that requires a gradient: the forward
    alone, no Function (the serving path and CUDA graph captures); a
    gradient of only some inputs computes only those."""
    x = torch.randn(4, 16)
    w = torch.ones(16, requires_grad=True)
    with torch.no_grad():
        assert rms.rmsnorm(x, w).grad_fn is None
    with torch.inference_mode():
        assert fa.flash_attention(*(torch.randn(2, 5, 8, requires_grad=True)
                                    for _ in range(3))).grad_fn is None
    assert rms.rmsnorm(x, w.detach()).grad_fn is None
    y = rms.rmsnorm(x, w)
    (dw,) = torch.autograd.grad(y.sum(), (w,))
    assert dw.shape == (16,)
    ops.reset_launch_counts()
    q = torch.randn(2, 5, 8, requires_grad=True)
    fa.flash_attention(q, torch.randn(1, 5, 8), torch.randn(1, 5, 8)
                       ).sum().backward()
    assert q.grad.shape == q.shape
    assert set(ops.launch_counts().values()) == {0}     # the CPU: no kernel


def test_flash_attention_gradient_needs_q_offset_0():
    q = torch.randn(2, 3, 8, requires_grad=True)
    kv = torch.randn(2, 9, 8)
    with pytest.raises(ValueError, match="q_offset 0"):
        fa.flash_attention(q, kv, kv, q_offset=6)
    with torch.no_grad():
        fa.flash_attention(q, kv, kv, q_offset=6)        # inference: fine


def test_backward_kernels_raise_off_the_card():
    """The launch wrappers take CUDA tensors only (a CPU tensor takes the
    plain version before reaching them)."""
    x = torch.randn(4, 8)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        rms._launch_bwd(x, torch.ones(8), x, 1e-6)
    q = torch.randn(2, 4, 16)
    lse = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        fa._launch_bwd(q, q, q, q, lse, q, causal=True, scale=None)
