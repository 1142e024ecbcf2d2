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
                                   "flash_attention": 0, "dpia_cuda": 0}


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
    assert _build.sources() == ["flash_attention", "matmul"]
    t = _build.target("flash_attention")
    assert t.parent == _build.BUILD_DIR and t.suffix == ".so"
    assert t == _build.target("flash_attention")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


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
    assert len(ops._compiled) == 3
    fn = ops.compiled("asum", "cuda", n=4096)
    assert fn.plan.grids == [(2,), (1,)]
    assert fn.program.name == ops.program_name("asum", n=4096) == "asum_4096"
