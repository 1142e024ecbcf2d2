"""The port's serving path (repro_torch.serve, repro_torch.launch) on the
CPU: greedy tokens identical to the reference's JAX engine, the samplers'
semantics, per-request determinism, the no-fallback device rule, and the
port's independence from JAX."""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compiler
from repro.configs import smoke_config as jax_smoke_config
from repro.models.transformer import Model as JaxModel
from repro.serve.engine import BatchedEngine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import (BatchedEngine, Request, sample,
                                      sample_tokens)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    """Smoke qwen3-4b, float32, use_flash: the JAX model + params and the
    port's model with the same params."""
    jcfg = dataclasses.replace(jax_smoke_config("qwen3_4b"), use_flash=True)
    jmodel = JaxModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    cfg = smoke_config("qwen3_4b", use_flash=True)
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jmodel, jparams, Model(cfg), params


def _prompts(n_list, seed=3):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, size=n) for n in n_list]


# ---------------------------------------------------------------------------
# greedy identity with the reference engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths,max_new", [((7, 3, 12, 5), 9),
                                             ((16, 1, 9), 6)])
@pytest.mark.parametrize("chunk", [3, 8])
def test_greedy_tokens_identical_to_jax_engine(models, lengths, max_new,
                                               chunk):
    jmodel, jparams, model, params = models
    prompts = _prompts(lengths)
    jengine = JaxEngine(jmodel, jparams, max_seq=48, chunk=chunk)
    with compiler.options(backend="pallas"):
        want = jengine.run([JaxRequest(prompt=jnp.asarray(p),
                                       max_new_tokens=max_new)
                            for p in prompts])
    engine = BatchedEngine(model, params, max_seq=48, chunk=chunk)
    got = engine.run([Request(prompt=p.tolist(), max_new_tokens=max_new)
                      for p in prompts])
    assert got == want
    assert all(len(o) == max_new for o in got)


def test_engine_counts_work_and_host_syncs(models):
    _, _, model, params = models
    engine = BatchedEngine(model, params, max_seq=48, chunk=4)
    engine.run([Request(prompt=[1, 2, 3], max_new_tokens=10),
                Request(prompt=[4], max_new_tokens=2)])
    # first token from the prefill, 9 more in ceil(9 / 4) = 3 chunks
    assert engine.stats() == {"prefills": 1, "decode_steps": 12,
                              "chunks": 3}


def test_engine_rejects_request_longer_than_cache(models):
    _, _, model, params = models
    engine = BatchedEngine(model, params, max_seq=16)
    with pytest.raises(ValueError, match="max_seq"):
        engine.run([Request(prompt=list(range(10)), max_new_tokens=7)])


def test_engine_on_cpu_launches_no_kernel(models):
    _, _, model, params = models
    ops.reset_launch_counts()
    BatchedEngine(model, params, max_seq=32).run(
        [Request(prompt=[5, 6, 7], max_new_tokens=3)])
    assert ops.launch_counts() == {"rmsnorm": 0, "matmul": 0,
                                   "flash_attention": 0, "dpia_cuda": 0}


# ---------------------------------------------------------------------------
# sampling semantics
# ---------------------------------------------------------------------------

def test_top_k_one_is_argmax():
    logits = torch.tensor([[0.1, 2.0, -1.0, 0.5]])
    for s in range(3):
        g = torch.Generator().manual_seed(s)
        assert int(sample(logits, g, temperature=1.0, top_k=1)[0]) == 1


def test_top_k_keeps_ties_at_cutoff():
    logits = torch.tensor([2.0, 2.0, 2.0, -10.0])
    g = torch.Generator().manual_seed(0)
    seen = {int(sample(logits, g, temperature=1.0, top_k=2))
            for _ in range(60)}
    assert seen == {0, 1, 2}


def test_top_k_zero_and_oversized_are_noops():
    logits = torch.tensor([0.0, 1.0, 2.0, 3.0])
    full = sample(logits, torch.Generator().manual_seed(4), temperature=1.0)
    over = sample(logits, torch.Generator().manual_seed(4), temperature=1.0,
                  top_k=99)
    assert int(full) == int(over)


def test_zero_temperature_is_greedy():
    logits = torch.tensor([[0.1, 5.0, -1.0], [3.0, 0.0, 1.0]])
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    assert sample_tokens(logits, gens, [0.0, 0.0], [0, 5]).tolist() == [1, 0]
    assert int(sample(logits[0], None, temperature=0.0)) == 1


def test_sample_tokens_rows_use_their_own_knobs():
    """Row 0 greedy, row 1 hot with top-1: both equal their argmax; row 2
    hot and unfiltered follows its own generator."""
    logits = torch.tensor([[0.0, 4.0, 1.0], [2.0, 0.0, 1.0],
                           [0.0, 0.0, 0.0]])
    mk = lambda: [torch.Generator().manual_seed(i)  # noqa: E731
                  for i in range(3)]
    a = sample_tokens(logits, mk(), [0.0, 1.0, 5.0], [0, 1, 0])
    b = sample_tokens(logits, mk(), [0.0, 1.0, 5.0], [0, 1, 0])
    assert a.tolist()[:2] == [1, 0]
    assert a.tolist() == b.tolist()
    draws = {int(sample(logits[2], torch.Generator().manual_seed(s),
                        temperature=5.0)) for s in range(40)}
    assert draws == {0, 1, 2}


# ---------------------------------------------------------------------------
# sampled determinism and independence
# ---------------------------------------------------------------------------

def _sampled(engine, temps, seed, lengths=(6, 4, 9)):
    prompts = _prompts(lengths, seed=11)
    return engine.run([Request(prompt=p.tolist(), max_new_tokens=8,
                               temperature=t, top_k=20 if t else 0)
                       for p, t in zip(prompts, temps)], seed=seed)


def test_sampled_runs_are_deterministic(models):
    _, _, model, params = models
    engine = BatchedEngine(model, params, max_seq=48, chunk=3)
    a = _sampled(engine, [0.9, 0.0, 1.3], seed=5)
    b = _sampled(engine, [0.9, 0.0, 1.3], seed=5)
    c = _sampled(engine, [0.9, 0.0, 1.3], seed=6)
    assert a == b
    assert a[0] != c[0] and a[1] == c[1]


def test_request_tokens_independent_of_neighbours(models):
    """Request 0's sampled stream is the same whatever the other requests
    are (their temperatures, lengths) and whatever the chunk size."""
    _, _, model, params = models
    base = _sampled(BatchedEngine(model, params, max_seq=48, chunk=3),
                    [0.9, 0.0, 1.3], seed=5)
    other = _sampled(BatchedEngine(model, params, max_seq=48, chunk=5),
                     [0.9, 2.0, 0.0], seed=5)
    alone = _sampled(BatchedEngine(model, params, max_seq=48, chunk=8),
                     [0.9], seed=5, lengths=(6,))
    assert base[0] == other[0] == alone[0]


# ---------------------------------------------------------------------------
# device rule and independence from JAX
# ---------------------------------------------------------------------------

def test_resolve_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_launcher_needs_cuda_unless_asked_for_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="no CUDA"):
        launch_serve.main(["--arch", "qwen3_4b", "--smoke"])
    outs = launch_serve.main(["--arch", "qwen3_4b", "--smoke", "--device",
                              "cpu", "--batch", "2", "--prompt-len", "5",
                              "--max-new", "4", "--temperature", "0.7"])
    assert [len(o) for o in outs] == [4, 4]
    assert all(0 <= t < 256 for o in outs for t in o)
    assert "device=cpu" in capsys.readouterr().out


def test_launcher_profile_writes_a_trace(tmp_path, capsys):
    trace = tmp_path / "trace.json"
    launch_serve.main(["--arch", "qwen3_4b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--max-new",
                       "3", "--profile", str(trace)])
    out = capsys.readouterr().out
    assert "profile: warm run" in out and "aten::" in out
    assert trace.stat().st_size > 0


def test_port_imports_no_jax_and_nothing_of_repro():
    code = ("import sys\n"
            "import repro_torch.serve.engine, repro_torch.launch.serve\n"
            "import repro_torch.models.convert, chip_smoke\n"
            "import repro_torch.core.dpia, repro_torch.compiler\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.dpia_blas\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=f"{REPO / 'src'}{os.pathsep}{REPO}")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


def test_port_sources_name_no_jax_or_repro_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
