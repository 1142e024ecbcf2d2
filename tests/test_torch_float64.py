"""mamba2's per-head scalars in float64: the one-device zamba2 gradients
of the port against the reference's, held to float64's rounding.

The gradients of mamba2's ``a_log``, ``dt_bias`` and ``d_skip`` sum
10^3-10^4 nearly cancelling terms, so in fp32 the port's lie a few 1e-6 of
the leaf's largest from the reference's (the sums run in other orders),
which the model-axis tests allow for (``tests/test_torch_recurrent_tp.py``
``ROUNDING``).  Both packages compute parts of the model in fp32 whatever
the config's dtype (rope, the selective scan's inputs and state, the
gated norm, the cross entropy; the per-head scalars are fp32 leaves), so
a float64 config alone keeps that distance.  Here every fp32 island runs
in float64 too (in a subprocess: ``jnp.float32`` and ``torch.float32``
stand for float64 there, ``Tensor.float`` for ``double``, the reference
under ``jax_enable_x64`` on the CPU), and the port's gradients of the
zamba2 smoke config at d_model 128 meet the reference's to float64's
rounding: the fp32 distance is rounding, not a fault.

Run by hand, ``python -c "$(python -c 'import test_torch_float64 as t;
print(t.SCRIPT)')" <mode>`` (from ``tests/``, ``PYTHONPATH=../src``)
prints each leaf's distance; ``fp32`` is the config as it is.
"""
import json
import os
import subprocess
import sys

SCRIPT = r"""
import json, sys, dataclasses
import numpy as np
import jax
import jax.numpy as jnp
import torch
mode = sys.argv[1]
if mode == "float64":
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.float32 = torch.float64
    torch.Tensor.float = lambda self: self.double()
from repro.configs import smoke_config as jsmoke
from repro.models.common import ModelConfig as JModelConfig
from repro.models.transformer import Model as JModel
from repro_torch.models.common import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
dt = "float64" if mode == "float64" else "float32"
kw = {**dataclasses.asdict(jsmoke("zamba2_2_7b")), "d_model": 128,
      "dtype": dt}
jm = JModel(JModelConfig(**kw))
params = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jax.random.PRNGKey(3)))
if mode == "float64":
    params = jax.tree_util.tree_map(
        lambda a: a.astype(np.float64) if a.dtype.kind == "f" else a, params)
rng = np.random.RandomState(0)
tokens = rng.randint(0, kw["vocab"], (8, 16))
labels = np.roll(tokens, -1, 1)
labels[:, -1] = -100
g = jax.grad(lambda p: jm.loss(p, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)}))(
    jax.tree_util.tree_map(jnp.asarray, params))
cfg = ModelConfig(**kw)
mine = params_from_numpy(cfg, params, device="cpu")
leaves = adamw.leaves(mine)
for _, t in leaves:
    t.requires_grad_(True)
loss = Model(cfg).loss(mine, {"tokens": torch.as_tensor(tokens),
                              "labels": torch.as_tensor(labels)})
got = torch.autograd.grad(loss, [t for _, t in leaves])
want = dict((tuple(p), t) for p, t in adamw.leaves(params_from_numpy(
    cfg, jax.tree_util.tree_map(np.asarray, g), device="cpu")))
worst = {}
for (path, _), a in zip(leaves, got):
    b = want[tuple(path)].double()
    name = "/".join(str(k) for k in path if not isinstance(k, int))
    d = float((a.double() - b).abs().max() / b.abs().max().clamp_min(1e-300))
    worst[name] = max(worst.get(name, 0.0), d)
print("WORST", json.dumps(worst))
"""

# float64's rounding, with room for the sums' 10^4 terms
F64_TOL = 1e-12


def _distances(mode):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", "/usr/bin"),
           "HOME": os.environ.get("HOME", root), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", SCRIPT, mode], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("WORST ")]
    assert line, r.stdout + r.stderr
    return json.loads(line[0][6:])


def test_mamba2_gradients_meet_the_reference_in_float64():
    """Every leaf's gradient, the per-head scalars included, within
    ``F64_TOL`` of the leaf's largest."""
    worst = _distances("float64")
    for leaf in ("blocks/mamba/a_log", "blocks/mamba/dt_bias",
                 "blocks/mamba/d_skip"):
        assert leaf in worst
    assert max(worst.values()) < F64_TOL, worst
