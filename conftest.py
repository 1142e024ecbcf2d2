"""Repo-root pytest hooks.

jax 0.9 deprecates ``jax.experimental.shard_map``, which
``repro.core.dpia.stage3_shardmap`` imports; ``pytest.ini`` turns a
``DeprecationWarning`` raised from a ``repro.*`` module into an error, so
every test module that reaches that import failed to collect.  jax caches
the deprecated attribute after its first access, so importing it once
here, with the warning silenced, lets the reference package import
unchanged.  (A machine without JAX, such as the GPU machine that runs
``tests/test_torch_cuda.py``, skips this.)

The ``cuda`` marker tags tests that need an NVIDIA card; they decide inside
a fixture whether there is one and skip without it.
"""
import importlib.util
import warnings

if importlib.util.find_spec("jax") is not None:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from jax.experimental.shard_map import shard_map  # noqa: F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (skips without one)")
