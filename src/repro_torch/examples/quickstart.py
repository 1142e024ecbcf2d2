"""Quickstart: the paper's pipeline end to end on dot product, in the port.

The port's copy of ``examples/quickstart.py``:

1. Write the functional spec (paper eq. (1)).
2. Derive a strategy by semantics-preserving rewrites (paper eq. (2)).
3. Stage the pipeline explicitly with ``repro_torch.compiler.Program``:
   ``check()`` (SCIR race-freedom) -> ``lower()`` (Stage I -> II) ->
   ``compile(backend)`` (Stage III via the backend registry).
4. Run every registered backend against the mathematical reading: on the
   card ``cuda`` launches the generated kernels (K4), ``torch`` is the
   plain version.
6. Scope kernel dispatch with ``compiler.options`` (thread-local).

Step 5 of the reference (``autotune.tune``: let the autotuner pick the
strategy) waits for the port's autotuner (ROADMAP.md queue 1 item 3).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu]     (the card by default)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import compiler, resolve_device
from repro_torch.core.dpia import interp, phrases as P, strategies
from repro_torch.core.dpia.pretty import show
from repro_torch.core.dpia.types import Arr, Num
from repro_torch.kernels import ops

N = 8192
RTOL = 1e-4      # blocked fp32 sums against the sequential oracle


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                     "quickstart")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    device = resolve_device(p.parse_args(argv).device)

    # -- 1. functional specification (the mathematical reading) --------------
    xs = P.var_exp("xs", Arr(N, Num()))
    ys = P.var_exp("ys", Arr(N, Num()))
    dot_spec = P.Reduce(
        lambda x, a: P.add(a, x), P.lit(0.0),
        P.Map(lambda z: P.mul(P.Fst(z), P.Snd(z)), P.Zip(xs, ys)))
    print("== functional spec ==")
    print(show(dot_spec), "\n")

    # -- 2. a strategy: fuse, block for the grid, reduce each block ----------
    # Strategies are rewrites (expr -> expr); Program.lower applies them
    # and translates the result to imperative DPIA (Stage I -> II).
    def grid_strategy(e):
        fused = strategies.fuse_map_into_reduce(e)
        return strategies.blocked_reduce(fused, 2048,
                                         partial_level=P.GRID(0),
                                         combine=lambda x, a: P.add(a, x))

    prog = compiler.Program(dot_spec, [xs, ys], name="dot").lower(
        grid_strategy)
    print("== strategy (after rewrites) ==")
    print(show(prog.expr), "\n")

    # -- 3. the staged pipeline: SCIR check, then the imperative form --------
    prog.check()                 # well-typed + data-race free, or it raises
    print("== imperative DPIA (stage II) ==")
    print(prog.show()[:800], "...\n")

    # -- 4. every registered backend against the oracle ----------------------
    rng = np.random.RandomState(0)
    hx = torch.from_numpy(rng.randn(N).astype(np.float32))
    hy = torch.from_numpy(rng.randn(N).astype(np.float32))
    oracle = float(interp.interp(dot_spec, {"xs": hx, "ys": hy}))
    ax, ay = hx.to(device), hy.to(device)
    got = {}
    for backend in compiler.backend_names():
        fn = prog.check().lower().compile(backend)
        got[backend] = float(fn(ax, ay))
        np.testing.assert_allclose(got[backend], oracle, rtol=RTOL)
        print(f"backend {backend:8s} on {device.type}: "
              f"{got[backend]:+.6f}  == oracle OK")
    print(f"oracle (sequential reading): {oracle:+.6f}")

    # -- 6. scoped kernel dispatch (no process globals) ----------------------
    with compiler.options(backend="dpia-cuda"):
        scoped = float(ops.dot(ax, ay))  # the op layer dispatches like this
    np.testing.assert_allclose(scoped, oracle, rtol=RTOL)
    print(f"\nops.dot under options(backend='dpia-cuda') on {device.type}: "
          f"{scoped:+.6f} OK")
    return {"oracle": oracle, "backends": got, "scoped": scoped}


if __name__ == "__main__":
    main()
