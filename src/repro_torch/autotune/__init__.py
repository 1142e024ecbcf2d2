"""repro_torch.autotune: the cost-model-guided strategy autotuner.

The paper's thesis is that parallelisation strategies are chosen at the
functional level and compiled strategy-preservingly; this package chooses
them automatically.  The port's copy of ``repro.autotune``:

  space    strategy-space enumeration over the DPIA rewrites
           (split_join / blocked_reduce / fuse_map_into_reduce /
           vectorize / level assignment) for dot/reduce, map, matmul,
           rmsnorm and softmax-like kernels, every candidate derived by a
           ``repro_torch.strategy`` program
  cost     analytical roofline cost model (FLOPs, bytes, grid/loop
           overhead) ranking candidates without executing them; the
           reference's per-platform presets, word for word
  measure  compile-and-time refinement of the analytic top-k through the
           staged pipeline: ``torch`` on the CPU, ``cuda`` (K4, generated
           CUDA timed by CUDA events around graph replays) on the card
  cache    persistent on-disk JSON tuning cache keyed by
           (kernel, shape, dtype, backend, mesh), with in-process memo
           (default ``~/.cache/repro_torch/autotune.json``,
           ``REPRO_AUTOTUNE_CACHE`` overrides it)
  api      ``tune(...)`` / ``get_tuned(...)`` / ``get_measured(...)`` /
           ``@autotuned`` / ``pick_kv_layout`` / warm-up entry points

With ``backend="shardmap"`` the space is the mesh-placement space of
``repro_torch.mesh.space``, keyed by the mesh descriptor.  ``xla_cost``,
the reference's HLO refinement, is the roofline of the call's counted op
stream (``repro_torch.analysis.hlo_counter``).
"""
from . import api, cache, cost, measure, space  # noqa: F401
from .api import (  # noqa: F401
    TuneResult, autotuned, get_measured, get_tuned, model_kernel_shapes,
    pick_kv_layout, tune, warm_for_model,
)
from .cache import TuningCache, default_cache  # noqa: F401
from .cost import (  # noqa: F401
    HW_PRESETS, CostEstimate, HwModel, KvLayoutCost, estimate, hw_model,
    kv_layout_cost, xla_cost,
)
from .space import (  # noqa: F401
    Candidate, candidate_from_params, default_params, enumerate_space,
)
