"""Data Parallel Idealised Algol (DPIA) in the PyTorch port.

The port's copy of ``repro.core.dpia``: the framework-neutral modules
(types, phrases, pretty, check, stage1, stage2, hoist, strategies) near
verbatim, the reference semantics in torch (``interp``), and two Stage III
targets:

  stage3_torch — imperative DPIA -> torch tensor code (the reference order;
                 backend ``"torch"``, alias ``"dpia-torch"``)
  stage3_cuda  — grid-level imperative DPIA -> generated CUDA C++ kernels,
                 one CUDA grid per grid-level ``parfor`` (backend
                 ``"cuda"``, alias ``"dpia-cuda"``)
  stage3_shardmap — mesh-level terms -> one shard a rank of a
                 ``torch.distributed`` ``DeviceMesh`` axis, each shard's
                 body through ``cuda`` or ``torch``, a mesh reduce as one
                 ``all_reduce`` (backend ``"shardmap"``, alias
                 ``"dpia-shardmap"``; requires ``mesh=``)

Drive the pipeline through ``repro_torch.compiler.Program(expr, args)
.check().lower().compile(backend)``.  Importing this package imports no
CUDA toolkit, starts no process group and builds nothing.
"""
from . import (check, hoist, interp, phrases, pretty, stage1, stage2,
               stage3_cuda, stage3_shardmap, stage3_torch, strategies,
               types)  # noqa: F401
from .phrases import (  # noqa: F401
    GRID, HBM, LANES, MESH, PAR, REG, SEQ, VMEM, Par,
    add, div, fmax, lit, map_grid, map_lanes, map_mesh, map_par, map_seq, mul,
    reduce_seq, sub, to_hbm, to_reg, to_vmem, var_acc, var_exp,
)
from .types import Arr, Idx, Num, Pair, Vec, arr  # noqa: F401
