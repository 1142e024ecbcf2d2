#!/usr/bin/env python3
"""Training on a mesh alone on the card: chip_smoke.py's phases 16 and 17.

    python3 tools/sharded_train.py [--with-13b] [--phase 16|17|all]

Builds K1 and K3 (``csrc/rmsnorm.cu``, ``csrc/flash_attention.cu``), then
runs ``chip_smoke.phase_sharded_train``: (a) one NCCL rank, 3 one-device
steps and 3 mesh steps of qwen3-4b at full width, bitwise; (b) DP of
qwen3-4b and (c) FSDP of yi-9b, both cut to 2 layers in fp32, on two gloo
ranks sharing the card, each held to the one-device step.  ``--with-13b``
runs phase 13b-d first, so 16a prints 13b's step time, peak memory and
launches beside its own.  ``--phase 17`` runs
``chip_smoke.phase_tp_train`` in place of phase 16 (the model axis: (a)
TP + SP of qwen3-4b on ``model=2``, (b) FSDP + TP of yi-9b on ``data=2,
model=2``, each cut to 4 layers in fp32, gloo ranks sharing the card),
``--phase all`` both; phase 17 starts with 17k, its kernels at a
tensor-parallel rank's shapes.  The log goes to standard error; each phase's
launches a step, as one JSON line, to standard output.

Needs the card; exits 2 without one.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("tools/sharded_train.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.kernels import _build
    smi = C.phase_card()
    _build.build(["rmsnorm", "flash_attention"])
    phase = sys.argv[sys.argv.index("--phase") + 1] \
        if "--phase" in sys.argv else "16"
    if phase in ("16", "all"):
        train13 = C.phase_train(smi)[0] if "--with-13b" in sys.argv \
            else None
        print(json.dumps(C.phase_sharded_train(smi, train13)), flush=True)
    if phase in ("17", "all"):
        C.phase_tp_kernels(C.k1_ptxas(_build.target("rmsnorm").with_suffix(
            ".log").read_text()))
        print(json.dumps(C.phase_tp_train(smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
