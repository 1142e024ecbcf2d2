#!/usr/bin/env python3
"""The model axis for the recurrent families and the op counter alone on
the card: chip_smoke.py's phase 20.

    python3 tools/recurrent_tp.py

Builds K1 and K3 (``csrc/rmsnorm.cu``, ``csrc/flash_attention.cu``), then
runs ``chip_smoke.phase_recurrent_tp``: (k) K1 / K3 at the tensor-parallel
ranks' shapes; (a) rwkv6-1.6b and (b) zamba2-2.7b, TP + SP on
``model=2`` (two gloo ranks sharing the card) against the one-device
step; (c) the op counter on the card against the meta device, with the
roofline beside the measured step.  The log goes to standard output; the
launches of each cell, as one JSON line, last.

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
        print("tools/recurrent_tp.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.kernels import _build
    smi = C.phase_card()
    _build.build(["rmsnorm", "flash_attention"])
    k1 = C.k1_ptxas(_build.target("rmsnorm").with_suffix(".log").read_text())
    _, launches = C.phase_recurrent_tp(smi, k1)
    print(json.dumps(launches), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
