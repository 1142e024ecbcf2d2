#!/usr/bin/env python3
"""The recurrent families alone on the card: chip_smoke.py's phase 19.

    python3 tools/recurrent.py

Builds K1 and K3 (``csrc/rmsnorm.cu``, ``csrc/flash_attention.cu``), then
runs ``chip_smoke.phase_recurrent``: (k) K3 at head dim 80 in all four
variants; (a) rwkv6-1.6b and (b) zamba2-2.7b at full width and depth
through the static and continuous engines (dense and paged, the decode
chunk a CUDA graph and eagerly), and a cut of each in fp32 against the
CPU; (c) a full-width train step of each and a cut's fp32 step against
the CPU's; (d) FSDP on two gloo ranks sharing the card.  The log goes to
standard output; the launches of each part, as one JSON line, last.

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
        print("tools/recurrent.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.kernels import _build
    smi = C.phase_card()
    _build.build(["rmsnorm", "flash_attention"])
    _, launches = C.phase_recurrent(smi)
    print(json.dumps(launches), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
