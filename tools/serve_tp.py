#!/usr/bin/env python3
"""Serving with the params split over ``model`` alone on the card:
chip_smoke.py's phase 21, or with ``--phase 22`` its phase 22.

    python3 tools/serve_tp.py [--phase 21|22]

Builds K1 and K3 (``csrc/rmsnorm.cu``, ``csrc/flash_attention.cu``), then
runs ``chip_smoke.phase_serve_tp``: (k) K1 / K3 at a serving rank's
shapes; (a) qwen3-4b and (b) dbrx-132b at full width on ``model=2`` (two
gloo ranks sharing the card) against the one-device port; (c) 21a's
decode step counted on the card against the meta device.  Phase 22
(``chip_smoke.phase_serve_tp_recurrent``) is the same for rwkv6-1.6b and
zamba2-2.7b, each rank's cache after the prefill held to the one-device
cache's piece too.  The log goes to standard output; the launches of each
cell, as one JSON line, last.

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
        print("tools/serve_tp.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.kernels import _build
    smi = C.phase_card()
    _build.build(["rmsnorm", "flash_attention"])
    k1 = C.k1_ptxas(_build.target("rmsnorm").with_suffix(".log").read_text())
    phase = sys.argv[sys.argv.index("--phase") + 1] \
        if "--phase" in sys.argv else "21"
    run = {"21": C.phase_serve_tp, "22": C.phase_serve_tp_recurrent}[phase]
    _, launches = run(smi, k1)
    print(json.dumps(launches), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
