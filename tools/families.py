#!/usr/bin/env python3
"""The transformer families alone on the card: chip_smoke.py's phase 18.

    python3 tools/families.py

Builds K1 and K3 (``csrc/rmsnorm.cu``, ``csrc/flash_attention.cu``), then
runs ``chip_smoke.phase_families``: (a) dbrx-132b at full width cut to 4
layers, bf16, on phase 4b's traffic through the static and continuous
engines, and 2 layers in fp32 against the CPU; (b) musicgen-large whole
(4 codebooks, K3 at head dim 64); (c) stablelm-1.6b, qwen1.5-32b,
chameleon-34b and grok-1-314b, one prefill and decode each; (k) K1 and K3
at the new shapes; (d) expert parallelism on two gloo ranks sharing the
card against the one-process step.  The log goes to standard output; the
launches of each part, as one JSON line, last.

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
        print("tools/families.py: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.kernels import _build
    smi = C.phase_card()
    _build.build(["rmsnorm", "flash_attention"])
    k1 = C.k1_ptxas(_build.target("rmsnorm").with_suffix(".log").read_text())
    _, launches = C.phase_families(smi, k1)
    print(json.dumps(launches), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
