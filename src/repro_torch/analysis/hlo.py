"""Roofline terms from a call's counted op stream: the port of
``repro.analysis.hlo``.

The reference reads a compiled XLA executable: its scan-aware HLO counter
(FLOPs, bytes, collective bytes, all per partition) and XLA's own
``cost_analysis`` FLOPs.  The port counts the op stream of one eager call
(``analysis.hlo_counter``: the ATen ops it dispatches, the work the
hand-written kernels declare, the collectives of the port's groups) and
combines it into the same three-term model:

    compute    = FLOPs / (chips * peak_flops)
    memory     = bytes / (chips * hbm_bw)
    collective = coll_bytes / (chips * link_bw)

with one rank's counts multiplied by ``chips`` (the reference's
per-partition x chips convention).  ``xla_raw_flops`` (XLA's scan-unaware
count) has no counterpart: the key stays, None.

Constants: an NVIDIA H100 SXM's, from NVIDIA's H100 Tensor Core GPU
datasheet (the card these numbers are for: NVIDIA H100 80GB HBM3, power
limit 700.00 W), never the reference's TPU v5e's:

  * ``PEAK_FLOPS``: 989.4 TFLOP/s, dense bf16 on the tensor cores;
  * ``HBM_BW``: 3.35 TB/s, HBM3;
  * ``ICI_BW``: the link a collective crosses, per card and direction:
    NVLink 4 within a node of 8 cards (``NVLINK_BW``: 450 GB/s, half the
    datasheet's 900 GB/s, which counts both directions), or, for an axis
    wider than a node (the production meshes' 16), the inter-node fabric
    (``FABRIC_BW``: 50 GB/s, one 400 Gb/s InfiniBand NDR port a card, as
    the datasheet's HGX H100 pairs them; the same number as the v5e ICI
    link the reference assumes, by coincidence).  :func:`link_bw` picks by the
    widest axis a step's collectives run on.

``coll_count`` is the count of collective calls (the reference writes one
a kind).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

from . import hlo_counter

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
PEAK_FLOPS = 989.4e12      # bf16 dense, tensor cores
HBM_BW = 3.35e12           # bytes/s, HBM3
NVLINK_BW = 450e9          # bytes/s per card and direction, NVLink 4
FABRIC_BW = 400e9 / 8      # bytes/s per card and direction, 400 Gb/s NDR
NODE_CARDS = 8             # cards a node joins by NVLink
ICI_BW = NVLINK_BW         # a collective within one node


def link_bw(widest_axis: int) -> float:
    """The per-card link rate of collectives over an axis of
    ``widest_axis`` cards: NVLink within a node, the fabric beyond it."""
    return NVLINK_BW if widest_axis <= NODE_CARDS else FABRIC_BW


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def collective_bytes(fn: Callable, *args, **kwargs) -> CollectiveStats:
    """The collectives one call ``fn(*args, **kwargs)`` issues through the
    port's groups, bytes (of each result) and calls by kind (the
    reference parses them out of HLO text)."""
    counter = hlo_counter.count(fn, *args, **kwargs)[1]
    t = counter.totals
    return CollectiveStats(dict(t.coll_by_kind), dict(counter.coll_calls))


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll: CollectiveStats
    chips: int
    bytes_min: float = 0.0
    compute_s: float = 0.0
    memory_s: float = 0.0           # write-once ceiling
    memory_floor_s: float = 0.0     # perfectly-fused floor
    collective_s: float = 0.0
    bottleneck: str = ""
    model_flops: Optional[float] = None
    xla_flops_raw: Optional[float] = None
    link_bw: float = ICI_BW

    def finalize(self) -> "Roofline":
        self.compute_s = self.flops / (self.chips * PEAK_FLOPS)
        self.memory_s = self.bytes_accessed / (self.chips * HBM_BW)
        self.memory_floor_s = self.bytes_min / (self.chips * HBM_BW)
        self.collective_s = self.coll.total_bytes / (self.chips
                                                     * self.link_bw)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        return self

    @property
    def useful_flops_frac(self) -> Optional[float]:
        if self.model_flops and self.flops:
            return self.model_flops / self.flops
        return None

    @property
    def step_time_s(self) -> float:
        """Optimistic (max of terms) step-time estimate."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes_accessed,
            "bytes_min": self.bytes_min,
            "coll_bytes": self.coll.total_bytes,
            "coll_count": self.coll.total_count,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_floor_s": self.memory_floor_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_frac": self.useful_flops_frac,
            "xla_flops_raw": self.xla_flops_raw,
        }


def from_totals(tot: "hlo_counter.Totals", coll_calls: Dict[str, float], *,
                chips: int, model_flops: Optional[float] = None,
                widest_axis: int = 1) -> Roofline:
    """The roofline of one rank's counted call (its ``Totals`` and its
    collective calls by kind), on ``chips`` cards whose collectives run
    over an axis of ``widest_axis`` cards."""
    coll = CollectiveStats(
        bytes_by_kind={k: v * chips for k, v in tot.coll_by_kind.items()},
        count_by_kind=dict(coll_calls))
    return Roofline(flops=tot.flops * chips,
                    bytes_accessed=tot.bytes * chips, coll=coll,
                    chips=chips, bytes_min=tot.bytes_min * chips,
                    model_flops=model_flops,
                    link_bw=link_bw(widest_axis)).finalize()


def from_counter(counter: "hlo_counter.Counter", **kw) -> Roofline:
    """:func:`from_totals` of a :class:`hlo_counter.Counter`."""
    return from_totals(counter.totals, counter.coll_calls, **kw)


def analyze(fn: Callable, args=(), *, chips: int,
            model_flops: Optional[float] = None, widest_axis: int = 1,
            scale: bool = True, kwargs=None) -> Roofline:
    """Roofline terms of one rank's call ``fn(*args)`` (the reference's
    ``analyze`` of a compiled executable): the op stream counted by
    ``hlo_counter`` (regions scaled by their trip counts unless
    ``scale`` is false), one rank's counts times ``chips``."""
    counter = hlo_counter.count(fn, *args, scale=scale,
                                **(kwargs or {}))[1]
    return from_counter(counter, chips=chips, model_flops=model_flops,
                        widest_axis=widest_axis)
