"""Analytical cost model for DPIA strategy candidates.

Ranks candidates WITHOUT executing them: a structural walk over the
functional expression collects FLOPs, HBM traffic (write-once model, the
same discipline as the reference's ``repro.analysis.hlo_counter``), the
per-grid-step VMEM working set, and the loop structure (grid launches vs
sequential trip counts).  A roofline combine (cf. the reference's
``benchmarks/roofline.py``) turns the counts into predicted seconds:

    t = max(flops / peak, hbm_bytes / bw)
        + grid_steps * grid_overhead + loop_iters * loop_overhead
        + ici_bytes / ici_bw + collective_steps * collective_launch
        + vmem-overflow penalty

Mesh-level strategies are costed per *device*: a ``map[mesh(ax)]`` charges
one shard's body (wall clock, not the sum over shards) and a
``reduce[mesh(ax)]`` charges one ring all-reduce (2(n-1) hops x result
bytes over the interconnect) — so the ranking trades compute-per-device
against collective latency and refuses to shard problems too small to
amortise the all-reduce.

Absolute numbers are not the point — *order* is.  The model needs exactly
the properties the search relies on: monotone in problem size, punishes
fully-sequential strategies (huge trip counts), punishes over-fine blocking
(launch overhead), and rejects blocks whose working set overflows VMEM.

``xla_cost`` is the reference's optional refinement (lower a compiled
candidate through XLA and count its HLO); the port has no XLA, and it
counts the call's op stream instead (``analysis/hlo_counter.py``): the
roofline seconds of the ATen ops it dispatches and of the work its
hand-written kernels declare.

The port's copy of ``repro.autotune.cost``: the presets are the
reference's, word for word, and ``hw_model(None)`` asks the port's device
(``"gpu"`` when CUDA is available, else ``"cpu"``).  The ``gpu`` preset
holds the reference's placeholder numbers, not measured ones.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

from repro_torch.core.dpia import phrases as P
from repro_torch.core.dpia.types import (Arr, Pair, Vec, dtype_of, is_numeric,
                                        shape_of)

_DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "int32": 4, "int64": 8, "int16": 2, "int8": 1, "bool": 1}


@dataclass(frozen=True)
class HwModel:
    """Roofline parameters.  Defaults approximate one TPU core; only the
    *relative* magnitudes matter for ranking."""
    peak_flops: float = 1.0e12       # FLOP/s
    hbm_bw: float = 1.0e11           # bytes/s
    vmem_bytes: float = 16 * 2 ** 20  # per-step working-set budget
    grid_overhead_s: float = 2.0e-6  # per grid step (kernel launch / dispatch)
    loop_overhead_s: float = 5.0e-8  # per sequential loop iteration
    vmem_penalty_s: float = 1.0e-3   # added per x of working-set overflow
    ici_bw: float = 5.0e10           # inter-chip bytes/s (collective traffic)
    collective_launch_s: float = 5.0e-6  # per collective step (ring hop)
    hbm_capacity: float = 16e9       # resident-bytes budget (KV planning)


DEFAULT_HW = HwModel()

# Per-platform presets (per-backend HW models).
# The cpu preset is the tpu model uniformly slowed 5x — identical *ratios*,
# so single-device strategy rankings are platform-stable — but with a host
# RAM capacity; the gpu preset has genuinely different balance (higher
# flops-per-byte) and an 80 GB HBM budget.  The capacity term is what the
# KV-layout planner (:func:`pick_kv_layout`) ranks against.
HW_PRESETS = {
    "tpu": DEFAULT_HW,
    "cpu": HwModel(peak_flops=2.0e11, hbm_bw=2.0e10,
                   grid_overhead_s=1.0e-5, loop_overhead_s=2.5e-7,
                   ici_bw=1.0e10, collective_launch_s=2.5e-5,
                   hbm_capacity=64e9),
    "gpu": HwModel(peak_flops=1.0e13, hbm_bw=2.0e12,
                   grid_overhead_s=3.0e-6, loop_overhead_s=1.0e-7,
                   ici_bw=2.0e11, collective_launch_s=3.0e-6,
                   hbm_capacity=80e9),
}


def default_platform() -> str:
    """The platform the port runs on: ``"gpu"`` when CUDA is available
    (entry points default to the card), else ``"cpu"``."""
    import torch
    return "gpu" if torch.cuda.is_available() else "cpu"


def hw_model(platform: Optional[str] = None) -> HwModel:
    """The HwModel preset for ``platform`` (:func:`default_platform` when
    None); unknown platforms get the TPU-shaped default."""
    if platform is None:
        platform = default_platform()
    return HW_PRESETS.get(platform, DEFAULT_HW)


@dataclass
class CostEstimate:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    vmem_peak: float = 0.0     # largest per-grid-step working set
    grid_steps: float = 0.0
    loop_iters: float = 0.0
    ici_bytes: float = 0.0     # bytes crossing the mesh interconnect
    collective_steps: float = 0.0  # latency-bound collective hops

    def __add__(self, o: "CostEstimate") -> "CostEstimate":
        return CostEstimate(self.flops + o.flops,
                            self.hbm_bytes + o.hbm_bytes,
                            max(self.vmem_peak, o.vmem_peak),
                            self.grid_steps + o.grid_steps,
                            self.loop_iters + o.loop_iters,
                            self.ici_bytes + o.ici_bytes,
                            self.collective_steps + o.collective_steps)

    def scaled(self, s: float) -> "CostEstimate":
        return CostEstimate(self.flops * s, self.hbm_bytes * s,
                            self.vmem_peak, self.grid_steps * s,
                            self.loop_iters * s, self.ici_bytes * s,
                            self.collective_steps * s)

    def seconds(self, hw: HwModel = DEFAULT_HW) -> float:
        t = max(self.flops / hw.peak_flops, self.hbm_bytes / hw.hbm_bw)
        t += self.grid_steps * hw.grid_overhead_s
        t += self.loop_iters * hw.loop_overhead_s
        t += self.ici_bytes / hw.ici_bw
        t += self.collective_steps * hw.collective_launch_s
        if self.vmem_peak > hw.vmem_bytes:
            t += hw.vmem_penalty_s * (self.vmem_peak / hw.vmem_bytes)
        return t


def _bytes_of(d) -> float:
    shp = shape_of(d)
    n = 1.0
    for s in shp:
        n *= s
    if isinstance(d, Pair):
        return _bytes_of(d.fst) + _bytes_of(d.snd)
    if isinstance(d, Arr):
        return d.n * _bytes_of(d.elem)
    return n * _DTYPE_BYTES.get(dtype_of(d) if is_numeric(d) else "float32", 4)


def _elems_of(d) -> float:
    if isinstance(d, Pair):
        return _elems_of(d.fst) + _elems_of(d.snd)
    if isinstance(d, Arr):
        return d.n * _elems_of(d.elem)
    if isinstance(d, Vec):
        return float(d.n)
    return 1.0


def estimate(expr: P.Phrase) -> CostEstimate:  # noqa: C901
    """Cost of evaluating ``expr`` once (structural, no execution)."""
    if isinstance(expr, (P.Var,)):
        # reading an argument / bound block: charge its HBM bytes once here
        d = P.exp_data(expr)
        return CostEstimate(hbm_bytes=_bytes_of(d))
    if isinstance(expr, P.Lit):
        return CostEstimate(hbm_bytes=_bytes_of(expr.d))
    if isinstance(expr, P.UnOp):
        d = P.exp_data(expr)
        return estimate(expr.e) + CostEstimate(
            flops=_elems_of(d), hbm_bytes=_bytes_of(d))
    if isinstance(expr, P.BinOp):
        d = P.exp_data(expr)
        return (estimate(expr.a) + estimate(expr.b)
                + CostEstimate(flops=_elems_of(d), hbm_bytes=_bytes_of(d)))
    if isinstance(expr, P.Map):
        d = P.exp_data(expr.e)
        assert isinstance(d, Arr)
        x = P.Var(P.fresh("c"), P.ExpT(d.elem))
        body = estimate(expr.f(x))
        feed = estimate(expr.e)
        if expr.level.kind == "mesh":
            # SPMD over d.n shards: every device reads 1/n of the feed and
            # runs the per-shard body ONCE — wall clock is the per-device
            # cost, not the sum over shards (that is the whole point of the
            # mesh placement; the collective price lands on the mesh Reduce)
            return feed.scaled(1.0 / d.n) + body
        total = feed + body.scaled(d.n)
        if expr.level.kind == "grid":
            step_ws = body.hbm_bytes + _bytes_of(d.elem)
            return replace(total,
                           grid_steps=total.grid_steps + d.n,
                           vmem_peak=max(total.vmem_peak, step_ws))
        if expr.level.kind in ("seq", "par"):
            return replace(total, loop_iters=total.loop_iters + d.n)
        # lanes: one vectorised step, no per-elem loop
        return total
    if isinstance(expr, P.Reduce):
        d = P.exp_data(expr.e)
        assert isinstance(d, Arr)
        di = P.exp_data(expr.init)
        x = P.Var(P.fresh("c"), P.ExpT(d.elem))
        a = P.Var(P.fresh("c"), P.ExpT(di))
        body = estimate(expr.f(x, a))
        feed = estimate(expr.e) + estimate(expr.init)
        if expr.level.kind == "mesh":
            # the partials live one-per-shard; combining them is a single
            # ring all-reduce of the result value: 2(n-1) hops, each moving
            # the result bytes over the interconnect (latency-bound for the
            # scalar reductions, bandwidth-bound for block results)
            hops = 2.0 * max(d.n - 1, 1)
            return feed + CostEstimate(ici_bytes=hops * _bytes_of(di),
                                       collective_steps=hops)
        total = feed + body.scaled(d.n)
        if expr.level.kind in ("seq", "par"):
            return replace(total, loop_iters=total.loop_iters + d.n)
        return total
    if isinstance(expr, P.FullReduce):
        d = P.exp_data(expr.e)
        return estimate(expr.e) + CostEstimate(flops=_elems_of(d))
    if isinstance(expr, P.DotBlock):
        da = P.exp_data(expr.a)
        db = P.exp_data(expr.b)
        sa, sb = shape_of(da), shape_of(db)
        contract = sa[-1]
        out_elems = 1.0
        if len(sa) == 2:
            out_elems *= sa[0]
        if len(sb) == 2:
            out_elems *= sb[1]
        dout = P.exp_data(expr)
        return (estimate(expr.a) + estimate(expr.b)
                + CostEstimate(flops=2.0 * out_elems * contract,
                               hbm_bytes=_bytes_of(dout)))
    if isinstance(expr, P.Zip):
        return estimate(expr.a) + estimate(expr.b)
    if isinstance(expr, (P.Split, P.Join, P.Transpose, P.AsVector,
                         P.AsScalar, P.Fst, P.Snd)):
        return estimate(expr.e)  # pure re-views: free
    if isinstance(expr, P.PairE):
        return estimate(expr.a) + estimate(expr.b)
    if isinstance(expr, P.IdxE):
        return estimate(expr.e).scaled(0.0) + CostEstimate(
            hbm_bytes=_bytes_of(P.exp_data(expr)))
    if isinstance(expr, P.ToMem):
        inner = estimate(expr.e)
        if expr.space == P.VMEM:
            return replace(inner, vmem_peak=max(
                inner.vmem_peak, _bytes_of(P.exp_data(expr))))
        return inner
    raise TypeError(f"cost.estimate: unhandled phrase {type(expr).__name__}")


def predicted_seconds(expr: P.Phrase, hw: HwModel = DEFAULT_HW) -> float:
    return estimate(expr).seconds(hw)


# ---------------------------------------------------------------------------
# serving KV-layout roofline (dense vs paged) — the HBM-bytes term
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KvLayoutCost:
    """HBM view of one serving KV layout at one engine shape.

    ``resident_bytes`` is the cache's standing footprint (what the paged
    layout shrinks: the pool is sized for expected occupancy, not
    ``slots * max_seq``); ``step_hbm_bytes`` is the attention-side traffic
    of ONE decode step across all slots/layers (what the dense layout wins:
    the paged gather materialises a per-slot view, roughly doubling the
    read traffic)."""
    layout: str
    resident_bytes: float
    step_hbm_bytes: float

    def seconds(self, hw: HwModel = DEFAULT_HW) -> float:
        """Predicted decode-step seconds, with a capacity penalty that
        dominates once the resident cache blows the HBM budget — a layout
        that does not fit is not a candidate, it is a spill."""
        t = self.step_hbm_bytes / hw.hbm_bw
        if self.resident_bytes > hw.hbm_capacity:
            t += hw.vmem_penalty_s * (self.resident_bytes
                                      / hw.hbm_capacity) * 1e3
        return t


def kv_layout_cost(layout: str, *, slots: int, max_seq: int, kv_heads: int,
                   head_dim: int, layers: int, dtype_bytes: int = 4,
                   block_size: int = 16,
                   expected_seq: Optional[int] = None) -> KvLayoutCost:
    """The KV-layout roofline point for one engine shape.

    ``expected_seq`` is the anticipated MEAN occupied positions per slot
    (prompt + decode budget); it defaults to ``max_seq // 2`` — the paged
    pool is sized for it (rounded up to whole blocks per slot), while the
    dense cache always pays ``max_seq``."""
    if layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv layout {layout!r}")
    per_pos = 2.0 * layers * kv_heads * head_dim * dtype_bytes  # k + v
    step = slots * max_seq * per_pos       # masked full-view read per token
    if layout == "dense":
        return KvLayoutCost("dense", slots * max_seq * per_pos, step)
    expected = max(1, int(expected_seq if expected_seq else max_seq // 2))
    blocks_per_slot = -(-min(expected, max_seq) // block_size)
    resident = slots * blocks_per_slot * block_size * per_pos
    return KvLayoutCost("paged", resident, 2.0 * step)  # + gather copy


# ---------------------------------------------------------------------------
# HLO-derived refinement (reuses the scan-aware counter)
# ---------------------------------------------------------------------------

def xla_cost(fn, args, hw: HwModel = DEFAULT_HW) -> Optional[float]:
    """Roofline seconds of one call ``fn(*args)`` from its counted op
    stream: ``max(flops / hw.peak_flops, bytes / hw.hbm_bw)``.  The
    reference lowers the candidate through XLA and runs its scan-aware HLO
    counter; the port counts the ATen ops the call dispatches and the work
    its hand-written kernels declare (``repro_torch.analysis.
    hlo_counter``).  Returns None when the call fails, as the reference
    does when lowering fails.  A call that launches a kernel with no
    declared work raises ``hlo_counter.UndeclaredKernel``: a K4 program is
    one (its executor declares nothing), so a ``dpia-cuda`` candidate on
    the card raises rather than costing its launches as zero."""
    from repro_torch.analysis.hlo_counter import (UndeclaredKernel,
                                                  analyze_text)
    try:
        t = analyze_text(fn, *args)
    except UndeclaredKernel:
        raise
    except Exception:
        return None
    return max(t.flops / hw.peak_flops, t.bytes / hw.hbm_bw)
