"""Serving engines: the decode fast path.

The port of ``repro.serve.engine``.  The decode hot loop runs entirely on
the device: one chunk function advances ``chunk`` tokens with sampling
(per-request temperature and top-k) fused into each step, over static
buffers written in place, and the host syncs once per chunk, when it reads
the chunk's ``(batch, chunk)`` token block.  On a CUDA device that chunk
is a CUDA graph, captured once per ``(batch, chunk, sampled)`` key and
replayed (:mod:`repro_torch.serve.graph`): the port's counterpart of the
reference's jitted ``lax.scan``, with "zero re-captures after warm-up" in
place of "zero recompiles".  ``graph=False`` runs the same chunk eagerly on
the card, for comparison; a CPU engine runs it eagerly.

Nothing inside the chunk may sync the host: no ``.item()``, ``.tolist()``,
``bool(tensor)``, tensor built from a host list, or host-to-device copy.
The chunk's knobs (temperatures, top-k, positions, block tables, each
slot's generator) are device state written at admission and parking.

Two engines share that chunk:

  * :class:`BatchedEngine`: static batch; prefill all requests together,
    decode lock-step until every request has its tokens (the oracle the
    continuous engine is held to).
  * :class:`ContinuousEngine`: continuous batching over a fixed number of
    device slots (:mod:`repro_torch.serve.scheduler`): requests are
    admitted into free slots and retired at chunk boundaries, prompts are
    right-padded to power-of-two buckets and the decode batch is always
    ``slots`` wide.  KV memory is a strategy dimension
    (``kv_layout="dense"|"paged"``, :mod:`repro_torch.serve.paged`), and
    prompts longer than ``prefill_chunk`` prefill in chunks across
    boundaries.

Sampling determinism: request ``i`` of a run with seed ``seed`` draws from
its own stream, seeded from ``(seed, i)`` into the ``torch.Generator`` of
its row or slot at admission and advanced once per sampled token (every
row of a sampled chunk draws, so a request's stream advances once per
step whatever its neighbours are).  The tokens a request receives thus
depend on the request alone: continuous batching gives the static
engine's tokens where the arithmetic is exact enough (fp32; in bf16 the
engines' other batch shapes round differently).  These streams give other bits than the reference's JAX
``fold_in`` keys: the two packages agree token for token only in greedy
mode.

Observability (:mod:`repro_torch.obs`, the reference's names).  Spans:
``engine.warm`` (an engine's first run: it builds the kernels it meets and
captures the decode graph; the engine is marked warm at its end),
``serve.step_chunk`` (one chunk boundary), ``serve.prefill_chunk`` (one
prompt chunk of one request) and ``serve.decode_chunk``.  Every span reads
the host's clock and none adds a device sync: ``serve.decode_chunk`` ends
after the chunk's one host sync (reading its tokens), so it is the
device's time for the chunk; ``serve.prefill_chunk`` wraps kernel launches
with no sync after them, so on the card it times their enqueue.  Metrics:
the ``serve.chunk_s`` histogram (the same decode chunk, host clock to the
sync), the ``serve.kv_pool.used_blocks`` / ``free_blocks`` gauges (paged)
and the ``serve.recompiles_after_warm`` counter and event, fed by the
re-capture detector.  The scheduler records the request lifecycle
(:mod:`repro_torch.serve.scheduler`).  No obs call runs inside the
captured chunk function: a call there would run once, at capture, and
never at a replay.

The tuner (:mod:`repro_torch.autotune`): ``ContinuousEngine(kv_layout=
"auto")`` ranks the dense and paged layouts with the HBM-bytes roofline
(``autotune.pick_kv_layout``) and takes the winner.  An engine given a
``tuning_cache`` (a path or an ``autotune.TuningCache``; the continuous
engine) runs every request under ``compiler.options(tuning_cache=...,
kv_layout=...)`` and at its warm boundary audits the measured records of
that cache (``obs.audit_cache``).  The reference also pre-tunes the
model's op shapes at construction and exports their executors to an AOT
store; the port's model path (K1, K3, the projections) dispatches through
no DPIA row and takes no tuned parameter, so that warm-up waits for a
model path that does (ROADMAP.md queue 1).

Resilience (``resilience=``, a
:class:`repro_torch.serve.resilience.ResilienceConfig`; its defaults are
on).  Every chunk goes through :meth:`_EngineBase._call_chunk`: the fault
sites ``serve.slow_chunk`` and ``serve.chunk_error``, the straggler
watchdog (``chunk_deadline_s``), armed before the chunk is dispatched and
disarmed after its host sync, so it covers the device's time, and
bounded retry with backoff.  Retry follows from what the port's chunk
does to its buffers: it writes the KV cache in place, so only a failure
*before* the chunk is enqueued leaves the state as it was.  An injected
fault fires there, and may be retried; past the retry budget the
continuous engine fails its in-flight requests and rebuilds its buffers
in place.  An exception from the chunk itself (the capture, the replay,
the eager chunk, the host sync) is neither retried nor quarantined: on
the card a CUDA error is sticky for the context, so it propagates after
the ``unhandled_exception`` flight dump.  The NaN guard runs inside the
chunk (inside the captured graph): each step ANDs ``isfinite(logits)
.all(-1)`` into a per-lane flag, sticky across the chunk, written into
the last column of the chunk's token buffer, so the chunk's one host sync
reads tokens and flags together; a flagged lane's request fails at the
boundary, co-batched requests untouched.  The continuous engine also
checks prompts' logits at admission, validates the paged block pool at
every boundary (corruption degrades the engine paged -> dense, a new
capture of the dense chunk) and scrubs a quarantined request's pages, and
the trash page, before they are reused.

A continuous engine given ``journal=`` (a path or a
:class:`repro_torch.serve.domains.SchedulerJournal`) journals every
submission, each boundary's emitted tokens and every terminal state, so a
killed engine's surviving requests ``domains.replay`` to token identity.

Not ported yet: :class:`ShardedEngine` (ROADMAP.md queue 1 item 7, mesh)
raises ``NotImplementedError``; the reference's AOT executables of the
model come with it."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import logging
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import compiler, obs
from repro_torch.ft.resilience import Watchdog
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import Model
from repro_torch.serve.domains import SchedulerJournal
from repro_torch.serve.graph import ChunkGraphs
from repro_torch.serve.paged import BlockPool, table_row
from repro_torch.serve.resilience import (RequestResult, ResilienceConfig,
                                          record_degradation)
from repro_torch.serve.scheduler import Scheduler, pick_bucket, seq_buckets
from repro_torch.testing import faults

log = logging.getLogger("repro_torch.serve.engine")

__all__ = ["Request", "BatchedEngine", "ContinuousEngine", "ShardedEngine",
           "sample", "sample_tokens"]


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample(logits, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0):
    """Sample one token per row of ``logits`` (..., vocab) with shared knobs.

    ``temperature <= 0`` is greedy argmax.  ``top_k > 0`` keeps the k
    largest logits per row; values tied with the k-th largest are all kept
    (the cutoff is a >=-threshold, not a count), and ``top_k >= vocab`` is a
    no-op.  Sampling is Gumbel-max over ``generator``'s uniforms."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    scaled = logits.float() / temperature
    vocab = scaled.shape[-1]
    if 0 < top_k < vocab:
        kth = scaled.topk(top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (scaled + gumbel).argmax(dim=-1)


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device`` without waiting for the card: a copy
    from pageable memory syncs the stream, one from pinned memory does not
    (admission's inputs go in while earlier work still runs)."""
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def sample_tokens(logits, generators: Sequence[torch.Generator], temps,
                  top_ks, *, sampled: Optional[bool] = None):
    """Per-request sampling over a batch, the form fused into the decode
    chunk: row ``i`` of ``logits`` (b, vocab) is sampled with ``temps[i]``
    (``<= 0`` means greedy for that row), ``top_ks[i]`` (``0`` means no
    top-k filter) and ``generators[i]``; same per-row semantics as
    :func:`sample`.

    ``temps`` and ``top_ks`` are host sequences or (b,) device tensors.
    ``sampled`` says whether any row samples; it is read from host
    ``temps`` when not given, and must be given with tensors (reading a
    device tensor would sync the host).  A greedy batch is one argmax.  In
    a sampled batch every row draws ``vocab`` uniforms from its own
    generator, greedy rows included (their draw is discarded), and the
    top-k threshold is the k-th value of a full sort: no host branch."""
    greedy = logits.argmax(dim=-1)
    if sampled is None:
        if isinstance(temps, torch.Tensor):
            raise ValueError("sample_tokens: pass sampled= with device "
                             "temperatures")
        sampled = any(float(t) > 0.0 for t in temps)
    if not sampled:
        return greedy
    dev = logits.device
    if not isinstance(temps, torch.Tensor):
        temps = _to_device(torch.tensor([float(t) for t in temps]), dev)
    if not isinstance(top_ks, torch.Tensor):
        top_ks = _to_device(torch.tensor([int(k or 0) for k in top_ks]), dev)
    vocab = logits.shape[-1]
    scaled = logits.float() / temps.clamp_min(1e-6)[:, None]
    k = torch.where(top_ks > 0, top_ks, vocab).clamp(1, vocab)
    kth = scaled.sort(dim=-1, descending=True).values.gather(
        -1, (k - 1)[:, None])
    scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    u = torch.stack([torch.rand((vocab,), generator=g, device=dev)
                     for g in generators])
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return torch.where(temps > 0.0, (scaled + gumbel).argmax(dim=-1),
                       greedy)


def _stream_seed(seed: int, index: int) -> int:
    """The seed of stream ``index`` in a run seeded ``seed``: a hash of
    both, so that every bit depends on each (the CPU generator reads only
    the low 32 bits of its seed)."""
    digest = hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little")


# ---------------------------------------------------------------------------
# requests and the chunk's static buffers
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    prompt: Sequence[int]        # (s,) token ids: a list or a 1-D tensor
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0
    # per-request deadlines, both measured from submission: ``deadline_s``
    # is end-to-end, ``ttft_deadline_s`` applies until the first token.
    # Enforced at chunk boundaries; an expired request ends in terminal
    # state "timeout" with its partial tokens intact.
    deadline_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None


@dataclasses.dataclass
class _DecodeState:
    """The decode chunk's buffers.  Prefill, admission and parking write
    them in place; they are never rebound, so a captured graph's addresses
    stay valid."""
    cache: KVCache                       # dense cache or page pools
    block_tables: Optional[torch.Tensor]  # (b, max_blocks); None: dense
    tokens: torch.Tensor                 # (b,) each lane's last token
    pos: torch.Tensor                    # (b,) each lane's next position
    temps: torch.Tensor                  # (b,) float32
    top_ks: torch.Tensor                 # (b,)
    generators: List[torch.Generator]    # one stream a lane
    # (b, chunk + 1): the chunk's tokens, then the NaN guard's flag (1: a
    # step of the chunk gave the lane a non-finite logit)
    out: torch.Tensor

    @classmethod
    def new(cls, cache, block_tables, b: int, chunk: int, device):
        z = functools.partial(torch.zeros, dtype=torch.long, device=device)
        return cls(cache=cache, block_tables=block_tables, tokens=z((b,)),
                   pos=z((b,)),
                   temps=torch.zeros((b,), dtype=torch.float32,
                                     device=device),
                   top_ks=z((b,)),
                   generators=[torch.Generator(device=device)
                               for _ in range(b)],
                   out=z((b, chunk + 1)))


def _slot_axis(big, small) -> Optional[int]:
    """The slot/batch axis of a cache leaf: the unique axis where the
    1-slot shape differs from the engine shape (None when slots == 1, i.e.
    the slot IS the cache)."""
    return next((i for i, (a, c) in enumerate(zip(big.shape, small.shape))
                 if a != c), None)


def _insert_slot(big: KVCache, small: KVCache, slot: int) -> None:
    """Copy a batch-1 cache into the engine cache at ``slot``, in place
    (the reference returns an updated copy)."""
    for bl, sl in zip(big, small):
        axis = _slot_axis(bl, sl)
        if axis is None:
            bl.copy_(sl)
        else:
            bl.select(axis, slot).copy_(sl.select(axis, 0))


def _prompt_tensor(prompt, length: int, device) -> torch.Tensor:
    """A (1, length) token tensor: ``prompt`` right-padded with token 0."""
    out = torch.zeros((1, length), dtype=torch.long)
    out[0, :len(prompt)] = torch.as_tensor(prompt, dtype=torch.long)
    return _to_device(out, device)


# ---------------------------------------------------------------------------
# shared engine core
# ---------------------------------------------------------------------------

class _EngineBase:
    """Model/params, the one decode chunk function and its graphs, the
    chunk's resilience wrapping, the work counters and the re-capture
    detector."""

    def __init__(self, model: Model, params, *, max_seq: int, chunk: int,
                 graph: bool = True, kv_layout: str = "dense",
                 tuning_cache=None,
                 resilience: Optional[ResilienceConfig] = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.chunk = chunk
        self.kv_layout = kv_layout
        self.tuning_cache = tuning_cache
        self._drift_audited = False
        self.resilience = resilience or ResilienceConfig()
        self._watchdog: Optional[Watchdog] = None
        if self.resilience.chunk_deadline_s is not None:
            self._watchdog = Watchdog(self.resilience.chunk_deadline_s,
                                      on_straggler=self._on_straggler)
        self._n_chunk_calls = 0
        self._n_chunk_retries = 0
        self._n_chunk_quarantines = 0
        self._n_nan_quarantines = 0
        self._n_degradations = 0
        self.device = params["embed"].device
        self._graphs = (ChunkGraphs(self.device)
                        if graph and self.device.type == "cuda" else None)
        # re-capture detector: captures at the last ``mark_warm()``; None
        # until the engine declares itself warm
        self._warm_captures: Optional[int] = None
        self._recaptures_after_warm = 0
        self.n_prefills = 0
        self.n_decode_steps = 0
        self.n_chunks = 0

    # -- the tuner: options scope, drift audit -------------------------------

    def _options_scope(self):
        """The compile-options scope this engine's requests run under."""
        if self.tuning_cache is None:
            return contextlib.nullcontext()
        # kv_layout is a strategy dimension: executors staged under this
        # scope carry it in their keys, like the mesh descriptor
        return compiler.options(tuning_cache=self.tuning_cache,
                                kv_layout=self.kv_layout)

    def _audit_drift(self) -> None:
        """At the warm boundary, once per engine: re-rank every measured
        record of this engine's tuning cache under the current cost model
        and fire ``tune.drift`` where the model's pick is not the measured
        one (analytic only: builds terms, compiles nothing)."""
        if self.tuning_cache is None or self._drift_audited:
            return
        self._drift_audited = True
        from repro_torch.autotune.api import _resolve_cache
        obs.audit_cache(_resolve_cache(self.tuning_cache))

    # -- the decode chunk ----------------------------------------------------

    def _chunk_fn(self, st: _DecodeState, sampled: bool) -> None:
        """``chunk`` decode steps over ``st``, sampling included, leaving
        the tokens (and, with the NaN guard, each lane's flag in the last
        column) in ``st.out`` and the lanes' state in ``st``: the body a
        CUDA graph captures.  Paged: each slot's pages are gathered into a
        dense-shaped view once per chunk; steps attend and update the view
        and mirror each token's write into the pool."""
        model, params, bt = self.model, self.params, st.block_tables
        view = None if bt is None else model.gather_paged_view(st.cache, bt)
        tok, pos = st.tokens, st.pos
        finite = None
        for i in range(self.chunk):
            if view is None:
                logits, _ = model.decode_step(params, tok[:, None], st.cache,
                                              pos)
            else:
                logits, _, view = model.decode_step(
                    params, tok[:, None], st.cache, pos, block_tables=bt,
                    kv_view=view)
            if self.resilience.nan_guard:
                # pure observation: the token dataflow is untouched, so
                # clean lanes keep their tokens bit for bit
                step_ok = torch.isfinite(
                    logits.reshape(logits.shape[0], -1)).all(dim=-1)
                finite = step_ok if finite is None else finite & step_ok
            tok = sample_tokens(logits, st.generators, st.temps, st.top_ks,
                                sampled=sampled)
            # a retired lane keeps decoding to the chunk's end; past max_seq
            # its writes drop
            pos = (pos + 1).clamp(max=self.max_seq)
            st.out[:, i] = tok
        if finite is not None:
            st.out[:, self.chunk] = ~finite
        st.tokens.copy_(tok)
        st.pos.copy_(pos)

    def _decode_chunk(self, st: _DecodeState, sampled: bool):
        """Run one chunk (a graph replay on the card unless ``graph=False``)
        and return its (b, chunk) tokens and each lane's NaN flag: the
        chunk's one host sync reads both."""
        if self._graphs is None:
            self._chunk_fn(st, sampled)
        else:
            key = (st.tokens.shape[0], self.chunk, sampled)
            self._graphs.run(key, functools.partial(self._chunk_fn, st,
                                                    sampled), st.generators)
            self._check_recaptures()
        self.n_decode_steps += self.chunk
        self.n_chunks += 1
        out = st.out.tolist()
        return ([row[:self.chunk] for row in out],
                [bool(row[self.chunk]) for row in out])

    # -- the chunk's resilience wrapping -------------------------------------

    def _on_straggler(self, chunk_i: int, dt: float) -> None:
        obs.counter("serve.stragglers").inc()
        obs.event("serve.straggler", chunk=chunk_i, elapsed_s=round(dt, 4))
        log.warning("decode chunk %d exceeded the chunk deadline "
                    "(%.3fs > %.3fs) — straggler suspected", chunk_i, dt,
                    self.resilience.chunk_deadline_s)

    def _call_chunk(self, st: _DecodeState, sampled: bool,
                    req_ids: str = ""):
        """:meth:`_decode_chunk` with the resilience wrapping: the
        ``serve.slow_chunk`` / ``serve.chunk_error`` fault sites, the
        straggler watchdog and bounded retry with backoff.

        ``req_ids`` (comma-joined active request ids) attributes the fault
        sites and failure events to the requests riding the chunk.

        The watchdog is armed before the chunk is dispatched and disarmed
        after its host sync: on the card a replay returns at once and the
        device's time is paid at the sync.  Only a failure before dispatch
        is retried (an injected fault fires there, with the buffers
        untouched); past ``max_chunk_retries`` it propagates, and the
        continuous engine quarantines.  An exception from the chunk itself
        is not caught here: the chunk writes the KV cache in place, and on
        the card a CUDA error is sticky for the context, so neither a
        retry nor a rebuild could be trusted."""
        rc = self.resilience
        self._n_chunk_calls += 1
        attempt = 0
        while True:
            if self._watchdog is not None:
                self._watchdog.arm(self._n_chunk_calls)
            try:
                try:
                    f = faults.should_fire("serve.slow_chunk",
                                           req_ids=req_ids)
                    if f is not None:
                        time.sleep(float(f.value or 0.05))
                    faults.raise_if("serve.chunk_error", req_ids=req_ids)
                except faults.InjectedFault as e:
                    attempt += 1
                    obs.counter("serve.chunk_failures").inc()
                    obs.event("serve.chunk_failure", attempt=attempt,
                              req_ids=req_ids,
                              error=f"{type(e).__name__}: {e}")
                    if attempt > rc.max_chunk_retries:
                        raise
                    self._n_chunk_retries += 1
                    log.warning("decode chunk failed before dispatch (%s: "
                                "%s); retry %d/%d", type(e).__name__, e,
                                attempt, rc.max_chunk_retries)
                else:
                    return self._decode_chunk(st, sampled)
            finally:
                if self._watchdog is not None:
                    self._watchdog.disarm()
            time.sleep(rc.retry_backoff_s * attempt)

    # -- stats and the re-capture detector -----------------------------------

    def stats(self) -> dict:
        """Work done so far: prefill calls, decode steps, decode chunks
        (each chunk is one host sync); with graphs, captures and
        re-captures after warm-up."""
        out = {"prefills": self.n_prefills,
               "decode_steps": self.n_decode_steps,
               "chunks": self.n_chunks}
        if self._graphs is not None:
            out["captures"] = self._graphs.captures
            out["recaptures_after_warm"] = self._recaptures_after_warm
            out["graph_keys"] = list(self._graphs.keys)
        out["resilience"] = {
            "chunk_retries": self._n_chunk_retries,
            "chunk_quarantines": self._n_chunk_quarantines,
            "nan_quarantines": self._n_nan_quarantines,
            "degradations": self._n_degradations,
            "stragglers": (len(self._watchdog.events)
                           if self._watchdog is not None else 0),
        }
        return out

    @staticmethod
    def _latency_stats() -> dict:
        """count / mean / p50 / p95 / p99 of each serving latency histogram
        with observations."""
        reg = obs.registry()
        out = {}
        for name in ("serve.queue_wait_s", "serve.ttft_s", "serve.e2e_s",
                     "serve.decode_tok_s", "serve.chunk_s"):
            h = reg.histogram(name)
            if h.count:
                out[name.split(".", 1)[1]] = {
                    "count": h.count, "mean": h.mean,
                    "p50": h.percentile(0.50),
                    "p95": h.percentile(0.95),
                    "p99": h.percentile(0.99),
                }
        return out

    def mark_warm(self) -> None:
        """Declare the graphs warm: a capture past this point is a
        *re-capture*, counted in ``stats()``, in the
        ``serve.recompiles_after_warm`` counter and event, and logged.
        The first completed run marks the engine warm."""
        self._warm_captures = (self._graphs.captures
                               if self._graphs is not None else 0)
        self._audit_drift()

    def _warm_run(self, run, **span_args):
        """``run()``; the engine's first run goes in an ``engine.warm``
        span and marks the engine warm when it completes."""
        with self._options_scope():
            if self._warm_captures is not None:
                out = run()
            else:
                with obs.span("engine.warm", max_seq=self.max_seq,
                              chunk=self.chunk, **span_args):
                    out = run()
        if self._warm_captures is None:    # first run, or degraded in it
            self.mark_warm()
        return out

    def _check_recaptures(self) -> None:
        """Compare the captures against the warm baseline; report each new
        key once (a re-capture costs time, it is never an error)."""
        if self._warm_captures is None:
            return
        grew = self._graphs.captures - self._warm_captures
        if grew <= 0:
            return
        self._recaptures_after_warm += grew
        base = self._warm_captures
        self._warm_captures = self._graphs.captures
        obs.counter("serve.recompiles_after_warm").inc(grew)
        obs.event("serve.recompile_after_warm",
                  captures=self._graphs.captures, baseline_captures=base,
                  keys=[str(k) for k in self._graphs.keys[-grew:]])
        log.warning("decode chunk captured after warm-up for key(s) %s "
                    "(batch, chunk, sampled): warm traffic should only "
                    "replay", self._graphs.keys[-grew:])

    # -- shared pieces -------------------------------------------------------

    def _check_request(self, r: Request) -> None:
        need = len(r.prompt) + max(int(r.max_new_tokens), 0)
        if need > self.max_seq:
            raise ValueError(
                f"request needs {need} cache positions (prompt "
                f"{len(r.prompt)} + {r.max_new_tokens} new) but max_seq is "
                f"{self.max_seq}")


# ---------------------------------------------------------------------------
# static batch (the oracle)
# ---------------------------------------------------------------------------

class BatchedEngine(_EngineBase):
    """Static-batch serving engine: prefill a batch of requests together,
    then decode lock-step in chunks until every request has its
    ``max_new_tokens``.

    The engine runs on the device its params live on.  Each request is
    sampled with its own temperature/top-k; prompts are right-padded to the
    batch max and ``prefill(lengths=...)`` takes each row's real next-token
    logits, so padding never distorts positions or outputs.  The chunk's
    buffers are kept per batch size and zeroed at each run, so a later run
    of as many requests replays the graphs of the first.

    ``resilience`` wraps each chunk (fault sites, watchdog, retry before
    dispatch); the chunk computes the NaN guard's flags as the continuous
    engine's does, and, as in the reference, the static engine does not
    act on them: it has no lane to quarantine a request from."""

    def __init__(self, model: Model, params, max_seq: int = 512,
                 chunk: int = 8, *, graph: bool = True,
                 resilience: Optional[ResilienceConfig] = None):
        super().__init__(model, params, max_seq=max_seq, chunk=chunk,
                         graph=graph, resilience=resilience)
        self._states: Dict[int, _DecodeState] = {}

    def _state(self, b: int) -> _DecodeState:
        st = self._states.get(b)
        if st is None:
            cache = self.model.init_cache(b, self.max_seq, device=self.device)
            st = self._states[b] = _DecodeState.new(cache, None, b,
                                                    self.chunk, self.device)
        return st

    def run(self, requests: List[Request], seed: int = 0) -> List[List[int]]:
        return self._warm_run(lambda: self._run(requests, seed),
                              batch=len(requests))

    def _run(self, requests: List[Request], seed: int) -> List[List[int]]:
        model, dev = self.model, self.device
        for r in requests:
            self._check_request(r)
        b = len(requests)
        lengths = [len(r.prompt) for r in requests]
        s = max(lengths)
        with torch.inference_mode():
            st = self._state(b)
            st.cache.k.zero_()
            st.cache.v.zero_()
            tokens = torch.cat([_prompt_tensor(r.prompt, s, dev)
                                for r in requests])
            pos = _to_device(torch.tensor(lengths, dtype=torch.long), dev)
            logits, _ = model.prefill(self.params, tokens, st.cache,
                                      lengths=pos)
            self.n_prefills += 1
            temps = [float(r.temperature) for r in requests]
            for i, r in enumerate(requests):
                st.temps[i].fill_(temps[i])
                st.top_ks[i].fill_(int(r.top_k or 0))
                st.generators[i].manual_seed(_stream_seed(seed, i))
            sampled = any(t > 0.0 for t in temps)
            first = sample_tokens(logits, st.generators, st.temps, st.top_ks,
                                  sampled=sampled)
            st.tokens.copy_(first)
            st.pos.copy_(pos)

            outs: List[List[int]] = [[] for _ in requests]
            remaining = [max(int(r.max_new_tokens), 0) for r in requests]
            for i, t in enumerate(first.tolist()):   # the prefill's host sync
                if remaining[i] > 0:
                    outs[i].append(t)
                    remaining[i] -= 1
            while any(n > 0 for n in remaining):
                live = ",".join(str(i) for i, n in enumerate(remaining)
                                if n > 0)
                rows, _ = self._call_chunk(st, sampled, req_ids=live)
                for i in range(b):
                    take = min(remaining[i], self.chunk)
                    outs[i].extend(rows[i][:take])
                    remaining[i] -= take
        return outs


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

class ContinuousEngine(_EngineBase):
    """Continuous-batching engine over ``slots`` fixed device decode lanes.

    Requests are admitted into free slots and retired at chunk boundaries;
    prompts prefill right-padded to a power-of-two bucket
    (:func:`repro_torch.serve.scheduler.seq_buckets`).  The decode batch is
    always ``slots`` wide (free lanes decode padding that is discarded), so
    the graph keys are ``(slots, chunk, sampled)``: at most two captures,
    and warm traffic only replays.

    Per-request streams and padding-invariant prefill make a request's
    tokens a function of the request alone, so in fp32 they equal
    :class:`BatchedEngine`'s on the same requests and seed (chip_smoke
    phase 5 holds them equal at full depth on the card).  In bf16 the two
    engines round other prefill batches, attention paths and decode widths
    differently, and tokens part at near-tied argmaxes.

    ``kv_layout``:

      * ``"dense"``: one ``(slots, max_seq)`` cache; an admission prefills
        into a fresh zero batch-1 cache and copies it into its slot;
      * ``"paged"``: KV lives in a pool of ``kv_blocks`` pages of
        ``block_size`` positions (:mod:`repro_torch.serve.paged`); each slot
        maps into the pool through a ``(max_blocks,)`` block-table row,
        pages are reserved at admission and freed at retirement;
      * ``"auto"``: the layout ``autotune.pick_kv_layout`` ranks first for
        this model and engine shape (the HBM-bytes roofline, cached in
        ``tuning_cache``).

    ``prefill_chunk`` caps the admission bucket set: prompts longer than it
    are CHUNKED, one prefill chunk per boundary, so a long prompt does not
    stall the other lanes for a whole prompt-length prefill.  The first
    chunk attends within itself (K3); continuation chunks attend to the
    whole cache (dense ``prefill(attend_cache=True)``, paged
    ``first=False``).

    ``resilience`` (a :class:`ResilienceConfig`; the defaults are on) and
    ``journal`` (a path or a :class:`SchedulerJournal`): see the module
    docstring.
    """

    def __init__(self, model: Model, params, max_seq: int = 512,
                 slots: int = 4, chunk: int = 8, min_bucket: int = 16,
                 kv_layout: str = "dense", block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None, *, graph: bool = True,
                 tuning_cache=None,
                 resilience: Optional[ResilienceConfig] = None,
                 journal=None):
        if kv_layout == "auto":
            from repro_torch import autotune
            kv_layout = autotune.pick_kv_layout(
                model.cfg, slots=slots, max_seq=max_seq,
                block_size=block_size, cache=tuning_cache)["layout"]
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense', 'paged' or "
                             f"'auto', got {kv_layout!r}")
        if kv_layout == "paged":
            if max_seq % block_size != 0:
                raise ValueError(
                    f"paged layout needs block_size ({block_size}) to "
                    f"divide max_seq ({max_seq}) so the gathered view is "
                    f"shape-identical to the dense cache")
            self.block_size = block_size
            self.max_blocks = max_seq // block_size
            self.kv_blocks = int(kv_blocks or slots * self.max_blocks)
        super().__init__(model, params, max_seq=max_seq, chunk=chunk,
                         graph=graph, kv_layout=kv_layout,
                         tuning_cache=tuning_cache, resilience=resilience)
        self.slots = slots
        self.prefill_chunk = prefill_chunk
        limit = (max_seq if prefill_chunk is None
                 else max(min(prefill_chunk, max_seq), min_bucket))
        self.buckets = seq_buckets(limit, min_bucket)
        if journal is None or isinstance(journal, SchedulerJournal):
            self.journal = journal
        else:
            self.journal = SchedulerJournal(journal)
        self._reset_state()

    # -- device state --------------------------------------------------------

    def _init_device_state(self) -> None:
        """Build the chunk's buffers for the current ``kv_layout``, every
        lane parked.  A captured graph reads the buffers it was captured on,
        so only construction and the paged -> dense degradation (which
        drops the graphs) may call this; the chunk-failure rebuild works in
        place (:meth:`_rebuild_in_place`)."""
        b, dev = self.slots, self.device
        if self.kv_layout == "paged":
            cache = self.model.init_paged_cache(
                b, self.max_seq, n_blocks=self.kv_blocks,
                block_size=self.block_size, device=dev)
            # all-sentinel tables: every lane's writes drop until admission
            tables = torch.full((b, self.max_blocks), self.kv_blocks,
                                dtype=torch.long, device=dev)
            self.pool: Optional[BlockPool] = BlockPool(self.kv_blocks,
                                                       self.block_size)
        else:
            cache = self.model.init_cache(b, self.max_seq, device=dev)
            tables, self.pool = None, None
        self.st = _DecodeState.new(cache, tables, b, self.chunk, dev)
        self.st.pos.fill_(self.max_seq)       # every lane parked
        self._staging: Dict[int, KVCache] = {}
        self._admit_logits: Dict[int, torch.Tensor] = {}

    def _reset_state(self) -> None:
        self._init_device_state()
        self.sched = Scheduler(self.slots, pool=self.pool)
        self._requests: Dict[int, Request] = {}
        self._stream_seeds: Dict[int, int] = {}
        self._next_id = 0
        self._run_seed = 0

    def _rebuild_in_place(self) -> None:
        """Reset the chunk's buffers after a chunk failure, in place: zero
        the cache (the trash page included), park every lane, reset the
        block tables and the pool.  ``self.st`` keeps its tensors, so the
        captured graphs stay valid and the rebuild costs no capture."""
        st = self.st
        st.cache.k.zero_()
        st.cache.v.zero_()
        st.pos.fill_(self.max_seq)
        st.tokens.zero_()
        st.temps.zero_()
        st.top_ks.zero_()
        if st.block_tables is not None:
            st.block_tables.fill_(self.kv_blocks)
        if self.pool is not None:
            self.pool = BlockPool(self.kv_blocks, self.block_size)
            self.sched.pool = self.pool
        self._staging.clear()
        self._admit_logits.clear()

    # -- API -----------------------------------------------------------------

    def submit(self, request: Request, stream: Optional[int] = None) -> int:
        """Queue a request; returns its id.

        ``stream`` is the request's stream index: its tokens are sampled
        from the stream seeded from (the run's seed, ``stream``).  ``run``
        passes each request's position in its batch, the stream the static
        engine uses; streaming callers that omit it get the request id."""
        self._check_request(request)
        rid = self._next_id
        self._next_id += 1
        self._requests[rid] = request
        self._stream_seeds[rid] = _stream_seed(
            self._run_seed, rid if stream is None else stream)
        self.sched.submit(rid, len(request.prompt),
                          max(int(request.max_new_tokens), 0),
                          deadline_s=request.deadline_s,
                          ttft_deadline_s=request.ttft_deadline_s)
        if self.journal is not None:
            self.journal.record_submit(
                rid, request.prompt,
                max_new=max(int(request.max_new_tokens), 0),
                temperature=request.temperature, top_k=request.top_k or 0,
                stream=rid if stream is None else stream,
                deadline_s=request.deadline_s,
                ttft_deadline_s=request.ttft_deadline_s)
        return rid

    def take_output(self, rid: int) -> List[int]:
        """Collect (and release) a finished request's tokens."""
        return self.sched.pop_output(rid)

    def take_result(self, rid: int) -> RequestResult:
        """Collect (and release) a terminal request's full outcome: tokens,
        terminal state, reason and time to first token."""
        return self.sched.pop_result(rid)

    def cancel(self, rid: int, reason: str = "cancelled by caller") -> None:
        """Cancel a pending or in-flight request at the current boundary.

        Partial tokens survive into the terminal result (state
        ``cancelled``); the device lane is parked and, paged, its pages
        return to the pool at once.  Idempotent once terminal; KeyError for
        ids never submitted."""
        slot = self.sched.cancel(rid, reason)
        if slot is not None:
            self._evict_slot(slot)
        if self.journal is not None and rid in self.sched.done:
            # cancellation happens between boundaries: journal the final
            # snapshot and the terminal now (there may be no next boundary)
            toks = self.sched.outputs.get(rid)
            if toks:
                self.journal.record_progress(rid, toks)
            self.journal.record_terminal(rid, *self.sched.done[rid])
        self._requests.pop(rid, None)
        self._stream_seeds.pop(rid, None)

    def run(self, requests: List[Request], seed: int = 0) -> List[List[int]]:
        """Serve a closed set of requests to completion; returns outputs in
        submission order."""
        return [list(r.tokens) for r in self.run_results(requests, seed)]

    def run_results(self, requests: List[Request],
                    seed: int = 0) -> List[RequestResult]:
        """:meth:`run`, returning each request's full outcome (time to
        first token included).  The first completed run marks the engine
        warm."""
        def run():
            self._run_seed = seed
            rids = [self.submit(r, stream=i) for i, r in enumerate(requests)]
            while not self.sched.idle:
                self.step_chunk()
            return [self.take_result(rid) for rid in rids]
        return self._warm_run(run, slots=self.slots)

    def stats(self) -> dict:
        """The base engine's numbers, the scheduler's lifecycle totals, the
        KV pool's (paged), the executor cache's statistics and percentile
        summaries of the serving latency histograms (``latency``: the
        process-wide metrics registry, so they cover every engine in the
        process)."""
        out = super().stats()
        out["executor_cache"] = compiler.executor_cache().stats()
        out["latency"] = self._latency_stats()
        out["scheduler"] = self.sched.stats()
        if self.pool is not None:
            out["kv_pool"] = self.pool.stats()
        return out

    def _check_request(self, r: Request) -> None:
        super()._check_request(r)
        if self.kv_layout == "paged":
            need = self.pool.blocks_for(len(r.prompt)
                                        + max(int(r.max_new_tokens), 0))
            if need > self.pool.n_blocks:
                raise ValueError(
                    f"request needs {need} KV blocks but the pool only has "
                    f"{self.pool.n_blocks} (block_size "
                    f"{self.pool.block_size}); raise kv_blocks")

    # -- the chunk-boundary loop ---------------------------------------------

    def step_chunk(self) -> List[int]:
        """Sweep deadlines, admit pending requests, advance in-flight prompt
        prefills by one chunk each, then decode one chunk.

        Returns the request ids that reached a terminal state at this
        boundary.  An exception leaving the engine dumps the flight
        recorder (reason ``unhandled_exception``) and propagates."""
        try:
            with torch.inference_mode(), obs.span("serve.step_chunk"):
                finished = self._step_chunk()
        except Exception as e:
            obs.flight_dump("unhandled_exception",
                            error=f"{type(e).__name__}: {e}")
            raise
        if self.journal is not None:
            self._journal_sync(finished)
        return finished

    def _journal_sync(self, finished: List[int]) -> None:
        """Journal this boundary: an emitted-token snapshot per request
        with new tokens, then a terminal record per request that ended.
        Chunk boundaries are the journal's granularity: inside a chunk the
        host observes nothing."""
        for rid, toks in self.sched.outputs.items():
            self.journal.record_progress(rid, toks)
        for rid in finished:
            state_reason = self.sched.done.get(rid)
            if state_reason is not None:
                self.journal.record_terminal(rid, *state_reason)

    def _step_chunk(self) -> List[int]:
        finished: List[int] = []
        for slot, rid in self.sched.check_deadlines():
            if slot is not None:
                self._evict_slot(slot)
            finished.append(rid)
        # pool integrity: a corrupt block pool means tables may alias pages
        # across requests; degrade paged -> dense instead of decoding
        # through a damaged mapping
        if self.pool is not None and self.resilience.pool_check:
            if faults.should_fire("serve.pool_corrupt") is not None:
                faults.corrupt_pool(self.pool)
            problems = self.pool.validate()
            if problems:
                finished.extend(self._degrade_to_dense("; ".join(problems)))
        self.sched.admissions()               # reserve slots (and KV blocks)
        if self.pool is not None:
            obs.gauge("serve.kv_pool.used_blocks").set(self.pool.used_blocks)
            obs.gauge("serve.kv_pool.free_blocks").set(self.pool.free_blocks)
        for slot, rid in self.sched.prefilling():
            if self._prefill_advance(slot, rid):      # one chunk per boundary
                if self._finish_admit(slot, rid):
                    finished.append(rid)
        busy = self.sched.busy_slots()
        if busy:
            rids = [self.sched.slots[i].req_id for i in busy]
            # the graph key's ``sampled``, from host values: no device sync
            sampled = any(self._requests[rid].temperature > 0.0
                          for rid in rids)
            slot_of = dict(zip(rids, busy))
            req_ids = ",".join(str(s.req_id) for s in self.sched.slots
                               if not s.free)
            t0 = time.perf_counter()
            try:
                # ends after the chunk's one host sync (the tokens' read):
                # the span and serve.chunk_s time the device's chunk
                with obs.span("serve.decode_chunk", chunk=self.chunk,
                              req_ids=req_ids):
                    rows, bad = self._call_chunk(self.st, sampled, req_ids)
            except faults.InjectedFault as e:
                # only a failure before dispatch reaches here (past its
                # retries): the buffers are as the last chunk left them
                if not self.resilience.quarantine_on_chunk_failure:
                    raise
                finished.extend(self._quarantine_chunk_failure(e))
            else:
                dt = time.perf_counter() - t0
                obs.histogram("serve.chunk_s").observe(dt)
                obs.drift_observe(f"serve|decode_chunk|slots={self.slots}"
                                  f"|chunk={self.chunk}", dt)
                if self.resilience.nan_guard and any(bad):
                    finished.extend(self._quarantine_nan_rows(bad))
                retired = self.sched.record_chunk(rows)
                for rid in retired:
                    self._park_lane(slot_of[rid])
                finished.extend(retired)
        for rid in finished:                  # release prompts at retire
            self._requests.pop(rid, None)
            self._stream_seeds.pop(rid, None)
        return finished

    # -- quarantine and degradation ------------------------------------------

    def _quarantine_nan_rows(self, bad: List[bool]) -> List[int]:
        """Fail the requests whose lanes the chunk's NaN guard flagged: the
        lane is parked and, paged, its pages (and the trash page) are
        scrubbed before they return to the pool.  Flags of free or
        prefilling lanes are stale lanes decoding padding: ignored."""
        out: List[int] = []
        for i, s in enumerate(self.sched.slots):
            if not bad[i] or s.free or s.prefilling:
                continue
            out.append(s.req_id)
            self._quarantine_nan(i, s.req_id,
                                 "non-finite logits in decode chunk")
        return out

    def _quarantine_nan(self, slot: int, rid: int, reason: str,
                        **where) -> None:
        """Fail ``rid`` for non-finite logits: its lane is parked and,
        paged, its pages and the trash page are scrubbed before they are
        reused."""
        self._n_nan_quarantines += 1
        obs.counter("serve.nan_quarantines").inc()
        obs.event("serve.nan_quarantine", req_id=rid, slot=slot, **where)
        log.warning("request %d: %s (slot %d) — quarantined, co-batched "
                    "requests unaffected", rid, reason, slot)
        if self.kv_layout == "paged":
            self._scrub_pages(self.pool.owned(slot))
        self.sched.fail(rid, reason)
        self._evict_slot(slot)

    def _quarantine_chunk_failure(self, e: Exception) -> List[int]:
        """The decode chunk failed before dispatch past the retry budget:
        fail every in-flight request and rebuild the chunk's buffers in
        place.  Pending requests survive in the queue and admit into the
        rebuilt state."""
        self._n_chunk_quarantines += 1
        obs.counter("serve.chunk_quarantines").inc()
        obs.event("serve.chunk_quarantine",
                  error=f"{type(e).__name__}: {e}")
        log.warning("decode chunk failed past the retry budget (%s: %s); "
                    "failing in-flight requests and rebuilding device "
                    "state in place", type(e).__name__, e)
        failed = self._fail_in_flight(
            f"decode chunk failed: {type(e).__name__}: {e}")
        self._rebuild_in_place()
        return failed

    def _fail_in_flight(self, reason: str) -> List[int]:
        """Fail every admitted request (shared device state is suspect);
        returns their ids.  Queued requests are untouched."""
        failed: List[int] = []
        for i, s in enumerate(self.sched.slots):
            if s.free:
                continue
            rid = s.req_id
            self.sched.fail(rid, reason)
            self._evict_slot(i)
            self._requests.pop(rid, None)
            self._stream_seeds.pop(rid, None)
            failed.append(rid)
        return failed

    def _degrade_to_dense(self, reason: str) -> List[int]:
        """The paged -> dense rung of the degradation ladder: the block
        pool failed validation, so the engine abandons the paged layout
        rather than write through a damaged page mapping.  In-flight
        requests fail (their pages are suspect); pending requests admit
        into a new dense cache; the switch is recorded as an obs provenance
        Decision with origin ``degraded(paged->dense)`` and a flight dump.

        The dense chunk reads other buffers than the captured paged one, so
        the engine's graphs are dropped and the dense chunk is captured
        anew; the warm baseline is reset, so that capture is not counted
        as a re-capture after warm-up (the run marks the engine warm again
        when it completes)."""
        self._n_degradations += 1
        log.warning("KV block pool failed validation (%s); degrading "
                    "kv_layout paged -> dense", reason)
        failed = self._fail_in_flight(f"kv pool corrupt: {reason}")
        record_degradation(
            "kv_layout", "serve.engine",
            key=f"serve|kv_layout|slots={self.slots}|max_seq={self.max_seq}",
            frm="paged", to="dense", layout="dense", note=reason)
        self.kv_layout = "dense"
        if self._graphs is not None:
            self._graphs = ChunkGraphs(self.device)
        self._warm_captures = None
        self.st = None                # free the page pools first
        # ordinary tensors, as at construction: cancel() writes them
        # outside inference mode
        with torch.inference_mode(False):
            self._init_device_state()
        self.sched.pool = None
        return failed

    def _scrub_pages(self, blocks: List[int]) -> None:
        """Zero the pool pages ``blocks`` and the trash page.  Attention's
        masking keeps a masked position's *weight* at zero, but ``0 * NaN``
        is NaN: a poisoned page handed to its next owner would re-poison
        it, and a NaN in the trash page (every lane reads it through its
        sentinel table entries) would poison every co-batched request."""
        idx = _to_device(torch.tensor(sorted(blocks) + [self.kv_blocks]),
                         self.device)
        self.st.cache.k.index_fill_(1, idx, 0.0)
        self.st.cache.v.index_fill_(1, idx, 0.0)

    def _poison_slot_cache(self, slot: int) -> None:
        """Deterministic damage for the ``serve.nan_decode`` drill: fill the
        slot's cached KV with NaN (paged: its pages) so its next decode
        chunk trips the NaN guard, the flaky-HBM poison model."""
        k, v = self.st.cache
        if self.kv_layout == "paged":
            blocks = self.pool.owned(slot)
            if blocks:
                idx = _to_device(torch.tensor(sorted(blocks)), self.device)
                k.index_fill_(1, idx, float("nan"))
                v.index_fill_(1, idx, float("nan"))
            return
        k[:, slot].fill_(float("nan"))
        v[:, slot].fill_(float("nan"))

    def _park_lane(self, slot: int) -> None:
        """Neutralise a freed lane: position past max_seq, so its decode
        writes drop.  Load-bearing for the paged layout: the slot's pages go
        back to the pool at retirement and may be re-issued."""
        self.st.pos[slot].fill_(self.max_seq)

    def _evict_slot(self, slot: int) -> None:
        """Neutralise a lane whose request terminated outside the normal
        retire path (cancel, timeout, failure): park it and drop its
        admission scratch."""
        self._park_lane(slot)
        self._staging.pop(slot, None)
        self._admit_logits.pop(slot, None)

    def _prefill_advance(self, slot: int, rid: int) -> bool:
        """Prefill the next prompt chunk of ``rid`` into ``slot``; True
        when the whole prompt is in the cache.

        Chunks are ``buckets[-1]`` tokens (the prefill-chunk cap); the tail
        is padded to the smallest bucket that fits."""
        r = self._requests[rid]
        plen = len(r.prompt)
        start = self.sched.slots[slot].prefill_pos
        if start == 0:
            self._begin_admit(slot)
        take = min(plen - start, self.buckets[-1])
        bucket = pick_bucket(take, self.buckets)
        # no host sync inside: on the card the span times the enqueue
        with obs.span("serve.prefill_chunk", slot=slot, req_id=rid,
                      bucket=bucket, start=start):
            self._prefill_chunk(slot, r, start, take, bucket)
        return start + take >= plen

    def _prefill_chunk(self, slot: int, r: Request, start: int, take: int,
                       bucket: int) -> None:
        tokens = _prompt_tensor(r.prompt[start:start + take], bucket,
                                self.device)
        lengths = _to_device(torch.tensor([take]), self.device)
        if self.kv_layout == "paged":
            logits, _, _ = self.model.prefill_paged(
                self.params, tokens, self.st.cache,
                self.st.block_tables[slot], None, start, lengths,
                first=start == 0)
        else:
            if start == 0:                    # a fresh zero staging cache
                staging = self.model.init_cache(1, self.max_seq,
                                                device=self.device)
            else:
                staging = self._staging[slot]
            logits, self._staging[slot] = self.model.prefill(
                self.params, tokens, staging, start=start, lengths=lengths,
                attend_cache=start > 0)
        self.n_prefills += 1
        rid = self.sched.slots[slot].req_id
        if (start + take >= len(r.prompt)
                and faults.should_fire("serve.nan_prefill",
                                       req_id=rid) is not None):
            # poison drill: the request's admission logits read as NaN
            logits = torch.full_like(logits, float("nan"))
        self._admit_logits[slot] = logits
        self.sched.prefill_advance(slot, take)

    def _begin_admit(self, slot: int) -> None:
        """Set up the slot for its (possibly multi-chunk) prompt prefill."""
        if self.kv_layout == "paged":
            row = table_row(self.pool.owned(slot), self.max_blocks,
                            self.kv_blocks)
            self.st.block_tables[slot].copy_(
                _to_device(torch.tensor(row, dtype=torch.long), self.device))
        self._park_lane(slot)  # mid-prefill decode writes must drop

    def _finish_admit(self, slot: int, rid: int) -> bool:
        """The prompt is fully cached: install the slot's decode state and
        sample the first token; True if it retired immediately."""
        r = self._requests[rid]
        st = self.st
        logits = self._admit_logits.pop(slot)
        staging = self._staging.pop(slot, None)
        if staging is not None:
            _insert_slot(st.cache, staging, slot)
        gen = st.generators[slot]
        gen.manual_seed(self._stream_seeds[rid])   # the request's stream
        st.temps[slot].fill_(float(r.temperature))
        st.top_ks[slot].fill_(int(r.top_k or 0))
        first = sample_tokens(logits, [gen], st.temps[slot:slot + 1],
                              st.top_ks[slot:slot + 1],
                              sampled=r.temperature > 0.0)
        # one host sync per ADMISSION (not per token): the first token and,
        # with the guard, whether the prompt's logits are finite
        if self.resilience.nan_guard:
            token, finite = torch.stack(
                [first[0], torch.isfinite(logits).all().long()]).tolist()
            if not finite:
                # before the lane joins the decode batch (it stays parked)
                self._quarantine_nan(slot, rid, "non-finite prefill logits",
                                     where="prefill")
                return True
        else:
            token = int(first[0])
        st.tokens[slot:slot + 1].copy_(first)
        st.pos[slot].fill_(len(r.prompt))
        done = self.sched.record_first(slot, token)
        if done:
            self._park_lane(slot)
        elif faults.should_fire("serve.nan_decode", req_id=rid) is not None:
            # poison drill: NaN the slot's cached KV so the next decode
            # chunk trips the in-chunk NaN guard for this lane
            self._poison_slot_cache(slot)
        return done


class ShardedEngine(ContinuousEngine):
    """The continuous engine with its slots sharded over a mesh: not
    ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "ShardedEngine comes with mesh and sharded serving (ROADMAP.md "
            "queue 1 item 7)")
