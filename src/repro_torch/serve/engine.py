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

Three engines share that chunk:

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
    boundaries;
  * :class:`ShardedEngine`: the continuous engine over a mesh axis, each
    rank decoding its own share of the slots.

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
``tuning_cache`` (a path or an ``autotune.TuningCache``) runs every
request under ``compiler.options(tuning_cache=..., kv_layout=...)`` and at
its warm boundary audits the measured records of that cache
(``obs.audit_cache``).  As the reference's, it also warms up at
construction, in an ``engine.warm`` span: it pre-tunes the model's op
shapes (``autotune.warm_for_model`` at ``max_seq`` and ``batch_sizes``,
the results in ``self.tuned``) and, where an AOT directory resolves
(``aot="auto"``: the cache's path plus ``.aot``; a path; None or False:
none), loads a prior engine's programs from it, stages the executor of
every shape of ``autotune.model_kernel_shapes`` under its options scope
(``ops.warm_kernel``; a shape with no strategy space is skipped) and
exports the keys it staged itself, never another engine's of the same
process.  The port's model path (K1, K3, the projections) dispatches
through no DPIA row, so nothing on it reads these programs: the
reference stages them all the same, and so does the port.

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

:class:`ShardedEngine` is the continuous engine with its slots sharded over
a ``torch.distributed`` mesh axis: one process a position, the weights
replicated, one ``all_gather`` a chunk boundary, and failure domains that
survive a lost host by evacuating its slots and shrinking the mesh."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import logging
import math
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch import compiler, obs
from repro_torch.ft.resilience import Watchdog
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
    prompt: Sequence[int]        # (s,) token ids (a list or a 1-D tensor),
    #                              or (s, K) for an audio model's codebooks
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
    # the model's serving cache: dense, or paged (KV page pools, the
    # recurrent state slot-indexed)
    cache: object
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


def _insert_slot(big, small, slot: int) -> None:
    """Copy a batch-1 cache tree (a KVCache, a recurrent state, the
    hybrid's dict) into the engine's at ``slot``, in place (the reference
    returns an updated copy)."""
    for bl, sl in zip(_leaves(big), _leaves(small)):
        axis = _slot_axis(bl, sl)
        if axis is None:
            bl.copy_(sl)
        else:
            bl.select(axis, slot).copy_(sl.select(axis, 0))


def _prompt_tensor(prompt, length: int, device) -> torch.Tensor:
    """A (1, length[, K]) token tensor: ``prompt`` (s[, K]) right-padded
    with token 0."""
    toks = torch.as_tensor(prompt, dtype=torch.long)
    out = torch.zeros((1, length) + tuple(toks.shape[1:]), dtype=torch.long)
    out[0, :len(toks)] = toks
    return _to_device(out, device)


def _step_tokens(tok: torch.Tensor, cfg) -> torch.Tensor:
    """A decode step's input from the lanes' sampled tokens (b,): (b, 1),
    or (b, 1, K) with the token on every codebook (the reference's
    broadcast)."""
    tok = tok[:, None]
    if cfg.n_codebooks:
        tok = tok[..., None].expand(-1, 1, cfg.n_codebooks)
    return tok


# ---------------------------------------------------------------------------
# shared engine core
# ---------------------------------------------------------------------------

class _EngineBase:
    """Model/params, the one decode chunk function and its graphs, the
    chunk's resilience wrapping, the work counters and the re-capture
    detector."""

    def __init__(self, model: Model, params, *, max_seq: int, chunk: int,
                 graph: bool = True, kv_layout: str = "dense",
                 tuning_cache=None, batch_sizes=(1, 8), aot="auto",
                 resilience: Optional[ResilienceConfig] = None):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.chunk = chunk
        self.kv_layout = kv_layout
        self.tuning_cache = tuning_cache
        self.tuned: Dict[str, dict] = {}
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
        if tuning_cache is not None:
            self._warm(batch_sizes, aot)

    # -- autotune + AOT warm-up ----------------------------------------------

    def _aot_dir(self, aot) -> Optional[str]:
        """The AOT directory of ``aot``: None or False none; a path itself;
        ``"auto"`` the tuning cache's path plus ``.aot`` (none for a cache
        with no path)."""
        if aot is None or aot is False:
            return None
        if isinstance(aot, str) and aot != "auto":
            return aot
        path = getattr(self.tuning_cache, "path", None) or (
            self.tuning_cache if isinstance(self.tuning_cache, str) else None)
        return (str(path) + ".aot") if path else None

    def _warm(self, batch_sizes, aot) -> None:
        """Pre-tune the model's op shapes and stage their executors, loaded
        from and exported to the AOT directory (module docstring)."""
        from repro_torch import autotune
        from repro_torch.kernels import ops
        cfg = self.model.cfg
        with obs.span("engine.warm", max_seq=self.max_seq,
                      batch_sizes=str(tuple(batch_sizes))):
            self.tuned = autotune.warm_for_model(
                cfg, max_seq=self.max_seq, cache=self.tuning_cache,
                batch_sizes=batch_sizes)
            aot_dir = self._aot_dir(aot)
            if aot_dir is None:
                return
            store = compiler.executor_cache()
            store.load_aot(aot_dir)   # a prior engine's programs: no staging
            before = set(store.keys())
            with self._options_scope():
                for kernel, shape in autotune.model_kernel_shapes(
                        cfg, max_seq=self.max_seq, batch_sizes=batch_sizes):
                    try:
                        ops.warm_kernel(kernel, **shape)
                    except (ValueError, AssertionError):
                        continue      # a shape with no valid strategy space
            # only the keys this engine staged: a process's shared cache must
            # not leak another model's programs into this directory
            store.save_aot(aot_dir, keys=set(store.keys()) - before)

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
            step_tok = _step_tokens(tok, model.cfg)
            if view is None:
                logits, _ = model.decode_step(params, step_tok, st.cache,
                                              pos)
            else:
                logits, _, view = model.decode_step(
                    params, step_tok, st.cache, pos, block_tables=bt,
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

    def _run_chunk(self, st: _DecodeState, sampled: bool) -> None:
        """Enqueue one chunk: a graph replay on the card unless
        ``graph=False``."""
        if self._graphs is None:
            self._chunk_fn(st, sampled)
        else:
            key = (st.tokens.shape[0], self.chunk, sampled)
            self._graphs.run(key, functools.partial(self._chunk_fn, st,
                                                    sampled), st.generators)
            self._check_recaptures()
        self.n_decode_steps += self.chunk
        self.n_chunks += 1

    def _decode_chunk(self, st: _DecodeState, sampled: bool):
        """Run one chunk and return its (b, chunk) tokens and each lane's
        NaN flag: the chunk's one host sync reads both."""
        self._run_chunk(st, sampled)
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

    ``tuning_cache``, ``batch_sizes`` and ``aot``: the warm-up at
    construction (module docstring).  ``resilience`` wraps each chunk
    (fault sites, watchdog, retry before dispatch); the chunk computes the
    NaN guard's flags as the continuous engine's does, and, as in the
    reference, the static engine does not act on them: it has no lane to
    quarantine a request from."""

    def __init__(self, model: Model, params, max_seq: int = 512,
                 chunk: int = 8, *, graph: bool = True, tuning_cache=None,
                 batch_sizes=(1, 8), aot="auto",
                 resilience: Optional[ResilienceConfig] = None):
        super().__init__(model, params, max_seq=max_seq, chunk=chunk,
                         graph=graph, tuning_cache=tuning_cache,
                         batch_sizes=batch_sizes, aot=aot,
                         resilience=resilience)
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
            for t in _leaves(st.cache):
                t.zero_()
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
                 tuning_cache=None, batch_sizes=None, aot="auto",
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
                         tuning_cache=tuning_cache,
                         batch_sizes=batch_sizes or (1, slots), aot=aot,
                         resilience=resilience)
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

    @property
    def _lanes(self) -> int:
        """Decode lanes this engine's buffers hold: one a slot (the sharded
        engine holds its own slots' lanes only)."""
        return self.slots

    def _lane(self, slot: int) -> Optional[int]:
        """The lane of ``slot`` in this engine's buffers (None: another
        rank's slot)."""
        return slot

    def _init_device_state(self) -> None:
        """Build the chunk's buffers for the current ``kv_layout``, every
        lane parked.  A captured graph reads the buffers it was captured on,
        so only construction and the paged -> dense degradation (which
        drops the graphs) may call this; the chunk-failure rebuild works in
        place (:meth:`_rebuild_in_place`)."""
        b, dev = self._lanes, self.device
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
        # the slot axis of each leaf of the slot-indexed state
        # (:meth:`_slot_state`), in ``_leaves`` order: where a 2-slot
        # cache's shape differs from a 1-slot one's (meta tensors)
        if self.kv_layout == "paged":
            two, one = (self.model.init_prefill_state(n, "meta")
                        for n in (2, 1))
        else:
            two, one = (self.model.init_cache(n, self.max_seq, "meta")
                        for n in (2, 1))
        self._row_axes: List[int] = [
            _slot_axis(x, y) for x, y in zip(_leaves(two), _leaves(one))]
        # a prompt's admission state until it installs: dense, its batch-1
        # cache; paged, its batch-1 recurrent state (recurrent families)
        self._staging: Dict[int, object] = {}
        self._admit_logits: Dict[int, torch.Tensor] = {}
        # slots the prompt poison drill hit (read by the sharded engine,
        # which clears it every boundary)
        self._nan_prefill: set = set()

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
        for t in _leaves(st.cache):
            t.zero_()
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
        self._nan_prefill.clear()

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

    def _expired(self):
        """The deadline sweep: ``(freed slot or None, req_id)`` per
        expiry."""
        return self.sched.check_deadlines()

    def _boundary_prelude(self) -> List[int]:
        """A boundary's work before its prompt prefills: the deadline
        sweep, the block pool's check, admissions.  Returns the request ids
        that ended."""
        finished: List[int] = []
        for slot, rid in self._expired():
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
        return finished

    def _release(self, finished: List[int]) -> None:
        """Drop the prompts and stream seeds of requests that ended."""
        for rid in finished:
            self._requests.pop(rid, None)
            self._stream_seeds.pop(rid, None)

    def _ending(self) -> set:
        """Slots whose request ends at this boundary's first token but is
        still to be recorded: none here (:meth:`_finish_admit` records it;
        the sharded engine records it after its gather)."""
        return set()

    def _after_chunk(self) -> List[int]:
        """Records due once the boundary's chunk has run, before its tokens
        are: none here (the sharded engine records its admissions' first
        tokens from its gather).  Returns the request ids that ended."""
        return []

    def _step_chunk(self) -> List[int]:
        finished = self._boundary_prelude()
        for slot, rid in self.sched.prefilling():
            if self._prefill_advance(slot, rid):      # one chunk per boundary
                if self._finish_admit(slot, rid):
                    finished.append(rid)
        ending = self._ending()
        busy = [i for i in self.sched.busy_slots() if i not in ending]
        failure = None
        if busy:
            rids = [self.sched.slots[i].req_id for i in busy]
            # the graph key's ``sampled``, from host values: no device sync
            sampled = any(self._requests[rid].temperature > 0.0
                          for rid in rids)
            slot_of = dict(zip(rids, busy))
            req_ids = ",".join(str(s.req_id)
                               for i, s in enumerate(self.sched.slots)
                               if not s.free and i not in ending)
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
                failure = e
        finished.extend(self._after_chunk())
        if failure is not None:
            finished.extend(self._quarantine_chunk_failure(failure))
        elif busy:
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
        self._release(finished)               # release prompts at retire
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
        kv, _ = self.model.split_paged_cache(self.st.cache)
        if kv is None:                  # ssm: no pool
            return
        idx = _to_device(torch.tensor(sorted(blocks) + [self.kv_blocks]),
                         self.device)
        for pool in _leaves(kv):
            pool.index_fill_(1, idx, 0.0)

    def _poison_slot_cache(self, slot: int) -> None:
        """Deterministic damage for the ``serve.nan_decode`` drill: fill the
        slot's cached state with NaN so its next decode chunk trips the NaN
        guard, the flaky-HBM poison model.  Dense: the slot's whole cache,
        recurrent rows included; paged: only the slot's pages (nothing for
        ssm, which has none), as the reference does."""
        lane = self._lane(slot)
        if lane is None:
            return
        if self.kv_layout == "paged":
            kv, _ = self.model.split_paged_cache(self.st.cache)
            blocks = self.pool.owned(slot)
            if blocks and kv is not None:
                idx = _to_device(torch.tensor(sorted(blocks)), self.device)
                for pool in _leaves(kv):
                    pool.index_fill_(1, idx, float("nan"))
            return
        for t, axis in zip(_leaves(self.st.cache), self._row_axes):
            if t.is_floating_point():
                t.select(axis, lane).fill_(float("nan"))

    def _slot_state(self):
        """The slot-indexed part of the cache: the whole dense cache, or
        the paged cache's recurrent state (None for the transformer
        families)."""
        if self.kv_layout == "paged":
            return self.model.split_paged_cache(self.st.cache)[1]
        return self.st.cache

    def _park_lane(self, slot: int) -> None:
        """Neutralise a freed lane: position past max_seq, so its decode
        writes drop.  Load-bearing for the paged layout: the slot's pages go
        back to the pool at retirement and may be re-issued."""
        lane = self._lane(slot)
        if lane is not None:
            self.st.pos[lane].fill_(self.max_seq)

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

    def _prefill_logits(self, slot: int, lane: int, r: Request, start: int,
                        take: int, bucket: int) -> torch.Tensor:
        """Prefill ``take`` prompt tokens from ``start`` into ``slot``'s
        lane (paged: its pages; dense: its staging cache) and return their
        last-position logits."""
        tokens = _prompt_tensor(r.prompt[start:start + take], bucket,
                                self.device)
        lengths = _to_device(torch.tensor([take]), self.device)
        self.n_prefills += 1
        if self.kv_layout == "paged":
            kv, _ = self.model.split_paged_cache(self.st.cache)
            logits, _, _ = self.model.prefill_paged(
                self.params, tokens, kv, self.st.block_tables[lane],
                self._staging.get(slot), start, lengths, first=start == 0)
            return logits
        if start == 0:                        # a fresh zero staging cache
            staging = self.model.init_cache(1, self.max_seq,
                                            device=self.device)
        else:
            staging = self._staging[slot]
        logits, self._staging[slot] = self.model.prefill(
            self.params, tokens, staging, start=start, lengths=lengths,
            attend_cache=start > 0)
        return logits

    def _prefill_chunk(self, slot: int, r: Request, start: int, take: int,
                       bucket: int) -> None:
        """Prefill one prompt chunk on the slot's owner (every lane is this
        engine's; a sharded engine's other ranks only advance the
        schedule) and keep the last chunk's logits for admission."""
        lane = self._lane(slot)
        logits = None
        if lane is not None:
            logits = self._prefill_logits(slot, lane, r, start, take, bucket)
        rid = self.sched.slots[slot].req_id
        # every rank of a sharded engine polls the site: one plan, one
        # schedule
        if (start + take >= len(r.prompt)
                and faults.should_fire("serve.nan_prefill",
                                       req_id=rid) is not None):
            # poison drill: the request's admission logits read as NaN
            self._nan_prefill.add(slot)
            if logits is not None:
                logits = torch.full_like(logits, float("nan"))
        if logits is not None:
            self._admit_logits[slot] = logits
        self.sched.prefill_advance(slot, take)

    def _begin_admit(self, slot: int) -> None:
        """Set up the slot for its (possibly multi-chunk) prompt prefill."""
        lane = self._lane(slot)
        if self.kv_layout == "paged" and lane is not None:
            row = table_row(self.pool.owned(slot), self.max_blocks,
                            self.kv_blocks)
            self.st.block_tables[lane].copy_(
                _to_device(torch.tensor(row, dtype=torch.long), self.device))
            # recurrent families: a fresh zero state the prompt's chunks
            # carry, installed into the lane at admission
            state = self.model.init_prefill_state(1, self.device)
            if state is not None:
                self._staging[slot] = state
        self._park_lane(slot)  # mid-prefill decode writes must drop

    def _install_lane(self, slot: int, lane: int, rid: int):
        """Install ``slot``'s decode state in ``lane`` (its staged cache,
        its stream's generator, temperature and top-k) and sample its
        first token, no host sync: returns the token (a 1-element device
        tensor) and the prompt's logits."""
        r = self._requests[rid]
        st = self.st
        logits = self._admit_logits.pop(slot)
        staging = self._staging.pop(slot, None)
        if staging is not None:
            _insert_slot(self._slot_state(), staging, lane)
        gen = st.generators[lane]
        gen.manual_seed(self._stream_seeds[rid])   # the request's stream
        st.temps[lane].fill_(float(r.temperature))
        st.top_ks[lane].fill_(int(r.top_k or 0))
        first = sample_tokens(logits, [gen], st.temps[lane:lane + 1],
                              st.top_ks[lane:lane + 1],
                              sampled=r.temperature > 0.0)
        st.tokens[lane:lane + 1].copy_(first)
        return first, logits

    def _nan_decode_drill(self, slot: int, rid: int) -> None:
        """Poison drill: NaN the slot's cached KV (on its owner) so its
        next decode chunk trips the in-chunk NaN guard for the lane."""
        if faults.should_fire("serve.nan_decode", req_id=rid) is not None:
            self._poison_slot_cache(slot)

    def _finish_admit(self, slot: int, rid: int) -> bool:
        """The prompt is fully cached: install the slot's decode state and
        sample the first token; True if it retired immediately."""
        first, logits = self._install_lane(slot, slot, rid)
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
        self.st.pos[slot].fill_(len(self._requests[rid].prompt))
        done = self.sched.record_first(slot, token)
        if done:
            self._park_lane(slot)
        else:
            self._nan_decode_drill(slot, rid)
        return done


# ---------------------------------------------------------------------------
# sharded continuous batching (data-parallel slots over a mesh axis)
# ---------------------------------------------------------------------------

def _leaves(node) -> List[torch.Tensor]:
    """The tensors of a params tree, in a fixed order."""
    if isinstance(node, torch.Tensor):
        return [node]
    if isinstance(node, dict):
        return [t for k in sorted(node) for t in _leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [t for x in node for t in _leaves(x)]
    return []


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of a tensor's bit patterns as int64 (a checksum of its
    bits), in pieces of 16 M elements to bound the temporary."""
    v = t.detach().reshape(-1).view(_INT_OF_SIZE[t.element_size()])
    out = torch.zeros((), dtype=torch.int64, device=t.device)
    for piece in v.split(1 << 24):
        out += piece.to(torch.int64).sum()
    return out


class _Reader:
    """Reads typed tensors back out of a flat uint8 buffer."""

    def __init__(self, buf: torch.Tensor):
        self.buf, self.at = buf, 0

    def take(self, shape, dtype) -> torch.Tensor:
        n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
        # a copy: a view would need the offset aligned to the dtype
        out = self.buf[self.at:self.at + n].clone().view(dtype).reshape(shape)
        self.at += n
        return out


class ShardedEngine(ContinuousEngine):
    """Continuous batching with the slot axis sharded over a named mesh
    axis (``data`` by default), SPMD over ``torch.distributed``: one
    process a position of the axis, every rank holding the whole model.

    Rank ``r`` of the axis (its coordinate) holds the decode state of slots
    ``[r*per, (r+1)*per)``, ``per = slots / n``: its KV cache rows (dense)
    or its lanes' block tables (paged), tokens, positions, temperatures,
    top-k and one generator a lane.  Its decode chunk is its own, at batch
    ``per`` (a CUDA graph on the card), and runs no collective.  The weights
    are replicated: at build time one ``all_gather`` of a checksum of each
    leaf's bits proves every rank holds the same, or raises.

    Every rank runs the same :class:`Scheduler` over all ``slots``; requests
    are submitted on every rank in the same order (and cancelled on every
    rank alike), so admission, deferral, retirement and evacuation are
    decided the same everywhere.  A slot's prompt prefills on its owner
    only, at batch 1.  At each chunk boundary one ``all_gather`` over the
    axis group exchanges each rank's chunk buffer: its lanes' tokens and
    NaN flags (the chunk's one host sync), the first token and prompt-NaN
    flag of every lane admitted at the boundary, and the rank's clock.  It
    is the boundary's one collective (``stats()["mesh"]
    ["boundary_gathers"]``); there is none between boundaries.  So a
    request admitted at a boundary has its first token recorded, or is
    quarantined for non-finite prompt logits, after that boundary's chunk
    rather than before it; its lane decodes in the chunk all the same, and
    its tokens are the unsharded engine's.  Fault sites are polled by every
    rank at the same points (``repro_torch.testing.faults``).

    Paged: every rank holds the whole page pool and the replicated
    scheduler's block allocator; a rank writes only its own lanes' pages,
    so the tables agree across ranks.

    Deadlines run on the mesh clock: each gather carries each rank's time
    since the build, the clock is their largest, and a request is timed
    from the first boundary after its submission (a deadline can expire up
    to a boundary late, never early), so every rank expires the same
    requests at the same boundary.

    ``hosts`` turns on failure domains
    (:class:`repro_torch.serve.domains.FailureDomains`): at every boundary
    the engine polls for a lost or straggling host (the ``mesh.host_lost``
    / ``mesh.host_slow`` / ``collective.timeout`` fault sites stand in for
    heartbeats in drills).  On a loss the dead host's slots are evacuated
    to the queue front in ascending slot order; the survivors make a mesh
    of their own and re-place the state under its mapping (``per`` grows,
    so surviving rows move between ranks: one ``all_gather`` of the rows,
    paged of the live slots' pages, over the survivors' group, on the card
    under NCCL), the lost rows zeroed; the chunk graph is
    captured anew at the new ``per`` and the warm baseline reset, so that
    capture is not counted as drift; the tuner re-ranks mesh candidates
    for the new descriptor, and the shrink is recorded as provenance origin
    ``degraded(mesh(data=4)->mesh(data=2))``, one ``host_lost`` flight dump
    and the journal's evacuate and shrink records.  A rank whose host is
    lost leaves: ``left`` turns true, ``run`` returns None there and
    ``step_chunk`` raises; it writes nothing more.  Survivors keep their
    tokens; evacuees re-decode from their prompts to the same tokens.

    ``journal`` given as a path: every rank journals its replicated
    scheduler to a file of its own, ``<path>.rank<global rank>`` (one file
    written by several processes would need them ordered at every
    boundary, a second collective); any survivor's file replays the run.
    """

    def __init__(self, model: Model, params, max_seq: int = 512,
                 slots: int = 8, chunk: int = 8, min_bucket: int = 16, *,
                 tuning_cache=None, batch_sizes=None, aot="auto",
                 mesh=None, mesh_axis: str = "data",
                 kv_layout: str = "dense", block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 journal=None, hosts=None, host_slow_threshold: int = 3,
                 graph: bool = True):
        from repro_torch.mesh.strategy import axis_sizes
        from repro_torch.sharding import ctx
        mesh = mesh if mesh is not None else ctx.get_mesh()
        if mesh is None:
            raise ValueError(
                "ShardedEngine needs a mesh: pass mesh=... or set the "
                "process mesh context (repro_torch.sharding.ctx.set_mesh)")
        sizes = axis_sizes(mesh)
        if mesh_axis not in sizes:
            raise ValueError(f"mesh axis {mesh_axis!r} not in mesh axes "
                             f"{list(sizes)}")
        n_shards = int(sizes[mesh_axis])
        if slots % n_shards != 0:
            raise ValueError(f"slots ({slots}) must be divisible by mesh "
                             f"axis {mesh_axis!r} of size {n_shards}")
        self.mesh_axis = mesh_axis
        self._place(mesh)
        self.domains = None
        if hosts is not None:
            from repro_torch.serve.domains import FailureDomains
            self.domains = FailureDomains(mesh, axis=mesh_axis, hosts=hosts,
                                          slow_threshold=host_slow_threshold)
        if journal is not None and not isinstance(journal,
                                                  SchedulerJournal):
            import torch.distributed as dist
            journal = f"{journal}.rank{dist.get_rank()}"
        self.left = False
        self._n_host_losses = 0
        self._n_gathers = 0
        self._gather_s = 0.0
        self._captures_at_shrink: Optional[int] = None
        self._pending_first: List[tuple] = []
        self._table: Optional[List[List[int]]] = None
        self._mesh_now = 0.0
        self._stamped: Dict[int, float] = {}
        self._unstamped: List[int] = []
        super().__init__(model, params, max_seq=max_seq, slots=slots,
                         chunk=chunk, min_bucket=min_bucket,
                         kv_layout=kv_layout, block_size=block_size,
                         kv_blocks=kv_blocks, prefill_chunk=prefill_chunk,
                         graph=graph, tuning_cache=tuning_cache,
                         batch_sizes=batch_sizes, aot=aot,
                         resilience=resilience, journal=journal)
        self._check_replicas()
        self._epoch = time.perf_counter()

    # -- placement -----------------------------------------------------------

    def _place(self, mesh) -> None:
        """Take ``mesh``'s axis group, size and this rank's coordinate; the
        order of the group's ranks along the axis (a gather's output is in
        group-rank order)."""
        import numpy as np
        import torch.distributed as dist
        from repro_torch.mesh.strategy import axis_sizes
        self.mesh = mesh
        self._group = mesh.get_group(self.mesh_axis)
        self._n = axis_sizes(mesh)[self.mesh_axis]
        self._index = mesh.get_local_rank(self.mesh_axis)
        dim = list(mesh.mesh_dim_names).index(self.mesh_axis)
        coord = {int(r): idx[dim]
                 for idx, r in np.ndenumerate(mesh.mesh.cpu().numpy())}
        order = [coord[r] for r in dist.get_process_group_ranks(self._group)]
        self._by_index = [order.index(i) for i in range(self._n)]
        self._host_exchange = dist.get_backend(self._group) != "nccl"

    @property
    def _lanes(self) -> int:
        return self.slots // self._n

    def _lane(self, slot: int) -> Optional[int]:
        lane = slot - self._index * self.per
        return lane if 0 <= lane < self.per else None

    def _init_device_state(self) -> None:
        self.per = self._lanes
        super()._init_device_state()
        # the chunk writes its tokens and NaN flags into the first columns
        # (st.out is a view); admission adds a lane's first token and its
        # prompt-NaN flag: the buffer one boundary gather exchanges
        self._xbuf = torch.zeros((self.per, self.chunk + 3),
                                 dtype=torch.long, device=self.device)
        self.st.out = self._xbuf[:, :self.chunk + 1]

    @property
    def _xdev(self) -> torch.device:
        """Where the axis group's backend exchanges tensors: the host for
        gloo, this engine's card for NCCL (which takes no host tensor)."""
        return torch.device("cpu") if self._host_exchange else self.device

    def _all_gather(self, t: torch.Tensor):
        """``t`` from every rank of the axis group, moved to :attr:`_xdev`
        first, as a list in axis order on that device, and the seconds the
        gather took: CUDA events around a gather of card tensors (its
        device time), else the host clock around the call (waiting for the
        slowest rank included)."""
        import torch.distributed as dist
        t = t.to(self._xdev)
        out = [torch.empty_like(t) for _ in range(self._n)]
        if t.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dist.all_gather(out, t, group=self._group)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            dist.all_gather(out, t, group=self._group)
            dt = time.perf_counter() - t0
        return [out[g] for g in self._by_index], dt

    def _check_replicas(self) -> None:
        """One ``all_gather`` of a checksum of each weight leaf's bits:
        every rank must hold the same weights."""
        sums = torch.stack([_bits_sum(t) for t in _leaves(self.params)])
        table, _ = self._all_gather(sums)
        differ = [i for i in range(self._n)
                  if not torch.equal(table[i], table[self._index])]
        if differ:
            raise ValueError(
                f"ShardedEngine: the weights differ across mesh axis "
                f"{self.mesh_axis!r}: positions {differ} hold other bits "
                f"than position {self._index} (a checksum a leaf)")

    # -- API -----------------------------------------------------------------

    def submit(self, request: Request, stream: Optional[int] = None) -> int:
        rid = super().submit(request, stream)
        self._unstamped.append(rid)        # timed from the next boundary
        return rid

    def run_results(self, requests: List[Request],
                    seed: int = 0) -> Optional[List[RequestResult]]:
        """:meth:`ContinuousEngine.run_results`; None on a rank whose host
        was lost during the run (it left the mesh)."""
        def run():
            self._run_seed = seed
            rids = [self.submit(r, stream=i) for i, r in enumerate(requests)]
            while not self.sched.idle and not self.left:
                self.step_chunk()
            if self.left:
                return None
            return [self.take_result(rid) for rid in rids]
        return self._warm_run(run, slots=self.slots)

    def run(self, requests: List[Request],
            seed: int = 0) -> Optional[List[List[int]]]:
        results = self.run_results(requests, seed)
        return (None if results is None
                else [list(r.tokens) for r in results])

    def step_chunk(self) -> List[int]:
        if self.left:
            raise RuntimeError("this rank's host was lost: it left the "
                               "sharded engine's mesh")
        return super().step_chunk()

    def stats(self) -> dict:
        from repro_torch.mesh.strategy import descriptor
        out = super().stats()
        out["mesh"] = {"axis": self.mesh_axis, "shards": self._n,
                       "devices": int(self.mesh.mesh.numel()),
                       "descriptor": descriptor(self.mesh),
                       "index": self._index, "lanes": self.per,
                       "boundary_gathers": self._n_gathers,
                       "gather_s": self._gather_s}
        if self._captures_at_shrink is not None and self._graphs is not None:
            out["mesh"]["captures_since_shrink"] = (
                self._graphs.captures - self._captures_at_shrink)
        if self.domains is not None:
            out["mesh"]["hosts"] = self.domains.describe()
        out["resilience"]["host_losses"] = self._n_host_losses
        return out

    # -- the chunk-boundary loop ---------------------------------------------

    def _expired(self):
        return self.sched.check_deadlines(now=self._mesh_now,
                                          since=self._stamped)

    def _release(self, finished: List[int]) -> None:
        super()._release(finished)
        for rid in finished:
            self._stamped.pop(rid, None)

    def _step_chunk(self) -> List[int]:
        self._domain_sweep()
        if self.left:
            return []
        self._pending_first, self._table = [], None
        self._nan_prefill.clear()
        return super()._step_chunk()

    def _ending(self) -> set:
        return {slot for slot, _, ends in self._pending_first if ends}

    def _decode_chunk(self, st: _DecodeState, sampled: bool):
        """Run this rank's chunk, then the boundary's gather (its host
        sync): every slot's tokens and NaN flag."""
        self._run_chunk(st, sampled)
        self._table = self._exchange()
        return ([row[:self.chunk] for row in self._table],
                [bool(row[self.chunk]) for row in self._table])

    def _after_chunk(self) -> List[int]:
        """The boundary's gather when no chunk ran (every rank takes part
        in it), then the first tokens of the slots admitted at it."""
        if self._table is None:
            self._table = self._exchange()
        return self._record_firsts(self._table)

    def _exchange(self) -> List[List[int]]:
        """The boundary's one collective: every rank's exchange buffer and
        clock, gathered over the axis.  Returns one row a slot (tokens, NaN
        flag, first token, prompt-NaN flag); advances the mesh clock and
        stamps the requests submitted since the last boundary."""
        clock = torch.tensor([int((time.perf_counter() - self._epoch)
                                  * 1e6)])
        # gloo: the copy to the host is the chunk's host sync
        payload = torch.cat([self._xbuf.reshape(-1).to(self._xdev),
                             _to_device(clock, self._xdev)])
        rows, dt = self._all_gather(payload)
        table = torch.stack(rows).cpu()
        self._gather_s += dt
        self._n_gathers += 1
        obs.histogram("serve.mesh_gather_s").observe(dt)
        self._mesh_now = int(table[:, -1].max()) / 1e6
        for rid in self._unstamped:
            self._stamped[rid] = self._mesh_now
        self._unstamped = []
        return table[:, :-1].reshape(self.slots, self.chunk + 3).tolist()

    # -- admission: prefill on the owner, records after the gather ----------

    def _finish_admit(self, slot: int, rid: int) -> bool:
        """The prompt is fully cached.  The owner installs the lane's
        decode state and samples the first token into the exchange buffer
        (no host sync); every rank notes the admission, to be recorded
        after the boundary's gather (:meth:`_record_firsts`), so none ends
        here.  A lane whose request ends at its first token
        (``max_new_tokens <= 1``, or a poisoned prompt under the NaN guard)
        is parked now, and so is one whose prompt logits are not finite."""
        guard = self.resilience.nan_guard
        ends = (self.sched.slots[slot].remaining <= 1
                or (guard and slot in self._nan_prefill))
        lane = self._lane(slot)
        if lane is not None:
            first, logits = self._install_lane(slot, lane, rid)
            st = self.st
            admit = self._xbuf[lane, self.chunk + 1:]
            admit[0].copy_(first[0])
            admit[1].copy_(~torch.isfinite(logits).all())
            plen = len(self._requests[rid].prompt)
            if ends:
                st.pos[lane].fill_(self.max_seq)
            elif guard:                # a non-finite prompt stays parked
                st.pos[lane:lane + 1].copy_(
                    admit[1:2] * (self.max_seq - plen) + plen)
            else:
                st.pos[lane].fill_(plen)
        self._pending_first.append((slot, rid, ends))
        if not ends:
            self._nan_decode_drill(slot, rid)
        return False

    def _record_firsts(self, table: List[List[int]]) -> List[int]:
        """Record the first token of every slot admitted at this boundary,
        from the gather; quarantine those whose prompt logits were not
        finite.  Returns the request ids that ended."""
        out: List[int] = []
        for slot, rid, _ in self._pending_first:
            row = table[slot]
            if self.resilience.nan_guard and row[self.chunk + 2]:
                self._quarantine_nan(slot, rid, "non-finite prefill logits",
                                     where="prefill")
                out.append(rid)
            elif self.sched.record_first(slot, row[self.chunk + 1]):
                self._park_lane(slot)
                out.append(rid)
        self._pending_first = []
        return out

    # -- failure domains: detection -> evacuation -> shrink ------------------

    def _domain_sweep(self) -> None:
        if self.domains is None:
            return
        ev = self.domains.poll()
        if ev is None:
            return
        if ev.kind == "slow":
            obs.counter("serve.host_slow").inc()
            obs.event("serve.host_slow", host=ev.host,
                      strikes=self.domains.slow_count(ev.host),
                      cause=ev.cause)
            log.warning("%s", ev.cause)
            if ev.delay_s:
                time.sleep(ev.delay_s)   # the drill's injected stall
            return
        self._handle_host_loss(ev.host, ev.cause)

    def _handle_host_loss(self, host: int, cause: str) -> None:
        """Survive the loss of ``host``: evacuate its slots to the queue
        front, shrink the mesh onto the survivors, re-place the state,
        re-tune for the new descriptor, and record the shrink as a
        degradation (one provenance origin and one ``host_lost`` flight
        dump per event).  A rank of a lost host leaves."""
        import torch.distributed as dist
        from repro_torch.mesh.strategy import descriptor
        dom = self.domains
        frm = descriptor(self.mesh)
        lost_slots = set(dom.slots_of_host(host, self.slots))
        # the slot axis must divide the surviving positions; when it would
        # not (uneven host sizes), drop further hosts from the tail until
        # it does: a smaller servable mesh beats an unshardable one
        drop = [host]

        def _size_after() -> int:
            return sum(len(g) for h, g in enumerate(dom.groups)
                       if dom.alive[h] and h not in drop)

        while _size_after() and self.slots % _size_after() != 0:
            extra = max(h for h in dom.alive_hosts() if h not in drop)
            drop.append(extra)
            lost_slots |= set(dom.slots_of_host(extra, self.slots))
        survivors = [dom.ranks[p] for h, g in enumerate(dom.groups)
                     if dom.alive[h] and h not in drop for p in g]
        me_lost = dist.get_rank() not in survivors
        if me_lost:
            self.journal = None         # a lost host writes nothing more
        self._n_host_losses += 1
        obs.counter("serve.host_losses").inc()
        log.warning("host %d lost (%s): evacuating slots %s and shrinking "
                    "the mesh", host, cause, sorted(lost_slots))
        evacuated: List[int] = []
        # descending slot order + appendleft => evacuees rejoin the queue
        # front in ascending slot order (FIFO among themselves, ahead of
        # never-admitted requests)
        for slot in sorted(lost_slots, reverse=True):
            rid = self.sched.evacuate(slot, reason=cause)
            if rid is None:
                continue
            self._evict_slot(slot)
            evacuated.append(rid)
            if self.journal is not None:
                self.journal.record_evacuate(rid, host)
        for h in drop:
            dom.mark_lost(h)    # raises when no host survives: unservable
        to = f"{self.mesh_axis}={dom.axis_size()}"
        new_mesh = dom.shrunk_mesh()
        if me_lost:
            self._leave()
            return
        obs.event("serve.host_lost", host=host, cause=cause, frm=frm,
                  to=to, evacuated=",".join(str(r) for r in evacuated),
                  dropped_hosts=",".join(str(h) for h in drop))
        self._remesh(new_mesh, sorted(lost_slots))
        record_degradation(
            "mesh", "serve.engine",
            key=f"serve|mesh|slots={self.slots}|axis={self.mesh_axis}",
            frm=f"mesh({frm})", to=f"mesh({to})", note=cause,
            params={"mesh_axis": self.mesh_axis, "hosts": dom.n_hosts,
                    "alive": len(dom.alive_hosts())},
            dump=False)
        # exactly ONE flight dump per host-loss event, reason host_lost
        # (record_degradation's generic dump is suppressed above)
        obs.flight_dump("host_lost", host=host, cause=cause, frm=frm,
                        to=to, evacuated=",".join(str(r) for r in evacuated))
        if self.journal is not None:
            self.journal.record_shrink(frm, to, host, cause)
        self._retune_mesh(to)

    def _leave(self) -> None:
        """This rank's host was lost: stop serving and free the decode
        state (in a drill the process lives on; a dead host's would not)."""
        self.left = True
        self.st = None
        self._staging, self._admit_logits = {}, {}
        if self._graphs is not None:
            self._graphs.reset()
        log.warning("this rank's host was lost: leaving the mesh")

    def _live_pages(self, index: int, per: int) -> List[tuple]:
        """``(slot, pages)`` of every live slot of axis position ``index``
        when each holds ``per`` slots, in slot order: the pages it owns
        (paged), which every rank reads alike off the replicated
        allocator."""
        return [(slot, self.pool.owned(slot))
                for slot in range(index * per, (index + 1) * per)
                if not self.sched.slots[slot].free]

    def _pack_lanes(self, width: int) -> torch.Tensor:
        """This rank's lanes' state as one uint8 buffer on :attr:`_xdev`:
        its axis index; paged, the KV pages its live slots own
        (:meth:`_live_pages`), zero-padded to ``width`` pages (the most
        any position owns) so every rank sends as many bytes; then per
        lane its rows of the slot-indexed state (:meth:`_slot_state`:
        dense, its cache row, recurrent rows included; paged, its
        recurrent rows), a prompt still prefilling sending its staging
        state instead, and which lanes were staged; then per lane its
        token, position, temperature, top-k and generator state."""
        st, dev = self.st, self._xdev

        def as_bytes(t: torch.Tensor) -> torch.Tensor:
            return t.detach().contiguous().reshape(-1).view(
                torch.uint8).to(dev)
        parts = [as_bytes(torch.tensor([self._index]))]
        kv, _ = self.model.split_paged_cache(st.cache)
        if self.kv_layout == "paged" and kv is not None:
            pages = [b for _, owned in self._live_pages(self._index,
                                                        self.per)
                     for b in owned]
            idx = torch.tensor(pages, dtype=torch.long,
                               device=self.device)
            for pool in _leaves(kv):
                live = pool.index_select(1, idx)
                pad = live.new_zeros((live.shape[0], width - len(pages))
                                     + live.shape[2:])
                parts.append(as_bytes(torch.cat([live, pad], dim=1)))
        axes, rows = self._row_axes, _leaves(self._slot_state())
        staged = []
        for lane in range(self.per):
            src = self._staging.get(self._index * self.per + lane)
            staged.append(src is not None)
            mine = ([t.select(a, 0) for t, a in zip(_leaves(src), axes)]
                    if src is not None else
                    [t.select(a, lane) for t, a in zip(rows, axes)])
            parts += [as_bytes(t) for t in mine]
        parts.append(as_bytes(torch.tensor(staged, dtype=torch.uint8)))
        parts += [as_bytes(t) for t in (st.tokens, st.pos, st.temps,
                                        st.top_ks)]
        parts += [as_bytes(g.get_state()) for g in st.generators]
        return torch.cat(parts)

    def _remesh(self, new_mesh, lost_slots: List[int]) -> None:
        """Re-place the decode state under the survivors' mapping with one
        ``all_gather`` of every survivor's lanes (:meth:`_pack_lanes`) over
        their group: each rank takes the rows (dense) or pages (paged) of
        its new slots, the lost ones zeroed (the dead host's memory is
        gone: nothing may depend on it, and survivors provably do not:
        their rows arrive bit for bit)."""
        from repro_torch.mesh.strategy import axis_sizes
        old_per, old_n, lost = self.per, self._n, set(lost_slots)
        with obs.span("serve.remesh", frm=str(axis_sizes(self.mesh)),
                      to=str(axis_sizes(new_mesh))):
            width = (max(sum(len(b) for _, b in self._live_pages(q, old_per))
                         for q in range(old_n))
                     if self.kv_layout == "paged" else 0)
            payload = self._pack_lanes(width)
            pool = self.pool
            if self._graphs is not None:
                self._graphs.reset()        # their buffers go
                self._captures_at_shrink = self._graphs.captures
            self.st = None
            self._place(new_mesh)
            parts = {}
            for buf in self._all_gather(payload)[0]:
                rd = _Reader(buf)
                parts[int(rd.take((1,), torch.long))] = rd
            self._init_device_state()
            self.pool = pool                # the replicated allocator
            st, dev = self.st, self.device
            pools, _ = self.model.split_paged_cache(st.cache)
            pools = _leaves(pools) if self.kv_layout == "paged" else []
            axes, mine = self._row_axes, _leaves(self._slot_state())
            row_of = [(tuple(s for i, s in enumerate(t.shape) if i != a),
                       t.dtype) for t, a in zip(mine, axes)]
            gen_bytes = st.generators[0].get_state().numel()
            fields = {}
            for q, rd in parts.items():
                kv = [rd.take((p.shape[0], width) + tuple(p.shape[2:]),
                              p.dtype) for p in pools]
                rows = [[rd.take(shape, d) for shape, d in row_of]
                        for _ in range(old_per)]
                staged = rd.take((old_per,), torch.uint8).tolist()
                lanes = [rd.take((old_per,), d) for d in
                         (torch.long, torch.long, torch.float32, torch.long)]
                gens = [rd.take((gen_bytes,), torch.uint8)
                        for _ in range(old_per)]
                fields[q] = (kv, rows, staged, lanes, gens)
            for lane in range(self.per):
                slot = self._index * self.per + lane
                s = self.sched.slots[slot]
                if s.free or slot in lost:
                    continue                # zero and parked
                q, old = divmod(slot, old_per)
                kv, rows, staged, lanes, gens = fields[q]
                if pools:
                    # the slot's pages sit in q's buffer after those of q's
                    # earlier live slots
                    at = 0
                    for other, blocks in self._live_pages(q, old_per):
                        if other == slot:
                            break
                        at += len(blocks)
                    blocks = pool.owned(slot)
                    idx = torch.tensor(blocks, dtype=torch.long, device=dev)
                    for buf, theirs in zip(pools, kv):
                        buf.index_copy_(1, idx, theirs[:, at:at + len(
                            blocks)].to(dev))
                if self.kv_layout == "paged":
                    st.block_tables[lane].copy_(torch.tensor(
                        table_row(self.pool.owned(slot), self.max_blocks,
                                  self.kv_blocks)).to(dev))
                if staged[old]:
                    self._staging[slot] = staging = (
                        self.model.init_prefill_state(1, dev)
                        if self.kv_layout == "paged" else
                        self.model.init_cache(1, self.max_seq, dev))
                    for t, a, row in zip(_leaves(staging), axes, rows[old]):
                        t.select(a, 0).copy_(row)
                else:
                    for t, a, row in zip(mine, axes, rows[old]):
                        t.select(a, lane).copy_(row)
                for dst, theirs in zip((st.tokens, st.pos, st.temps,
                                        st.top_ks), lanes):
                    dst[lane].copy_(theirs[old])
                st.generators[lane].set_state(gens[old].cpu())
        # the chunk is captured anew at the new per: reset the warm
        # baseline so that capture is not counted as a re-capture
        self._warm_captures = None

    def _retune_mesh(self, desc: str) -> None:
        """Re-rank mesh-axis candidates for the shrunk descriptor (cache
        keys carry it, so this fills the cold rows the new mesh would
        otherwise tune one by one at dispatch)."""
        if self.tuning_cache is None:
            return
        from repro_torch.serve.domains import retune_for_mesh
        try:
            retune_for_mesh(self.model.cfg, desc, max_seq=self.max_seq,
                            batch_sizes=(1, self.slots),
                            cache=self.tuning_cache)
        except Exception:
            log.debug("mesh retune for %s skipped", desc, exc_info=True)
