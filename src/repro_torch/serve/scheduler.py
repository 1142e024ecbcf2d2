"""Continuous-batching scheduler: host-side bookkeeping for the serving
engine's fixed device slots.

The port's copy of ``repro.serve.scheduler`` (host-only, framework-free).
The engine owns a device-resident batch of ``n_slots`` decode lanes; this
module owns the *policy*: which pending request enters which free slot,
which sequence-length bucket its prompt is padded to, how far its prompt
has been prefilled (chunked prefill spreads a long prompt over successive
chunk boundaries), and when a slot retires.  All decisions happen at chunk
boundaries: inside a chunk the device runs the fused decode chunk with no
host involvement, so the scheduler never sees individual tokens.

With a paged KV cache (:mod:`repro_torch.serve.paged`), admission also
*reserves* blocks: a request is only admitted when the pool can hold its
whole span (prompt + decode budget), and its pages are returned at
retirement.  FIFO order is preserved (no head-of-line skipping), so a
block-starved pool defers admissions rather than reordering them.

Observability (:mod:`repro_torch.obs`), with the reference's names:
counters ``serve.requests_submitted`` / ``_admitted`` / ``_retired`` /
``_<state>``, ``serve.admission_deferrals`` and ``serve.evacuations``;
lifecycle events carrying ``req_id`` (``serve.submit``, ``serve.admit``,
``serve.admission_deferred``, ``serve.first_token``, ``serve.retire``,
``serve.request_terminal``, ``serve.evacuate``); the histograms
``serve.queue_wait_s``, ``serve.ttft_s``, ``serve.e2e_s``,
``serve.request_tokens`` and ``serve.decode_tok_s``; a flight-recorder
dump when a request ends ``failed`` or ``timeout``.  Every clock is the
host's, read at a chunk boundary.

The fault site ``serve.pool_exhausted`` (ctx ``req_id``) in ``admissions``
makes the queue head read as block-starved: it defers, as a full pool
would (``repro_torch.testing.faults``).

The per-request timestamps (``t_submit``, ``t_admit``, ``t_first`` in
``meta``) feed those histograms, and ``pop_result`` reads time to first
token from them.
"""
from __future__ import annotations

import bisect
import dataclasses
import functools
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.serve.resilience import RequestResult
from repro_torch.testing import faults

__all__ = ["seq_buckets", "pick_bucket", "Scheduler"]


@functools.lru_cache(maxsize=None)
def seq_buckets(max_seq: int, min_bucket: int = 16) -> Tuple[int, ...]:
    """Power-of-two prompt buckets up to ``max_seq`` (always included),
    ascending."""
    if max_seq < 1:
        raise ValueError(f"max_seq must be >= 1, got {max_seq}")
    out = []
    b = min_bucket
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(max_seq)
    return tuple(sorted(set(out)))


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket that fits ``n`` tokens (``buckets`` sorted
    ascending, as :func:`seq_buckets` returns them)."""
    i = bisect.bisect_left(buckets, n)
    if i == len(buckets):
        raise ValueError(f"prompt of {n} tokens exceeds the largest bucket "
                         f"{buckets[-1]}")
    return buckets[i]


@dataclasses.dataclass
class _Slot:
    """Host mirror of one device decode lane."""
    req_id: int = -1          # -1: free
    remaining: int = 0        # tokens still owed to the request
    prefill_pos: int = 0      # prompt positions already prefilled
    prefill_len: int = 0      # total prompt length (0 once decoding)

    @property
    def free(self) -> bool:
        return self.req_id < 0

    @property
    def prefilling(self) -> bool:
        """Admitted but the prompt is not fully in the cache yet: the lane
        decodes discarded padding until the last prefill chunk lands."""
        return self.req_id >= 0 and self.prefill_pos < self.prefill_len


class Scheduler:
    """Admission/retirement bookkeeping over ``n_slots`` decode lanes.

    The engine drives it:

      * ``submit(req_id, prompt_len, max_new)`` queues a request;
      * ``admissions()`` (at a chunk boundary) pops pending requests into
        free slots, FIFO, reserving KV blocks first when a ``pool`` is
        attached, and marks them prefilling;
      * ``prefilling()`` lists slots whose prompts still have chunks to
        prefill; the engine advances each by one chunk per boundary and
        records progress with ``prefill_advance(slot, n)``;
      * ``record_first(slot, token)`` accounts the token sampled from the
        (final) prefill logits;
      * ``record_chunk(tokens)`` accounts one decoded chunk for every
        decoding slot (``tokens``: a (n_slots, chunk) host array or list of
        rows) and retires slots whose requests are complete.

    Outputs accumulate in ``outputs[req_id]``; tokens a slot decodes past
    its request's ``max_new_tokens`` are discarded here.  Every request
    ends in exactly one terminal state (``ok|timeout|cancelled|failed``,
    :data:`repro_torch.serve.resilience.STATES`), recorded in
    ``done[req_id]`` and surfaced by ``pop_result``; partial tokens survive
    into the result whatever the state.
    """

    def __init__(self, n_slots: int, pool=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.slots: List[_Slot] = [_Slot() for _ in range(n_slots)]
        self.pending: Deque[int] = deque()
        self.meta: Dict[int, dict] = {}
        self.outputs: Dict[int, List[int]] = {}
        self.done: Dict[int, Tuple[str, str]] = {}  # rid -> (state, reason)
        self.pool = pool  # repro_torch.serve.paged.BlockPool (None: dense)
        # lifecycle totals; a *deferral* is one chunk boundary at which the
        # queue head could not be admitted for lack of KV blocks
        self.n_admits = 0
        self.n_retires = 0
        self.n_deferrals = 0
        self.n_timeouts = 0
        self.n_cancelled = 0
        self.n_failed = 0
        self.n_evacuations = 0

    # -- intake --------------------------------------------------------------

    def submit(self, req_id: int, prompt_len: int, max_new: int, *,
               deadline_s: Optional[float] = None,
               ttft_deadline_s: Optional[float] = None) -> None:
        if req_id in self.meta or req_id in self.done:
            raise ValueError(f"request id {req_id} already submitted")
        self.meta[req_id] = {"prompt_len": prompt_len, "max_new": max_new,
                             "t_submit": time.perf_counter(),
                             "deadline_s": deadline_s,
                             "ttft_deadline_s": ttft_deadline_s}
        self.outputs[req_id] = []
        self.pending.append(req_id)
        obs.counter("serve.requests_submitted").inc()
        obs.event("serve.submit", req_id=req_id, prompt_len=prompt_len,
                  max_new=max_new)

    # -- chunk-boundary decisions -------------------------------------------

    def admissions(self) -> List[Tuple[int, int]]:
        """(slot index, req_id) pairs to admit now: free slots, FIFO.

        With a block pool, each admission first reserves pages for the
        request's whole span (prompt + decode budget); when the head of the
        queue does not fit, admission stops: later requests never jump
        ahead of it."""
        out = []
        now = time.perf_counter()
        for i, slot in enumerate(self.slots):
            if not self.pending:
                break
            if not slot.free:
                continue
            rid = self.pending[0]
            meta = self.meta[rid]
            starved = faults.should_fire("serve.pool_exhausted",
                                         req_id=rid) is not None
            if self.pool is not None or starved:
                need = (self.pool.blocks_for(meta["prompt_len"]
                                             + meta["max_new"])
                        if self.pool is not None else 0)
                if starved or not self.pool.can_alloc(need):
                    # the queue head is block-starved: one deferral per
                    # boundary, however many slots were still free behind it
                    self.n_deferrals += 1
                    obs.counter("serve.admission_deferrals").inc()
                    obs.event("serve.admission_deferred", req_id=rid,
                              need_blocks=need,
                              free_blocks=(self.pool.free_blocks
                                           if self.pool is not None else 0))
                    break
                self.pool.alloc(i, need)
            self.pending.popleft()
            slot.req_id = rid
            slot.remaining = meta["max_new"]
            slot.prefill_pos = 0
            slot.prefill_len = meta["prompt_len"]
            self.n_admits += 1
            meta["t_admit"] = now
            obs.counter("serve.requests_admitted").inc()
            obs.histogram("serve.queue_wait_s").observe(
                now - meta["t_submit"])
            obs.event("serve.admit", req_id=rid, slot=i,
                      prompt_len=meta["prompt_len"])
            out.append((i, rid))
        return out

    def prefilling(self) -> List[Tuple[int, int]]:
        """(slot index, req_id) pairs with prompt chunks still to prefill."""
        return [(i, s.req_id) for i, s in enumerate(self.slots)
                if s.prefilling]

    def prefill_advance(self, slot_idx: int, n: int) -> None:
        """Account ``n`` prompt positions prefilled into ``slot_idx``."""
        slot = self.slots[slot_idx]
        slot.prefill_pos = min(slot.prefill_pos + n, slot.prefill_len)

    def record_first(self, slot_idx: int, token: int) -> bool:
        """Account the prefill-sampled token; True if the request is already
        complete (max_new_tokens == 1) and the slot retired.

        Recording the first token means the prompt is fully in the cache,
        so this also closes the slot's prefill window."""
        slot = self.slots[slot_idx]
        slot.prefill_pos = slot.prefill_len
        meta = self.meta.get(slot.req_id)
        if meta is not None and "t_first" not in meta:
            meta["t_first"] = time.perf_counter()
            ttft = meta["t_first"] - meta["t_submit"]
            obs.histogram("serve.ttft_s").observe(ttft)
            obs.event("serve.first_token", req_id=slot.req_id,
                      slot=slot_idx, ttft_s=round(ttft, 6))
        if slot.remaining > 0:
            self.outputs[slot.req_id].append(int(token))
            slot.remaining -= 1
        if slot.remaining == 0:
            self._retire(slot_idx)
            return True
        return False

    def record_chunk(self, tokens) -> List[int]:
        """Account one decoded chunk; returns req_ids retired this boundary.

        ``tokens`` holds one row of the chunk's tokens per slot: the single
        device->host transfer of the chunk.  Free and still-prefilling
        slots decoded discarded padding; their rows are skipped."""
        finished = []
        for i, slot in enumerate(self.slots):
            if slot.free or slot.prefilling:
                continue
            row = tokens[i]
            take = min(slot.remaining, len(row))
            self.outputs[slot.req_id].extend(int(t) for t in row[:take])
            slot.remaining -= take
            if slot.remaining == 0:
                finished.append(slot.req_id)
                self._retire(i)
        return finished

    def _retire(self, slot_idx: int, state: str = "ok",
                reason: str = "") -> None:
        slot = self.slots[slot_idx]
        rid = slot.req_id
        meta = self.meta.get(rid)
        self.n_retires += 1
        obs.counter("serve.requests_retired").inc()
        if meta is not None:
            now = time.perf_counter()
            n_tok = len(self.outputs.get(rid, ()))
            obs.histogram("serve.request_tokens").observe(n_tok)
            obs.histogram("serve.e2e_s").observe(now - meta["t_submit"])
            t_first = meta.get("t_first")
            # decode throughput: tokens after the first, over the time after
            # the first (prefill latency is TTFT's burden, not decode's)
            if t_first is not None and n_tok > 1 and now > t_first:
                obs.histogram("serve.decode_tok_s").observe(
                    (n_tok - 1) / (now - t_first))
        obs.event("serve.retire", req_id=rid, slot=slot_idx, state=state)
        slot.req_id = -1
        slot.remaining = 0
        slot.prefill_pos = slot.prefill_len = 0
        if self.pool is not None:
            self.pool.free(slot_idx)  # every page back; tables re-set on
            #                           the next admission, never trusted
        self._finish(rid, state, reason)

    def _finish(self, rid: int, state: str, reason: str) -> None:
        """Record a request's terminal state (exactly once per request)."""
        self.done[rid] = (state, reason)
        if state == "timeout":
            self.n_timeouts += 1
        elif state == "cancelled":
            self.n_cancelled += 1
        elif state == "failed":
            self.n_failed += 1
        if state != "ok":
            obs.counter(f"serve.requests_{state}").inc()
            obs.event("serve.request_terminal", req_id=rid, state=state,
                      reason=reason)
        if state in ("failed", "timeout"):
            # the black box: everything the process saw leading up to this
            # request going bad (cancellation is a caller action, not a
            # failure: no dump)
            obs.flight_dump(f"request_{state}", req_id=rid, why=reason)

    def _slot_of(self, rid: int) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.req_id == rid:
                return i
        return None

    def _terminate(self, rid: int, state: str,
                   reason: str) -> Optional[int]:
        """Move a live request to a terminal state; returns the slot index
        it occupied (the engine must park that device lane) or None if it
        was still pending / already terminal.  KeyError for unknown ids."""
        if rid in self.done:
            return None  # already terminal: idempotent
        if rid not in self.meta:
            raise KeyError(f"unknown request id {rid}")
        slot_idx = self._slot_of(rid)
        if slot_idx is not None:
            self._retire(slot_idx, state, reason)
            return slot_idx
        self.pending.remove(rid)
        self._finish(rid, state, reason)
        return None

    def cancel(self, rid: int, reason: str = "cancelled by caller"
               ) -> Optional[int]:
        """Cancel a pending or in-flight request (partial tokens kept).
        Returns the freed slot index when it was occupying a device lane
        (the engine parks it), else None.  No-op when already terminal."""
        return self._terminate(rid, "cancelled", reason)

    def fail(self, rid: int, reason: str) -> Optional[int]:
        """Quarantine a request as ``failed`` (same mechanics as cancel)."""
        return self._terminate(rid, "failed", reason)

    def evacuate(self, slot_idx: int,
                 reason: str = "host lost") -> Optional[int]:
        """Return an in-flight request to the FRONT of the pending queue:
        its slot frees without the request ending.

        The request restarts from its prompt on re-admission: emitted
        tokens are discarded (they regenerate identically, sampling being
        a function of the request's own stream), timing metadata resets so
        TTFT is measured against the *new* admission, and, paged, the
        slot's pages return to the pool.  Returns the evacuated req_id, or
        None for a free slot.  ``reason`` rides into the
        ``serve.evacuate`` event."""
        slot = self.slots[slot_idx]
        rid = slot.req_id
        if rid < 0:
            return None
        meta = self.meta.get(rid)
        if meta is not None:
            meta.pop("t_first", None)
            meta.pop("t_admit", None)
        self.outputs[rid] = []
        slot.req_id = -1
        slot.remaining = 0
        slot.prefill_pos = slot.prefill_len = 0
        if self.pool is not None:
            self.pool.free(slot_idx)
        self.pending.appendleft(rid)
        self.n_evacuations += 1
        obs.counter("serve.evacuations").inc()
        obs.event("serve.evacuate", req_id=rid, slot=slot_idx,
                  reason=reason)
        return rid

    def check_deadlines(self, now: Optional[float] = None,
                        since: Optional[Dict[int, float]] = None
                        ) -> List[Tuple[Optional[int], int]]:
        """Expire requests past their deadlines; returns
        ``(freed slot or None, req_id)`` per expiry.

        Two clocks per request, both from ``t_submit``: ``ttft_deadline_s``
        applies until the first token lands (``t_first``), ``deadline_s``
        applies end-to-end.  Swept at chunk boundaries: a deadline is
        enforced at the first boundary at or after its expiry.

        ``since`` (with ``now``) measures each request from its time in
        ``since`` instead of ``t_submit``, on ``now``'s clock; a request
        missing from it is not swept (the sharded engine's mesh clock,
        ``repro_torch.serve.engine.ShardedEngine``)."""
        now = time.perf_counter() if now is None else now
        expired: List[Tuple[str, int]] = []
        for rid, meta in self.meta.items():
            if rid in self.done:
                continue
            if since is None:
                waited = now - meta["t_submit"]
            elif rid in since:
                waited = now - since[rid]
            else:
                continue
            dl = meta.get("deadline_s")
            ttft = meta.get("ttft_deadline_s")
            if dl is not None and waited >= dl:
                expired.append(("e2e deadline expired", rid))
            elif (ttft is not None and "t_first" not in meta
                  and waited >= ttft):
                expired.append(("ttft deadline expired", rid))
        out: List[Tuple[Optional[int], int]] = []
        for why, rid in expired:
            out.append((self._terminate(rid, "timeout", why), rid))
        return out

    def pop_result(self, req_id: int) -> RequestResult:
        """Collect a terminal request's tokens + state and drop its records.
        KeyError for ids never submitted (or already collected);
        ValueError while the request is still pending/in-flight."""
        if req_id not in self.done:
            if req_id in self.meta:
                raise ValueError(f"request {req_id} is still in flight")
            raise KeyError(f"unknown request id {req_id}")
        state, reason = self.done.pop(req_id)
        tokens = tuple(self.outputs.pop(req_id, ()))
        meta = self.meta.pop(req_id, {})
        ttft = (meta["t_first"] - meta["t_submit"] if "t_first" in meta
                else None)
        return RequestResult(req_id=req_id, tokens=tokens, state=state,
                             reason=reason, ttft_s=ttft)

    def pop_output(self, req_id: int) -> List[int]:
        """Tokens-only view of :meth:`pop_result`.  Raises the same
        KeyError/ValueError on unknown/in-flight ids."""
        return list(self.pop_result(req_id).tokens)

    # -- state ---------------------------------------------------------------

    def busy_slots(self) -> List[int]:
        """Slots actively DECODING (admitted and fully prefilled)."""
        return [i for i, s in enumerate(self.slots)
                if not s.free and not s.prefilling]

    def stats(self) -> Dict[str, int]:
        """Lifecycle totals + instantaneous occupancy (one dict, cheap)."""
        return {
            "admits": self.n_admits,
            "retires": self.n_retires,
            "deferrals": self.n_deferrals,
            "timeouts": self.n_timeouts,
            "cancelled": self.n_cancelled,
            "failed": self.n_failed,
            "evacuations": self.n_evacuations,
            "pending": len(self.pending),
            "busy": sum(1 for s in self.slots if not s.free),
            "prefilling": sum(1 for s in self.slots if s.prefilling),
            "slots": len(self.slots),
        }

    @property
    def idle(self) -> bool:
        return not self.pending and all(s.free for s in self.slots)
