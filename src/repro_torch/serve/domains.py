"""The scheduler-state journal and its replay; failure domains (not ported
yet).

The port's copy of the journal half of ``repro.serve.domains``:

  * :class:`SchedulerJournal` is an append-only, per-record-checksummed
    journal (``repro_torch.ft.artefacts.append_record``) of scheduler
    state: request submissions (prompt, sampling knobs, stream index),
    emitted tokens snapshotted at chunk boundaries, terminal states,
    evacuations and mesh shrinks; enough for a *restarted* engine to
    :func:`replay` every surviving request to token identity with the
    fault-free run.  Its records are the reference's, field for field, so
    either package reads a journal the other wrote.
  * :func:`replay` feeds the live requests of a journal into a fresh
    engine.

Token identity after replay is not luck: request ``i`` of a run seeded
``seed`` samples from the stream seeded ``_stream_seed(seed, stream)``
(``repro_torch.serve.engine``), advanced once per token: a function of
(prompt, stream index, run seed) alone, independent of slot, batch
composition, or how many times decoding restarted.  A replayed request
re-decodes from its prompt and reproduces its tokens bit for bit.

:class:`FailureDomains`, :class:`HostEvent` and :func:`retune_for_mesh`
(host loss and straggler survival for the sharded engine) come with mesh
and sharded serving, ROADMAP.md queue 1 item 7, and raise
``NotImplementedError`` until then.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch import obs
from repro_torch.ft import artefacts

__all__ = ["FailureDomains", "HostEvent", "SchedulerJournal", "JournalState",
           "replay", "retune_for_mesh", "JOURNAL_KINDS"]

_MESH = "comes with mesh and sharded serving (ROADMAP.md queue 1 item 7)"


class HostEvent:
    """One host detection at a chunk boundary: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"HostEvent {_MESH}")


class FailureDomains:
    """The host groups of a sharded engine's mesh: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"FailureDomains {_MESH}")


def retune_for_mesh(cfg, desc: str, *, max_seq: int, batch_sizes,
                    cache) -> int:
    """Re-rank the tuner's mesh-axis candidates for a shrunk mesh: not
    ported yet."""
    raise NotImplementedError(f"retune_for_mesh {_MESH}")


# ---------------------------------------------------------------------------
# the scheduler-state journal
# ---------------------------------------------------------------------------

# record kinds a journal may contain
JOURNAL_KINDS = ("submit", "progress", "terminal", "evacuate", "shrink")


class SchedulerJournal:
    """Append-only, per-record-checksummed journal of scheduler state.

    One JSONL record per event, each line independently verified
    (``ft.artefacts.append_record``), so a crash-torn journal recovers to
    the last complete chunk boundary (``read_records`` drops the torn
    tail).  Record kinds:

      * ``submit``: rid, prompt (token list), max_new, temperature,
        top_k, stream (the stream index: the whole sampling state a replay
        needs), deadlines;
      * ``progress``: rid + the tokens emitted since the last snapshot
        (written at chunk boundaries: inside a chunk the host sees
        nothing, so boundaries ARE the journal's granularity);
      * ``terminal``: rid, terminal state, reason;
      * ``evacuate``: rid returned to the queue by a host loss (its
        emitted-token snapshot resets: re-decode regenerates them);
      * ``shrink``: mesh descriptor before/after + the lost host.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._n_snap: Dict[int, int] = {}
        self._terminal: set = set()

    # -- writers (engine-driven) --------------------------------------------

    def record_submit(self, rid: int, prompt, *, max_new: int,
                      temperature: float, top_k: int, stream: int,
                      deadline_s=None, ttft_deadline_s=None) -> None:
        artefacts.append_record(self.path, {
            "kind": "submit", "rid": int(rid),
            "prompt": [int(t) for t in prompt],
            "max_new": int(max_new), "temperature": float(temperature),
            "top_k": int(top_k), "stream": int(stream),
            "deadline_s": deadline_s, "ttft_deadline_s": ttft_deadline_s})

    def record_progress(self, rid: int, tokens) -> None:
        """Snapshot ``rid``'s emitted tokens (the full list so far); only
        the delta since the last snapshot is appended."""
        n0 = self._n_snap.get(rid, 0)
        if len(tokens) <= n0:
            return
        artefacts.append_record(self.path, {
            "kind": "progress", "rid": int(rid),
            "tokens": [int(t) for t in tokens[n0:]], "n": len(tokens)})
        self._n_snap[rid] = len(tokens)

    def record_terminal(self, rid: int, state: str, reason: str = "") -> None:
        if rid in self._terminal:
            return  # exactly one terminal record per request
        self._terminal.add(rid)
        artefacts.append_record(self.path, {
            "kind": "terminal", "rid": int(rid), "state": str(state),
            "reason": str(reason)})

    def record_evacuate(self, rid: int, host: int) -> None:
        self._n_snap[rid] = 0   # re-decode re-emits from the first token
        artefacts.append_record(self.path, {
            "kind": "evacuate", "rid": int(rid), "host": int(host)})

    def record_shrink(self, frm: str, to: str, host: int,
                      cause: str = "") -> None:
        artefacts.append_record(self.path, {
            "kind": "shrink", "frm": str(frm), "to": str(to),
            "host": int(host), "cause": str(cause)})

    # -- reader --------------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "JournalState":
        """Fold a journal file into :class:`JournalState`, recovering a
        torn tail to the last complete record."""
        records, clean = artefacts.read_records(str(path),
                                                what="scheduler journal")
        state = JournalState(clean=clean)
        for r in records:
            kind = r.get("kind")
            if kind == "submit":
                state.requests[int(r["rid"])] = dict(r, emitted=[])
            elif kind == "progress":
                req = state.requests.get(int(r["rid"]))
                if req is not None:
                    req["emitted"].extend(int(t) for t in r["tokens"])
            elif kind == "terminal":
                state.terminals[int(r["rid"])] = (r["state"],
                                                  r.get("reason", ""))
            elif kind == "evacuate":
                req = state.requests.get(int(r["rid"]))
                if req is not None:
                    req["emitted"] = []
                state.evacuations += 1
            elif kind == "shrink":
                state.shrinks.append(r)
        return state


@dataclasses.dataclass
class JournalState:
    """A journal folded into its end state (what :func:`replay` consumes)."""
    requests: Dict[int, dict] = dataclasses.field(default_factory=dict)
    terminals: Dict[int, Tuple[str, str]] = dataclasses.field(
        default_factory=dict)
    shrinks: List[dict] = dataclasses.field(default_factory=list)
    evacuations: int = 0
    clean: bool = True

    def live(self) -> Dict[int, dict]:
        """Requests with no terminal record: the ones a restarted engine
        owes tokens to (mid-queue, mid-prefill and mid-decode alike:
        replay restarts each from its prompt)."""
        return {rid: r for rid, r in self.requests.items()
                if rid not in self.terminals}


def replay(journal, engine, seed: int = 0) -> Dict[int, List[int]]:
    """Re-admit every live request recorded in ``journal`` (a path,
    :class:`SchedulerJournal` or :class:`JournalState`) into ``engine`` (a
    fresh ``ContinuousEngine``) and run it to idle; returns ``{original
    rid: tokens}``.

    ``seed`` is the run's seed, the one the crashed engine ran under
    (``ContinuousEngine.run``'s default is 0; the reference takes its PRNG
    key here).  Each request re-enters with its recorded stream index, in
    rid order (the original FIFO), so its tokens are the crashed run's.
    Recorded deadlines are *not* re-armed: they were wall-clock promises to
    the original caller, and replay's contract is token identity, not
    latency identity.  Replaying the same journal again (into this or
    another fresh engine) yields the same tokens."""
    from repro_torch.serve.engine import Request

    if isinstance(journal, JournalState):
        state = journal
    elif isinstance(journal, SchedulerJournal):
        state = SchedulerJournal.load(journal.path)
    else:
        state = SchedulerJournal.load(journal)
    live = state.live()
    obs.event("serve.journal_replay", requests=len(live),
              terminal=len(state.terminals), clean=state.clean)
    with engine._options_scope():
        engine._run_seed = int(seed)
        mapping: Dict[int, int] = {}
        for rid in sorted(live):
            r = live[rid]
            req = Request(prompt=list(r["prompt"]),
                          max_new_tokens=int(r["max_new"]),
                          temperature=float(r["temperature"]),
                          top_k=int(r["top_k"]))
            mapping[rid] = engine.submit(req, stream=int(r["stream"]))
        while not engine.sched.idle:
            engine.step_chunk()
    return {rid: engine.take_output(new_rid)
            for rid, new_rid in mapping.items()}
