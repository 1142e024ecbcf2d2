"""Failure domains: host loss and straggler survival for the sharded
engine; the scheduler-state journal and its replay.

The port's copy of ``repro.serve.domains``:

  * :class:`FailureDomains` partitions the positions of a sharded engine's
    mesh axis into host groups (by node with ``hosts="auto"``; an even,
    contiguous split into ``hosts`` groups for a drill) and polls the
    boundary fault sites (``mesh.host_lost``, ``mesh.host_slow``,
    ``collective.timeout``) at every chunk boundary: a lost host is an
    *event* the engine handles, never an exception that escapes it;
  * :class:`SchedulerJournal` is an append-only, per-record-checksummed
    journal (``repro_torch.ft.artefacts.append_record``) of scheduler
    state: request submissions (prompt, sampling knobs, stream index),
    emitted tokens snapshotted at chunk boundaries, terminal states,
    evacuations and mesh shrinks; enough for a *restarted* engine to
    :func:`replay` every surviving request to token identity with the
    fault-free run.  Its records are the reference's, field for field, so
    either package reads a journal the other wrote;
  * :func:`replay` feeds the live requests of a journal into a fresh
    engine;
  * :func:`retune_for_mesh` re-ranks the tuner's mesh-axis candidates for
    a shrunk mesh descriptor, so the degraded placement is a tuned
    strategy (cache keys carry the descriptor).

Token identity after evacuation or replay is not luck: request ``i`` of a
run seeded ``seed`` samples from the stream seeded ``_stream_seed(seed,
stream)`` (``repro_torch.serve.engine``), advanced once per token: a
function of (prompt, stream index, run seed) alone, independent of slot,
batch composition, mesh shape, or how many times decoding restarted.  An
evacuated request re-decodes from its prompt on the shrunk mesh and a
replayed one in a fresh process; both reproduce their tokens bit for bit.

The mesh is a ``torch.distributed`` ``DeviceMesh`` with one dim over
every rank of the process group; every rank builds its own
:class:`FailureDomains` and, given the same fault plan, sees the same
events at the same boundaries (``repro_torch.testing.faults``).  At each
loss :meth:`FailureDomains.shrunk_mesh` gives the survivors a mesh on a
process group that only they create: they meet under a key of the
default store (the one the world started from) made of their global
ranks and the count of the set's earlier meetings, so it depends neither
on the lost ranks nor on how many groups each survivor built before.  A
lost rank calls nothing: it gets None and stops serving
(``ShardedEngine`` leaves its loop), whether its process lives on, as in
a drill, or is gone.  The Nth shrink works as the first; the world's
numbering stays (the default group is never re-initialised).
"""
from __future__ import annotations

import dataclasses
import logging
import socket
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch import obs
from repro_torch.ft import artefacts

log = logging.getLogger("repro_torch.serve.domains")

__all__ = ["FailureDomains", "HostEvent", "SchedulerJournal", "JournalState",
           "replay", "retune_for_mesh", "survivors_group", "JOURNAL_KINDS"]


# ---------------------------------------------------------------------------
# host events + failure domains
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HostEvent:
    """One detection at a chunk boundary: a host is slow or lost."""
    kind: str                   # "slow" | "lost"
    host: int
    cause: str = ""
    delay_s: float = 0.0        # slow only: the injected stall


class FailureDomains:
    """Partition of a mesh's slot-axis positions into host groups, plus the
    chunk-boundary detection that turns fault-site firings (or, on a real
    deployment, heartbeat / collective timeouts) into
    :class:`HostEvent`\\ s.

    Only single-axis meshes are supported: the slot axis is the one the
    sharded engine partitions, and a host owns a *contiguous* run of axis
    positions (the contiguous slot -> rank mapping of the engine), so
    evacuation can name exactly the slots that lived on the dead ranks.

    ``mesh`` is a one-dim ``DeviceMesh`` (``mesh_dim_names=(axis,)``), or
    an axis -> size dict for the logic alone (no ranks: position ``p`` is
    rank ``p``, one node, and no :meth:`shrunk_mesh`).  ``hosts``: an int
    splits the positions evenly and contiguously (a drill's stand-in for
    nodes); ``"auto"`` or None groups the ranks by the node they run on
    (one ``all_gather_object`` of each rank's host name over the axis
    group: every rank of the axis builds its domains together).

    Detection policy per boundary, first match wins:

      1. ``mesh.host_lost(host=H)``: immediate loss of host ``H``;
      2. ``collective.timeout``: the boundary's collective stalled; the
         presumed-dead host is the fault's ``value`` (default: the last
         alive host, the conventional scapegoat when attribution is lost);
      3. ``mesh.host_slow(host=H)``: host ``H`` straggled this boundary;
         after ``slow_threshold`` strikes it escalates to lost (a
         persistently slow host is a dead host that still answers pings).
    """

    def __init__(self, mesh, axis: str = "data", hosts=None,
                 slow_threshold: int = 3):
        from repro_torch.mesh.strategy import axis_sizes
        shape = axis_sizes(mesh)
        if axis not in shape:
            raise ValueError(f"mesh axis {axis!r} not in mesh axes "
                             f"{list(shape)}")
        if len(shape) != 1:
            raise ValueError(
                f"failure domains support single-axis meshes (the sharded "
                f"slot axis); got axes {list(shape)}")
        if slow_threshold < 1:
            raise ValueError(f"slow_threshold must be >= 1, got "
                             f"{slow_threshold}")
        self.axis = axis
        self.slow_threshold = slow_threshold
        ranked = not isinstance(mesh, dict)
        self._device_type = mesh.device_type if ranked else None
        # global ranks in axis order: position p is rank ranks[p]
        self.ranks: List[int] = ([int(r) for r in mesh.mesh.reshape(-1)]
                                 if ranked else list(range(shape[axis])))
        n = len(self.ranks)
        if hosts is None or hosts == "auto":
            self.groups = (self.by_node(self._host_names(mesh)) if ranked
                           else self.partition(n, 1))
        else:
            self.groups = self.partition(n, int(hosts))
        self.alive: List[bool] = [True] * len(self.groups)
        self._slow_counts: Dict[int, int] = {}
        self.n_losses = 0

    def _host_names(self, mesh) -> List[str]:
        """Every axis position's node name, gathered over the axis."""
        import torch.distributed as dist
        got: List[Optional[tuple]] = [None] * len(self.ranks)
        dist.all_gather_object(got, (dist.get_rank(), socket.gethostname()),
                               group=mesh.get_group(self.axis))
        names = dict(got)
        return [str(names[r]) for r in self.ranks]

    # -- pure partition/mapping logic (unit-testable without ranks) ---------

    @staticmethod
    def partition(n_positions: int, hosts: int) -> Tuple[Tuple[int, ...], ...]:
        """Even, contiguous split of ``n_positions`` axis positions into
        ``hosts`` groups: the drill's stand-in for nodes."""
        if hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {hosts}")
        if n_positions % hosts != 0:
            raise ValueError(f"{hosts} hosts must evenly divide the "
                             f"{n_positions} devices on the slot axis")
        per = n_positions // hosts
        return tuple(tuple(range(h * per, (h + 1) * per))
                     for h in range(hosts))

    @staticmethod
    def by_node(names: Sequence[str]) -> Tuple[Tuple[int, ...], ...]:
        """Positions grouped by node name, the groups in the order of their
        first position (the reference groups its devices by
        ``process_index``)."""
        groups: Dict[str, List[int]] = {}
        for p, name in enumerate(names):
            groups.setdefault(name, []).append(p)
        return tuple(tuple(g) for g in groups.values())

    @staticmethod
    def slots_for(groups: Sequence[Sequence[int]], alive: Sequence[bool],
                  host: int, n_slots: int) -> List[int]:
        """The engine slots currently living on ``host``, under the
        contiguous slot -> rank mapping over the *alive* axis positions.

        Shard ``r`` (the r-th alive position, in axis order) owns slots
        ``[r*per, (r+1)*per)`` with ``per = n_slots / n_alive_positions``,
        exactly how ``ShardedEngine`` lays its lanes out, so host -> slots
        attribution and the actual placement can never disagree."""
        positions = [p for h, g in enumerate(groups) if alive[h] for p in g]
        if n_slots % len(positions) != 0:
            raise ValueError(f"{n_slots} slots not divisible across "
                             f"{len(positions)} alive positions")
        per = n_slots // len(positions)
        rank = {p: r for r, p in enumerate(positions)}
        out: List[int] = []
        for p in groups[host]:
            r = rank.get(p)
            if r is not None:
                out.extend(range(r * per, (r + 1) * per))
        return sorted(out)

    # -- live topology -------------------------------------------------------

    @property
    def n_hosts(self) -> int:
        return len(self.groups)

    def alive_hosts(self) -> List[int]:
        return [h for h, a in enumerate(self.alive) if a]

    def alive_positions(self) -> List[int]:
        """Surviving axis positions, in original axis order."""
        return [p for h, g in enumerate(self.groups) if self.alive[h]
                for p in g]

    def axis_size(self) -> int:
        return len(self.alive_positions())

    def slots_of_host(self, host: int, n_slots: int) -> List[int]:
        """Engine slots on ``host`` under the *current* placement (call
        before :meth:`mark_lost`: attribution needs the mapping the dead
        host was part of)."""
        return self.slots_for(self.groups, self.alive, host, n_slots)

    def slow_count(self, host: int) -> int:
        return self._slow_counts.get(host, 0)

    def mark_lost(self, host: int) -> None:
        if not self.alive[host]:
            return
        self.alive[host] = False
        self.n_losses += 1
        self._slow_counts.pop(host, None)
        if not any(self.alive):
            raise RuntimeError(
                f"all {self.n_hosts} hosts lost — no devices left to "
                f"serve on")

    def shrunk_mesh(self):
        """A fresh one-dim ``DeviceMesh`` over the surviving ranks, in
        original axis order, on a process group of the survivors alone
        (:func:`survivors_group`); None on a rank whose host was lost,
        which calls no collective and creates no group.  Each call after a
        :meth:`mark_lost` shrinks again; a rendezvous that fails raises on
        the survivors."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if self._device_type is None:
            raise ValueError("shrunk_mesh needs failure domains built on a "
                             "DeviceMesh, not an axis -> size dict")
        ranks = [self.ranks[p] for p in self.alive_positions()]
        if dist.get_rank() not in ranks:
            return None
        return DeviceMesh.from_group(survivors_group(ranks),
                                     self._device_type, mesh=ranks,
                                     mesh_dim_names=(self.axis,))

    # -- detection -----------------------------------------------------------

    def poll(self) -> Optional[HostEvent]:
        """Consult the boundary fault sites once for this chunk boundary;
        at most one event per poll (the engine handles it before the next
        boundary polls again).  Near-free when no fault plan is active."""
        from repro_torch.testing import faults
        if not faults.active():
            return None
        for h in self.alive_hosts():
            f = faults.should_fire("mesh.host_lost", host=h, axis=self.axis)
            if f is not None:
                return HostEvent("lost", h,
                                 cause=f"host {h} lost ({f.describe()})")
        f = faults.should_fire("collective.timeout", axis=self.axis)
        if f is not None:
            alive = self.alive_hosts()
            h = alive[-1]
            if isinstance(f.value, int) and f.value in alive:
                h = int(f.value)
            return HostEvent(
                "lost", h,
                cause=f"collective timeout at the chunk boundary — host "
                      f"{h} presumed dead ({f.describe()})")
        for h in self.alive_hosts():
            f = faults.should_fire("mesh.host_slow", host=h, axis=self.axis)
            if f is not None:
                n = self._slow_counts.get(h, 0) + 1
                self._slow_counts[h] = n
                if n >= self.slow_threshold:
                    return HostEvent(
                        "lost", h,
                        cause=f"host {h} straggled {n} consecutive chunks "
                              f"(slow_threshold={self.slow_threshold}) — "
                              f"escalated to lost")
                return HostEvent("slow", h,
                                 delay_s=float(f.value or 0.0),
                                 cause=f"host {h} straggling "
                                       f"(strike {n}/{self.slow_threshold})")
        return None

    def describe(self) -> dict:
        """Topology summary for ``ShardedEngine.stats()["mesh"]["hosts"]``."""
        return {"n_hosts": self.n_hosts,
                "alive": self.alive_hosts(),
                "lost": [h for h, a in enumerate(self.alive) if not a],
                "losses": self.n_losses,
                "groups": [list(g) for g in self.groups]}


def survivors_group(ranks: Sequence[int]):
    """A process group of the global ``ranks`` that only they create.

    ``dist.new_group`` needs every rank of the world, the lost ones too;
    with ``use_local_synchronization=True`` it names the group after the
    count of groups each member built before, so members whose histories
    differ (a rank outside an earlier sub-mesh) meet under different keys
    and wait forever.  Here the members meet under a key of the default
    store made of their sorted ranks and the count of the set's earlier
    meetings: each adds one to the set's counter, and waits on the store
    until every member has joined this meeting, so no member starts the
    next meeting before all have counted this one.  The backend is the
    default group's, on a ``PrefixStore`` of that key, with the store's
    timeout: a member that never comes makes the others raise.  The
    group is registered as ``dist.new_group`` registers its own, so
    collectives and ``DeviceMesh.from_group`` take it."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    ranks = sorted(int(r) for r in ranks)
    default = c10d._get_default_group()
    if default.bound_device_id is not None:
        raise ValueError(
            "a survivors' group cannot be built when the default process "
            "group is bound to a device (init_process_group(device_id=...)):"
            " NCCL would split it from the world's communicator, which "
            "needs every rank of the world")
    backend, store = c10d._world.pg_map[default]
    key = "repro_torch.shrink/" + "_".join(map(str, ranks))
    meeting = (store.add(key, 1) - 1) // len(ranks)
    name = f"{key}/{meeting}"
    me = dist.get_rank()
    store.set(f"{name}/joined/{me}", "1")
    store.wait([f"{name}/joined/{r}" for r in ranks])
    group, _ = c10d._new_process_group_helper(
        len(ranks), ranks.index(me), ranks, backend, store, name,
        timeout=store.timeout)
    c10d._world.pg_group_ranks[group] = {r: i for i, r in enumerate(ranks)}
    return group


# ---------------------------------------------------------------------------
# re-tuning for a shrunk mesh
# ---------------------------------------------------------------------------

def retune_for_mesh(cfg, desc: str, *, max_seq: int, batch_sizes,
                    cache) -> int:
    """Re-rank the tuner's mesh-axis candidates for mesh descriptor
    ``desc`` over a model's kernel shapes (analytic: descriptor-only tuning
    needs no ranks and launches nothing); returns the number of shapes
    tuned.

    Called after a mesh shrink: the cache keys carry the descriptor, so the
    shrunk mesh is a cold cache row until this fills it; with it the
    degraded placement is already a ranked, recorded strategy."""
    from repro_torch import autotune
    n = 0
    with obs.span("serve.mesh_retune", mesh=desc):
        for kernel, shape in autotune.model_kernel_shapes(
                cfg, max_seq=max_seq, batch_sizes=batch_sizes):
            try:
                autotune.tune(kernel, backend="shardmap", mesh=desc,
                              cache=cache, measure=False, **shape)
                n += 1
            except (ValueError, AssertionError):
                continue    # a shape with no valid mesh placement
    obs.event("serve.mesh_retune", mesh=desc, shapes=n)
    return n


# ---------------------------------------------------------------------------
# the scheduler-state journal
# ---------------------------------------------------------------------------

# record kinds a journal may contain
JOURNAL_KINDS = ("submit", "progress", "terminal", "evacuate", "shrink")


def _token_list(prompt) -> list:
    """A prompt (a list, a tensor or an array; (s,) or (s, K)) as nested
    lists of ints."""
    if hasattr(prompt, "tolist"):
        return prompt.tolist()
    return [_token_list(t) if isinstance(t, (list, tuple)) else
            (t.tolist() if hasattr(t, "tolist") else int(t)) for t in prompt]


class SchedulerJournal:
    """Append-only, per-record-checksummed journal of scheduler state.

    One JSONL record per event, each line independently verified
    (``ft.artefacts.append_record``), so a crash-torn journal recovers to
    the last complete chunk boundary (``read_records`` drops the torn
    tail).  Record kinds:

      * ``submit``: rid, prompt (token list, nested for codebooks),
        max_new, temperature,
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
            "prompt": _token_list(prompt),
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
