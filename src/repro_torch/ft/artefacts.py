"""Self-healing JSON artefact stores: checksummed atomic writes, verified
loads, and quarantine instead of silent loss.

The port's copy of ``repro.ft.artefacts`` (framework-neutral).  The port
persists its AOT program store as JSON (``repro_torch.compiler.
executors``); the tuning cache and mined strategies follow with their
slices.  They are *caches*: a corrupt file must never abort a load, and
swallowing the error would destroy the evidence and the signal.  This
module gives every artefact store the same discipline:

  * **checksummed writes** — :func:`save_json` embeds a ``checksum`` field
    (sha256 over the canonical JSON of the rest) and writes atomically
    (tmp + rename), so torn writes and bit flips are *detectable*;
  * **verified loads** — :func:`load_json` re-derives the checksum
    (legacy files without one still load) and treats parse failures,
    type mismatches, and checksum mismatches as corruption;
  * **quarantine, not deletion** — a corrupt file is moved aside into a
    ``<path>.quarantine/`` directory (:func:`quarantine`) so the next
    writer rebuilds a clean file while the evidence survives for
    inspection;
  * **a visible signal** — every load failure fires the always-on
    ``artefact.load_failed`` obs counter + a structured event naming the
    path, and a warn-once ``logging`` warning per path (the event stream
    sees every occurrence, the log warns once).

Missing files are *not* failures — they return None silently (a cold
cache is the normal first-run state).

Append-only journals (:func:`append_record` / :func:`read_records`) get the
same discipline per *record*: each JSONL line embeds its own checksum, so a
reader can recover a crash-torn journal to the last complete record — the
torn tail is the expected crash artefact, and recovery IS dropping it (no
quarantine; the signal is the ``artefact.journal_torn`` counter + event).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import threading
from typing import Optional

from repro_torch import obs
from repro_torch.testing import faults

__all__ = ["save_json", "load_json", "quarantine", "report_load_failure",
           "append_record", "read_records", "CHECKSUM_FIELD"]

log = logging.getLogger("repro_torch.ft.artefacts")

CHECKSUM_FIELD = "checksum"

_warned_paths: set = set()
_warn_lock = threading.Lock()


def _digest(payload: dict) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      default=str)
    return "sha256:" + hashlib.sha256(blob.encode()).hexdigest()


def save_json(path: str, doc: dict, *, checksum: bool = True,
              indent: int = 1) -> str:
    """Atomically write ``doc`` as JSON with an embedded content checksum.

    The checksum covers every field except ``checksum`` itself, computed
    over canonical (sorted, compact) JSON — so a reader can verify it
    regardless of formatting.  Atomic: tmp file + rename, the tmp is
    unlinked on failure and the ``OSError`` re-raised (callers that treat
    persistence as best-effort catch it)."""
    payload = {k: v for k, v in doc.items() if k != CHECKSUM_FIELD}
    out = dict(payload)
    if checksum:
        out[CHECKSUM_FIELD] = _digest(payload)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".artefact-", suffix=".json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(out, f, indent=indent, sort_keys=True, default=str)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def quarantine(path: str, qdir: Optional[str] = None) -> Optional[str]:
    """Move a corrupt artefact aside into ``qdir`` (default
    ``<path>.quarantine/``); returns the new location, or None if the move
    itself failed (the load still proceeds as empty — quarantine is
    evidence preservation, never a new failure mode)."""
    qdir = qdir or (path + ".quarantine")
    base = os.path.basename(path)
    try:
        os.makedirs(qdir, exist_ok=True)
        dest = os.path.join(qdir, base)
        n = 0
        while os.path.exists(dest):
            n += 1
            dest = os.path.join(qdir, f"{base}.{n}")
        os.replace(path, dest)
        return dest
    except OSError:
        return None


def report_load_failure(path: str, what: str, err: Exception,
                        quarantined: Optional[str] = None) -> None:
    """The load-failure signal: always-on counter + structured event per
    occurrence, warn-once ``logging`` warning per path."""
    obs.counter("artefact.load_failed").inc()
    obs.event("artefact.load_failed", path=str(path), what=what,
              error=f"{type(err).__name__}: {err}",
              quarantined=str(quarantined or ""))
    # an artefact quarantine is silent data loss narrowly averted — worth
    # the full black box, not just a counter
    obs.flight_dump("artefact_quarantine", path=str(path), what=what,
                    error=f"{type(err).__name__}: {err}")
    with _warn_lock:
        if path in _warned_paths:
            return
        _warned_paths.add(path)
    log.warning(
        "%s artefact %s failed to load (%s: %s)%s; continuing with an "
        "empty store — it will be rebuilt on the next write",
        what, path, type(err).__name__, err,
        f"; corrupt file quarantined to {quarantined}" if quarantined
        else "")


def load_json(path: str, *, what: str = "artefact",
              qdir: Optional[str] = None) -> Optional[dict]:
    """Read + verify a JSON artefact; None when missing OR corrupt.

    Missing files return None silently.  Corrupt files (unparseable, not
    an object, or checksum mismatch) are quarantined via
    :func:`quarantine` and reported via :func:`report_load_failure`, then
    return None — the caller starts empty and rebuilds.  The returned dict
    has the ``checksum`` field stripped.

    Fault site ``artefact.corrupt`` (ctx: ``what``, ``path``) makes a
    healthy file read as corrupt, for deterministic resilience drills."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None  # missing: the normal cold-cache state
    try:
        if faults.should_fire("artefact.corrupt", what=what, path=path):
            raise ValueError("injected artefact corruption")
        doc = json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError(f"top level is {type(doc).__name__}, "
                             f"expected object")
        stored = doc.pop(CHECKSUM_FIELD, None)
        if stored is not None and stored != _digest(doc):
            raise ValueError("checksum mismatch (torn write or bit flip)")
        return doc
    except ValueError as e:
        qpath = quarantine(path, qdir)
        report_load_failure(path, what, e, qpath)
        return None


# ---------------------------------------------------------------------------
# append-only checksummed journals (JSONL, one verified record per line)
# ---------------------------------------------------------------------------

def append_record(path: str, record: dict) -> None:
    """Append one record to a JSONL journal with an embedded per-record
    checksum (same sha256-over-canonical-JSON as :func:`save_json`, scoped
    to the single record).

    The write is a single ``write()`` of one line — the common torn-write
    failure is a truncated *last* line, which :func:`read_records` detects
    and drops.  Creates the file (and parent directory) on first append."""
    payload = {k: v for k, v in record.items() if k != CHECKSUM_FIELD}
    out = dict(payload)
    out[CHECKSUM_FIELD] = _digest(payload)
    line = json.dumps(out, sort_keys=True, separators=(",", ":"),
                      default=str)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(line + "\n")


def read_records(path: str, *, what: str = "journal"):
    """Read a checksummed JSONL journal; returns ``(records, clean)``.

    Reading stops at the first unparseable or checksum-failing line: a
    crash mid-append leaves a truncated tail, and the records up to the
    last complete, verified line ARE the recoverable state.  ``clean`` is
    False when a tail was dropped — reported through the always-on
    ``artefact.journal_torn`` counter + a structured event naming the path
    and line (the file itself is left untouched: subsequent appends go
    after the torn bytes, so callers recovering a journal should replay
    into a fresh one).  A missing file is an empty, clean journal."""
    try:
        with open(path) as f:
            lines = f.readlines()
    except OSError:
        return [], True
    records = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
            if not isinstance(doc, dict):
                raise ValueError(f"record is {type(doc).__name__}, "
                                 f"expected object")
            stored = doc.pop(CHECKSUM_FIELD, None)
            if stored is None or stored != _digest(doc):
                raise ValueError("record checksum mismatch (torn write "
                                 "or bit flip)")
        except ValueError as e:
            obs.counter("artefact.journal_torn").inc()
            obs.event("artefact.journal_torn", path=str(path), what=what,
                      line=i, error=f"{type(e).__name__}: {e}",
                      recovered=len(records))
            log.warning(
                "%s journal %s torn at line %d (%s); recovered %d complete "
                "records up to the last verified boundary", what, path, i,
                e, len(records))
            return records, False
        records.append(doc)
    return records, True
