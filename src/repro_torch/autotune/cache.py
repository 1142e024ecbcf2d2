"""Persistent tuning cache.

On-disk format (JSON, human-editable):

    {
      "version": 1,
      "entries": {
        "dot|n=4096|float32|jnp|single": {
          "kernel": "dot",
          "params": {"block": 4096, "leaf": "vpu"},
          "source": "measured",            # or "analytic"
          "cost_s": 4.1e-06,               # analytic prediction, seconds
          "measured_us": 12.3,             # chosen candidate, if measured
          "timings": {"block=4096,leaf=vpu": 12.3, ...},
          "shape": {"n": 4096}
        }, ...
      }
    }

Keys are ``kernel|shape|dtype|backend|mesh``; every component the compiled
artefact depends on is in the key, so serving never has to re-search — a hit
is always safe to reuse.

The store is self-healing (``repro_torch.ft.artefacts``): writes are atomic
(tmp + rename) and carry an embedded content checksum; a corrupt FILE is
quarantined to ``<path>.quarantine/`` and reported (warn-once log +
always-on ``artefact.load_failed`` counter), and a corrupt ENTRY —
well-formed file, malformed record — is quarantined individually
(``artefact.entry_quarantined``) while the healthy entries load.  Either
way the next ``tune()`` sees a miss and rebuilds the lost decisions;
nothing is ever silently dropped, and nothing aborts the load.

The port's copy of ``repro.autotune.cache``: the same keys (``make_key``),
``VERSION`` and record layout, so the two packages make equal keys for
equal arguments.  The port's default file is
``~/.cache/repro_torch/autotune.json``; ``REPRO_AUTOTUNE_CACHE`` overrides
it, as in the reference.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

from repro_torch.ft import artefacts

VERSION = 1

_ENV_PATH = "REPRO_AUTOTUNE_CACHE"


def default_path() -> str:
    env = os.environ.get(_ENV_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


# the reference's signature, defaults included: equal arguments make equal
# keys in both packages (the port's callers always name their backend)
def make_key(kernel: str, shape: Dict[str, object], dtype: str = "float32",
             backend: str = "jnp", mesh: str = "single",
             layout: str = "dense") -> str:
    """``kernel|shape|dtype|backend|mesh[|layout]`` — the serving KV layout
    joins the key like the mesh descriptor, but only when it departs from
    the default, so every pre-paged cache entry keeps its address."""
    shape_s = ",".join(f"{k}={shape[k]}" for k in sorted(shape))
    key = f"{kernel}|{shape_s}|{dtype}|{backend}|{mesh}"
    if layout and layout != "dense":
        key += f"|layout={layout}"
    return key


class TuningCache:
    """JSON-backed tuning cache with in-process memoisation."""

    def __init__(self, path: Optional[str] = None):
        self.path = path or default_path()
        self._lock = threading.Lock()
        self._mem: Dict[str, dict] = {}
        self._loaded = False

    # -- disk ---------------------------------------------------------------

    @staticmethod
    def _valid_record(v) -> bool:
        """Shape check for one entry: a dict whose ``params`` (when present)
        is a dict — the contract ``kernels.ops``/``autotune.get_tuned``
        rely on.  Anything else is a corrupt record."""
        return isinstance(v, dict) and isinstance(v.get("params", {}), dict)

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        doc = artefacts.load_json(self.path, what="tuning cache")
        if doc is None:
            return  # missing (cold) or corrupt (quarantined + reported)
        if doc.get("version") != VERSION:
            return  # version skew: expected after an upgrade, start empty
        entries = doc.get("entries", {})
        if not isinstance(entries, dict):
            return
        bad = {k: v for k, v in entries.items() if not self._valid_record(v)}
        if bad:
            # entry-level self-healing: park the malformed records beside
            # the cache, keep the healthy ones, and let the next tune()
            # rebuild what was lost
            from repro_torch import obs
            qdir = self.path + ".quarantine"
            qpath = None
            try:
                os.makedirs(qdir, exist_ok=True)
                qpath = os.path.join(
                    qdir, f"entries-{abs(hash(tuple(sorted(bad)))):x}.json")
                with open(qpath, "w") as f:
                    json.dump(bad, f, indent=1, sort_keys=True, default=str)
            except OSError:
                qpath = None
            obs.counter("artefact.entry_quarantined").inc(len(bad))
            artefacts.report_load_failure(
                self.path, "tuning cache",
                ValueError(f"{len(bad)} malformed entr"
                           f"{'y' if len(bad) == 1 else 'ies'}: "
                           f"{sorted(bad)[:4]}"), qpath)
        # disk never overrides fresher in-process results
        for k, v in entries.items():
            if k not in bad:
                self._mem.setdefault(k, v)

    def _save(self) -> None:
        doc = {"version": VERSION, "entries": self._mem}
        try:
            artefacts.save_json(self.path, doc)
        except OSError:
            pass  # persistence is best-effort; the in-process memo stands

    # -- API ----------------------------------------------------------------
    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            self._load()
            return self._mem.get(key)

    def put(self, key: str, record: dict) -> None:
        with self._lock:
            self._load()
            self._mem[key] = record
            self._save()

    def __contains__(self, key: str) -> bool:
        return self.get(key) is not None

    def __len__(self) -> int:
        with self._lock:
            self._load()
            return len(self._mem)

    def keys(self):
        with self._lock:
            self._load()
            return sorted(self._mem)

    def clear(self) -> None:
        with self._lock:
            self._mem = {}
            self._loaded = True
            self._save()


_default: Optional[TuningCache] = None
_default_lock = threading.Lock()


def default_cache() -> TuningCache:
    """Process-wide cache at ``$REPRO_AUTOTUNE_CACHE`` or
    ~/.cache/repro_torch/."""
    global _default
    with _default_lock:
        if _default is None or _default.path != default_path():
            _default = TuningCache()
        return _default
