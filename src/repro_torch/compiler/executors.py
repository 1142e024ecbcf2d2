"""Process-wide executor cache: compiled Stage III callables, reused across
calls and persistable ahead of time.

The port's copy of ``repro.compiler.executors``.  The op layer
(``repro_torch.kernels.ops``) memoises its compiled DPIA programs here:

  * canonical keys: ``(kernel, shape, dtype, backend, mesh, layout,
    params)`` rendered as one stable string, so the same executor is found
    whichever layer asks for it.  The reference's key also carries its
    ``interpret`` and ``jit`` bits, which have no counterpart here: a
    generated CUDA program dispatches on its tensors' device (a CPU call
    runs the torch Stage III, a CUDA call launches the kernels), so one
    executor serves both devices;
  * hit/build statistics (``stats()``), which chip_smoke reads to assert
    one build per program;
  * an AOT store: ``save_aot(dir)`` exports every cached entry's *lowered*
    program (via ``Program.to_doc``), and ``load_aot(dir)`` rebuilds the
    executors in a fresh process without Stage I->II or the SCIR check.

A rebuilt CUDA executor regenerates its source from the persisted
command; the program's name and the command round-trip exactly, so the
source's hash finds the library an earlier process built
(``build/dpia/<name>-<sha>.so``, ``kernels._build``) and no ``nvcc`` runs.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import Callable, Dict, Optional

from repro_torch import obs
from repro_torch.ft import artefacts
from repro_torch.testing import faults

__all__ = ["ExecutorCache", "make_key", "default_cache", "AOT_VERSION"]

# the reference's AOT version (v2: the mesh-descriptor key component; v3:
# the kv_layout component); older artefacts' keys can never hit again, so
# they are skipped on load
AOT_VERSION = 3


def _fmt_params(params: Optional[Dict[str, object]]) -> str:
    if params is None:
        return "default"
    return ",".join(f"{k}={params[k]}" for k in sorted(params)) or "default"


def make_key(kernel: str, shape: Dict[str, object], backend: str, *,
             params: Optional[Dict[str, object]] = None,
             dtype: str = "float32", mesh: str = "single",
             layout: str = "dense") -> str:
    """Canonical executor key.  Every component the compiled artefact
    depends on is in the key, including the mesh descriptor and the
    serving KV layout (``CompileOptions.kv_layout``), so a hit is always
    safe to reuse.  ``params=None`` is the kernel's default strategy point
    (a pure function of the shape)."""
    shape_s = ",".join(f"{k}={shape[k]}" for k in sorted(shape))
    return (f"{kernel}|{shape_s}|{dtype}|{backend}|{mesh or 'single'}"
            f"|{layout or 'dense'}|{_fmt_params(params)}")


class ExecutorCache:
    """Memoised compiled kernels + AOT persistence.

    ``get_or_compile`` is the one dispatch entry: steady state is a dict
    lookup; a cold key runs the supplied builder (typically
    ``Program.check().lower().compile(backend)``) once per process (two
    racing threads may both build; ``setdefault`` keeps one result).
    """

    def __init__(self):
        self._mem: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._hits = 0
        self._builds = 0
        self._aot_loads = 0

    # -- dispatch -----------------------------------------------------------

    def get(self, key: str):
        return self._mem.get(key)

    def get_or_compile(self, key: str, build: Callable[[], object]):
        fn = self._mem.get(key)
        if fn is not None:
            with self._lock:
                self._hits += 1
            obs.event("executor_cache.hit", key=key)
            return fn
        # deterministic build-failure drill (``executor.build``, ctx: key):
        # raises into the caller, as a real staging failure does
        faults.raise_if("executor.build", key=key)
        with obs.span("executor_cache.build", key=key):
            fn = build()
        with self._lock:
            self._builds += 1
        obs.counter("executor_cache.builds").inc()
        return self._mem.setdefault(key, fn)

    def put(self, key: str, fn) -> None:
        with self._lock:
            self._mem[key] = fn

    def __contains__(self, key: str) -> bool:
        return key in self._mem

    def __len__(self) -> int:
        return len(self._mem)

    def keys(self):
        return list(self._mem)

    def values(self):
        return list(self._mem.values())

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._mem), "hits": self._hits,
                    "builds": self._builds, "aot_loads": self._aot_loads}

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._hits = self._builds = self._aot_loads = 0

    # -- AOT store ----------------------------------------------------------

    @staticmethod
    def _aot_path(directory: str, key: str) -> str:
        h = hashlib.sha1(key.encode()).hexdigest()[:16]
        return os.path.join(directory, f"prog-{h}.json")

    def save_aot(self, directory: str, keys=None) -> int:
        """Export the cached executors whose provenance is a Program.

        ``keys`` restricts the export to those cache keys.  Files already
        present are left alone (the export is content-addressed by key).
        Returns the number of programs written."""
        from .program import CompiledKernel
        os.makedirs(directory, exist_ok=True)
        keyset = None if keys is None else set(keys)
        written = 0
        for key, fn in list(self._mem.items()):
            if not isinstance(fn, CompiledKernel):
                continue
            if keyset is not None and key not in keyset:
                continue
            path = self._aot_path(directory, key)
            if os.path.exists(path):
                continue
            doc = {"version": AOT_VERSION, "key": key,
                   "backend": fn.backend, "program": fn.program.to_doc()}
            # checksummed + atomic: a torn or bit-flipped program file is
            # detected and quarantined at load instead of silently skipped
            artefacts.save_json(path, doc)
            written += 1
        return written

    def load_aot(self, directory: str) -> int:
        """Populate the cache from an AOT directory (idempotent).

        Each artefact is rebuilt as an imperative-only Program and compiled
        through the backend registry: Stage I->II and the SCIR check are
        skipped.  Version skew is a silent skip (expected after an
        upgrade); a CORRUPT file (unparseable, or failing its embedded
        checksum) is quarantined to ``<directory>/.quarantine/`` and
        reported through the always-on ``artefact.load_failed`` counter
        (``ft.artefacts``), never silently dropped.  A file whose program
        fails to REBUILD is reported but left in place: the file is
        intact, the environment changed.  Returns the number of executors
        loaded."""
        from .backends import get_backend
        from .program import Program
        if not os.path.isdir(directory):
            return 0
        qdir = os.path.join(directory, ".quarantine")
        loaded = 0
        for name in sorted(os.listdir(directory)):
            if not name.endswith(".json") or name.startswith("."):
                continue
            path = os.path.join(directory, name)
            doc = artefacts.load_json(path, what="AOT program", qdir=qdir)
            if doc is None:
                continue  # corrupt (quarantined + reported) or vanished
            try:
                if doc.get("version") != AOT_VERSION:
                    continue
                key = doc["key"]
                if key in self._mem:
                    continue
                prog = Program.from_doc(doc["program"])
                b = get_backend(doc["backend"])
                with obs.span("executor_cache.aot_load", key=key,
                              backend=b.name):
                    fn = prog.compile(b)
                self.put(key, fn)
                with self._lock:
                    self._aot_loads += 1
                obs.counter("executor_cache.aot_loads").inc()
                # the staged strategy arrived via the AOT store: record it
                # (the params component is the 7th field of the key)
                parts = key.split("|")
                obs.record("executor", prog.kernel or prog.name, key,
                           {"params": parts[6] if len(parts) > 6 else "?"},
                           "aot-loaded", shape=dict(prog.shape),
                           backend=b.name,
                           strategy_trace=prog.strategy_trace,
                           note=f"program {prog.name!r} rebuilt from "
                                f"{directory}")
                loaded += 1
            except (OSError, ValueError, KeyError, TypeError) as e:
                # a well-formed file that cannot be rebuilt here: report,
                # skip, never poison the whole load
                artefacts.report_load_failure(path, "AOT program", e)
                continue
        return loaded


_default: Optional[ExecutorCache] = None
_default_lock = threading.Lock()


def default_cache() -> ExecutorCache:
    """The process-wide executor cache (what ``kernels.ops`` dispatches
    on)."""
    global _default
    with _default_lock:
        if _default is None:
            _default = ExecutorCache()
        return _default
