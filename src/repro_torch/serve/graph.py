"""The decode chunk as a CUDA graph: captured once per key, replayed after.

The reference's decode chunk is one jitted ``lax.scan`` with sampling
fused in, its buffers donated, and one host sync per chunk; jit compiles it
once per shape and a detector flags any recompile after warm-up.  The
port's counterpart is :class:`ChunkGraphs`: the engine's chunk function
(``chunk`` decode steps over static buffers, sampling included) is
captured once per ``(batch, chunk, sampled)`` key and replayed, so the
~1 800 launches of a decode step leave the host's loop.

How a key's first chunk runs.  ``torch.cuda.graphs`` asks for an eager
warm-up on a side stream before a capture.  That warm-up is the chunk's
own work: it runs eagerly on a side stream and its results stand.  The
capture that follows records the same calls without running them, so it
changes no state, and every later chunk of the key is a replay.  The
graphs of one engine share one memory pool; they never run at once.

Random numbers.  Each slot's ``torch.Generator`` is registered with every
graph (``CUDAGraph.register_generator_state``).  A replay reads the
generator's seed and offset as they are at that moment and advances the
offset by what the capture consumed, as eager calls would, so a replay
draws the same numbers as the eager chunk.  Installing a request's stream
at admission is ``manual_seed`` on the slot's generator, which changes the
registered state in place.

Launch counts.  A kernel wrapper counts when it is called; under capture
that call records its kernel and launches nothing.  So the capture's counts
are taken back, and each replay adds them once (``ops.add_launches``).

No fallback: a capture or a replay that fails raises; a chunk runs eagerly
on the card only when the engine was asked for that (``graph=False``)."""
from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Sequence, Tuple

import torch

from repro_torch.kernels import ops

__all__ = ["ChunkGraphs"]


class ChunkGraphs:
    """The CUDA graphs of one engine's decode chunk, one per key."""

    def __init__(self, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.device = device
        self._graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, dict]] = {}
        self._pool = None
        self.keys: List[Hashable] = []      # in the order they were captured

    @property
    def captures(self) -> int:
        return len(self.keys)

    def reset(self) -> None:
        """Drop every graph and the memory pool (their buffers are gone);
        the keys captured so far stay counted, and a key met again is
        captured anew."""
        self._graphs.clear()
        self._pool = None

    def run(self, key: Hashable, chunk_fn: Callable[[], None],
            generators: Sequence[torch.Generator]) -> None:
        """Run one chunk: replay ``key``'s graph, or, the first time, run
        ``chunk_fn`` eagerly on a side stream and capture it."""
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs[key] = self._capture(chunk_fn, generators)
            self.keys.append(key)
            return
        graph, delta = entry
        graph.replay()
        ops.add_launches(delta)

    def _capture(self, chunk_fn, generators):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            chunk_fn()                  # this chunk's own work: the warm-up
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for g in generators:
            graph.register_generator_state(g)
        before = ops.launch_snapshot()
        with torch.cuda.graph(graph, pool=self._pool):
            chunk_fn()                  # recorded, not run
        after = ops.launch_snapshot()
        delta = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        ops.add_launches(delta, -1)     # the capture launched nothing
        if self._pool is None:
            self._pool = graph.pool()
        return graph, delta

