"""Run a function on W ranks of a ``torch.distributed`` process group.

    from repro_torch.testing import ranks

    def work(rank, world, n):            # a module-level (picklable) function
        mesh = launch.mesh.make_mesh((world,), ("data",), "cpu")
        ...
        return result                    # picklable; one per rank

    results = ranks.spawn(work, 4, args=(1024,), device="cpu")

:func:`spawn` starts W processes with the ``spawn`` start method (a fresh
interpreter each: CUDA state and threads of the caller are never forked),
initialises the default process group in each (``gloo``, or ``nccl``) at a
``FileStore`` in a fresh temporary directory, so concurrent callers (xdist
workers) never share a rendezvous, runs ``fn(rank, world, *args)``, waits
until every rank has finished or died on purpose, then
``destroy_process_group()`` (a rank that tears down while another is
still in a collective kills it), and returns the ranks' results in rank
order.  If any rank raises, exits or outlives ``timeout``, every rank
still running is terminated and :class:`RankFailure` is raised with each
failed rank's traceback.  No process outlives the call.

A rank may die on purpose, as a host that is lost would: :func:`die`
posts its result, marks the rank done and ends the process at once, with
no teardown.  :func:`spawn` takes that result like any other.  The wait
at teardown counts those marks in the default store, not a world-wide
``barrier()``, which a dead rank could never meet.

``device="cuda"`` selects the card ``rank % device_count`` in each rank
before the process group starts: several ranks on one card share it (NCCL
refuses two ranks on one GPU, so they must use ``gloo``, which takes CUDA
tensors for ``all_reduce`` and ``broadcast``).

The reference's multi-device tests run forced-device JAX subprocesses
(``tests/conftest.py::forced_devices``); this is their counterpart for the
port.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

__all__ = ["spawn", "die", "RankFailure"]

# seconds the other ranks get to finish once one has failed: a rank that
# waits in a collective on the failed one never does
_GRACE_S = 3.0
# this rank's result queue (set in each spawned rank)
_QUEUE = None
_DONE = "repro_torch.ranks/done/"


class RankFailure(RuntimeError):
    """One or more ranks failed; the message holds their tracebacks."""


def _store():
    from torch.distributed import distributed_c10d as c10d
    return c10d._get_default_store()


def die(result) -> None:
    """End this spawned rank now, as a host that dies would: post
    ``result`` (``spawn`` returns it in this rank's place), mark the rank
    done in the default store and exit with no teardown and no further
    call to any other rank."""
    import torch.distributed as dist
    _store().set(f"{_DONE}{dist.get_rank()}", "1")
    _QUEUE.put((dist.get_rank(), True, result))
    os._exit(0)


def _rank_main(rank: int, world: int, backend: str, device: Optional[str],
               store: str, timeout_s: float, fn: Callable, args, queue):
    import torch
    import torch.distributed as dist
    global _QUEUE
    _QUEUE = queue
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=timeout_s))
        out = fn(rank, world, *args)
        # every rank finished or died on purpose (die marks it first)
        _store().set(f"{_DONE}{rank}", "1")
        _store().wait([f"{_DONE}{r}" for r in range(world)])
        dist.destroy_process_group()
        queue.put((rank, True, out))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))
        os._exit(1)       # no teardown: another rank may wait in a collective


def spawn(fn: Callable, world: int, *, args: Sequence = (),
          backend: str = "gloo", device: Optional[str] = "cpu",
          timeout: float = 600.0) -> List[object]:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks and
    return their results in rank order (module docstring).  ``fn``, its
    arguments and its results must pickle."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    queue = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, world, backend, device, os.path.join(tmp, "store"), timeout, fn,
        tuple(args), queue)) for r in range(world)]
    results, errors = {}, {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed_at = None
        while len(results) + len(errors) < world:
            now = time.monotonic()
            if now > deadline or (failed_at is not None
                                  and now > failed_at + _GRACE_S):
                break
            while not queue.empty():
                rank, ok, out = queue.get()
                (results if ok else errors)[rank] = out
                if not ok and failed_at is None:
                    failed_at = time.monotonic()
            dead = [r for r, p in enumerate(procs)
                    if not p.is_alive() and r not in results
                    and r not in errors]
            if dead and queue.empty():
                for r in dead:
                    errors[r] = (f"rank {r} exited with code "
                                 f"{procs[r].exitcode} without a result")
                failed_at = failed_at or time.monotonic()
            time.sleep(0.02)
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [r for r in range(world) if r not in results and r not in errors]
    for r in missing:
        errors[r] = f"rank {r} did not finish within {timeout} s"
    if errors:
        raise RankFailure("\n".join(
            f"--- rank {r} ---\n{errors[r]}" for r in sorted(errors)))
    return [results[r] for r in range(world)]
