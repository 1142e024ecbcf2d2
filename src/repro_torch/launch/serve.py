"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Builds the model at full width on the CUDA device (``--device cpu`` runs
the plain PyTorch versions instead; ``--smoke`` takes the reduced config),
with random weights drawn from a seeded generator on that device, prefills
a batch of random prompts and decodes with :class:`BatchedEngine`.  The
config has ``use_flash=True``, the reference's TPU-target setting; the
port's prefill runs the flash-attention kernel whatever the flag says."""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import torch

from repro_torch.configs import config, smoke_config
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import BatchedEngine, Request


def build(arch: str, *, smoke: bool = False, device: DeviceLike = None,
          seed: int = 0, **overrides):
    """(cfg, model, params) for ``arch`` with ``use_flash=True``, params
    drawn on ``device`` from a generator seeded ``seed``."""
    cfg = (smoke_config if smoke else config)(arch, use_flash=True,
                                              **overrides)
    dev = resolve_device(device)
    model = Model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, model, model.init_params(gen, dev)


def make_requests(vocab: int, lengths: Sequence[int], max_new: int, *,
                  temperature: float = 0.0, top_k: int = 0,
                  seed: int = 0) -> List[Request]:
    """Requests with random prompts of the given lengths (host tensors)."""
    gen = torch.Generator().manual_seed(seed)
    return [Request(prompt=torch.randint(0, vocab, (n,), generator=gen),
                    max_new_tokens=max_new, temperature=temperature,
                    top_k=top_k) for n in lengths]


def profile(engine: BatchedEngine, reqs: List[Request], path: str) -> None:
    """Serve ``reqs`` twice more, warm: once timed by the host clock, once
    under ``torch.profiler``.  Writes the Chrome trace to ``path`` and
    prints the ops with the most device time and the device's busy share:
    the profiled run's total kernel time over the unprofiled run's wall
    time (the profiler's host cost stretches its own run several-fold, but
    not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    cuda = engine.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    t0 = time.perf_counter()
    engine.run(reqs)
    sync()
    wall = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=acts) as prof:
        engine.run(reqs)
        sync()
    prof.export_chrome_trace(path)
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e6
    print(f"profile: warm run {wall:.3f} s wall, kernels {busy:.3f} s on "
          f"the device ({busy / wall:.1%} busy); trace {path}")
    print(events.table(sort_by="self_device_time_total" if cuda
                       else "self_cpu_time_total", row_limit=20))


def main(argv: Optional[Sequence[str]] = None) -> List[List[int]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per host sync")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' for the plain versions")
    ap.add_argument("--profile", metavar="TRACE_JSON",
                    help="after the timed run, serve the same requests "
                         "under torch.profiler and write a Chrome trace")
    args = ap.parse_args(argv)

    cfg, model, params = build(args.arch, smoke=args.smoke,
                               device=args.device)
    reqs = make_requests(cfg.vocab, [args.prompt_len] * args.batch,
                         args.max_new, temperature=args.temperature)
    engine = BatchedEngine(model, params,
                           max_seq=args.prompt_len + args.max_new + 8,
                           chunk=args.chunk)
    t0 = time.perf_counter()
    outs = engine.run(reqs)
    dt = time.perf_counter() - t0
    total_new = sum(len(o) for o in outs)
    print(f"arch={cfg.name} device={engine.device} batch={args.batch} "
          f"generated {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s)")
    for i, o in enumerate(outs):
        print(f"  request[{i}]: {o[:12]}{'...' if len(o) > 12 else ''}")
    if args.profile:
        profile(engine, reqs, args.profile)
    return outs


if __name__ == "__main__":
    main()
