"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The port of ``repro.launch.train`` on one device: config -> model -> train
state (weights from a generator seeded 0 on the device) -> train step ->
``SyntheticLM`` -> ``TrainLoop`` (checkpoint every ``--ckpt-every`` steps
into ``--ckpt-dir``, resume from its newest checkpoint, the NaN guard, the
watchdog).  It runs on the CUDA device unless ``--device cpu`` is given;
``--smoke`` takes the reduced config.  Every ``--log-every`` steps it logs
the loss, the gradient norm, the learning rate, the step time (host clock;
each step ends in a host sync), tokens per second and, on the card, the
peak device memory.

On a mesh.  Under an initialised ``torch.distributed`` process group (one
started by the caller, or the one this launcher starts from the
environment ``torchrun`` sets), the launcher builds the reference's
``(nd, 1)`` ``("data", "model")`` mesh, ``nd`` being ``--data-axis`` (0:
every rank), sets ``sharding.ctx``'s mesh, draws the state and keeps this
rank's shards of it (``train.step``: FSDP when ``cfg.fsdp``, else
replicated), runs the sharded step, checkpoints the global state (the
data group's index 0 writes) and logs on every rank, with the rank and
its peak memory.  ``TrainLoop`` retries no step there: a rank that fails
fails the run.  Without a process group ``--data-axis`` must be 0 or 1.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen3_4b --smoke --device cpu --data-axis 2"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU tests)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default the card")
    ap.add_argument("--data-axis", type=int, default=0,
                    help="mesh data-axis size; 0 = all ranks")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch.configs import config, smoke_config
    from repro_torch.device import resolve_device

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("repro_torch.train")

    cfg = smoke_config(args.arch) if args.smoke else config(args.arch)
    dev = resolve_device(args.device)
    started = False
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        started = True
    try:
        return _run(args, cfg, dev, log)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, cfg, dev, log) -> int:
    import torch
    import torch.distributed as dist

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.ft.resilience import TrainLoop
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    from repro_torch.sharding import ctx
    from repro_torch.train.step import (make_train_state, make_train_step,
                                        state_specs)

    model = Model(cfg)
    mesh, rank, ckpt_kw, retries = None, "", {}, {}
    world = dist.get_world_size() if dist.is_initialized() else 1
    nd = args.data_axis or world
    if dist.is_initialized():
        if nd != world:
            raise ValueError(f"--data-axis {nd}: the mesh (nd, 1) takes "
                             f"every one of the {world} ranks")
        mesh = make_mesh((nd, 1), ("data", "model"), dev.type)
        ctx.set_mesh(mesh)
        rank = f" rank={dist.get_rank()}/{world}"
        ckpt_kw = {"mesh": mesh, "specs": state_specs(
            make_train_state(model, torch.Generator(), device="meta",
                             use_8bit=cfg.opt_8bit), mesh, cfg)}
        retries = {"max_retries": 0}
    elif nd != 1:
        raise ValueError(f"--data-axis {nd} needs a process group of {nd} "
                         f"ranks (torchrun)")
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             use_8bit=cfg.opt_8bit, device=dev, mesh=mesh)
    log.info("arch=%s device=%s layers=%d d_model=%d dtype=%s mesh=%s%s",
             cfg.name, dev, cfg.n_layers, cfg.d_model, cfg.dtype,
             None if mesh is None else {"data": nd, "model": 1}, rank)
    step = make_train_step(model, mesh, microbatches=args.microbatches,
                           base_lr=args.lr, total_steps=args.steps)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch,
                                  n_codebooks=cfg.n_codebooks))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    last = [time.perf_counter()]

    def on_metrics(i, m):
        if cuda:
            # the step returns with its update still queued on the card
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        dt, last[0] = now - last[0], now
        if (i + 1) % args.log_every == 0 or i == 0:
            peak = (f" peak={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
                    f"GiB" if cuda else "")
            log.info("step=%d loss=%.4f gnorm=%.3f lr=%.2e applied=%d "
                     "%.1fms/step %.0f tok/s%s%s", i + 1, m["loss"],
                     m["grad_norm"], m["lr"], m["applied"], dt * 1e3,
                     args.batch * args.seq / dt, peak, rank)

    loop = TrainLoop(step, CheckpointManager(args.ckpt_dir, keep=2,
                                             **ckpt_kw), data,
                     ckpt_every=args.ckpt_every, **retries)
    loop.run(state, num_steps=args.steps, on_metrics=on_metrics)
    log.info("done: %d steps (skipped=%d)%s", args.steps,
             loop.skipped_steps, rank)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
