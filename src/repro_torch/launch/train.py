"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

The port of ``repro.launch.train`` on one device: config -> model -> train
state (weights from a generator seeded 0 on the device) -> train step ->
``SyntheticLM`` -> ``TrainLoop`` (checkpoint every ``--ckpt-every`` steps
into ``--ckpt-dir``, resume from its newest checkpoint, the NaN guard, the
watchdog).  It runs on the CUDA device unless ``--device cpu`` is given;
``--smoke`` takes the reduced config.  Every ``--log-every`` steps it logs
the loss, the gradient norm, the learning rate, the step time (host clock;
each step ends in a host sync), tokens per second and, on the card, the
peak device memory."""
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
    args = ap.parse_args(argv)

    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs import config, smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.ft.resilience import TrainLoop
    from repro_torch.models.transformer import Model
    from repro_torch.train.step import make_train_state, make_train_step

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger("repro_torch.train")

    cfg = smoke_config(args.arch) if args.smoke else config(args.arch)
    dev = resolve_device(args.device)
    model = Model(cfg)
    state = make_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             use_8bit=cfg.opt_8bit, device=dev)
    log.info("arch=%s device=%s layers=%d d_model=%d dtype=%s", cfg.name,
             dev, cfg.n_layers, cfg.d_model, cfg.dtype)
    step = make_train_step(model, microbatches=args.microbatches,
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
                     "%.1fms/step %.0f tok/s%s", i + 1, m["loss"],
                     m["grad_norm"], m["lr"], m["applied"], dt * 1e3,
                     args.batch * args.seq / dt, peak)

    loop = TrainLoop(step, CheckpointManager(args.ckpt_dir, keep=2), data,
                     ckpt_every=args.ckpt_every)
    loop.run(state, num_steps=args.steps, on_metrics=on_metrics)
    log.info("done: %d steps (skipped=%d)", args.steps, loop.skipped_steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
