"""Deterministic, sharded, checkpointable synthetic token pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only, the same
Philox streams, so every batch is bitwise the reference's): batches stay
numpy arrays here and become tensors only at the train step.

Each global step's batch is a pure function of (seed, step) — so restarts
resume bit-identically from the checkpointed step counter, and each data
shard host materialises only its slice (shard-aware by construction; there is
no shared filesystem dependency).  Tokens follow a Zipf-ish distribution with
short-range structure (repeat motifs) so losses move like language, not noise.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_codebooks: int = 0     # musicgen-style multi-codebook streams


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self) -> Dict:
        return {"step": self.step}

    @staticmethod
    def from_dict(d: Dict) -> "DataState":
        return DataState(step=int(d["step"]))


class SyntheticLM:
    """tokens[t+1] depends weakly on tokens[t]: mixture of a Zipf draw and a
    shifted copy, which gives learnable bigram structure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=self.cfg.seed, counter=step))

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._batch_rng(step)
        shape = (cfg.global_batch, cfg.seq_len + 1)
        if cfg.n_codebooks:
            shape = shape + (cfg.n_codebooks,)
        z = rng.zipf(1.3, size=shape).astype(np.int64)
        toks = (z - 1) % cfg.vocab
        # motif structure: with p=0.3, copy the previous token + 1
        copy = rng.random(shape) < 0.3
        shifted = np.roll(toks, 1, axis=1)
        toks = np.where(copy, (shifted + 1) % cfg.vocab, toks)
        toks = toks.astype(np.int32)
        inputs = toks[:, :-1]
        labels = toks[:, 1:]
        if cfg.n_codebooks:
            labels = labels[..., 0]          # predict codebook 0 (stub head)
        return {"tokens": inputs, "labels": labels}

    def shard_at(self, step: int, shard: int, num_shards: int
                 ) -> Dict[str, np.ndarray]:
        """Deterministic slice for data-parallel host ``shard``."""
        b = self.cfg.global_batch
        if b % num_shards:
            raise ValueError(f"global batch {b} does not split into "
                             f"{num_shards} shards")
        per = b // num_shards
        full = self.global_batch_at(step)
        return {k: v[shard * per:(shard + 1) * per] for k, v in full.items()}

    def iterator(self, state: Optional[DataState] = None, *, shard: int = 0,
                 num_shards: int = 1) -> Iterator[Tuple[Dict, DataState]]:
        state = state or DataState()
        step = state.step
        while True:
            yield self.shard_at(step, shard, num_shards), DataState(step + 1)
            step += 1
