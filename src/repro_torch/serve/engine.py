"""Serving engine: static batch, batched prefill, chunked decode.

The port of ``repro.serve.engine``'s :class:`BatchedEngine` and its
samplers.  Prefill runs the whole batch at once, right-padded to the
longest prompt, with ``Model.prefill(lengths=...)`` taking each row's
next-token logits at its own last position.  Decode then runs lock-step in
chunks of ``chunk`` steps; every step stays on the device (sampling
included), and the host syncs once per chunk, when it reads the chunk's
``(batch, chunk)`` token block.

Sampling determinism: request ``i`` of a run with seed ``seed`` draws from
its own ``torch.Generator`` seeded from ``(seed, i)``, advanced only by that
request's own sampled tokens, so the tokens a request receives depend on
the request alone, not on its neighbours in the batch.  These streams give
other bits than the reference's JAX ``fold_in`` keys: the two packages
agree token for token only in greedy mode.

The continuous engine, scheduler, paged KV, tuning cache, AOT, resilience
and obs layers of the reference arrive with later slices (ROADMAP.md)."""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.models.transformer import Model

__all__ = ["Request", "BatchedEngine", "sample", "sample_tokens"]


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample(logits, generator: Optional[torch.Generator] = None, *,
           temperature: float = 0.0, top_k: int = 0):
    """Sample one token per row of ``logits`` (..., vocab) with shared knobs.

    ``temperature <= 0`` is greedy argmax.  ``top_k > 0`` keeps the k
    largest logits per row; values tied with the k-th largest are all kept
    (the cutoff is a >=-threshold, not a count), and ``top_k >= vocab`` is a
    no-op.  Sampling is Gumbel-max over ``generator``'s uniforms."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    scaled = logits.float() / temperature
    vocab = scaled.shape[-1]
    if 0 < top_k < vocab:
        kth = scaled.topk(top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (scaled + gumbel).argmax(dim=-1)


def sample_tokens(logits, generators: Sequence[torch.Generator],
                  temps: Sequence[float], top_ks: Sequence[int]):
    """Per-request sampling over a batch: row ``i`` of ``logits`` (b, vocab)
    is sampled with ``temps[i]`` (``<= 0`` means greedy for that row),
    ``top_ks[i]`` (``0`` means no top-k filter) and ``generators[i]``.

    The knobs are host values known per request, so choosing the path costs
    no device sync: an all-greedy batch is one argmax, and only the sampled
    rows draw random numbers, each from its own generator."""
    toks = logits.argmax(dim=-1)
    for i, t in enumerate(temps):
        if t > 0.0:
            toks[i] = sample(logits[i], generators[i], temperature=t,
                             top_k=top_ks[i])
    return toks


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    prompt: Sequence[int]        # (s,) token ids: a list or a 1-D tensor
    max_new_tokens: int = 32
    temperature: float = 0.0
    top_k: int = 0


def _stream_seed(seed: int, index: int) -> int:
    """The seed of request ``index``'s generator in a run seeded ``seed``:
    a hash of both, so that every bit depends on each (the CPU generator
    reads only the low 32 bits of its seed)."""
    digest = hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=8)
    return int.from_bytes(digest.digest(), "little")


# ---------------------------------------------------------------------------
# static batch
# ---------------------------------------------------------------------------

class BatchedEngine:
    """Static-batch serving engine: prefill a batch of requests together,
    then decode lock-step in chunks until every request has its
    ``max_new_tokens``.

    The engine runs on the device its params live on.  Each request is
    sampled with its own temperature/top-k; prompts are right-padded to the
    batch max and ``prefill(lengths=...)`` takes each row's real next-token
    logits, so padding never distorts positions or outputs."""

    def __init__(self, model: Model, params, max_seq: int = 512,
                 chunk: int = 8):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.chunk = chunk
        self.device = params["embed"].device
        self.n_prefills = 0
        self.n_decode_steps = 0
        self.n_chunks = 0

    def stats(self) -> Dict[str, int]:
        """Work done so far: prefill calls, decode steps, decode chunks
        (each chunk is one host sync)."""
        return {"prefills": self.n_prefills,
                "decode_steps": self.n_decode_steps,
                "chunks": self.n_chunks}

    def _check_request(self, r: Request) -> None:
        need = len(r.prompt) + max(int(r.max_new_tokens), 0)
        if need > self.max_seq:
            raise ValueError(
                f"request needs {need} cache positions (prompt "
                f"{len(r.prompt)} + {r.max_new_tokens} new) but max_seq is "
                f"{self.max_seq}")

    def run(self, requests: List[Request], seed: int = 0) -> List[List[int]]:
        model, dev = self.model, self.device
        for r in requests:
            self._check_request(r)
        b = len(requests)
        lengths = [len(r.prompt) for r in requests]
        s = max(lengths)
        tokens = torch.zeros((b, s), dtype=torch.long, device=dev)
        for i, r in enumerate(requests):
            tokens[i, :lengths[i]] = torch.as_tensor(r.prompt,
                                                     dtype=torch.long)
        cache = model.init_cache(b, self.max_seq, device=dev)
        pos = torch.tensor(lengths, dtype=torch.long, device=dev)
        with torch.inference_mode():
            logits, cache = model.prefill(self.params, tokens, cache,
                                          lengths=pos)
            self.n_prefills += 1
            temps = [float(r.temperature) for r in requests]
            top_ks = [int(r.top_k or 0) for r in requests]
            gens = [torch.Generator(device=dev).manual_seed(
                _stream_seed(seed, i)) for i in range(b)]
            tok = sample_tokens(logits, gens, temps, top_ks)

            outs: List[List[int]] = [[] for _ in requests]
            remaining = [max(int(r.max_new_tokens), 0) for r in requests]
            first = tok.tolist()                 # the prefill's host sync
            for i in range(b):
                if remaining[i] > 0:
                    outs[i].append(first[i])
                    remaining[i] -= 1

            while any(n > 0 for n in remaining):
                block = []
                for _ in range(self.chunk):
                    logits, cache = model.decode_step(self.params,
                                                      tok[:, None], cache,
                                                      pos)
                    tok = sample_tokens(logits, gens, temps, top_ks)
                    # a finished row keeps decoding to the chunk's end; past
                    # max_seq its cache writes are dropped
                    pos = (pos + 1).clamp(max=self.max_seq)
                    block.append(tok)
                self.n_decode_steps += self.chunk
                self.n_chunks += 1
                rows = torch.stack(block, dim=1).tolist()   # one host sync
                for i in range(b):
                    take = min(remaining[i], self.chunk)
                    outs[i].extend(rows[i][:take])
                    remaining[i] -= take
        return outs
