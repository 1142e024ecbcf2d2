"""Paged KV-cache: the host-side block-pool allocator behind
``kv_layout="paged"``.

The port's own copy of ``repro.serve.paged`` (host-only; nothing here
touches a device).  The dense serving cache allocates ``(slots, max_seq)``
KV positions per layer up front.  The paged layout stores KV as a pool of
fixed-size pages, ``(n_blocks, block_size, kv_heads, head_dim)`` per layer,
and gives each slot a *block table*: a ``(max_blocks,)`` row mapping the
slot's logical position ``p`` to physical page ``table[p // block_size]``
at offset ``p % block_size``.  Peak KV memory is then the pool's size, a
policy, not ``slots * max_seq``.

This module owns the HOST side: block accounting (allocate on admission,
free on retire), table-row construction and byte accounting.  The DEVICE
side (page gather/scatter and the paged attention variants) lives in
``repro_torch.models.attention``.  The shared convention is the
**sentinel**: a table entry ``n_blocks`` means "no page here".  Writes
through it land in the pool's one trash page (index ``n_blocks``, never
handed out: torch has no ``mode='drop'``, so a dropped write needs a place
no live lane can reach), and reads through it are masked by the attention's
``kpos <= pos`` validity test.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["BlockPool", "blocks_for", "table_row", "dtype_bytes",
           "dense_kv_bytes", "paged_kv_bytes"]


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache positions (>= 1)."""
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return max(1, -(-int(n_tokens) // int(block_size)))


class BlockPool:
    """Free-list allocator over ``n_blocks`` KV pages of ``block_size``
    positions each.

    Deterministic: blocks are handed out in ascending id order from a
    LIFO free list, so a given admission sequence always produces the same
    tables.  Owners are opaque keys (the engine uses slot indices);
    ``free(owner)`` returns every page the owner holds, so retirement can
    never leak."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {n_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._owned: Dict[object, List[int]] = {}

    # -- accounting ----------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def owned(self, owner) -> List[int]:
        return list(self._owned.get(owner, ()))

    # -- allocate / free -----------------------------------------------------

    def alloc(self, owner, n: int) -> List[int]:
        """Take ``n`` pages for ``owner`` (appends to its existing pages)."""
        if n < 0:
            raise ValueError(f"alloc: n must be >= 0, got {n}")
        if n > len(self._free):
            raise ValueError(
                f"block pool exhausted: owner {owner!r} asked for {n} "
                f"blocks, {len(self._free)} free of {self.n_blocks}")
        got = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(owner, []).extend(got)
        return got

    def free(self, owner) -> int:
        """Return every page ``owner`` holds; returns how many were freed."""
        got = self._owned.pop(owner, [])
        self._free.extend(reversed(got))  # LIFO: freed pages are reused first
        return len(got)

    def stats(self) -> Dict[str, int]:
        return {"n_blocks": self.n_blocks, "block_size": self.block_size,
                "free": self.free_blocks, "used": self.used_blocks,
                "owners": len(self._owned)}

    # -- integrity -----------------------------------------------------------

    def validate(self) -> List[str]:
        """Check the allocator invariants; returns the violations (empty =
        healthy): every block id in range; no id both free and owned; no id
        owned twice or free twice; free + owned covers exactly the pool.
        "In range" is below ``n_blocks``: the trash page ``n_blocks`` is
        never handed out, so an id naming it (or past it) is damage too.
        The continuous engine checks this at every chunk boundary and
        degrades paged -> dense on a violation."""
        problems: List[str] = []
        seen: Dict[int, str] = {}
        for b in self._free:
            if not 0 <= b < self.n_blocks:
                problems.append(f"free list holds out-of-range block {b}")
            elif b in seen:
                problems.append(f"block {b} on the free list twice")
            else:
                seen[b] = "free"
        for owner, blocks in self._owned.items():
            for b in blocks:
                if not 0 <= b < self.n_blocks:
                    problems.append(f"owner {owner!r} holds out-of-range "
                                    f"block {b}")
                elif b in seen:
                    problems.append(f"block {b} double-booked "
                                    f"({seen[b]} and owner {owner!r})")
                else:
                    seen[b] = f"owner {owner!r}"
        if not problems and len(seen) != self.n_blocks:
            missing = [b for b in range(self.n_blocks) if b not in seen]
            problems.append(f"blocks neither free nor owned: {missing[:8]}")
        return problems


def table_row(blocks: List[int], max_blocks: int, sentinel: int) -> List[int]:
    """A slot's full ``(max_blocks,)`` table row: its pages in logical
    order, sentinel-padded.  The whole row is written on admission so a
    previous occupant's mapping can never leak into a reused slot."""
    if len(blocks) > max_blocks:
        raise ValueError(f"{len(blocks)} blocks exceed the table width "
                         f"{max_blocks}")
    return list(blocks) + [int(sentinel)] * (max_blocks - len(blocks))


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------

_DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2,
                "float8_e4m3fn": 1, "float8_e5m2": 1, "int8": 1}


def dtype_bytes(dtype) -> int:
    """Bytes per KV element of a dtype named as ``ModelConfig.dtype``
    names it."""
    return _DTYPE_BYTES.get(str(dtype), 4)


def _kv_layers(cfg) -> int:
    """KV-carrying layers: none for ssm, one shared block per group for
    hybrid, every layer otherwise."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def dense_kv_bytes(cfg, slots: int, max_seq: int) -> int:
    """Resident bytes of the dense ``(slots, max_seq)`` KV cache."""
    db = dtype_bytes(cfg.dtype)
    return 2 * _kv_layers(cfg) * slots * max_seq * cfg.n_kv_heads * cfg.hd * db


def paged_kv_bytes(cfg, n_blocks: int, block_size: int) -> int:
    """Resident bytes of the paged pool's ``n_blocks`` pages (tables, and
    the port's one trash page a layer, are noise on top)."""
    db = dtype_bytes(cfg.dtype)
    return (2 * _kv_layers(cfg) * n_blocks * block_size
            * cfg.n_kv_heads * cfg.hd * db)
