"""Sharding rules: parameters, optimizer state, activations, KV caches.

The port of ``repro.sharding.rules``, its logic kept line for line.

Strategy (the reference's):
  * TP   — the 'model' axis splits head/ff/expert/vocab dims (Megatron
           col/row);
  * FSDP — when cfg.fsdp, the 'data' (+'pod') axes additionally shard the
           complementary dim of every matrix (ZeRO-3 style);
  * EP   — expert dim over 'model' when divisible, else TP inside experts;
  * SP   — sequence dim of activations over 'model' between blocks.

A dimension-size-aware auto-sharder with a small override table: every
architecture shards without per-arch spec tables, and no spec it emits
fails to divide.

What differs from the reference, and why:

  * **The spec type.**  :class:`PartitionSpec` is the port's own: a tuple
    with one entry per tensor dim, each None, an axis name, or a tuple of
    axis names (split over their product, the first axis major),
    normalised as JAX's.
  * **The layout.**  The port keeps one dict per layer
    (``params["blocks"][i]``) where the reference stacks the layers along a
    leading axis.  Layer ``i``'s leaf gets the reference's spec of the
    stacked leaf with its leading None dropped, and its path is the
    reference's without the layer index (``blocks/attn/wo``).  The returned
    trees have the port's layout.
  * **The mesh.**  Every function takes a ``DeviceMesh`` (named dims) or
    anything with a ``shape`` mapping of axis sizes (``mesh.shape["data"]``,
    the reference's duck type), so the rules run with no process group.
  * **Placements.**  :func:`named` turns specs into DTensor placements, one
    per mesh dim (``Shard(d)`` or ``Replicate()``), the counterpart of the
    reference's ``NamedSharding``; :func:`local_shard` cuts a global tensor
    into one rank's piece by them, :func:`shard_cache` a serving cache by
    :func:`cache_specs`, and :func:`kv_slice` says which batch rows,
    positions and kv heads of the KV leaves that piece holds (the serving
    step on a model axis reads it: ``sharding.collectives.
    TensorParallel``).

Size-1 axes are named like the others (qwen3-4b on ``{data: 2, model:
1}`` gives the reference's stacked ``wq`` ``(None, None, 'model')``, each
port layer's ``(None, 'model')``); a size-1 axis splits nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["PartitionSpec", "PS", "mesh_shape", "dp_axes", "param_spec",
           "params_specs", "opt_state_specs", "batch_specs",
           "activation_spec", "cache_specs", "kv_slice", "state_slice",
           "shard_cache",
           "named", "local_shard", "tree_map_specs"]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name, or a tuple of axis
    names.  As JAX's, a tuple of one name is that name and an empty tuple
    None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else (e[0] if len(e) == 1 else tuple(e))
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"

    def __reduce__(self):
        # rebuilt from its entries (a tuple subclass would otherwise be
        # rebuilt from one tuple, read as a single entry)
        return (PartitionSpec, tuple(self))


PS = PartitionSpec


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` (named dims), of anything with
    a ``shape`` mapping, or of such a mapping."""
    if isinstance(mesh, Mapping):
        return {str(a): int(s) for a, s in mesh.items()}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {str(a): int(s) for a, s in zip(names, tuple(mesh.shape))}
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping):
        return {str(a): int(s) for a, s in shape.items()}
    raise TypeError(f"expected a DeviceMesh with named dims or a mesh with "
                    f"a shape mapping, got {type(mesh).__name__}")


def dp_axes(mesh) -> Tuple[str, ...]:
    shape = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in shape)


def _axis_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    if axes is None:
        return 1
    if isinstance(axes, str):
        return shape[axes]
    return int(math.prod(shape[a] for a in axes)) if axes else 1


def _divides(mesh, axes, dim: int) -> bool:
    return dim % _axis_size(mesh, axes) == 0


def param_spec(leaf, path: str, mesh, *, fsdp: bool,
               stacked_dims: int = 0) -> PS:
    """Auto-shard one parameter leaf.

    stacked_dims: number of leading layer-stack dims to leave unsharded
    (0 for the port's per-layer leaves)."""
    shape = tuple(leaf.shape)[stacked_dims:]
    lead = (None,) * stacked_dims
    model = "model" if "model" in mesh_shape(mesh) else None
    fs = dp_axes(mesh) if fsdp else None

    if len(shape) == 0:
        return PS(*lead)
    if len(shape) == 1:
        # vectors: shard over model when cleanly divisible and large
        if model and shape[0] >= 1024 and _divides(mesh, model, shape[0]):
            return PS(*lead, model)
        return PS(*lead, None)

    # matrices / tensors: pick the model dim = last dim by default (column
    # parallel); for *_out / w_down / wo style (detected by name) use first
    # (row parallel).  FSDP takes the complementary dim.
    row_parallel = any(t in path for t in ("wo", "w_down", "w_out", "cw_v",
                                           "w_lora_b", "head"))

    if "router" in path:
        return PS(*lead, *([None] * len(shape)))
    if path.endswith("embed"):
        # (vocab, d): shard vocab over model, d over fsdp axes
        spec = [None] * len(shape)
        if model and _divides(mesh, model, shape[-2]):
            spec[-2] = model
        if fs and _divides(mesh, fs, shape[-1]):
            spec[-1] = fs
        return PS(*lead, *spec)

    if len(shape) == 3 and ("w_gate" in path or "w_up" in path
                            or "w_down" in path):
        # MoE expert tensors (E, d, f) / (E, f, d): experts over model (EP)
        # when divisible, else TP on the ff dim.
        e = shape[0]
        if model and _divides(mesh, model, e):
            spec = [model, None, None]
            if fs and _divides(mesh, fs, shape[1]):
                spec[1] = fs
            return PS(*lead, *spec)
        ff_dim = 2 if "w_down" not in path else 1
        spec = [None, None, None]
        if model and _divides(mesh, model, shape[ff_dim]):
            spec[ff_dim] = model
        other = 1 if ff_dim == 2 else 2
        if fs and _divides(mesh, fs, shape[other]):
            spec[other] = fs
        return PS(*lead, *spec)

    if row_parallel:
        m_dim, f_dim = 0 if len(shape) == 2 else len(shape) - 2, len(shape) - 1
    else:
        m_dim, f_dim = len(shape) - 1, len(shape) - 2

    spec = [None] * len(shape)
    if model and _divides(mesh, model, shape[m_dim]):
        spec[m_dim] = model
    if fs and _divides(mesh, fs, shape[f_dim]) and spec[f_dim] is None:
        spec[f_dim] = fs
    return PS(*lead, *spec)


def _walk(fn, node, path: Tuple):
    """``fn(path, leaf)`` over a tree of dicts and lists; a tuple (a
    QTensor) is one leaf; None stays None."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _walk(fn, v, path + (k,)) for k, v in node.items()}
    if isinstance(node, list):
        return [_walk(fn, v, path + (i,)) for i, v in enumerate(node)]
    return fn(path, node)


def _rule_path(path: Tuple) -> str:
    """The reference's path string of a port leaf: keys joined by ``/``,
    the layer index of ``blocks`` left out (the reference's stacked
    leaf)."""
    return "/".join(str(k) for k in path if not isinstance(k, int))


def params_specs(params, mesh, cfg):
    """PartitionSpec tree for a parameter tree (the port's layout)."""
    def assign(path, leaf):
        # the reference's scan-stacked leaves lose their leading layer
        # dims here: each port leaf is one layer's (ssm's (L,) blocks, the
        # hybrid's (G, E) mamba / mamba_ln stacks), and the hybrid's
        # shared block, unstacked in the reference too, is carried once;
        # the path keeps the reference's names ("blocks/mamba/w_out",
        # "blocks/shared_attn/wq"), so the name tests pick the same dims
        return param_spec(leaf, _rule_path(path), mesh, fsdp=cfg.fsdp,
                          stacked_dims=0)
    return _walk(assign, params, ())


def opt_state_specs(params_spec_tree, mesh, cfg):
    """Adam moments shard exactly like their parameters (plus they are always
    FSDP-sharded when the config asks for it — ZeRO-1)."""
    return params_spec_tree  # moments mirror param specs


def batch_specs(mesh) -> PS:
    return PS(dp_axes(mesh) or None)


def activation_spec(mesh, *, sp: bool = True) -> PS:
    """(b, s, d) activations: batch over dp axes, seq over model (SP)."""
    model = "model" if (sp and "model" in mesh_shape(mesh)) else None
    return PS(dp_axes(mesh) or None, model, None)


def cache_specs(cfg, mesh, cache):
    """KV cache sharding for decode: batch over dp; kv-heads over model
    when divisible, else sequence-sharded KV (flash-decode layout).
    ``cache`` is a ``KVCache`` (k, v) or a tree of them (dicts, lists);
    the result has its structure."""
    model = "model" if "model" in mesh_shape(mesh) else None
    dp = dp_axes(mesh) or None

    dp_sz = _axis_size(mesh, dp)

    def assign(p, shape):
        if "kv" in p or p.endswith("k") or p.endswith("v"):
            # stacked (L, b, s, kv, hd)
            if len(shape) == 5:
                bspec = dp if shape[1] % dp_sz == 0 else None
                if model and shape[3] % _axis_size(mesh, model) == 0:
                    return PS(None, bspec, None, model, None)
                if model and shape[2] % _axis_size(mesh, model) == 0:
                    return PS(None, bspec, model, None, None)  # seq-sharded
                return PS(None, bspec, None, None, None)
        if len(shape) >= 2:
            spec = [None] * len(shape)
            # batch dim is the first non-layer dim
            bdim = 1 if len(shape) >= 3 else 0
            if shape[bdim] % dp_sz == 0:
                spec[bdim] = dp
            # try model on the largest remaining divisible dim
            rest = [(i, s) for i, s in enumerate(shape)
                    if i != bdim and spec[i] is None]
            rest.sort(key=lambda t: -t[1])
            for i, s in rest:
                if model and s % _axis_size(mesh, model) == 0 and s >= 64:
                    spec[i] = model
                    break
            return PS(*spec)
        return PS(*([None] * len(shape)))

    def walk(node, path):
        fields = getattr(node, "_fields", None)
        if fields is not None:             # a NamedTuple (KVCache)
            return type(node)(*(walk(getattr(node, f), path + (f,))
                                for f in fields))
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        if node is None:
            return None
        return assign("/".join(map(str, path)), tuple(node.shape))
    return walk(cache, ())


def tree_map_specs(fn, spec_tree, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure
    (dicts, lists; a PartitionSpec is a leaf; a QTensor's spec is a
    QTensor of specs, matched field by field)."""
    if spec_tree is None:
        return None
    if isinstance(spec_tree, PartitionSpec):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: tree_map_specs(fn, v, *(t[k] for t in trees))
                for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [tree_map_specs(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(spec_tree)]
    if isinstance(spec_tree, tuple):       # a QTensor of specs
        return type(spec_tree)(*(tree_map_specs(fn, v, *(t[i] for t in trees))
                                 for i, v in enumerate(spec_tree)))
    raise TypeError(f"not a spec tree node: {type(spec_tree).__name__}")


def _mesh_axes(mesh, spec: PS):
    """Per tensor dim, the tuple of axes that split it (absent or empty:
    whole), checked against the mesh's dim order."""
    shape = mesh_shape(mesh)
    order = list(shape)
    out = []
    for entry in spec:
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            if a not in shape:
                raise ValueError(f"spec {spec} names axis {a!r}, which the "
                                 f"mesh {shape} lacks")
        if [order.index(a) for a in axes] != sorted(order.index(a)
                                                    for a in axes):
            raise ValueError(f"spec {spec}: the axes {axes} of one dim must "
                             f"follow the mesh's order {order}")
        out.append(axes)
    return out


def named(mesh, spec_tree):
    """Each spec's DTensor placements, one per mesh dim: ``Shard(d)`` where
    mesh dim ``a`` splits tensor dim ``d``, else ``Replicate()``.  Several
    mesh dims splitting one tensor dim shard it in mesh order, as a tuple
    of axes does (the first axis major)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_shape(mesh))

    def one(spec):
        placements = [Replicate()] * len(names)
        for d, axes in enumerate(_mesh_axes(mesh, spec)):
            for a in axes:
                placements[names.index(a)] = Shard(d)
        return tuple(placements)
    return tree_map_specs(one, spec_tree)


def _split_of(mesh, spec: PS, coordinate: Dict[str, int]):
    """Per tensor dim, ``(index, parts)`` of the piece the rank at
    ``coordinate`` (axis -> index) holds: the axes of a dim flattened, the
    first major."""
    shape = mesh_shape(mesh)
    out = []
    for axes in _mesh_axes(mesh, spec):
        idx, parts = 0, 1
        for a in axes:
            idx, parts = idx * shape[a] + coordinate[a], parts * shape[a]
        out.append((idx, parts))
    return out


def local_shard(t: torch.Tensor, mesh, spec: PS,
                coordinate: Dict[str, int]) -> torch.Tensor:
    """The piece of the global tensor ``t`` that the rank at
    ``coordinate`` holds under ``spec`` (a view; equal to DTensor's
    ``distribute_tensor(t, mesh, named(mesh, spec)).to_local()``)."""
    if len(spec) != t.dim():
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"{t.dim()}-dim tensor")
    for d, (idx, parts) in enumerate(_split_of(mesh, spec, coordinate)):
        if parts > 1:
            if t.shape[d] % parts:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split into {parts} under {spec}")
            n = t.shape[d] // parts
            t = t.narrow(d, idx * n, n)
    return t


def shard_cache(cfg, mesh, cache, coordinate: Dict[str, int]):
    """The piece of the serving ``cache`` (a ``KVCache`` or a tree of them,
    global shapes) that the rank at ``coordinate`` holds under
    :func:`cache_specs`: fresh tensors of the cache's structure, the
    counterpart of the train step's ``shard_state`` for the KV leaves."""
    specs = cache_specs(cfg, mesh, cache)

    def walk(spec, node):
        if node is None:
            return None
        fields = getattr(node, "_fields", None)
        if fields is not None:
            return type(node)(*(walk(getattr(spec, f), getattr(node, f))
                                for f in fields))
        if isinstance(node, dict):
            return {k: walk(spec[k], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(sp, v) for sp, v in zip(spec, node))
        return local_shard(node, mesh, spec, coordinate).clone()
    return walk(specs, cache)


def kv_slice(cfg, mesh, shape, coordinate: Dict[str, int]) -> Dict:
    """What the rank at ``coordinate`` holds of layer-stacked KV leaves of
    global ``shape`` (L, b, max_seq, nkv, hd) under :func:`cache_specs`:
    ``{"rows": (b0, b1), "pos": (p0, p1), "heads": (h0, h1), "max_seq":
    max_seq}``, each range of the global dim, and ``"layout"``: ``"heads"``
    where ``model`` splits the kv heads, ``"seq"`` where it splits the
    positions (the flash-decode layout), ``"whole"`` where it splits
    neither."""
    spec = cache_specs(cfg, mesh, {"k": torch.empty(shape, device="meta")})
    out = {"max_seq": shape[2], "layout": "whole"}
    for name, dim, (idx, parts) in zip(
            (None, "rows", "pos", "heads", None), shape,
            _split_of(mesh, spec["k"], coordinate)):
        if name is None:
            continue
        n = dim // parts
        out[name] = (idx * n, (idx + 1) * n)
    axes = _mesh_axes(mesh, spec["k"])
    sizes = mesh_shape(mesh)
    for name, dim in (("seq", 2), ("heads", 3)):
        if "model" in axes[dim] and sizes["model"] > 1:
            out["layout"] = name
    return out


def state_slice(cfg, mesh, cache, coordinate: Dict[str, int]) -> Dict:
    """What the rank at ``coordinate`` holds of each recurrent state leaf
    of the serving ``cache`` (global shapes; ``meta`` tensors will do)
    under :func:`cache_specs`, the counterpart of :func:`kv_slice`:
    ``{path: {"shape": the leaf's global shape, "spec": its spec, "held":
    per dim the range (lo, hi) of the global dim}}`` for rwkv6's
    ``tshift``, ``cshift`` and ``wkv`` and the hybrid's ``mamba/conv`` and
    ``mamba/ssm``; empty for the transformer families, whose cache is KV
    alone.

    The rules read these leaves as they read any other, so their layout
    follows from their names and sizes: ``wkv`` and ``mamba/conv`` take
    the KV branch (``"kv"`` in the path, a path ending in ``v``), so
    ``model`` splits ``wkv``'s key index and the conv tail's batch rows
    (or nothing); the rest take their "first non-layer dim" for the batch,
    which for the hybrid's (G, E, b, ...) leaves is ``attn_every``."""
    specs = cache_specs(cfg, mesh, cache)
    if cfg.family == "ssm":
        state, spec = cache, specs
        prefix = ""
    elif cfg.family == "hybrid":
        state, spec = cache["mamba"], specs["mamba"]
        prefix = "mamba/"
    else:
        return {}
    out = {}
    for name, t, sp in zip(state._fields, state, spec):
        held = tuple((idx * (n // parts), (idx + 1) * (n // parts))
                     for n, (idx, parts) in zip(
                         t.shape, _split_of(mesh, sp, coordinate)))
        out[prefix + name] = {"shape": tuple(t.shape), "spec": sp,
                              "held": held}
    return out
