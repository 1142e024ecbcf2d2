"""Stage III (mesh backend): mesh-level strategies -> SPMD shards + collectives
over ``torch.distributed``.

The port's copy of ``repro.core.dpia.stage3_shardmap``: the paper's strategy
hierarchy at the multi-device level.  ``map[mesh(ax)]`` distributes blocks
over a named mesh axis exactly as ``mapWorkgroup`` distributed blocks over
OpenCL work groups, and a ``reduce[mesh(ax)]`` over the distributed blocks
becomes a single ``all_reduce`` on the axis's process group: the collective
schedule is the one the functional term dictates (strategy preservation at
the collective level).

Canonical forms accepted (what the strategy rewrites produce):

  1. [Join] (Map_{mesh ax} f (Split c E))                      -- sharded map
  2. Reduce_{mesh ax} (+|max) z (Map_{mesh ax} f (Split c E))  -- + all-reduce

where E is built from input Vars with Zip (chunking commutes with Zip).
Argument Vars that do NOT flow through the Split (a scal's alpha, rmsnorm's
weight vector, matmul's B operand) are passed to every shard whole
(replicated): the mesh map shards the big operand and broadcasts the small
ones, the data-parallel reading of the term.

Where the reference wraps the body in ``jax.shard_map``, this is SPMD over
a ``DeviceMesh``: every rank calls the same compiled program with the same
arguments, and the program runs the shard of its own rank
(``i = mesh.get_local_rank(ax)``):

  * inputs: a plain tensor is the replicated global value and the rank
    takes its chunk ``[i*c:(i+1)*c]``; a ``DTensor`` placed ``Shard(0)`` on
    ``ax`` gives its ``to_local()``, one placed ``Replicate()`` its chunk;
    any other placement raises;
  * the chunk expression (``Zip`` of the chunks) is rebuilt by
    :mod:`.interp`, as the reference's ``chunk_fn`` does;
  * the per-shard body is compiled by the inner backend: ``inner="cuda"``
    (K4, :func:`.stage3_cuda.compile_expr_cuda`: the generated kernels on a
    CUDA tensor, launched or raising; its plain version on a CPU tensor) or
    ``inner="torch"`` (:mod:`.stage3_torch`); the reference's ``"pallas"``
    and ``"jnp"``;
  * outputs: form 1 returns ``DTensor.from_local`` of the shard's output,
    ``Shard(0)`` on ``ax`` and ``Replicate()`` on every other mesh dim (the
    reference's ``out_specs=PS(ax)``), with a leading shard axis added when
    the term has no outer ``Join``; it issues no collective.  Form 2 issues
    exactly one ``all_reduce`` (SUM for ``add``, MAX for ``max``) on
    ``mesh.get_group(ax)``, never on the world group (on a (2, 2) mesh that
    would sum twice), and returns a ``Replicate()`` DTensor.

Each call of form 2 adds one to the program's ``collectives`` and to this
module's ``collectives`` count where it issues the all-reduce, and nowhere
else.  Registered as backend ``"shardmap"`` (alias ``"dpia-shardmap"``),
which requires ``mesh``.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Sequence

from . import phrases as P
from .types import Arr, ExpT

collectives = 0                 # all_reduce calls, every sharded program

INNER = ("cuda", "torch")


class MeshFormError(TypeError):
    pass


def _peel_join(e: P.Phrase):
    if isinstance(e, P.Join):
        return e.e, True
    return e, False


def _chunk_expr(e: P.Phrase, c: int):
    """Rewrite E (Vars/Zip of Vars) to its local-chunk version, returning the
    rewritten expression plus the list of (var, chunked_var) pairs."""
    if isinstance(e, P.Var):
        d = P.exp_data(e)
        if not isinstance(d, Arr):
            raise MeshFormError("sharded input must be an array")
        local = P.Var(e.name, ExpT(Arr(c, d.elem)))
        return local, [(e, local)]
    if isinstance(e, P.Zip):
        a, pa = _chunk_expr(e.a, c)
        b, pb = _chunk_expr(e.b, c)
        return P.Zip(a, b), pa + pb
    raise MeshFormError(
        f"cannot shard through {type(e).__name__}; expected Var/Zip")


def _elem(split: P.Split):
    d = P.exp_data(split)
    assert isinstance(d, Arr) and isinstance(d.elem, Arr)
    return d.elem.elem


def _dim_of(mesh, ax: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if ax not in names:
        raise MeshFormError(f"mesh axis {ax!r} not in mesh dims {names}")
    return names.index(ax)


class ShardedProgram:
    """A mesh-level term compiled for one ``DeviceMesh``: every rank calls
    it with the same arguments and runs the shard of its own rank.

    ``form`` is ``"map"`` or ``"reduce"``, ``axis`` the bound mesh axis,
    ``shard`` the compiled per-shard body (a K4 ``GeneratedProgram`` for
    ``inner="cuda"``), ``collectives`` the all-reduces this program has
    issued and ``launches`` its per-shard kernels' launches on this rank."""

    def __init__(self, *, form: str, axis: str, mesh, shard: Callable,
                 inner: str, names: Sequence[str], pairs, extras,
                 local_e: P.Phrase, chunk: int, n: int, op: str = "add",
                 joined: bool = True):
        self.form, self.axis, self.mesh = form, axis, mesh
        self.shard, self.inner, self.op, self.joined = shard, inner, op, joined
        self.chunk, self.n = chunk, n
        self._names = list(names)
        self._pairs, self._extras, self._local_e = pairs, extras, local_e
        self._dim = _dim_of(mesh, axis)
        self.collectives = 0

    @property
    def launches(self) -> int:
        return int(getattr(self.shard, "launches", 0))

    @launches.setter
    def launches(self, value: int) -> None:
        if hasattr(self.shard, "launches"):
            self.shard.launches = value

    def rank_index(self) -> int:
        """This rank's coordinate on the bound axis: the shard it runs."""
        return int(self.mesh.get_local_rank(self.axis))

    # -- inputs ---------------------------------------------------------------

    def _placements_ok(self, x, sharded: bool) -> None:
        from torch.distributed.tensor import Replicate, Shard
        if x.device_mesh != self.mesh:
            raise ValueError(f"a DTensor argument lives on mesh "
                             f"{x.device_mesh}, the program on {self.mesh}")
        for d, pl in enumerate(x.placements):
            if d == self._dim and sharded and pl == Shard(0):
                continue
            if not isinstance(pl, Replicate):
                raise ValueError(
                    f"DTensor placement {tuple(x.placements)} is not "
                    f"supported: the sharded operand takes Shard(0) or "
                    f"Replicate() on mesh axis {self.axis!r} and Replicate() "
                    f"elsewhere; a replicated operand takes Replicate() on "
                    f"every dim")

    def _local(self, x):
        """This rank's chunk of a sharded operand."""
        from torch.distributed.tensor import DTensor, Shard
        if isinstance(x, DTensor):
            self._placements_ok(x, sharded=True)
            if x.placements[self._dim] == Shard(0):
                loc = x.to_local()
                if loc.shape[0] != self.chunk:
                    raise ValueError(f"a Shard(0) operand holds "
                                     f"{loc.shape[0]} rows on this rank, the "
                                     f"strategy's chunk is {self.chunk}")
                return loc
            x = x.to_local()
        if x.shape[0] != self.n:
            raise ValueError(f"sharded operand has leading extent "
                             f"{x.shape[0]}, the term's is {self.n}")
        i = self.rank_index()
        return x[i * self.chunk:(i + 1) * self.chunk]

    def _whole(self, x):
        """A replicated operand, whole on every shard."""
        from torch.distributed.tensor import DTensor
        if isinstance(x, DTensor):
            self._placements_ok(x, sharded=False)
            return x.to_local()
        return x

    # -- the call -------------------------------------------------------------

    def shard_args(self, *args) -> tuple:
        """The arguments this rank's shard body is called with for a call
        on ``args``: the chunked operands, the replicated ones, the chunk
        (for a K4 shard, ``self.shard.bind(*shard_args)`` gives its
        launches)."""
        from .interp import interp
        if len(args) != len(self._names):
            raise TypeError(f"{len(self._names)} arguments, got {len(args)}")
        env = dict(zip(self._names, args))
        locs = [self._local(env[v.name]) for v, _ in self._pairs]
        reps = [self._whole(env[v.name]) for v in self._extras]
        chunk = interp(self._local_e, {lv.name: lo for (_, lv), lo
                                       in zip(self._pairs, locs)})
        return tuple(locs + reps + [chunk])

    def __call__(self, *args):
        out = self.shard(*self.shard_args(*args))
        if self.form == "reduce":
            return self._all_reduce(out)
        return self._sharded(out)

    def _all_reduce(self, part):
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Replicate
        global collectives
        part = part.contiguous()
        op = dist.ReduceOp.SUM if self.op == "add" else dist.ReduceOp.MAX
        dist.all_reduce(part, op=op, group=self.mesh.get_group(self.axis))
        self.collectives += 1
        collectives += 1
        return DTensor.from_local(part, self.mesh,
                                  [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    def _sharded(self, out):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        placements = [Shard(0) if d == self._dim else Replicate()
                      for d in range(self.mesh.ndim)]

        def wrap(t):
            if isinstance(t, tuple):
                return tuple(wrap(u) for u in t)
            if not self.joined:
                t = t.unsqueeze(0)
            return DTensor.from_local(t, self.mesh, placements,
                                      run_check=False)
        return wrap(out)

    def __repr__(self):
        return (f"<ShardedProgram {self.form}[mesh({self.axis})] "
                f"{self.n // self.chunk} shards, inner={self.inner!r}>")


def _analyse(expr: P.Phrase):
    """(form, axis, reduce op, joined, the mesh map) of a canonical mesh
    term; raises MeshFormError for anything else."""
    if isinstance(expr, P.Reduce) and expr.level.kind == "mesh":
        ax = expr.level.axis
        x = P.Var(P.fresh("x"), ExpT(P.exp_data(expr.init)))
        acc = P.Var(P.fresh("a"), ExpT(P.exp_data(expr.init)))
        body = expr.f(x, acc)
        if not (isinstance(body, P.BinOp) and body.op in ("add", "max")):
            raise MeshFormError("mesh reduce must combine with + or max")
        inner_map = expr.e
        if not (isinstance(inner_map, P.Map)
                and inner_map.level.kind == "mesh"
                and inner_map.level.axis == ax):
            raise MeshFormError("mesh reduce must consume a mesh map")
        return "reduce", ax, body.op, True, inner_map
    body_e, joined = _peel_join(expr)
    if isinstance(body_e, P.Map) and body_e.level.kind == "mesh":
        return "map", body_e.level.axis, "add", joined, body_e
    raise MeshFormError(
        "expression is not in a recognised mesh-level canonical form")


class ShardBody(NamedTuple):
    """The per-shard part of a canonical mesh term (:func:`shard_body`)."""
    form: str                   # "map" | "reduce"
    axis: str                   # the bound mesh axis
    op: str                     # the mesh reduce's combine ("add" | "max")
    joined: bool                # form 1 under an outer Join
    split: P.Split              # the Split the mesh map consumes
    pairs: list                 # (argument Var, its chunked Var)
    extras: list                # argument Vars passed whole (replicated)
    local_e: P.Phrase           # the chunk expression over chunked Vars
    body: P.Phrase              # one shard's body ...
    body_vars: list             # ... over chunked, replicated and chunk Vars

    @property
    def shards(self) -> int:
        return P.exp_data(self.split).n


def shard_body(expr: P.Phrase, arg_vars: Sequence[P.Var]) -> ShardBody:
    """The per-shard part of a canonical mesh term, with no mesh needed.
    ``body`` over ``body_vars`` (the chunked inputs, the replicated ones,
    the chunk) is what the inner backend compiles."""
    form, ax, op, joined, mesh_map = _analyse(expr)
    split = mesh_map.e
    if not isinstance(split, P.Split):
        raise MeshFormError("mesh map must consume a split")
    local_e, pairs = _chunk_expr(split.e, split.n)
    chunked = {v.name for v, _ in pairs}
    extras = [v for v in arg_vars if v.name not in chunked]
    blk = P.Var(P.fresh("blk"), ExpT(Arr(split.n, _elem(split))))
    body = mesh_map.f(blk)
    body_vars: List[P.Var] = [lv for _, lv in pairs] + extras + [blk]
    return ShardBody(form, ax, op, joined, split, pairs, extras, local_e,
                     body, body_vars)


def compile_shard(body: P.Phrase, body_vars, *, inner: str = "torch",
                  check: bool = True, name: str = "shard"):
    """A per-shard body through the inner backend: K4 for ``"cuda"``, the
    torch Stage III for ``"torch"``."""
    from . import stage3_cuda, stage3_torch
    if inner == "cuda":
        return stage3_cuda.compile_expr_cuda(body, body_vars, check=check,
                                             name=name)
    if inner == "torch":
        return stage3_torch.compile_expr(body, body_vars, check=check)
    raise ValueError(f"shardmap: inner must be one of {INNER}, got "
                     f"{inner!r}")


def shard_program(expr: P.Phrase, arg_vars: Sequence[P.Var], shards: int,
                  *, inner: str = "torch", check: bool = True,
                  name: str = "program"):
    """``(compiled per-shard body, ShardBody)`` of a mesh term split into
    ``shards`` shards, with no mesh: what :func:`compile_expr_shardmap`
    runs on every rank, under the name it gives it (so a caller can build a
    K4 shard's source before any rank starts)."""
    sb = shard_body(expr, arg_vars)
    if sb.shards != shards:
        raise MeshFormError(f"split yields {sb.shards} blocks but axis "
                            f"{sb.axis!r} has {shards}")
    return compile_shard(sb.body, sb.body_vars, inner=inner, check=check,
                         name=f"{name}.shard_{sb.axis}{shards}"), sb


def compile_expr_shardmap(expr: P.Phrase, arg_vars: Sequence[P.Var], mesh,
                          *, inner: str = "torch", check: bool = True,
                          name: str = "program") -> ShardedProgram:
    """Compile a mesh-level functional strategy for ``mesh`` (a
    ``DeviceMesh`` with named dims): the per-shard body through the inner
    backend, the mesh level as this rank's shard plus, for a mesh reduce,
    one all-reduce on the axis group."""
    from repro_torch.mesh.strategy import is_device_mesh
    if not is_device_mesh(mesh):
        raise TypeError(f"shardmap: mesh must be a torch DeviceMesh, got "
                        f"{type(mesh).__name__}")
    ax = _analyse(expr)[1]
    shard, sb = shard_program(
        expr, arg_vars, int(tuple(mesh.shape)[_dim_of(mesh, ax)]),
        inner=inner, check=check, name=name)
    return ShardedProgram(
        form=sb.form, axis=ax, mesh=mesh, shard=shard, inner=inner,
        names=[v.name for v in arg_vars], pairs=sb.pairs, extras=sb.extras,
        local_e=sb.local_e, chunk=sb.split.n, n=sb.split.n * sb.shards,
        op=sb.op, joined=sb.joined)


# self-register as a Stage III target (see repro_torch.compiler.backends)
from ...compiler.backends import Backend as _Backend  # noqa: E402
from ...compiler.backends import register_backend as _register  # noqa: E402

_register(_Backend(
    name="shardmap", compile=compile_expr_shardmap,
    accepts=("mesh", "inner", "check", "name"), requires=("mesh",),
    description="mesh-level strategies -> SPMD shards + one all_reduce per "
                "mesh reduce over torch.distributed (pass mesh=, optional "
                "inner='torch'|'cuda')"),
    aliases=("dpia-shardmap",), overwrite=True)
