"""Rank work of ``tests/test_torch_sharded_train.py``: the port's sharded
train step on gloo ranks of the CPU.  Imports only ``repro_torch`` (and
torch, numpy): the parent computes the reference's values with JAX and
sends the initial state and the batches as numpy.

Every case starts from the reference's train state (numpy, its layout),
converts it (``models.convert.train_state_from_numpy``), cuts this rank's
shards (``train.step.shard_state``), runs the sharded step and returns,
per step, the metrics and the whole state again (``gather_state``), as
numpy in the port's layout.
"""
from __future__ import annotations

import os

import numpy as np
import torch

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab=64, dtype="float32", remat=True,
            qk_norm=True, max_seq=32)
STEP = dict(base_lr=1e-2, warmup=1, total_steps=20)


def cfg_of(**kw):
    from repro_torch.models.common import ModelConfig
    return ModelConfig(**{**TINY, **kw})


def numpy_state(state):
    """``(path, array)`` of every tensor of a port state (a QTensor's
    payload and scale as ``path + ("q",)`` / ``("scale",)``)."""
    from repro_torch.optim import adamw
    out = []
    for path, leaf in adamw.leaves(state):
        if isinstance(leaf, adamw.QTensor):
            out += [(path + ("q",), leaf.q.detach().numpy().copy()),
                    (path + ("scale",), leaf.scale.detach().numpy().copy())]
        else:
            out.append((path, leaf.detach().numpy().copy()))
    return out


def _mesh(world):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((world, 1), ("data", "model"), "cpu")


def run_case(mesh, ref_state, batches, *, microbatches=1, model_cls=None,
             **cfg_kw):
    """The sharded step from the reference's state on ``batches``: per
    step ``(metrics, whole state as numpy)``."""
    from repro_torch.models.convert import train_state_from_numpy
    from repro_torch.models.transformer import Model
    from repro_torch.train import step as tstep
    cfg = cfg_of(**cfg_kw)
    model = (model_cls or Model)(cfg)
    whole = train_state_from_numpy(cfg, ref_state, device="cpu")
    specs = tstep.state_specs(whole, mesh, cfg)
    state = tstep.shard_state(whole, mesh, specs)
    step = tstep.make_train_step(model, mesh, microbatches=microbatches,
                                 **STEP)
    out = []
    for batch in batches:
        state, m = step(state, batch)
        out.append((m, numpy_state(tstep.gather_state(state, mesh, specs))))
    return out, state, specs, step


def _nan_model(rank_with_nan):
    """A model class whose loss is NaN on one rank's rows."""
    import torch.distributed as dist

    from repro_torch.models.transformer import Model

    class NanModel(Model):
        def loss(self, params, batch):
            out = super().loss(params, batch)
            return out * float("nan") if dist.get_rank() == rank_with_nan \
                else out
    return NanModel


def checksum_state(state):
    return [(p, a.tobytes()) for p, a in numpy_state(state)]


def placements(mesh, specs_np):
    """Each spec's local piece by ``rules.local_shard`` and by DTensor's
    ``distribute_tensor(...).to_local()``, on a tensor of distinct
    values."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding import rules
    coord = dict(zip(rules.mesh_shape(mesh), mesh.get_coordinate()))
    out = []
    for shape, spec in specs_np:
        t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
            shape)
        spec = rules.PS(*spec)
        mine = rules.local_shard(t, mesh, spec, coord)
        theirs = distribute_tensor(t, mesh, list(rules.named(
            mesh, spec))).to_local()
        out.append((tuple(shape), tuple(spec), bool(torch.equal(mine,
                                                               theirs))))
    return out


def compress_work(mesh, axis, rows, errs):
    """compress.bf16_psum / int8_ef_psum of this rank's row."""
    from repro_torch.ft import compress
    import torch.distributed as dist
    r = dist.get_rank()
    g = {"a": torch.tensor(rows[r])}
    e = {"a": torch.tensor(errs[r])}
    bf = compress.bf16_psum({"a": g["a"].clone()}, axis, mesh)["a"]
    red, new_e = compress.int8_ef_psum(g, e, axis, mesh)
    q, scale = compress._q8(torch.tensor(rows[r]))
    zeros = compress.init_error_state(g)["a"]
    return {"bf16": bf.numpy(), "int8": red["a"].numpy(),
            "err": new_e["a"].numpy(), "q8": (q.numpy(), float(scale)),
            "zeros": (zeros.dtype == torch.float32 and not zeros.any())}


def rank_work_two(rank, world, ref, tmp):
    """The 2-rank spawn: every case of ``ref`` (``{name: (cfg kw, step
    kw, numpy state, batches)}``) on ``data=2``, the NaN drill, the
    placements, ``constraint``, compress, checkpoints and the launcher."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.sharding import collectives, ctx, rules
    from repro_torch.train import step as tstep
    mesh = _mesh(world)
    res = {"runs": {}, "collectives": {}}
    for name, (cfg_kw, step_kw, state, batches) in ref["cases"].items():
        for mode in ("dp", "fsdp"):
            if name == "8bit" and mode == "dp":
                continue
            kw = {**cfg_kw, "fsdp": mode == "fsdp"}
            out, _, _, step = run_case(mesh, state, batches, **step_kw, **kw)
            res["runs"][f"{mode}_{name}"] = out
            res["collectives"][f"{mode}_{name}"] = dict(
                step.placement.group.counts)

    # a NaN loss on rank 1's rows only: nobody writes a bit
    cfg_kw, _, state, batches = ref["cases"]["base"]
    for mode in ("dp", "fsdp"):
        from repro_torch.models.convert import train_state_from_numpy
        cfg = cfg_of(**cfg_kw, fsdp=mode == "fsdp")
        whole = train_state_from_numpy(cfg, state, device="cpu")
        specs = tstep.state_specs(whole, mesh, cfg)
        local = tstep.shard_state(whole, mesh, specs)
        before = checksum_state(local)
        step = tstep.make_train_step(_nan_model(1)(cfg), mesh, **STEP)
        local, m = step(local, batches[0])
        res[f"nan_{mode}"] = (m, before == checksum_state(local))
    # a global batch the data ranks do not divide
    try:
        step(local, {k: v[:3] for k, v in batches[0].items()})
        res["odd_batch"] = None
    except ValueError as e:
        res["odd_batch"] = str(e)

    # DTensor placements on three meshes of these two ranks: the given
    # specs and the rules' own for every param of the FSDP config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Model
    res["placements"] = {}
    for shape, axes in (((2,), ("data",)), ((2, 1), ("data", "model")),
                        ((1, 2), ("data", "model"))):
        m = make_mesh(shape, axes, "cpu")
        label = ",".join(f"{a}={n}" for a, n in zip(axes, shape))
        cfg = cfg_of(fsdp=True)
        meta = Model(cfg).init_params(torch.Generator(), "meta")
        actual = []
        rules.tree_map_specs(
            lambda sp, t: actual.append((tuple(t.shape), tuple(sp))),
            rules.params_specs(meta, m, cfg), meta)
        res["placements"][label] = placements(
            m, ref["placement_specs"][label] + actual)

    # constraint with a mesh set; on the model axis inside the tensor-
    # parallel step's context, where x is this rank's sequence shard
    model_mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    x = torch.ones(4, 8, 16)
    tp = tstep.make_train_step(Model(cfg_of()), model_mesh,
                               **STEP).placement.tensor_parallel(8)
    out = {}
    for label, m, t in (("data=2,model=1", mesh, x),
                        ("data=1,model=2", model_mesh,
                         x[:, tp.rows[0]:tp.rows[1]])):
        ctx.set_mesh(m)
        try:
            with ctx.tensor_parallel(tp if m is model_mesh else None):
                out[label] = ctx.constraint(t, ctx.dp_axes(), "model",
                                            None) is t
        except NotImplementedError as e:
            out[label] = str(e)
    ctx.set_mesh(None)
    group = collectives.DataGroup(model_mesh)
    out["data_group"] = (group.size, group.index, group.split_dim(
        rules.PS("data", "model")), collectives.ModelGroup(
            model_mesh).split_dim(rules.PS("data", "model")))
    res["constraint"] = out

    # compress over the data axis
    res["compress"] = compress_work(mesh, "data", *ref["compress"])

    # checkpoints: one FSDP step, saved whole from the mesh; and the
    # parent's one-process checkpoint cut into this rank's shards
    cfg_kw, _, state, batches = ref["cases"]["base"]
    _, local, specs, _ = run_case(mesh, state, batches[:1], fsdp=True,
                                  **cfg_kw)
    mgr = CheckpointManager(os.path.join(tmp, "from_mesh"), mesh=mesh,
                            specs=specs, async_save=False)
    mgr.save(1, local, extra={"data_state": {"step": 1}})
    res["saved_shards"] = numpy_state(local)
    mgr = CheckpointManager(os.path.join(tmp, "from_one"), mesh=mesh,
                            specs=specs)
    step_no, restored, extra = mgr.restore_latest(local)
    res["restored"] = (step_no, extra, numpy_state(restored),
                       dict(mgr.group.coordinate))

    # the launcher on the mesh
    from repro_torch.launch import train
    res["launch"] = train.main([
        "--arch", "qwen3_4b", "--smoke", "--device", "cpu", "--data-axis",
        str(world), "--steps", "2", "--batch", "4", "--seq", "16",
        "--log-every", "1", "--ckpt-every", "2",
        "--ckpt-dir", os.path.join(tmp, "launch")])
    ctx.set_mesh(None)
    res["coordinate"] = dict(zip(rules.mesh_shape(mesh),
                                 mesh.get_coordinate()))
    return res


def rank_work_four(rank, world, ref):
    """The 4-rank spawn: ``pod=2, data=2, model=1``, FSDP and DP on the
    base case; compress over a 4-rank data axis."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    cfg_kw, step_kw, state, batches = ref["cases"]["base"]
    res = {"runs": {}}
    for mode in ("dp", "fsdp"):
        out, _, _, step = run_case(mesh, state, batches, **step_kw,
                                   **cfg_kw, fsdp=mode == "fsdp")
        res["runs"][f"{mode}_base"] = out
    res["index"] = step.placement.group.index
    line = make_mesh((world,), ("data",), "cpu")
    res["compress"] = compress_work(line, "data", *ref["compress"])
    return res

