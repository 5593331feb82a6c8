"""Port parity, training under the parallel plan on microbatches whose rows
do not split evenly over the batch axes: a train step with
``microbatches=2`` whose microbatch has fewer rows than the batch axes'
ranks (one row over two: the second rank holds none) or a count that does
not divide by them (three rows over two: 2 and 1).

The reference's step splits the batch into microbatches inside ``jit``
and its ``with_sharding_constraint`` pins pad a dimension that does not
divide, so it runs sharded there. The port places each microbatch by
``place_batch`` as DTensor's uneven parts (``torch.chunk``'s: ceil rows
on the first ranks, none on the last) and runs the same sharded step.
Jobs, each ``microbatches=2`` at S=32 (the machinery of
``tests/test_torch_mesh_moe.py``: the reference's ``jit`` step in one
subprocess with 4 host devices on ``jax.sharding.Mesh``\\ es of Auto axes
built directly; the port in 4 spawned ``gloo`` processes a mesh; the
port's unsharded step in this process meanwhile):

* the widened reduced dense SmolLM of ``tests/test_torch_mesh.py`` (f32,
  d_model 256, FSDP and TP both engaged) on a (data=2, model=2) mesh at
  B=2 (one row a microbatch) and B=6 (three rows), and on a (pod=2,
  data=1, model=2) mesh, ``multi``'s layout, at B=2;
* the reduced granite-moe (f32, head_dim 64) under each of its three
  dispatches on the (2, 2) mesh at B=2, and under ``global`` (the
  default, arctic-480b's) on the (2, 1, 2) mesh. ``sharded`` and
  ``shardmap`` route each data shard's tokens with its own capacity, and
  the reference's shards split the flattened tokens evenly (16 of the one
  row's 32 tokens each), not the padded rows: the port's must too;
* the reduced Jamba (the Mamba conv and chunk scan, the MoE), xLSTM (the
  mLSTM and sLSTM blocks) and Qwen2-VL (M-RoPE positions split on axis 1)
  on the (2, 2) mesh at B=2, held to the port's unsharded step only (their
  functions do not depend on the split; their sharded steps are held to
  the reference's in ``tests/test_torch_mesh_ssm.py`` and
  ``tests/test_torch_mesh_enc.py``).

Both packages start from one state: the port's ``init_state`` (seed 0),
which the reference reads from a file. The reference's step returns no
gradients, so its subprocess wraps the step's ``adamw_update`` to keep
them beside the moments: they are the gradients the reference's own
jitted step hands to AdamW. Tolerances (``tests/test_torch_mesh.py``'s,
each with its reason there): the loss and the gradients' global norm
within 1e-5 relative; the first step's gradients allclose with rtol 1e-4
and atol 1e-5 x the leaf's largest magnitude. Where the reference's
gradients are not finite (the pad token's embedding row: see
:func:`test_uneven_step_matches_reference`), the port's row is held to
its unsharded step's, or the two local dispatches' to each other. Every
process runs one torch thread.
"""
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig
from repro_torch.data import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.train.optimizer import tree_map
from repro_torch.train.step import init_state, loss_and_grads, \
    make_train_step
from test_torch_mesh import WIDEN
from test_torch_mesh_moe import DISPATCHES, _flat, job, job_cfg

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
S, MB, WARMUP = 32, 2, 1
TIMEOUT = 420
MESH = (2, 2)
POD = (2, 1, 2)


def _job(name, arch, mesh, B, dispatch=None, over=None, ref=True,
         step=False):
    """A job; ``ref``: the reference runs it too; ``step``: the port runs
    ``make_train_step`` on it besides ``loss_and_grads``."""
    j = job(name, arch, dispatch)
    if over is not None:
        j["over"] = over
    return dict(j, mesh=list(mesh), B=B, ref=ref, step=step)


JOBS = [
    _job("dense_1row", "smollm-360m", MESH, 2, over=WIDEN, step=True),
    _job("dense_3rows", "smollm-360m", MESH, 6, over=WIDEN),
    _job("dense_pod", "smollm-360m", POD, 2, over=WIDEN),
    *(_job(f"moe_{d}", "granite-moe-1b-a400m", MESH, 2, d,
           step=d == "sharded") for d in DISPATCHES),
    _job("moe_pod", "granite-moe-1b-a400m", POD, 2, "global"),
    # the blocks on local rows of the other families (the Mamba conv and
    # scan, the mLSTM and sLSTM, M-RoPE's positions split on axis 1): the
    # split-independent functions, held to the unsharded step
    *(_job(a.split("-")[0], a, MESH, 2, ref=False)
      for a in ("jamba-v0.1-52b", "xlstm-125m", "qwen2-vl-7b")),
]
REF_JOBS = [j for j in JOBS if j["ref"]]


def _names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")


def _data(cfg, B):
    return SyntheticTokens(cfg, ShapeConfig("mesh", "train", S, B), seed=0)


# --- the ranks -----------------------------------------------------------


def _rank(rank, world, shape, jobs, out_dir):
    """One rank of a mesh of ``shape`` (spawned): for each job, the rows
    every rank holds of the first microbatch, the placed gradients
    (``loss_and_grads(microbatches=2)``, gathered) and, for a ``step``
    job, one step of ``make_train_step(microbatches=2)``.
    Rank 0 writes
    ``out_dir/<name>.npz`` and ``<name>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.sharding import ctx, place

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(
            out_dir, "store_" + "x".join(map(str, shape))),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = launch_mesh.init_mesh(shape, _names(shape), "cpu")
        for j in jobs:
            cfg = job_cfg(j)
            ctx.configure(mesh)
            model = build_model(cfg, tp=2, device="cpu")
            placed = place.place_state(
                init_state(model, torch.Generator().manual_seed(0)), mesh)
            batch = _data(cfg, j["B"]).batch(0)
            first = place.place_batch(
                {"labels": batch["labels"][:j["B"] // MB]}, cfg)
            rows = [None] * world
            dist.all_gather_object(rows, first["labels"].to_local().shape[0])
            loss, g = loss_and_grads(model, placed["params"], batch,
                                     microbatches=MB)
            out = {f"grad/{k}": v
                   for k, v in _flat(place.gather_state(g)).items()}
            meta = {"grad_loss": float(loss), "rows": rows,
                    "placements": str(loss.placements)}
            del g
            if j["step"]:
                _, m = make_train_step(model, microbatches=MB,
                                       warmup=WARMUP)(placed, batch)
                meta.update(loss=float(m["loss"]), gnorm=float(m["gnorm"]))
            if rank == 0:
                np.savez(os.path.join(out_dir, j["name"] + ".npz"), **out)
                with open(os.path.join(out_dir, j["name"] + ".json"),
                          "w") as f:
                    json.dump(meta, f)
            ctx.reset()
        dist.barrier()
    finally:
        ctx.reset()
        dist.destroy_process_group()


def _spawn(shape, jobs, out_dir):
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    return mp.start_processes(
        _rank, args=(int(np.prod(shape)), tuple(shape), jobs, out_dir),
        nprocs=int(np.prod(shape)), join=False, start_method="spawn")


def _join(procs, deadline):
    try:
        while not procs.join(timeout=2):
            assert time.monotonic() < deadline, "the gloo ranks timed out"
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)


# --- the reference's sharded step, in a subprocess -------------------------

_REF = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import jax
from jax.sharding import AxisType, Mesh, NamedSharding
from repro.configs import ARCHS, reduced
from repro.configs.base import ShapeConfig
from repro.data import SyntheticTokens
from repro.launch.mesh import batch_axes, data_size
from repro.models import build_model
from repro.sharding.ctx import configure
from repro.sharding.specs import P, batch_specs, tree_param_specs
import repro.train.step as ref_step
from repro.train.step import make_train_step

update = ref_step.adamw_update


def adamw_keeping_grads(params, grads, opt, lr, **kw):
    # the reference's update, the gradients it took kept beside it
    new_params, new_opt, gnorm = update(params, grads, opt, lr, **kw)
    return new_params, dict(new_opt, g=grads), gnorm


ref_step.adamw_update = adamw_keeping_grads
for job in json.loads({jobs!r}):
    over = {{k: tuple(v) if isinstance(v, list) else v
             for k, v in job["over"].items()}}
    cfg = dataclasses.replace(reduced(ARCHS[job["arch"]]), **over)
    if job["dispatch"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=job["dispatch"]))
    shape = tuple(job["mesh"])
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), names,
                axis_types=(AxisType.Auto,) * len(shape))
    configure(mesh)

    def ns(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    model = build_model(cfg, tp=2)
    state = {{}}
    for path, arr in np.load(os.path.join({tmp!r}, job["name"] + "_init.npz")
                             ).items():
        node = state
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {{}})
        node[last] = arr
    p_specs = tree_param_specs(state["params"], 2, data_size(mesh))
    s_specs = {{"params": p_specs, "opt": {{"m": p_specs, "v": p_specs,
                                           "step": P()}}}}
    o_specs = {{"params": p_specs, "opt": dict(s_specs["opt"], g=p_specs)}}
    step = jax.jit(make_train_step(model, microbatches={mb},
                                   warmup={warmup}),
                   in_shardings=(ns(s_specs),
                                 ns(batch_specs(batch_axes(mesh), cfg,
                                                None))),
                   out_shardings=(ns(o_specs), ns({{"loss": P(), "gnorm": P(),
                                                    "lr": P()}})))
    data = SyntheticTokens(cfg, ShapeConfig("mesh", "train", {S}, job["B"]),
                           seed=0)
    state, m = step(state, data.batch(0))
    out = {{"loss": np.asarray(m["loss"]), "gnorm": np.asarray(m["gnorm"])}}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            state["opt"]["g"])[0]:
        out["g/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    np.savez(os.path.join({tmp!r}, job["name"] + "_ref.npz"), **out)
print("REF_MESH_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this file, once: the reference's steps (one
    subprocess), the (2, 2) and (2, 1, 2) mesh runs (4 gloo ranks each,
    one after the other) and the port's unsharded runs in this process
    meanwhile. Returns ``{name: namespace(ref, mesh, meta, plain)}``."""
    tmp = tmp_path_factory.mktemp("mesh_uneven")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    plain = {}
    try:
        for j in REF_JOBS:
            model = build_model(job_cfg(j), tp=2, device="cpu")
            state = init_state(model, torch.Generator().manual_seed(0))
            np.savez(tmp / f"{j['name']}_init.npz",
                     **_flat(tree_map(lambda x: x.clone(), state)))
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF.format(
                src=SRC, jobs=json.dumps(REF_JOBS), tmp=str(tmp), mb=MB,
                warmup=WARMUP, S=S)],
            env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        deadline = time.monotonic() + TIMEOUT
        try:
            for shape in (MESH, POD):
                procs = _spawn(shape, [j for j in JOBS
                                       if tuple(j["mesh"]) == shape],
                               str(tmp / "mesh"))
                if shape == MESH:
                    for j in JOBS:
                        cfg = job_cfg(j)
                        model = build_model(cfg, tp=2, device="cpu")
                        state = init_state(model,
                                           torch.Generator().manual_seed(0))
                        loss, g = loss_and_grads(
                            model, state["params"],
                            _data(cfg, j["B"]).batch(0), microbatches=MB)
                        plain[j["name"]] = {
                            "grad_loss": float(loss),
                            **{f"grad/{k}": v for k, v in _flat(g).items()}}
                _join(procs, deadline)
            stdout, stderr = ref.communicate(
                timeout=max(deadline - time.monotonic(), 1))
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    finally:
        torch.set_num_threads(threads)
    assert "REF_MESH_OK" in stdout, stdout + stderr
    out = {}
    for j in JOBS:
        n = j["name"]
        with open(tmp / "mesh" / f"{n}.json") as f:
            meta = json.load(f)
        out[n] = types.SimpleNamespace(
            ref=dict(np.load(tmp / f"{n}_ref.npz")) if j["ref"] else None,
            mesh=dict(np.load(tmp / "mesh" / f"{n}.npz")), meta=meta,
            plain=plain[n])
    return out


def _sub(flat, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def _close(got, want, what):
    """Every leaf allclose (rtol :data:`GRAD_RTOL`, atol :data:`GRAD_ATOL`
    x the leaf's largest magnitude)."""
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        atol = GRAD_ATOL * float(np.abs(w).max())
        np.testing.assert_allclose(got[name], w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("name, rows", [
    ("dense_1row", [1, 1, 0, 0]),      # (data, model) ranks: data=1 empty
    ("dense_3rows", [2, 2, 1, 1]),
    ("dense_pod", [1, 1, 0, 0]),       # (pod, data, model): pod=1 empty
])
def test_ranks_hold_chunk_parts(runs, name, rows):
    """``place_batch`` gives each rank ``torch.chunk``'s part of the
    microbatch's rows over the batch axes: ceil rows on the first ranks,
    the rest (none) on the last, the same on every "model" rank."""
    assert runs[name].meta["rows"] == rows


@pytest.mark.parametrize("name", [j["name"] for j in REF_JOBS])
def test_uneven_step_matches_reference(runs, name):
    """The loss and gradients of ``loss_and_grads(microbatches=2)`` and
    the gradients' norm (for a ``step`` job the loss and norm of
    ``make_train_step(microbatches=2)``) against the reference's sharded
    step (its gradients as the step hands them to AdamW); the loss comes
    back replicated.

    On some of these runs (the MoE on (2, 2), the dense model on (pod=2,
    data=1, model=2)) one row of the reference's gradients is not finite:
    the embedding's row 0, the token id of the row XLA pads the
    microbatch's one row with, whose garbage cotangent its scatter-add
    takes in (no token of the batch is 0). The reference's norm, and so
    its clipped update, are NaN there. That row is held elsewhere (the
    unsharded step; the two local dispatches agreeing), and the norm to
    the reference's other gradients with the port's row in its place."""
    r = runs[name]
    j = next(j for j in JOBS if j["name"] == name)
    got, ref = _sub(r.mesh, "grad"), _sub(r.ref, "g")
    bad = {k: ~np.isfinite(v) for k, v in ref.items()
           if not np.isfinite(v).all()}
    assert set(bad) <= {"embed"}, sorted(bad)
    if bad:
        assert bad["embed"].any(1).nonzero()[0].tolist() == [0]
        tokens = _data(job_cfg(j), j["B"]).batch(0)["tokens"]
        assert not (np.asarray(tokens) == 0).any()
        ref["embed"] = np.where(bad["embed"], got["embed"], ref["embed"])
    def norm(tree):
        return np.sqrt(sum(np.sum(v.astype(np.float64) ** 2)
                           for v in tree.values()))

    np.testing.assert_allclose(r.meta["grad_loss"], r.ref["loss"],
                               rtol=LOSS_RTOL, err_msg=name)
    np.testing.assert_allclose(r.meta.get("loss", r.meta["grad_loss"]),
                               r.ref["loss"], rtol=LOSS_RTOL, err_msg=name)
    np.testing.assert_allclose(r.meta.get("gnorm", norm(got)), norm(ref),
                               rtol=LOSS_RTOL, err_msg=name)
    _close(got, ref, f"{name} grad")
    assert r.meta["placements"].count("Replicate()") == len(j["mesh"])


@pytest.mark.parametrize("name", ["dense_1row", "dense_3rows", "dense_pod",
                                  "moe_global", "moe_pod", "jamba", "xlstm",
                                  "qwen2"])
def test_uneven_step_matches_unsharded(runs, name):
    """Where the function does not depend on the split (the dense family;
    the MoE's global routing with the global capacity) the mesh step's
    loss and gradients are the port's unsharded step's."""
    r = runs[name]
    np.testing.assert_allclose(r.meta["grad_loss"], r.plain["grad_loss"],
                               rtol=LOSS_RTOL, err_msg=name)
    _close(_sub(r.mesh, "grad"), _sub(r.plain, "grad"), name)


@pytest.mark.parametrize("dispatch", ["sharded", "shardmap"])
def test_uneven_local_dispatch_splits_tokens_evenly(runs, dispatch):
    """``sharded`` and ``shardmap`` route each data shard's tokens with
    its own capacity: on the one-row microbatch each of the two shards
    routes 16 of the row's 32 tokens, as the reference's do, so their loss
    is the reference's mesh value, apart from the unsharded one (other
    pairs are dropped), and the two dispatches agree, loss and gradients
    (the embedding's row 0 among them)."""
    r = runs[f"moe_{dispatch}"]
    mesh_loss, ref = r.meta["grad_loss"], float(r.ref["loss"])
    plain = r.plain["grad_loss"]
    assert abs(mesh_loss - ref) <= LOSS_RTOL * abs(ref)
    assert abs(plain - ref) > 10 * LOSS_RTOL * abs(ref), (plain, ref)
    other = runs["moe_shardmap" if dispatch == "sharded" else "moe_sharded"]
    np.testing.assert_allclose(mesh_loss, other.meta["grad_loss"],
                               rtol=LOSS_RTOL)
    _close(_sub(r.mesh, "grad"), _sub(other.mesh, "grad"), dispatch)
