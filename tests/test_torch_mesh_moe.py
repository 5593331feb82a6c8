"""Port parity, training under the parallel plan beyond the dense family:
the MoE (granite-moe under its three dispatches) on a (data=2, model=2)
mesh of 4 ``gloo`` processes against the reference's sharded step, and
against the port's own unsharded step; and the MoE's per-shard routing
against the reference's.

This file also holds the machinery the other ``test_torch_mesh_*`` files
share (:func:`run_jobs`). A job is one reduced f32 configuration: the
reference's ``reduced`` config at head_dim 64 (the flash kernels'
smallest, so the card runs the same widths), B=4, S=32. For each job:

* the reference, in a subprocess with 4 host devices on a
  ``jax.sharding.Mesh`` of Auto axes built directly (as
  ``tests/test_torch_mesh.py``'s ``_REF``), jits ``value_and_grad`` of its
  loss and its train step with ``in_shardings`` by the reference's specs
  and runs :data:`STEPS` steps;
* the port, in 4 spawned ``gloo`` processes on a (2, 2) ``DeviceMesh``:
  ``loss_and_grads`` on the placed state (the gradients gathered) and
  ``train(mesh=)`` for :data:`STEPS` steps;
* the port, unsharded, in this process meanwhile: ``loss_and_grads`` and
  ``train(tp=2)``.

Both packages start from one state: the port's ``init_state`` (seed 0),
which the reference reads from a file. Tolerances (``tests/
test_torch_mesh.py``'s, each with its reason there): the loss and the
gradients' global norm per step within 1e-5 relative; the first step's
gradients allclose with rtol 1e-4 and atol 1e-5 x the leaf's largest
magnitude. Without rotary positions (Whisper) a key bias's gradient
(``bk``) is zero in exact arithmetic (the softmax does not move when
every key shifts by one vector), so every side gives rounding noise
there: those leaves are held below 1e-5 of the largest gradient magnitude
of the step instead (with RoPE the bias is rotated by the key's position,
and its gradient is not zero). Every process runs one torch thread.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro_torch.configs import ShapeConfig
from repro_torch.data import SyntheticTokens
from repro_torch.launch import train as tl
from repro_torch.models import build_model
from repro_torch.models import moe as TMOE
from repro_torch.train.optimizer import tree_map
from repro_torch.train.step import init_state, loss_and_grads

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ZERO_GRAD_TOL = 1e-5
B, S, STEPS = 4, 32, 2
WARMUP = min(50, STEPS // 5 + 1)          # the train driver's, at 2 steps
TIMEOUT = 300
# the reduced widths at the flash kernels' smallest head dimension; the
# VLM's M-RoPE sections then sum to 32
WIDTH = {"head_dim": 64}
MROPE = {"mrope_sections": (8, 12, 12)}


def job(name, arch, dispatch=None) -> dict:
    """One configuration: ``arch`` reduced at :data:`WIDTH` (an MoE under
    ``dispatch``)."""
    over = dict(WIDTH, **(MROPE if TC.ARCHS[arch].rope == "mrope" else {}))
    return {"name": name, "arch": arch, "over": over, "dispatch": dispatch}


def job_cfg(j):
    cfg = dataclasses.replace(TC.reduced(TC.ARCHS[j["arch"]]), **j["over"])
    if j["dispatch"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=j["dispatch"]))
    return cfg


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_paths(v, name) if isinstance(v, dict) else {name: v})
    return out


def _flat(tree):
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in _paths(tree).items()}


def _data(cfg):
    return SyntheticTokens(cfg, ShapeConfig("mesh", "train", S, B), seed=0)


# --- the ranks -----------------------------------------------------------


def _mesh_rank(rank, world, jobs, out_dir):
    """One rank of the (2, 2) mesh runs (spawned): every job's placed
    first-step gradients and ``train(mesh=)``. Rank 0 writes
    ``out_dir/<name>.npz`` and ``<name>.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.sharding import ctx, place

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = launch_mesh.init_mesh((2, 2), ("data", "model"), "cpu")
        for j in jobs:
            cfg = job_cfg(j)
            ctx.configure(mesh)
            model = build_model(cfg, tp=2, device="cpu")
            placed = place.place_state(
                init_state(model, torch.Generator().manual_seed(0)), mesh)
            loss, g = loss_and_grads(model, placed["params"],
                                     _data(cfg).batch(0))
            out = {f"grad/{k}": v
                   for k, v in _flat(place.gather_state(g)).items()}
            meta = {"grad_loss": float(loss),
                    "placements": str(loss.placements)}
            del placed, g
            run = tl.train(cfg, steps=STEPS, batch=B, seq=S, ckpt_dir=None,
                           device="cpu", mesh=mesh, log=lambda m: None)
            meta["losses"], meta["gnorms"] = run["losses"], run["gnorms"]
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


def _spawn(jobs, out_dir):
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    return mp.start_processes(_mesh_rank, args=(4, jobs, out_dir), nprocs=4,
                              join=False, start_method="spawn")


def _join(procs):
    deadline = time.monotonic() + TIMEOUT
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
from repro.models import build_model
from repro.sharding.ctx import configure
from repro.sharding.specs import P, batch_specs, tree_param_specs
from repro.train.step import make_train_step

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
configure(mesh)


def ns(tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


for job in json.loads({jobs!r}):
    over = {{k: tuple(v) if isinstance(v, list) else v
             for k, v in job["over"].items()}}
    cfg = dataclasses.replace(reduced(ARCHS[job["arch"]]), **over)
    if job["dispatch"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=job["dispatch"]))
    model = build_model(cfg, tp=2)
    state = {{}}
    for path, arr in np.load(os.path.join({tmp!r}, job["name"] + "_init.npz")
                             ).items():
        node = state
        *head, last = path.split("/")
        for p in head:
            node = node.setdefault(p, {{}})
        node[last] = arr
    p_specs = tree_param_specs(state["params"], 2, 2)
    s_specs = {{"params": p_specs, "opt": {{"m": p_specs, "v": p_specs,
                                           "step": P()}}}}
    b_specs = ns(batch_specs(("data",), cfg, None))
    step = jax.jit(make_train_step(model, warmup={warmup}),
                   in_shardings=(ns(s_specs), b_specs),
                   out_shardings=(ns(s_specs), ns({{"loss": P(), "gnorm": P(),
                                                    "lr": P()}})))
    grad = jax.jit(jax.value_and_grad(model.loss),
                   in_shardings=(ns(p_specs), b_specs),
                   out_shardings=(NamedSharding(mesh, P()), ns(p_specs)))
    data = SyntheticTokens(cfg, ShapeConfig("mesh", "train", {S}, {B}),
                           seed=0)
    out = {{}}
    loss, g = grad(state["params"], data.batch(0))
    out["grad_loss"] = np.asarray(loss)
    for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
        out["grad/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    for s in range({steps}):
        state, m = step(state, data.batch(s))
        out[f"loss{{s}}"] = np.asarray(m["loss"])
        out[f"gnorm{{s}}"] = np.asarray(m["gnorm"])
    np.savez(os.path.join({tmp!r}, job["name"] + "_ref.npz"), **out)
print("REF_MESH_OK")
"""


def run_jobs(jobs, tmp):
    """Every job of a file, once: the reference's sharded steps (one
    subprocess), the (2, 2) mesh runs (4 gloo ranks) and the port's
    unsharded runs in this process while they run. Returns ``{name:
    namespace(ref, mesh, mesh_meta, plain)}``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    plain = {}
    try:
        for j in jobs:
            cfg = job_cfg(j)
            model = build_model(cfg, tp=2, device="cpu")
            state = init_state(model, torch.Generator().manual_seed(0))
            np.savez(tmp / f"{j['name']}_init.npz",
                     **_flat(tree_map(lambda x: x.clone(), state)))
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF.format(
                src=SRC, jobs=json.dumps(jobs), tmp=str(tmp), warmup=WARMUP,
                S=S, B=B, steps=STEPS)],
            env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            procs = _spawn(jobs, str(tmp / "mesh"))
            for j in jobs:
                cfg = job_cfg(j)
                model = build_model(cfg, tp=2, device="cpu")
                state = init_state(model, torch.Generator().manual_seed(0))
                loss, g = loss_and_grads(model, state["params"],
                                         _data(cfg).batch(0))
                run = tl.train(cfg, steps=STEPS, batch=B, seq=S,
                               ckpt_dir=None, device="cpu", tp=2,
                               log=lambda m: None)
                plain[j["name"]] = {
                    "grad_loss": float(loss), "losses": run["losses"],
                    "gnorms": run["gnorms"],
                    **{f"grad/{k}": v for k, v in _flat(g).items()}}
            _join(procs)
            stdout, stderr = ref.communicate(timeout=TIMEOUT)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    finally:
        torch.set_num_threads(threads)
    assert "REF_MESH_OK" in stdout, stdout + stderr
    out = {}
    for j in jobs:
        n = j["name"]
        with open(tmp / "mesh" / f"{n}.json") as f:
            meta = json.load(f)
        out[n] = types.SimpleNamespace(
            ref=dict(np.load(tmp / f"{n}_ref.npz")),
            mesh=dict(np.load(tmp / "mesh" / f"{n}.npz")), mesh_meta=meta,
            plain=plain[n], zero_bk=job_cfg(j).rope == "abs")
    return out


def _grads(flat):
    return {k[5:]: v for k, v in flat.items() if k.startswith("grad/")}


def close_grads(got, want, what="", zero_bk=False):
    """Every gradient leaf allclose (rtol :data:`GRAD_RTOL`, atol
    :data:`GRAD_ATOL` x the leaf's largest magnitude); with ``zero_bk`` a
    key bias's (exactly zero) below :data:`ZERO_GRAD_TOL` of the largest
    magnitude of all leaves on both sides."""
    got, want = _grads(got), _grads(want)
    assert sorted(got) == sorted(want), what
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, w in want.items():
        if zero_bk and name.endswith("bk"):
            for side in (got[name], w):
                assert float(np.abs(side).max()) <= ZERO_GRAD_TOL * top, \
                    f"{what} {name}"
            continue
        atol = GRAD_ATOL * float(np.abs(w).max())
        np.testing.assert_allclose(got[name], w, rtol=GRAD_RTOL, atol=atol,
                                   err_msg=f"{what} {name}")


def check_against_reference(r, what):
    """The mesh run's first-step loss and gradients and its per-step
    losses and norms against the reference's sharded step; the metrics
    replicated."""
    meta = r.mesh_meta
    np.testing.assert_allclose(meta["grad_loss"], r.ref["grad_loss"],
                               rtol=LOSS_RTOL, err_msg=what)
    close_grads(r.mesh, r.ref, what, r.zero_bk)
    for s in range(STEPS):
        np.testing.assert_allclose(meta["losses"][s], r.ref[f"loss{s}"],
                                   rtol=LOSS_RTOL, err_msg=f"{what} loss {s}")
        np.testing.assert_allclose(meta["gnorms"][s], r.ref[f"gnorm{s}"],
                                   rtol=LOSS_RTOL,
                                   err_msg=f"{what} gnorm {s}")
    assert meta["placements"] == "(Replicate(), Replicate())"


def check_against_unsharded(r, what):
    """The mesh run against the port's unsharded step: the first-step loss
    and gradients, and the per-step losses and norms."""
    meta = r.mesh_meta
    np.testing.assert_allclose(meta["grad_loss"], r.plain["grad_loss"],
                               rtol=LOSS_RTOL, err_msg=what)
    close_grads(r.mesh, r.plain, what, r.zero_bk)
    np.testing.assert_allclose(meta["losses"], r.plain["losses"],
                               rtol=LOSS_RTOL, err_msg=what)
    np.testing.assert_allclose(meta["gnorms"], r.plain["gnorms"],
                               rtol=LOSS_RTOL, err_msg=what)


# --- the MoE ---------------------------------------------------------------

DISPATCHES = ("global", "sharded", "shardmap")
JOBS = [job(f"moe_{d}", "granite-moe-1b-a400m", d) for d in DISPATCHES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_jobs(JOBS, tmp_path_factory.mktemp("mesh_moe"))


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_moe_mesh_matches_reference(runs, dispatch):
    check_against_reference(runs[f"moe_{dispatch}"], dispatch)


def test_moe_global_mesh_matches_unsharded(runs):
    """Global routing with the global capacity is the unsharded function:
    the (2, 2) run equals the port's unsharded step."""
    check_against_unsharded(runs["moe_global"], "global")


@pytest.mark.parametrize("dispatch", ["sharded", "shardmap"])
def test_moe_local_dispatch_is_the_mesh_function(runs, dispatch):
    """Each data shard routes its own tokens with its own capacity, so the
    ``sharded`` and ``shardmap`` losses are the reference's mesh value,
    apart from the unsharded one (other pairs are dropped), and equal to
    each other: both route per data shard."""
    r = runs[f"moe_{dispatch}"]
    mesh_loss, ref = r.mesh_meta["grad_loss"], float(r.ref["grad_loss"])
    plain = r.plain["grad_loss"]
    assert abs(mesh_loss - ref) <= LOSS_RTOL * abs(ref)
    assert abs(plain - ref) > 10 * LOSS_RTOL * abs(ref), (plain, ref)
    other = runs["moe_shardmap" if dispatch == "sharded" else "moe_sharded"]
    np.testing.assert_allclose(mesh_loss, other.mesh_meta["grad_loss"],
                               rtol=LOSS_RTOL)


# --- the per-shard routing against the reference's -------------------------


class _Recorder:
    """``jax.numpy`` as the reference's ``moe`` module sees it, recording
    the results of ``take_along_axis`` (the sorted experts, tokens and
    gates, in that order) and of ``where`` (the slots, then the gates) in
    an eager run."""

    def __init__(self, jnp):
        self._jnp, self.taken, self.wheres = jnp, [], []

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def take_along_axis(self, *a, **kw):
        out = self._jnp.take_along_axis(*a, **kw)
        self.taken.append(np.asarray(out))
        return out

    def where(self, cond, *a):
        out = self._jnp.where(cond, *a)
        self.wheres.append((np.asarray(cond), np.asarray(out)))
        return out


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_per_shard_routing_is_the_reference_s(monkeypatch, cf):
    """The port's per-shard routing (``moe.route_shards``: each of 2 data
    shards' tokens routed with its own capacity ``cap_l``) against the
    reference's ``moe_ffn_sharded`` run eagerly with its batch axis at 2
    shards (``axis_size`` set to 2, ``shard`` the identity): the sorted
    experts, tokens, keep mask and slots bitwise. At capacity factor 0.5
    pairs are dropped in every shard."""
    import jax
    import jax.numpy as jnp

    from repro.models import moe as RMOE
    from repro.sharding import ctx as r_ctx

    cfg = job_cfg(job("r", "granite-moe-1b-a400m", "sharded"))
    mcfg = dataclasses.replace(cfg.moe, capacity_factor=cf)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    p = jax.tree.map(lambda a: np.array(a[0]), RMOE.init_moe(
        jax.random.PRNGKey(1), cfg.d_model, mcfg, 1))
    rec = _Recorder(jnp)
    monkeypatch.setattr(r_ctx, "axis_size", lambda name: 2)
    monkeypatch.setattr(RMOE, "shard", lambda x, *axes: x)
    monkeypatch.setattr(RMOE, "jnp", rec)
    with jax.disable_jit():
        RMOE.moe_ffn_sharded(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             mcfg)
    se, st = rec.taken[0], rec.taken[1]
    keep, slot = rec.wheres[0][0], rec.wheres[0][1]

    nt = B * S
    cap_l = TMOE.capacity(mcfg, nt // 2)
    got = TMOE.route_shards(torch.from_numpy(x.reshape(2, nt // 2, -1)),
                            torch.from_numpy(p["gate"]), mcfg, cap_l)
    for name, want in (("se", se), ("st", st), ("keep", keep),
                       ("slot", slot)):
        g = got[name].numpy()
        assert g.shape == want.shape, name
        assert np.array_equal(g, want), name
    if cf < 1:
        assert not keep.all()
