"""Port parity, training under the parallel plan: the dense family's train
step on a (data=2, model=2) mesh of 4 ``gloo`` processes against the
reference's sharded step, and against the port's own unsharded step.

The port places its state and batches as DTensors by the reference's specs
(``sharding.place``: TP over "model", FSDP over "data" for leaves of 2^20
elements and more, the batch over the batch axes), pins activations with
``shard()`` and runs the attention on local shards. The reference runs
``jax.jit(make_train_step(...), in_shardings=...)`` in a subprocess with 4
host devices on ``jax.sharding.Mesh(devices.reshape(2, 2), ("data",
"model"))`` built directly, with Auto axes (never ``jax.make_mesh``, whose
Explicit axes break ``with_sharding_constraint`` on this jax). Both start
from one state: the port's ``init_state`` (seed 0), which the reference
reads from a file. The model is a widened reduced SmolLM in f32 (4 layers,
d_model 256, d_ff 1024, vocab 4096, 4 heads of 64), wide enough that the
embedding and the MLP weights reach FSDP's 2^20 elements.

Tolerances, each with its reason (those of ``tests/test_torch_train.py``):

* the loss and the gradients' global norm per step: 1e-5 relative (f32
  sums in another order: partial sums over shards, then all-reduced);
* the first step's gradients: allclose with rtol 1e-4 and atol 1e-5 x the
  leaf's largest magnitude; the moments m the same, v rtol 2e-4;
* parameters after AdamW steps: a tiny gradient that rounds to the other
  sign moves a parameter by 2 lr, so one step is held to the bound its own
  moments give (``tests/test_torch_train.py``'s ``_check_params``), and
  k steps to 2 lr k beside rtol 1e-4.

A restart on the mesh (the train driver stopped after step 1 and resumed,
and ``run_with_restarts`` with a failure injected at step 2) ends bitwise
equal to an uninterrupted run on the mesh; the sharded run's checkpoints
are the files an unsharded run writes (the same manifest, and the initial
state's checkpoint byte for byte). A (pod=2, data=1, model=2) mesh runs
one step. Every process runs one torch thread.
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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ShapeConfig
from repro_torch.data import SyntheticTokens
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch import train as tl
from repro_torch.models import build_model
from repro_torch.sharding import ctx, specs
from repro_torch.train.optimizer import tree_map
from repro_torch.train.step import init_state, loss_and_grads, \
    make_train_step

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
V_RTOL = 2e-4
B1, B2, EPS, PEAK_LR = 0.9, 0.95, 1e-8, 3e-4     # the step's defaults
WIDEN = dict(d_model=256, d_ff=1024, vocab=4096, num_heads=4, head_dim=64)
B, S, STEPS, FAIL_AT = 4, 32, 4, 2
WARMUP = min(50, STEPS // 5 + 1)          # the train driver's, at 4 steps
TIMEOUT = 300


def _cfg():
    return dataclasses.replace(TC.reduced(TC.ARCHS["smollm-360m"]), **WIDEN)


def _paths(tree, prefix=""):
    """Nested dicts as ``{"a/b": leaf}``, the leaves as they are."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_paths(v, name) if isinstance(v, dict) else {name: v})
    return out


def _flat(tree):
    """:func:`_paths` with numpy leaves."""
    return {k: v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v) for k, v in _paths(tree).items()}


def _data():
    return SyntheticTokens(_cfg(), ShapeConfig("mesh", "train", S, B), seed=0)


# --- the ranks -----------------------------------------------------------


class _FailOnce:
    """Raises ``SimulatedFailure`` at step ``at``, once, on every rank."""

    def __init__(self, at):
        self.at, self.fired = at, False

    def maybe_fail(self, step):
        from repro_torch.runtime.fault import SimulatedFailure
        if step == self.at and not self.fired:
            self.fired = True
            raise SimulatedFailure(f"injected failure at step {step}")


def _mesh_rank(rank, world, shape, names, out_dir, full):
    """One rank of a mesh run (spawned): the placed first-step gradients,
    the train driver on the mesh, and with ``full`` a restart through the
    driver, ``run_with_restarts`` and the checkpoints. Rank 0 writes
    ``out_dir/mesh.npz`` and ``mesh.json``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.runtime import run_with_restarts
    from repro_torch.sharding import place

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out_dir, 'store')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = launch_mesh.init_mesh(shape, names, "cpu")
        ctx.configure(mesh)
        cfg, data = _cfg(), _data()
        model = build_model(cfg, tp=mesh.shape["model"], device="cpu")
        state = init_state(model, torch.Generator().manual_seed(0))
        placed = place.place_state(state, mesh)
        out, meta = {}, {}
        spec = place.state_specs(state, mesh)["params"]
        meta["spec_axes"] = sorted({a for s in _paths(spec).values()
                                    for a in s if a is not None})
        meta["local_shapes"] = {
            k: list(v.to_local().shape) for k, v in
            _paths(placed["params"]).items()}
        for mb in (1, 2) if full else (1,):
            loss, g = loss_and_grads(model, placed["params"], data.batch(0),
                                     microbatches=mb)
            meta[f"grad_loss_mb{mb}"] = float(loss)
            meta[f"grad_loss_mb{mb}_placements"] = str(loss.placements)
            out.update({f"grad_mb{mb}/{k}": v for k, v in
                        _flat(place.gather_state(g)).items()})
        one, m1 = make_train_step(model, warmup=WARMUP)(placed, data.batch(0))
        meta["one_lr"] = float(m1["lr"])
        out.update({f"one/{k}": v for k, v in
                    _flat(place.gather_state(one)).items()})
        steps = STEPS if full else 1
        ckpt = os.path.join(out_dir, "ckpt_run") if full else None
        run = tl.train(cfg, steps=steps, batch=B, seq=S, ckpt_dir=ckpt,
                       ckpt_every=1, device="cpu", mesh=mesh,
                       log=lambda m: None)
        meta["losses"], meta["gnorms"] = run["losses"], run["gnorms"]
        meta["metric_placements"] = str(m1["loss"].placements)
        out.update({f"run/{k}": v for k, v in
                    _flat(place.gather_state(run["state"])).items()})
        if full:
            # the driver stopped after step FAIL_AT - 1, then resumed
            again = os.path.join(out_dir, "ckpt_again")
            tl.train(cfg, steps=FAIL_AT, batch=B, seq=S, ckpt_dir=again,
                     ckpt_every=1, device="cpu", mesh=mesh,
                     log=lambda m: None)
            resumed = tl.train(cfg, steps=STEPS, batch=B, seq=S,
                               ckpt_dir=again, ckpt_every=1, device="cpu",
                               mesh=mesh, log=lambda m: None)
            meta["resumed_start"] = resumed["start"]
            out.update({f"resumed/{k}": v for k, v in
                        _flat(place.gather_state(resumed["state"])).items()})
            # run_with_restarts over a mesh manager, a failure at FAIL_AT
            mgr = CheckpointManager(os.path.join(out_dir, "ckpt_restarts"),
                                    keep=2, every=1, mesh=mesh)
            step_fn = make_train_step(model, warmup=WARMUP)
            inj = _FailOnce(FAIL_AT)

            def train_fn(st, start, stop):
                for s in range(start, stop):
                    inj.maybe_fail(s)
                    st, _ = step_fn(st, data.batch(s))
                    mgr.maybe_save(st, s)
                return st

            def fresh():
                return place.place_state(
                    init_state(model, torch.Generator().manual_seed(0)),
                    mesh)

            final, done, restarts = run_with_restarts(train_fn, mgr, fresh,
                                                      STEPS)
            meta["restarts"] = [done, restarts]
            out.update({f"restarts/{k}": v for k, v in
                        _flat(place.gather_state(final)).items()})
            # the placed initial state's checkpoint
            CheckpointManager(os.path.join(out_dir, "ckpt_init"),
                              mesh=mesh).save(placed, 0)
        if rank == 0:
            np.savez(os.path.join(out_dir, "mesh.npz"), **out)
            with open(os.path.join(out_dir, "mesh.json"), "w") as f:
                json.dump(meta, f)
        dist.barrier()
    finally:
        ctx.reset()
        dist.destroy_process_group()


def _spawn(shape, names, out_dir, full):
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    world = int(np.prod(shape))
    procs = mp.start_processes(
        _mesh_rank, args=(world, shape, names, out_dir, full),
        nprocs=world, join=False, start_method="spawn")
    return procs


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
import os, sys
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

cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **{widen!r})
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
configure(mesh)
model = build_model(cfg, tp=2)
state = {{}}
for path, arr in np.load({init!r}).items():
    node = state
    *head, last = path.split("/")
    for p in head:
        node = node.setdefault(p, {{}})
    node[last] = arr
p_specs = tree_param_specs(state["params"], 2, 2)
s_specs = {{"params": p_specs, "opt": {{"m": p_specs, "v": p_specs,
                                       "step": P()}}}}


def ns(tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


b_specs = ns(batch_specs(("data",), cfg, None))
step = jax.jit(make_train_step(model, warmup={warmup}),
               in_shardings=(ns(s_specs), b_specs),
               out_shardings=(ns(s_specs), ns({{"loss": P(), "gnorm": P(),
                                                "lr": P()}})))
grad = jax.jit(jax.value_and_grad(model.loss),
               in_shardings=(ns(p_specs), b_specs),
               out_shardings=(NamedSharding(mesh, P()), ns(p_specs)))
data = SyntheticTokens(cfg, ShapeConfig("mesh", "train", {S}, {B}), seed=0)
out = {{}}
loss, g = grad(state["params"], data.batch(0))
out["grad_loss"] = np.asarray(loss)
for path, leaf in jax.tree_util.tree_flatten_with_path(g)[0]:
    out["grad/" + "/".join(k.key for k in path)] = np.asarray(leaf)
for s in range({steps}):
    state, m = step(state, data.batch(s))
    out[f"loss{{s}}"] = np.asarray(m["loss"])
    out[f"gnorm{{s}}"] = np.asarray(m["gnorm"])
np.savez({out!r}, **out)
print("REF_MESH_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this file, once: the reference's sharded step (a
    subprocess), the (2, 2) and (2, 1, 2) mesh runs (4 gloo ranks each)
    and the port's unsharded runs in this process while they run."""
    tmp = tmp_path_factory.mktemp("mesh")
    cfg, data = _cfg(), _data()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = build_model(cfg, tp=2, device="cpu")
        state = init_state(model, torch.Generator().manual_seed(0))
        init = tree_map(lambda x: x.clone(), state)
        np.savez(tmp / "init.npz", **_flat(init))
        ref = subprocess.Popen(
            [sys.executable, "-c", _REF.format(
                src=SRC, widen=WIDEN, init=str(tmp / "init.npz"),
                warmup=WARMUP, S=S, B=B, steps=STEPS - 1,
                out=str(tmp / "ref.npz"))],
            env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            procs = _spawn((2, 2), ("data", "model"), str(tmp / "m22"), True)
            # the port, unsharded, meanwhile
            plain = {}
            for mb in (1, 2):
                loss, g = loss_and_grads(model, init["params"],
                                         data.batch(0), microbatches=mb)
                plain[f"grad_loss_mb{mb}"] = float(loss)
                plain.update({f"grad_mb{mb}/{k}": v
                              for k, v in _flat(g).items()})
            one, _ = make_train_step(model, warmup=WARMUP)(init,
                                                           data.batch(0))
            plain.update({f"one/{k}": v for k, v in _flat(one).items()})
            run = tl.train(cfg, steps=STEPS, batch=B, seq=S,
                           ckpt_dir=str(tmp / "plain_ckpt"), ckpt_every=1,
                           device="cpu", tp=2, log=lambda m: None)
            plain["losses"], plain["gnorms"] = run["losses"], run["gnorms"]
            plain.update({f"run/{k}": v
                          for k, v in _flat(run["state"]).items()})
            CheckpointManager(str(tmp / "plain_init")).save(init, 0)
            _join(procs)
            procs = _spawn((2, 1, 2), ("pod", "data", "model"),
                           str(tmp / "m212"), False)
            _join(procs)
            stdout, stderr = ref.communicate(timeout=TIMEOUT)
        finally:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    finally:
        torch.set_num_threads(threads)
    assert "REF_MESH_OK" in stdout, stdout + stderr

    def load(d):
        with open(tmp / d / "mesh.json") as f:
            meta = json.load(f)
        return dict(np.load(tmp / d / "mesh.npz")), meta

    return types.SimpleNamespace(
        tmp=tmp, init=_flat(init), plain=plain, ref=dict(np.load(
            tmp / "ref.npz")), mesh=load("m22"), pod=load("m212"))


def _close(got, want, rtol=GRAD_RTOL, atol_frac=GRAD_ATOL, what=""):
    """Every leaf allclose with ``rtol`` and an atol of ``atol_frac`` x the
    leaf's largest magnitude."""
    assert sorted(got) == sorted(want), what
    for name in want:
        atol = atol_frac * float(np.abs(want[name]).max())
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {name}")


def _sub(flat, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def _check_one_step(got, want, old, lr):
    """A state after one AdamW step from ``old``: m, v at the gradients'
    tolerances, each parameter within the bound its moments give."""
    _close(_sub(got, "opt/m"), _sub(want, "opt/m"), what="m")
    _close(_sub(got, "opt/v"), _sub(want, "opt/v"), rtol=V_RTOL, what="v")
    assert int(got["opt/step"]) == int(want["opt/step"]) == 1
    c1, c2 = 1 - B1, 1 - B2
    for name, b_p in _sub(want, "params").items():
        a, b = got[f"opt/m/{name}"] / c1, want[f"opt/m/{name}"] / c1
        x = np.sqrt(got[f"opt/v/{name}"] / c2)
        y = np.sqrt(want[f"opt/v/{name}"] / c2)
        tol = lr * (np.abs(a - b) / (x + EPS)
                    + np.abs(b) * np.abs(y - x) / ((x + EPS) * (y + EPS)))
        step_r = np.abs(b) / (y + EPS) + 0.1 * np.abs(old[name])
        tol += 4 * 2.0 ** -24 * (np.abs(b_p) + lr * step_r)
        err = np.abs(got[f"params/{name}"] - b_p)
        assert (err <= tol).all(), (name, float((err - tol).max()))


# --- the (2, 2) mesh against the reference ---------------------------------


def test_spec_tree_exercises_fsdp_and_tp(runs):
    """The widened config's spec tree shards some leaf over "data" (FSDP)
    and some over "model" (TP), and the placed shards have those shapes."""
    out, meta = runs.mesh
    assert meta["spec_axes"] == ["data", "model"]
    local = meta["local_shapes"]
    assert local["embed"] == [WIDEN["vocab"] // 2, WIDEN["d_model"] // 2]
    assert local["mlp/w1"] == [4, WIDEN["d_model"] // 2, WIDEN["d_ff"] // 2]
    assert local["attn/wq"] == [4, WIDEN["d_model"], 2, WIDEN["head_dim"]]
    assert local["ln1"] == [4, WIDEN["d_model"]]


def test_mesh_losses_and_norms_match_reference(runs):
    _, meta = runs.mesh
    for s in range(STEPS - 1):
        np.testing.assert_allclose(meta["losses"][s], runs.ref[f"loss{s}"],
                                   rtol=LOSS_RTOL, err_msg=f"loss {s}")
        np.testing.assert_allclose(meta["gnorms"][s], runs.ref[f"gnorm{s}"],
                                   rtol=LOSS_RTOL, err_msg=f"gnorm {s}")


def test_mesh_first_step_gradients_match_reference(runs):
    out, meta = runs.mesh
    np.testing.assert_allclose(meta["grad_loss_mb1"], runs.ref["grad_loss"],
                               rtol=LOSS_RTOL)
    _close(_sub(out, "grad_mb1"), _sub(runs.ref, "grad"), what="grad")


def test_metrics_come_back_replicated(runs):
    _, meta = runs.mesh
    want = "(Replicate(), Replicate())"
    assert meta["metric_placements"] == want
    assert meta["grad_loss_mb1_placements"] == want


# --- the mesh against the port's own unsharded run -------------------------


@pytest.mark.parametrize("mb", [1, 2])
def test_mesh_gradients_match_unsharded(runs, mb):
    """Microbatches are cut from the global batch before placement, so
    the sums add the unsharded step's parts."""
    out, meta = runs.mesh
    np.testing.assert_allclose(meta[f"grad_loss_mb{mb}"],
                               runs.plain[f"grad_loss_mb{mb}"],
                               rtol=LOSS_RTOL)
    _close(_sub(out, f"grad_mb{mb}"), _sub(runs.plain, f"grad_mb{mb}"),
           what=f"grad mb={mb}")


def test_mesh_one_step_state_matches_unsharded(runs):
    out, meta = runs.mesh
    _check_one_step(_sub(out, "one"), _sub(runs.plain, "one"),
                    _sub(runs.init, "params"), meta["one_lr"])


def test_mesh_driver_run_matches_unsharded(runs):
    """``train(mesh=)`` against ``train(tp=2)``: losses and norms per
    step, the final moments, and the parameters within 2 lr per step."""
    out, meta = runs.mesh
    np.testing.assert_allclose(meta["losses"], runs.plain["losses"],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta["gnorms"], runs.plain["gnorms"],
                               rtol=LOSS_RTOL)
    got, want = _sub(out, "run"), _sub(runs.plain, "run")
    assert sorted(got) == sorted(want)
    assert int(got["opt/step"]) == STEPS
    atol = 2 * PEAK_LR * STEPS
    for name, w in _sub(want, "params").items():
        np.testing.assert_allclose(got[f"params/{name}"], w, rtol=GRAD_RTOL,
                                   atol=atol, err_msg=name)


def test_pod_mesh_matches_unsharded(runs):
    """A (pod=2, data=1, model=2) mesh: the batch over ("pod", "data"),
    one step's loss and norm, and the first gradients."""
    out, meta = runs.pod
    # FSDP splits over data_size = pod x data = 2 as the reference's
    # specs do; on this mesh its "data" axis has one position
    assert meta["spec_axes"] == ["data", "model"]
    np.testing.assert_allclose(meta["losses"][0], runs.plain["losses"][0],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(meta["gnorms"][0], runs.plain["gnorms"][0],
                               rtol=LOSS_RTOL)
    _close(_sub(out, "grad_mb1"), _sub(runs.plain, "grad_mb1"),
           what="pod grad")
    _check_one_step(_sub(out, "one"), _sub(runs.plain, "one"),
                    _sub(runs.init, "params"), meta["one_lr"])


# --- restarts and checkpoints on the mesh ----------------------------------


@pytest.mark.parametrize("how", ["resumed", "restarts"])
def test_mesh_restart_is_bitwise_uninterrupted(runs, how):
    """The driver resumed from its step-1 checkpoint, and
    ``run_with_restarts`` after a failure at step 2: the final state's
    bits equal the uninterrupted mesh run's."""
    out, meta = runs.mesh
    if how == "resumed":
        assert meta["resumed_start"] == FAIL_AT
    else:
        assert meta["restarts"] == [STEPS, 1]
    got, want = _sub(out, how), _sub(out, "run")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].tobytes() == want[name].tobytes(), name


def _ckpt_files(root):
    return sorted(d for d in os.listdir(root) if d.startswith("ckpt_"))


def test_mesh_checkpoint_is_the_unsharded_file(runs):
    """Rank 0 writes the gathered state: the initial state's checkpoint is
    the unsharded one byte for byte, and the run's kept checkpoints have
    the unsharded run's names and manifests, their final one holding the
    gathered final state."""
    tmp = runs.tmp
    for name in ("manifest.json", "arrays.npz"):
        a = (tmp / "m22" / "ckpt_init" / "ckpt_00000000" / name).read_bytes()
        b = (tmp / "plain_init" / "ckpt_00000000" / name).read_bytes()
        assert a == b, name
    sharded, plain = tmp / "m22" / "ckpt_run", tmp / "plain_ckpt"
    kept = _ckpt_files(sharded)
    assert kept == _ckpt_files(plain) == [f"ckpt_{s:08d}" for s in
                                          range(STEPS - 3, STEPS)]
    for d in kept:
        assert (sharded / d / "manifest.json").read_text() \
            == (plain / d / "manifest.json").read_text()
    from repro_torch.checkpoint import load_checkpoint
    state, step = load_checkpoint(str(sharded / kept[-1]))
    assert step == STEPS - 1
    final = _sub(runs.mesh[0], "run")
    for name, leaf in _flat(state).items():
        assert leaf.tobytes() == final[name].tobytes(), name


# --- placements against the specs ------------------------------------------


def _fake_mesh(names):
    return types.SimpleNamespace(mesh_dim_names=names)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_placements_follow_full_width_specs(arch, multi):
    """Every leaf of every arch's full-width spec tree (its model on the
    meta device, the production mesh's tp and data size): each named mesh
    axis shards its entry's dimension, a ("pod", "data") entry both, and
    every other mesh axis is replicated."""
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model") if multi else ("data", "model")
    meta = build_model(TC.ARCHS[arch], tp=16, device="meta").param_tree()
    tree = specs.tree_param_specs(meta, 16, 32 if multi else 16)
    flat = _paths(tree)
    assert flat
    seen = set()
    for path, spec in flat.items():
        pl = specs.placements(specs.P(*spec), _fake_mesh(names))
        assert len(pl) == len(names)
        for m, axis in enumerate(names):
            dims = [i for i, e in enumerate(spec)
                    if axis == e or (isinstance(e, tuple) and axis in e)]
            assert len(dims) <= 1, (path, spec)
            want = Shard(dims[0]) if dims else Replicate()
            assert pl[m] == want, (path, spec, pl)
            if dims:
                seen.add(axis)
    assert "model" in seen
    batch = specs.batch_specs(launch_mesh.batch_axes(types.SimpleNamespace(
        axis_names=names)), TC.ARCHS[arch], None)
    for spec in batch.values():
        pl = specs.placements(spec, _fake_mesh(names))
        dim = list(spec).index(next(e for e in spec if e is not None))
        assert pl[names.index("data")] == Shard(dim)
        if multi:
            assert pl[names.index("pod")] == Shard(dim)
        assert pl[names.index("model")] == Replicate()


def test_placements_reject_an_unknown_axis():
    with pytest.raises(ValueError, match="not an axis of the mesh"):
        specs.placements(specs.P(None, "pod"), _fake_mesh(("data", "model")))


def test_logical_axes_resolve_to_mesh_specs():
    """``shard()``'s logical axes under the configured rules, which are
    the reference's: "batch" is ("pod", "data") on a pod mesh, "tp" is
    "model", "kv_tp" whole. With no process group no DeviceMesh is bound
    and a tensor passes unchanged."""
    from repro.sharding import ctx as r_ctx
    prev = ctx.set_host_device_count(8)
    try:
        for shape, axes, batch in (((2, 2), ("data", "model"), "data"),
                                   ((2, 2, 2), ("pod", "data", "model"),
                                    ("pod", "data"))):
            ctx.configure(ctx.make_mesh(shape, axes,
                                        ctx.visible_devices("cpu")))
            r_ctx.configure(types.SimpleNamespace(axis_names=axes))
            assert ctx._CTX["rules"] == r_ctx._CTX["rules"]
            assert ctx.device_mesh() is None      # no process group
            assert tuple(ctx.logical_spec(4, "batch", None, "tp", None)) \
                == (batch, None, "model", None)
            assert tuple(ctx.logical_spec(3, "batch", None, "kv_tp")) \
                == (batch, None, None)
            x = torch.zeros(2, 3, 4)
            assert ctx.shard(x, "batch", None, "tp") is x
    finally:
        ctx.reset()
        r_ctx.reset()
        ctx.set_host_device_count(prev)


@pytest.mark.parametrize("env, cards, backend, card", [
    # torchrun on 32 nodes of 8 cards: rank 11 is node 1's fourth rank
    (dict(RANK="11", WORLD_SIZE="256", LOCAL_RANK="3",
          LOCAL_WORLD_SIZE="8"), 8, "nccl", 3),
    # 4 ranks a node on nodes of 8 cards: rank 6 is node 1's third rank
    (dict(RANK="6", WORLD_SIZE="64", LOCAL_RANK="2",
          LOCAL_WORLD_SIZE="4"), 8, "nccl", 2),
    # one node, no LOCAL_*: a rank is its own place on the node
    (dict(RANK="1", WORLD_SIZE="2"), 8, "nccl", 1),
    # four ranks sharing one card: NCCL refuses them, gloo carries them
    (dict(RANK="3", WORLD_SIZE="4", LOCAL_RANK="3",
          LOCAL_WORLD_SIZE="4"), 1, "gloo", 0),
])
def test_process_group_backend_and_card_follow_the_node(
        monkeypatch, env, cards, backend, card):
    """``init_process_group`` on the card takes the rank's card from its
    place on its node (``LOCAL_RANK``), not from its global rank, and
    picks NCCL whenever the node's ranks (``LOCAL_WORLD_SIZE``) have a
    card each, whatever the world's size."""
    import torch.distributed as dist
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}
    monkeypatch.setattr(launch_mesh, "resolve_device",
                        lambda d: torch.device("cuda"))
    monkeypatch.setattr(launch_mesh, "_group_running", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.update(current=d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    dev = launch_mesh.init_process_group(store="unused")
    assert dev == torch.device("cuda", card) == seen["current"]
    assert seen["backend"] == backend
    assert (seen["rank"], seen["world_size"]) == (int(env["RANK"]),
                                                  int(env["WORLD_SIZE"]))
    assert seen.get("device_id") == (dev if backend == "nccl" else None)
