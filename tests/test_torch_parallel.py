"""Port parity, the parallel plan's modules: ``sharding.specs``,
``sharding.ctx``'s mesh and logical axes, ``launch.mesh``,
``runtime.elastic`` and ``train.pipeline`` against the reference's.

Specs, meshes and the elastic plan are string and integer logic: they
compare exactly, a port spec against a reference ``PartitionSpec`` entry by
entry. The spec trees are built from the reference's shape trees
(``jax.eval_shape``, nothing allocated) and from the port's models on the
``meta`` device, for every arch at full width and reduced.

The GPipe schedule runs over 2 ``gloo`` processes (``torch.multiprocessing``
spawn, a ``file://`` store under the test's temporary directory) and is
held against the reference's ``make_pipelined_forward`` (run in a
subprocess with 8 host devices, as ``tests/test_pipeline.py`` does) and
against the stages applied in sequence, within 1e-5 absolute and relative
(f32 matmul and tanh through two frameworks; the reference test's
tolerance).
"""
import dataclasses
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.launch import mesh as r_mesh
from repro.models.model_zoo import build_model as r_build
from repro.runtime import elastic as r_elastic
from repro.sharding import specs as r_specs
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import mesh as t_mesh
from repro_torch.models import build_model
from repro_torch.runtime import elastic
from repro_torch.sharding import ctx, specs
from repro_torch.train import pipeline

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
PIPE_TOL = 1e-5
PIPE_D, PIPE_M, PIPE_MB, PIPE_STAGES = 16, 8, 4, 2


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tuple(tree)}


@pytest.fixture
def host_devices():
    prev = ctx.set_host_device_count(1)
    yield ctx.set_host_device_count
    ctx.set_host_device_count(prev)


# --- specs -------------------------------------------------------------


def test_param_specs_rules():
    """tests/test_substrates.py's cases, and each against the reference."""
    tp, ds = 16, 16
    cases = [("attn/wq", (32, 3584, 32, 128)),
             ("blocks/mlstm/wq", (10, 768, 4, 192)),
             ("moe/w1", (24, 32, 1024, 512)), ("ln1", (32, 960)),
             ("moe/gate", (24, 1024, 32)), ("embed", (151936, 1024)),
             ("mamba/in_proj", (8, 4096, 16384)), ("tiny", (4, 4))]
    for path, shape in cases:
        got = specs.param_spec(path, shape, tp, ds)
        assert isinstance(got, specs.PartitionSpec)
        assert tuple(got) == tuple(r_specs.param_spec(path, shape, tp, ds))
        assert tuple(specs.param_spec(path, shape, tp, ds, fsdp=False)) \
            == tuple(r_specs.param_spec(path, shape, tp, ds, fsdp=False))
    assert specs.param_spec("attn/wq", (32, 3584, 32, 128), tp, ds)[2] \
        == "model"
    assert "data" in specs.param_spec("attn/wq", (32, 3584, 32, 128), tp, ds)
    assert specs.param_spec("blocks/mlstm/wq", (10, 768, 4, 192), tp,
                            ds)[2] is None
    assert specs.param_spec("moe/w1", (24, 32, 1024, 512), tp, ds)[1] \
        == "model"
    assert all(a is None for a in specs.param_spec("ln1", (32, 960), tp, ds))
    assert specs._TP_RULES == r_specs._TP_RULES
    assert specs._FSDP_MIN_SIZE == r_specs._FSDP_MIN_SIZE
    assert repr(specs.P("data", None)) == "PartitionSpec('data', None)"
    for parts in ((("data",), None), ((), "model"), (("pod", "data"),)):
        assert tuple(specs.P(*parts)) == tuple(r_specs.P(*parts))


@pytest.mark.parametrize("width", ["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_tree_specs_equal_reference(arch, width):
    """Every leaf's spec equals the reference's at (tp, dsize) (16, 16)
    and (4, 2), from the reference's shape tree and from the port's model
    on the meta device."""
    rcfg, tcfg = R_ARCHS[arch], ARCHS[arch]
    if width == "reduced":
        rcfg, tcfg = r_reduced(rcfg), reduced(tcfg)
    shapes = jax.eval_shape(
        lambda: r_build(rcfg, tp=16).init(jax.random.PRNGKey(0)))
    meta = build_model(tcfg, tp=16, device="meta").param_tree()
    for tp, ds in ((16, 16), (4, 2)):
        want = _flat(r_specs.tree_param_specs(shapes, tp, ds))
        assert _flat(specs.tree_param_specs(shapes, tp, ds)) == want
        assert _flat(specs.tree_param_specs(meta, tp, ds)) == want
        shape_tree = jax.tree.map(lambda a: tuple(a.shape), shapes)
        assert _flat(specs.tree_param_specs(shape_tree, tp, ds)) == want


@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_batch_and_cache_specs_equal_reference(arch):
    rcfg, tcfg = R_ARCHS[arch], ARCHS[arch]
    for ba in (("data",), ("pod", "data")):
        assert _flat(specs.batch_specs(ba, tcfg, None)) \
            == _flat(r_specs.batch_specs(ba, rcfg, None))
        for batch in (1, 16, 32):
            for kv in (True, False):
                got = specs.cache_specs(ba, tcfg, batch, kv, 16)
                want = r_specs.cache_specs(ba, rcfg, batch, kv, 16)
                assert _flat(got) == _flat(want)


# --- ctx, meshes, elastic ----------------------------------------------


def test_logical_axes_and_shard(host_devices):
    host_devices(8)
    mesh = ctx.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         ctx.visible_devices("cpu"))
    x = torch.zeros(4, 3)
    try:
        assert ctx.shard(x, "batch", "tp") is x      # no mesh: identity
        assert ctx.axis_size("batch") == ctx.tp_size() == 1
        ctx.configure(mesh)
        assert ctx.shard(x, "batch", "tp") is x
        assert ctx.shard(x, None, "kv_tp") is x
        assert ctx.axis_size("batch") == 4
        assert (ctx.tp_size(), ctx.axis_size("kv_tp")) == (2, 1)
        with pytest.raises(ValueError, match="unknown logical axis"):
            ctx.shard(x, "heads")
        with pytest.raises(ValueError, match="dimensions"):
            ctx.shard(x, "batch", None, "tp")
        ctx.configure(ctx.make_mesh((4,), ("model",),
                                    ctx.visible_devices("cpu")))
        with pytest.raises(ValueError, match="not axes of the mesh"):
            ctx.shard(x, "batch")
    finally:
        ctx.reset()
    assert ctx.tp_size() == 1


def test_grid_batch_spec_and_mesh_helpers(host_devices):
    assert tuple(specs.grid_batch_spec()) \
        == tuple(r_specs.grid_batch_spec())
    host_devices(8)
    for shape, axes in (((2, 2, 2), ("pod", "data", "model")),
                        ((4, 2), ("data", "model"))):
        mesh = ctx.make_mesh(shape, axes, ctx.visible_devices("cpu"))
        assert mesh.shape == dict(zip(axes, shape))
        assert mesh.size == 8
        # the reference's helpers read only axis_names and shape
        assert t_mesh.batch_axes(mesh) == r_mesh.batch_axes(mesh)
        assert t_mesh.data_size(mesh) == r_mesh.data_size(mesh)
    with pytest.raises(ValueError, match="do not match"):
        ctx.Mesh(np.empty((2, 2), dtype=object), ("data",))


def test_production_mesh_raises_on_this_host(host_devices):
    for n in (1, 8):
        host_devices(n)
        with pytest.raises(ValueError, match=r"\(16, 16\)"):
            t_mesh.make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match=r"\(2, 16, 16\)"):
            t_mesh.make_production_mesh(multi_pod=True, device="cpu")
    host_devices(512)
    single = t_mesh.make_production_mesh(device="cpu")
    multi = t_mesh.make_production_mesh(multi_pod=True, device="cpu")
    assert single.shape == {"data": 16, "model": 16}
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert (t_mesh.batch_axes(multi), t_mesh.data_size(multi)) \
        == (("pod", "data"), 32)
    assert (t_mesh.batch_axes(single), t_mesh.data_size(single)) \
        == (("data",), 16)


def test_remesh_plan_equals_reference():
    for old in range(1, 5):
        for lost in range(old):
            got = elastic.remesh_plan(old, lost)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                r_elastic.remesh_plan(old, lost))
        with pytest.raises(AssertionError, match="no pods left"):
            elastic.remesh_plan(old, old)
        with pytest.raises(AssertionError, match="no pods left"):
            r_elastic.remesh_plan(old, old)
    got = elastic.remesh_plan(4, 1, base_shape=(2, 2))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        r_elastic.remesh_plan(4, 1, base_shape=(2, 2)))


def test_rebuild_mesh_keeps_its_assertion():
    cpu = torch.device("cpu")
    plan = elastic.remesh_plan(4, 1, base_shape=(2, 2))   # (3, 2, 2)
    with pytest.raises(AssertionError):
        elastic.rebuild_mesh(plan, devices=[cpu] * 11)
    mesh = elastic.rebuild_mesh(plan, devices=[cpu] * 13)
    assert mesh.shape == {"pod": 3, "data": 2, "model": 2}
    assert mesh.axis_names == plan.axis_names


# --- the GPipe pipeline over gloo ----------------------------------------


def _pipe_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((PIPE_STAGES, PIPE_D, PIPE_D)) * 0.5) \
        .astype(np.float32)
    x = rng.standard_normal((PIPE_M, PIPE_MB, PIPE_D)).astype(np.float32)
    return w, x


def _body(params, x):
    return torch.tanh(x @ params)


def _pipeline_rank(rank, world, store, out_dir):
    """One rank of the 2-process gloo pipeline (spawned)."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        w, x = (torch.from_numpy(a) for a in _pipe_inputs())
        mesh = ctx.make_mesh((2, 2, 2), ("pod", "data", "model"),
                             [torch.device("cpu")] * 8)
        fwd = pipeline.make_pipelined_forward(_body, mesh, "pod")
        got = fwd(w, x)
        direct = pipeline.pipeline_apply(_body, w[rank], x)
        few = wrong = False
        try:      # fewer than 4 microbatches per stage
            pipeline.pipeline_apply(_body, w[rank], x[:4 * world - 1])
        except AssertionError:
            few = True
        wide = ctx.make_mesh((4, 2), ("pod", "data"),
                             [torch.device("cpu")] * 8)
        try:
            pipeline.make_pipelined_forward(_body, wide, "pod")(w, x)
        except ValueError:
            wrong = True
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 got=got.numpy(), direct=direct.numpy(),
                 flags=np.array([few, wrong]))
    finally:
        dist.destroy_process_group()


_REF_PIPE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp
import numpy as np
from test_torch_parallel import _pipe_inputs
from repro.train.pipeline import make_pipelined_forward

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
w, x = _pipe_inputs()
pipe = make_pipelined_forward(lambda p, v: jnp.tanh(v @ p), mesh, "pod")
np.save({path!r}, np.asarray(pipe(jnp.asarray(w), jnp.asarray(x))))
print("REF_PIPE_OK")
"""


def test_pipeline_over_gloo_matches_reference(tmp_path):
    import torch.multiprocessing as mp

    procs = mp.start_processes(
        _pipeline_rank, args=(PIPE_STAGES, str(tmp_path / "store"),
                              str(tmp_path)),
        nprocs=PIPE_STAGES, join=False, start_method="spawn")
    deadline = time.monotonic() + 300
    try:
        while not procs.join(timeout=5):
            assert time.monotonic() < deadline, "gloo pipeline timed out"
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    assert not any(p.is_alive() for p in procs.processes)

    ref_path = str(tmp_path / "ref.npy")
    out = subprocess.run(
        [sys.executable, "-c", _REF_PIPE.format(src=SRC, tests=TESTS,
                                                path=ref_path)],
        env=dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert "REF_PIPE_OK" in out.stdout, out.stdout + out.stderr
    ref = np.load(ref_path)

    w, x = _pipe_inputs()
    seq = _body(torch.from_numpy(w[1]), _body(torch.from_numpy(w[0]),
                                              torch.from_numpy(x))).numpy()
    for rank in range(PIPE_STAGES):
        with np.load(tmp_path / f"rank{rank}.npz") as z:
            got, direct, flags = z["got"], z["direct"], z["flags"]
        assert got.shape == (PIPE_M, PIPE_MB, PIPE_D)
        np.testing.assert_allclose(got, ref, rtol=PIPE_TOL, atol=PIPE_TOL)
        np.testing.assert_allclose(got, seq, rtol=PIPE_TOL, atol=PIPE_TOL)
        assert np.array_equal(got, direct)
        assert flags.tolist() == [True, True]
