"""The port's dry run (``repro_torch.launch.dryrun``) and ``input_specs``
against the reference's (``repro.launch.dryrun``, ``repro.models``).

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \
        tests/test_torch_dryrun.py

* ``input_specs``, ``model_flops``, ``MICROBATCHES`` and ``run_cell``'s
  keys, skip reasons, chips and microbatches equal the reference's; full
  configurations cost nothing on either side (``jax.eval_shape``, the meta
  device).
* The count is exactly linear in depth (the test that found the Whisper
  decoder's cross-K/V gradients summed a zero-padded full-size tensor a
  layer); the counted sLSTM recurrence is
  ``_slstm_correction``'s formula at the reference's ``CHUNK``; bytes
  match a hand count on single ops; the CLI writes its JSON with no GPU;
  ``--mesh single`` checks the spec trees over the 256-device production
  mesh and records per-device bytes.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.configs import reduced as r_reduced
from repro.configs.base import ShapeConfig as RShape
from repro.models import build_model as r_build_model
from repro.models import input_specs as r_input_specs
from repro.models import model_flops as r_model_flops
from repro.models import xlstm as r_xlstm
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, reduced
from repro_torch.launch import dryrun as D
from repro_torch.models import build_model, input_specs, model_flops
from repro_torch.models import xlstm as X
from repro_torch.sharding import ctx

ROOT = os.path.join(os.path.dirname(__file__), "..")
B, S = 2, 64
FAMILY_ARCH = {"dense": "qwen2.5-3b", "moe": "granite-moe-1b-a400m",
               "vlm": "qwen2-vl-7b", "hybrid": "jamba-v0.1-52b",
               "ssm": "xlstm-125m", "audio": "whisper-large-v3"}
DEPTHS = {"ssm": (2, 3, 4)}          # xLSTM: an mLSTM layer at every depth


@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported without moving this process's
    device count: it sets ``XLA_FLAGS`` to 512 host devices when
    imported, so the backend starts first and the variable is restored
    after."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    yield ref
    from repro.sharding import ctx as r_ctx
    r_ctx.reset()


@pytest.fixture(scope="module")
def auto_mesh():
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def at_depth(cfg, d):
    """``cfg`` with ``d`` units of depth: layers; hybrid groups; audio
    encoder and decoder layers each."""
    if cfg.family == "audio":
        return dataclasses.replace(cfg, encoder_layers=d, num_layers=d)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=d * cfg.attn_every)
    kw = {"num_layers": d}
    if cfg.slstm_layers:
        kw["slstm_layers"] = tuple(i for i in cfg.slstm_layers if i < d)
    return dataclasses.replace(cfg, **kw)


# ---------------------------------------------------------------------------
# input_specs, model_flops, run_cell's record
# ---------------------------------------------------------------------------

def _torch_dtype(dt) -> torch.dtype:
    return getattr(torch, jnp.dtype(dt).name)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_equal_the_reference(arch):
    for name in SHAPES:
        shape, r_shape = SHAPES[name], R_SHAPES[name]
        model = build_model(ARCHS[arch], device="meta")
        got = input_specs(ARCHS[arch], shape, model=model)
        want = r_input_specs(R_ARCHS[arch], r_shape,
                             model=r_build_model(R_ARCHS[arch]))
        g, w = dict(_leaves(got)), dict(_leaves(want))
        assert sorted(g) == sorted(w), (name, sorted(g), sorted(w))
        for path, leaf in w.items():
            if path == "/cache/len":
                # the port's cache length is a host int
                assert leaf.shape == () and g[path] == 0
                continue
            assert g[path].device.type == "meta", (name, path)
            assert tuple(g[path].shape) == leaf.shape, (name, path)
            assert g[path].dtype == _torch_dtype(leaf.dtype), (name, path)


def test_input_specs_of_a_decode_shape_need_the_meta_model():
    cfg = reduced(ARCHS["qwen2.5-3b"])
    with pytest.raises(ValueError, match="meta"):
        input_specs(cfg, SHAPES["decode_32k"])
    with pytest.raises(ValueError, match="meta"):
        input_specs(cfg, SHAPES["decode_32k"],
                    model=build_model(cfg, device="cpu"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_the_reference(arch):
    model = build_model(ARCHS[arch], device="meta")
    r_model = r_build_model(R_ARCHS[arch])
    r_params = jax.eval_shape(r_model.init, jax.random.PRNGKey(0))
    for name in SHAPES:
        assert model_flops(ARCHS[arch], model, SHAPES[name]) == \
            r_model_flops(R_ARCHS[arch], r_params, R_SHAPES[name])


def test_microbatches_are_the_reference_s(ref_dryrun):
    assert D.MICROBATCHES == ref_dryrun.MICROBATCHES


def test_run_cell_skips_as_the_reference(ref_dryrun, tmp_path):
    from repro.configs import shape_applicable
    n = 0
    for arch in sorted(ARCHS):
        for name in SHAPES:
            if shape_applicable(R_ARCHS[arch], R_SHAPES[name])[0]:
                continue            # the reference would lower the cell
            want = ref_dryrun.run_cell(arch, name, "single", "both",
                                       str(tmp_path / "ref"))
            assert "skipped" in want
            for mesh in ("none", "single", "multi"):
                got = D.run_cell(arch, name, mesh, "both",
                                 str(tmp_path / "port"))
                assert got == {**want, "mesh": mesh}
            n += 1
    assert n == 8           # long_500k of the eight full-attention archs
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        f.replace("_single", f"_{m}")
        for f in os.listdir(tmp_path / "ref")
        for m in ("none", "single", "multi"))


def test_run_cell_keys_chips_and_microbatches(ref_dryrun, auto_mesh,
                                              tmp_path, monkeypatch):
    """The reference's record of a reduced cell (its production mesh
    replaced by the ``Auto`` one, which this JAX can lower on) against the
    port's, whose single and multi meshes span 256 and 512 host devices:
    the reference's production meshes' sizes."""
    arch = "qwen2.5-3b"
    r_cfg = dataclasses.replace(r_reduced(R_ARCHS[arch]), num_layers=1)
    cfg = dataclasses.replace(reduced(ARCHS[arch]), num_layers=1)
    monkeypatch.setitem(ref_dryrun.ARCHS, arch, r_cfg)
    monkeypatch.setitem(ref_dryrun.SHAPES, "train_4k",
                        RShape("train_4k", "train", S, 32))
    monkeypatch.setattr(ref_dryrun, "make_production_mesh",
                        lambda multi_pod=False: auto_mesh)
    # the record's keys, not its numbers (the counts have their own tests)
    monkeypatch.setattr(ref_dryrun, "cost_cell",
                        lambda *args, **kw: (1.0, 1.0, 0.0))
    want = ref_dryrun.run_cell(arch, "train_4k", "single", "both",
                               str(tmp_path))
    monkeypatch.setitem(D.ARCHS, arch, cfg)
    monkeypatch.setitem(D.SHAPES, "train_4k",
                        ShapeConfig("train_4k", "train", S, 32))
    chips = {}
    for mesh in ("none", "single", "multi"):
        got = D.run_cell(arch, "train_4k", mesh, "both", str(tmp_path))
        keys = set(want) - ({"cost_s", "cost", "roofline"}
                            if mesh == "multi" else set())
        assert set(got) == keys, (mesh, set(got) ^ keys)
        assert got["microbatches"] == want["microbatches"] == 4
        chips[mesh] = got["chips"]
        if "cost" in got:
            assert set(want["cost"]) <= set(got["cost"])
            assert set(want["roofline"]) <= set(got["roofline"])
        # a mesh's record also breaks its collectives down by mesh axis
        by_axis = set() if mesh == "none" else {"collectives_by_axis"}
        assert set(got["hlo_once"]) == set(want["hlo_once"]) | by_axis
    # the reference's production meshes, built on stand-in devices
    monkeypatch.undo()
    from repro.launch import mesh as r_mesh
    fake = types.SimpleNamespace(make_mesh=lambda shape, axes: (
        types.SimpleNamespace(shape=dict(zip(axes, shape)),
                              axis_names=axes)))
    monkeypatch.setattr(r_mesh, "jax", fake)
    for kind, multi in (("single", False), ("multi", True)):
        m = r_mesh.make_production_mesh(multi_pod=multi)
        assert chips[kind] == int(np.prod([m.shape[a]
                                           for a in m.axis_names]))
    assert chips["none"] == 1
    assert ctx.host_device_count() == 1       # restored


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_count_is_linear_in_depth(family, kind):
    cfg = reduced(ARCHS[FAMILY_ARCH[family]])
    shape = ShapeConfig("t", kind, S, B)
    counts = [D.trace_step(at_depth(cfg, d), shape)
              for d in DEPTHS.get(family, (1, 2, 3))]
    for what in ("flops", "bytes"):
        a, b, c = (getattr(t, what) for t in counts)
        assert a > 0 and b - a > 0 and c - b == b - a, (what, a, b, c)
        if kind == "train":
            assert counts[0].mb == 1
    # the optimizer's share grows with the parameters, linearly too
    if kind == "train":
        a, b, c = (t.opt_flops for t in counts)
        assert c - b == b - a > 0


class _RecurrenceCounter(D.StepCounter):
    """Also sums the FLOPs of the sLSTM recurrence's batched products:
    [H, ., .] by [H, ., .] over the dimensions {B, hd, 4 hd} (the forward
    h @ wr and its two gradients)."""

    def __init__(self, cfg, batch, arguments=()):
        super().__init__(arguments)
        self.dims = sorted((batch, cfg.head_dim, 4 * cfg.head_dim))
        self.heads = cfg.num_heads
        self.recurrence = 0.0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types_, args, kwargs)
        if func is torch.ops.aten.bmm.default:
            a, b = args[0].shape, args[1].shape
            if a[0] == b[0] == self.heads and sorted(
                    (a[1], a[2], b[2])) == self.dims:
                self.recurrence += self.flops - before
        return out


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_slstm_recurrence_is_the_reference_correction(kind, ref_dryrun,
                                                      monkeypatch):
    """At the reference's mLSTM chunk (S = CHUNK = 64), the port's counted
    sLSTM recurrence is ``_slstm_correction``: 8 H hd^2 a token and layer,
    three times over when training."""
    assert X.CHUNK == r_xlstm.CHUNK == S
    cfg = at_depth(reduced(ARCHS["xlstm-125m"]), 3)
    counters = []

    def make(arguments=()):
        counters.append(_RecurrenceCounter(cfg, B, arguments))
        return counters[-1]

    monkeypatch.setattr(D, "StepCounter", make)
    D.trace_step(cfg, ShapeConfig("t", kind, S, B))
    want = ref_dryrun._slstm_correction(
        at_depth(r_reduced(R_ARCHS["xlstm-125m"]), 3), RShape("t", kind, S, B))
    # the first step's h is the zero state, which takes no gradient: its
    # backward product is the one the formula counts and autograd skips
    skipped = B * 8 * cfg.num_heads * cfg.head_dim ** 2 * len(
        cfg.slstm_layers) if kind == "train" else 0
    assert want > 0 and counters[0].recurrence == want - skipped


# ---------------------------------------------------------------------------
# the counter by hand
# ---------------------------------------------------------------------------

def test_counted_bytes_and_flops_by_hand():
    M, K, N = 32, 48, 16
    a = torch.empty((M, K), device="meta")
    b = torch.empty((K, N), device="meta")
    x = torch.empty((M, N), device="meta", dtype=torch.bfloat16)
    with D.StepCounter((a, b, x)) as c:
        y = a @ b
    assert c.flops == 2 * M * K * N
    assert c.bytes == 4 * (M * K + K * N + M * N)
    assert c.argument_bytes == 4 * (M * K + K * N) + 2 * M * N
    assert c.peak_bytes == 4 * M * N
    with D.StepCounter((y,)) as c:
        v = y.view(N, M).t()
        w = y.reshape(M * N)
    assert (c.flops, c.bytes, c.peak_bytes) == (0, 0, 0)
    with D.StepCounter((x,)) as c:
        x.add_(x)
    assert c.flops == M * N
    assert c.bytes == 3 * 2 * M * N           # read twice, written once
    assert c.peak_bytes == 0
    with D.StepCounter((x,)) as c:
        t = x.float()                          # a conversion: one pass
        del t
        s = x.sum()
    assert c.flops == 2 * M * N
    assert c.bytes == (2 + 4) * M * N + 2 * M * N + 2
    assert c.peak_bytes == 4 * M * N and c.live == 2
    with D.StepCounter((y,)) as c:
        z = torch.logsumexp(y, dim=-1)
    # its CUDA kernel's temporary, (y - max).exp_(), while it runs
    assert c.peak_bytes == 4 * M + 4 * M * N and c.live == 4 * M
    assert c.flops == M * N and c.bytes == 4 * (M * N + M)
    del v, w, s, z


class _Forgetful(dict):
    def __setitem__(self, key, value):
        pass


class _Uncached(D.StepCounter):
    """Runs every op, as if the counter kept no cache."""

    def __init__(self, arguments=()):
        super().__init__(arguments)
        self._cache = _Forgetful()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_repeated_ops_count_as_the_first(kind, monkeypatch):
    """The counter's cache of outputs by input shapes: a step counted
    twice, and counted op by op without it, gives the same numbers."""
    cfg = at_depth(reduced(ARCHS["granite-moe-1b-a400m"]), 2)
    shape = ShapeConfig("t", kind, S, B)
    a = D.trace_step(cfg, shape)
    b = D.trace_step(cfg, shape)
    monkeypatch.setattr(D, "StepCounter", _Uncached)
    c = D.trace_step(cfg, shape)
    for t in (b, c):
        assert (t.flops, t.bytes, t.temp_bytes, t.argument_bytes,
                t.output_bytes) == (a.flops, a.bytes, a.temp_bytes,
                                    a.argument_bytes, a.output_bytes)


def test_kernel_attention_counts_the_flash_kernels():
    """``attention="kernel"``: each self-attention as the flash kernels'
    work (causal pairs, q, k, v and the output once; the backward's
    stages), and the MoE's routing on the meta device (bincount)."""
    cfg = at_depth(reduced(ARCHS["qwen2.5-3b"]), 1)
    shape = ShapeConfig("t", "prefill", S, B)
    plain = D.trace_step(cfg, shape, step="loss")
    kern = D.trace_step(cfg, shape, step="loss", attention="kernel")
    H, hd = 16, cfg.head_dim                       # head_plan pads to 16
    pairs = S * (S + 1) // 2
    flash = 4 * B * H * hd * pairs
    assert kern.flops < plain.flops
    train = D.trace_step(cfg, ShapeConfig("t", "train", S, B),
                         attention="kernel", donate=True)
    # remat: the forward twice, then the backward's five products
    assert train.fb_flops > 2 * flash + 10 * B * H * hd * pairs
    # donated: written in place; new are the step, gnorm and lr scalars
    assert train.output_bytes == 12
    moe = D.trace_step(at_depth(reduced(ARCHS["granite-moe-1b-a400m"]), 1),
                       shape, step="loss", attention="kernel")
    assert moe.flops > 0


# ---------------------------------------------------------------------------
# the production meshes' spec trees, the CLI
# ---------------------------------------------------------------------------

def test_spec_checks_and_per_device_bytes():
    from repro_torch.sharding.specs import P
    prev = ctx.set_host_device_count(8)
    try:
        mesh = ctx.make_mesh((2, 4), ("data", "model"),
                             ctx.visible_devices("cpu"))
    finally:
        ctx.set_host_device_count(prev)
    tree = {"w": torch.empty((8, 12), device="meta"),
            "b": torch.empty((6,), device="meta", dtype=torch.bfloat16),
            "len": 0}
    specs = {"w": P("data", "model"), "b": P(None), "len": P()}
    assert D.check_specs(specs, tree, mesh) == 2
    assert D.per_device_bytes(specs, tree, mesh) == 8 * 12 * 4 // 8 + 12
    with pytest.raises(ValueError, match="b: dimension 0"):
        D.check_specs({**specs, "b": P("model")}, tree, mesh)
    assert D.per_device_bytes(None, tree, mesh) == 8 * 12 * 4 + 12


def test_cli_writes_its_json_without_a_gpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2.5-3b", "--shape", "train_4k", "--mesh", "none", "--mode",
         "both", "--out", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    with open(tmp_path / "qwen2.5-3b_train_4k_none.json") as f:
        rec = json.load(f)
    assert rec == json.loads(out.stdout)
    assert rec["chips"] == 1 and rec["microbatches"] == 4
    assert rec["roofline"]["hw"] == "h100-sxm5"
    assert rec["cost"]["hlo_flops"] > rec["cost"]["model_flops"] > 0
    m = rec["memory"]
    assert m["argument_size_in_bytes"] > 0 and m["temp_size_in_bytes"] > 0


def test_cli_writes_under_the_port_s_own_default(tmp_path, monkeypatch,
                                                 capsys):
    """Without ``--out`` the dry run writes into experiments/dryrun_torch,
    never the reference's experiments/dryrun."""
    monkeypatch.chdir(tmp_path)
    prev = ctx.host_device_count()
    try:
        D.main(["--arch", "smollm-360m", "--shape", "train_4k", "--mesh",
                "none", "--mode", "cost"])
    finally:
        ctx.set_host_device_count(prev)
    capsys.readouterr()
    assert os.listdir(tmp_path / "experiments") == ["dryrun_torch"]
    with open(tmp_path / "experiments" / "dryrun_torch"
              / "smollm-360m_train_4k_none.json") as f:
        assert json.load(f)["roofline"]["hw"] == "h100-sxm5"


def test_sweep_writes_under_the_port_s_own_default(monkeypatch, capsys):
    from repro_torch.launch import dryrun_sweep

    dirs = set()

    def run_cell(arch, shape, mesh, mode, out_dir):
        dirs.add(out_dir)
        return {"skipped": "stand-in"}

    monkeypatch.setattr(dryrun_sweep, "run_cell", run_cell)
    dryrun_sweep.main([])
    capsys.readouterr()
    assert dirs == {"experiments/dryrun_torch"}


def test_single_mesh_checks_specs_and_records_per_device_bytes(tmp_path):
    """A full-width cell on the 256-device production mesh: the spec trees
    shard evenly, the arguments per device are the whole ones divided as
    the specs say; the decode step runs sharded (the cache placed by
    ``cache_specs``), so its collective term and a device's temporaries
    are modelled. Its FLOPs (the device's times 256) against the closed
    form of the step's matrix products M (the unsharded step's): the
    sharded step adds the kv projections on every one of the 16 model
    ranks (2 kv heads do not split over them) and drops the unsharded
    step's copies of the kv heads repeated to Hq (k and v each repeated,
    then laid out for the einsum: four copies of [B, S, Hq, hd] a layer;
    each rank reads its one kv head as it lies); the rest, the
    elementwise work, is the unsharded step's at least and at most
    repeated on every model rank."""
    rec = D.run_cell("qwen2.5-3b", "decode_32k", "single", "both",
                     str(tmp_path))
    assert rec["chips"] == 256
    tr = D.trace_step(ARCHS["qwen2.5-3b"], SHAPES["decode_32k"])
    m = rec["memory"]
    whole = tr.argument_bytes
    assert whole / 256 < m["argument_size_in_bytes"] < whole / 8
    assert m["temp_size_in_bytes"] > 0 and "temp_note" not in m
    assert rec["cost"]["collective_bytes_per_chip"] > 0
    assert rec["roofline"]["hw"] == "tpu-v5e"
    cfg, sh, tp = ARCHS["qwen2.5-3b"], SHAPES["decode_32k"], 16
    B, S, d, hd = sh.batch, sh.seq, cfg.d_model, cfg.head_dim
    hq, hkv, Ln = cfg.num_heads, cfg.kv_heads, cfg.num_layers
    kv = 2 * 2 * B * d * hkv * hd
    M = Ln * (2 * 2 * B * d * hq * hd + kv + 3 * 2 * B * d * cfg.d_ff
              + 2 * 2 * B * hq * S * hd) + 2 * B * d * cfg.vocab
    copies = Ln * 4 * B * S * hq * hd
    rest = tr.flops - M - copies
    assert 0 < rest < 0.05 * M
    got = rec["cost"]["hlo_flops"]
    assert got == 256 * rec["cost"]["hlo_flops_per_chip"]
    assert M + (tp - 1) * Ln * kv + rest <= got \
        <= M + (tp - 1) * Ln * kv + tp * rest
    assert ctx._CTX is None and ctx.host_device_count() == 1


NEW_MODULES = ["roofline/__init__.py", "roofline/analysis.py",
               "launch/dryrun.py", "launch/dryrun_sweep.py",
               "models/model_zoo.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_new_modules_import_neither_jax_nor_repro(rel):
    tree = ast.parse(open(os.path.join(ROOT, "src", "repro_torch",
                                       rel)).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_unrolled_attention_is_the_port_s_at_a_ragged_length():
    """``repro.models.unroll`` has no counterpart module: the port's layer
    loops are Python loops, the reference's ``UNROLL = True`` form. Its
    unrolled attention cuts the last query chunk of a length that is no
    multiple of 512 short, as the port's ``attention_plain_model`` does:
    at S=600 the reference's forward under ``set_unroll(True)`` equals the
    port's plain forward at the f32 model tolerances (hidden states 5e-5,
    loss 1e-5). Its default ``fori_loop`` form clamps the last chunk's
    slice to start at 88 and masks it from offset 512 (ROADMAP Queue 3
    item 6): rows 88-599 then differ."""
    from repro.models import unroll
    from repro_torch import interop

    cfg = at_depth(reduced(ARCHS["qwen2.5-3b"]), 2)
    r_cfg = at_depth(r_reduced(R_ARCHS["qwen2.5-3b"]), 2)
    assert cfg.dtype == r_cfg.dtype == "float32"
    rm = r_build_model(r_cfg, tp=16)
    tree = jax.tree.map(np.asarray, jax.jit(rm.init)(jax.random.PRNGKey(0)))
    tm = interop.load_params(build_model(cfg, tp=16, device="cpu"), tree)
    params = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(1, cfg.vocab, (1, 600)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (1, 600)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # each form traced anew (the switch is read when a function traces)
    unroll.set_unroll(True)
    try:
        h_unrolled = np.asarray(jax.jit(
            lambda p, b: rm.apply(p, b, remat=False))(params, jb))
        loss_unrolled = float(jax.jit(
            lambda p, b: rm.loss(p, b, remat=False))(params, jb))
    finally:
        unroll.set_unroll(False)
    h_fori = np.asarray(jax.jit(
        lambda p, b: rm.apply(p, b, remat=False))(params, jb))
    got = tm.apply(batch).numpy()
    np.testing.assert_allclose(got, h_unrolled, rtol=5e-5, atol=5e-5)
    assert abs(float(tm.loss(batch)) - loss_unrolled) <= 1e-5 * max(
        1.0, abs(loss_unrolled))
    np.testing.assert_allclose(got[:, :88], h_fori[:, :88], rtol=5e-5,
                               atol=5e-5)
    assert not np.allclose(got[:, 88:], h_fori[:, 88:], rtol=5e-5,
                           atol=5e-5)
