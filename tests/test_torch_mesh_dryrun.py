"""The dry run's collective term under ``--mesh single|multi``
(``repro_torch.launch.dryrun``): the sharded step traced as one rank of a
``fake``-backend process group on the meta device.

* A closed form: one TP'd SwiGLU MLP (``layers.mlp``) on a (data=2,
  model=2) fake mesh, its input's rows over "data", ``w1``/``w3`` split on
  their hidden columns and ``w2`` on its hidden rows over "model": the
  second product leaves a partial sum over "model", whose one all-reduce
  moves this rank's output, (B/2) S d f32 elements; the rank's FLOPs are
  the three products over its quarter of the work plus the SiLU and the
  product of the gates.
* ``run_cell``'s records: every arch's ``train_4k`` cell on the single
  production mesh (256 ranks), at full width cut to its least depth
  (:func:`cut`), gives a positive ``collective_bytes_per_chip`` with its
  kinds and counts, per-device FLOPs and temporaries, and a collective
  term in the roofline; so do decode cells (the sharded decode step, its
  cache placed by ``cache_specs``): ``decode_32k`` (rows over "data"),
  whose all-gathers a device move less than its share of the cache (the
  reference's pin against a whole-cache gather), and ``long_500k``'s B=1
  (the sequence over "data"), whose attention all-reduces across "data".
"""
import types

import dataclasses

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.launch import dryrun as D
from repro_torch.models import layers as L
from repro_torch.sharding import ctx


def cut(cfg):
    """``cfg`` at full width and its least depth: one layer (one group of
    a hybrid, one encoder and one decoder layer, an sLSTM and an mLSTM
    block)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, num_layers=cfg.attn_every)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, num_layers=1, encoder_layers=1)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, num_layers=2, slstm_layers=(0,))
    return dataclasses.replace(cfg, num_layers=1)


def test_tp_mlp_all_reduce_is_its_closed_form():
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    B, S, d, ff = 8, 16, 64, 256
    prev = ctx._CTX
    try:
        with D.fake_mesh((2, 2), ("data", "model")) as mesh:
            ctx.configure(mesh)
            dm = mesh.device_mesh

            def place(shape, placements):
                return distribute_tensor(
                    torch.empty(shape, device="meta"), dm, placements,
                    src_data_rank=None)

            x = place((B, S, d), (Shard(0), Replicate()))
            p = {"w1": place((d, ff), (Replicate(), Shard(1))),
                 "w3": place((d, ff), (Replicate(), Shard(1))),
                 "w2": place((ff, d), (Replicate(), Shard(0)))}
            counter = D.StepCounter()
            with counter:
                y = ctx.shard(L.mlp(p, x), "batch", None, None)
            assert y.placements == (Shard(0), Replicate())
    finally:
        ctx._CTX = prev
    c = counter.collectives
    rows = B // 2 * S
    assert c["all-reduce"] == c["total"] == rows * d * 4
    assert c["counts"] == {"all-gather": 0, "all-reduce": 1,
                           "reduce-scatter": 0, "all-to-all": 0,
                           "collective-permute": 0}
    # w1, w3 and w2 over this rank's rows and hidden half; SiLU and the
    # gates' product over [rows, ff / 2]
    assert counter.flops == 3 * 2 * rows * d * (ff // 2) + 2 * rows * (ff // 2)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_cell_has_a_collective_term(arch, tmp_path):
    rec = D.run_cell(arch, "train_4k", "single", "both", str(tmp_path),
                     cfg=cut(ARCHS[arch]))
    assert rec["chips"] == 256
    cost = rec["cost"]
    coll = cost["collective_bytes_per_chip"]
    assert coll is not None and coll > 0
    kinds = cost["collectives"]
    assert kinds["total"] == coll
    assert sum(kinds["counts"].values()) > 0
    assert all(kinds[k] >= 0 for k in kinds["counts"])
    assert cost["hlo_flops"] == pytest.approx(256 * cost["hlo_flops_per_chip"])
    assert rec["roofline"]["collective_s"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert rec["hlo_once"]["collectives"]["total"] > 0
    assert ctx._CTX is None


def _cache_bytes_per_device(cfg, shape) -> int:
    """The decode cache's bytes on one device of the single production
    mesh, as ``cache_specs`` places it."""
    from repro_torch.models import build_model, input_specs
    from repro_torch.sharding.specs import cache_specs

    model = build_model(cfg, tp=16, device="meta")
    cache = input_specs(cfg, shape, model=model)["cache"]
    specs = cache_specs(("data",), cfg, shape.batch, model.hkv % 16 == 0,
                        16)
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    return D.per_device_bytes(specs, cache, mesh)


@pytest.mark.parametrize("arch,shape", [
    ("smollm-360m", "decode_32k"), ("jamba-v0.1-52b", "long_500k"),
    ("xlstm-125m", "long_500k")])
def test_decode_cell_has_a_collective_term(arch, shape, tmp_path):
    from repro_torch.configs import SHAPES

    cfg = cut(ARCHS[arch])
    rec = D.run_cell(arch, shape, "single", "both", str(tmp_path), cfg=cfg)
    cost = rec["cost"]
    coll = cost["collective_bytes_per_chip"]
    assert coll is not None and coll > 0 and "collective_note" not in cost
    assert cost["collectives"]["total"] == coll
    assert rec["roofline"]["collective_s"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    by_axis = rec["hlo_once"]["collectives_by_axis"]
    if shape == "decode_32k":
        # rows over "data": no collective over it but FSDP's weight gathers,
        # and no gather of the cache
        assert cost["collectives"]["all-gather"] < _cache_bytes_per_device(
            cfg, SHAPES[shape])
    elif cfg.family == "hybrid":
        # B=1: the attention's partial softmax combined across "data"
        assert by_axis["data"]["all-reduce"] > 0
    assert ctx._CTX is None


# --- a finding, not a gate: the port's collectives beside XLA's -----------

_REF_COLLECTIVES = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
import dataclasses
import numpy as np
import jax
from jax.sharding import AxisType, Mesh, NamedSharding
from repro.configs import ARCHS, reduced
from repro.configs.base import ShapeConfig
from repro.launch.dryrun import _batch_struct_and_specs, \
    _state_struct_and_specs
from repro.models import build_model, unroll
from repro.roofline.analysis import collective_bytes
from repro.sharding.ctx import configure
from repro.sharding.specs import P
from repro.train.step import make_train_step

unroll.set_unroll(True)          # every layer's collectives in the text
cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **{widen!r})
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)
model = build_model(cfg, tp=2)
configure(mesh)
state, s_specs = _state_struct_and_specs(model, mesh)
batch, b_specs = _batch_struct_and_specs(
    cfg, ShapeConfig("mesh", "train", {S}, {B}), mesh)


def ns(tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


step = jax.jit(make_train_step(model),
               in_shardings=(ns(s_specs), ns(b_specs)),
               out_shardings=(ns(s_specs), ns({{"loss": P(), "gnorm": P(),
                                                "lr": P()}})))
text = step.lower(state, batch).compile().as_text()
print("REF_COLLECTIVES " + json.dumps(collective_bytes(text)))
"""


def test_widened_smollm_collectives_beside_the_reference():
    """``tests/test_torch_mesh.py``'s widened reduced SmolLM, its f32
    train step on a (data=2, model=2) mesh (B=4, S=32): the port's
    collectives by kind (the traced sharded step on a fake mesh) beside
    the reference's (``collective_bytes`` of its compiled step's HLO, the
    layers unrolled so that each layer's collectives are in the text).
    DTensor and XLA's partitioner choose different collectives, so only
    that both move bytes is held; ``pytest -s`` prints both (PERF.md)."""
    import json
    import os
    import subprocess
    import sys

    from repro_torch.configs import ShapeConfig, reduced

    widen = dict(d_model=256, d_ff=1024, vocab=4096, num_heads=4,
                 head_dim=64)
    B, S = 4, 32
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    ref = subprocess.run(
        [sys.executable, "-c", _REF_COLLECTIVES.format(
            src=src, widen=widen, S=S, B=B)],
        env=dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    line = [x for x in ref.stdout.splitlines()
            if x.startswith("REF_COLLECTIVES ")]
    assert line, ref.stdout + ref.stderr
    want = json.loads(line[0].split(" ", 1)[1])
    cfg = dataclasses.replace(reduced(ARCHS["smollm-360m"]), **widen)
    prev = ctx._CTX
    try:
        with D.fake_mesh((2, 2), ("data", "model")) as mesh:
            tr = D.trace_step(cfg, ShapeConfig("mesh", "train", S, B),
                              mesh=mesh)
    finally:
        ctx._CTX = prev
    got = D.step_collectives(tr)
    print("\nwidened SmolLM, f32 train step, (2, 2) mesh, per device:")
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute", "total"):
        n = "" if kind == "total" else (
            f" ({got['counts'][kind]} / {want['counts'][kind]})")
        print(f"  {kind:<20} port {got[kind]:>12,} B  reference "
              f"{want[kind]:>12,} B{n}")
    assert got["total"] > 0 and want["total"] > 0
