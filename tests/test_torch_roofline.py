"""The port's roofline (``repro_torch.roofline``) against the reference's
``repro.roofline``: the HLO collective parser, the roofline terms and the
reference's TPU spec bit for bit, and the H100 specs beside them; and the
count the roofline is computed from against the reference's.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \
        tests/test_torch_roofline.py

The counted FLOPs of one reduced configuration of each family, train (the
forward and backward, the reference's ``lower_train(with_opt=False)``) and
prefill, at unrolled depths 1 and 2 (xLSTM: 2 and 3, so that an mLSTM layer
is there to differentiate), against the reference's ``cost_analysis()`` on
a (1, 1) mesh of ``Auto`` axes built here (this JAX's ``jax.make_mesh``
makes ``Explicit`` axes, on which the reference's ``configure`` fails).
For xLSTM the reference's own ``_slstm_correction`` is added, as its
``cost_cell`` adds it (XLA counts the recurrence's scan body once).
Measured ratios (port / reference, B=2, S=64; the hybrid at S=32, whose
unrolled Mamba chunks make the reference's compile the slowest), and the
band each family is held to:

========  ==============================  ===========
family    train d1, d2 / prefill d1, d2    band
========  ==============================  ===========
dense     0.9950 0.9919 / 0.9947 0.9947    0.98-1.01
moe       0.9876 0.9866 / 0.9898 0.9897    0.98-1.01
vlm       0.9939 0.9916 / 0.9941 0.9950    0.98-1.01
hybrid    0.8826 0.8686 / 0.8883 0.8878    0.84-0.92
ssm       1.0379 1.0260 / 1.0325 1.0368    1.00-1.06
audio     0.9929 0.9912 / 0.9936 0.9952    0.98-1.01
========  ==============================  ===========

The port counts one flop per output element of a pointwise op and per
input element of a reduction, as XLA does; the rest is how the programs
differ: the port's Mamba scan is Hillis-Steele over each chunk where the
reference's is ``lax.associative_scan``, and XLA simplifies and fuses
some elementwise work.
"""
import dataclasses
import itertools

import pytest

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.configs.base import ShapeConfig as RShape
from repro.roofline import analysis as ref
from repro_torch import roofline
from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.launch import dryrun as D
from repro_torch.roofline import analysis as port
from test_torch_dryrun import (B, DEPTHS, FAMILY_ARCH, at_depth,  # noqa: F401
                               auto_mesh, ref_dryrun)

# port / reference FLOPs: the band each family's measured ratios keep
BANDS = {"dense": (0.98, 1.01), "moe": (0.98, 1.01), "vlm": (0.98, 1.01),
         "hybrid": (0.84, 0.92), "ssm": (1.00, 1.06), "audio": (0.98, 1.01)}
COST_S = {"hybrid": 32}

# tests/test_substrates.py's HLO text
SUBSTRATES_HLO = """
  %all-reduce.1 = f32[256,128]{1,0} all-reduce(f32[256,128]{1,0} %x), replica_groups={}
  %all-gather.2 = bf16[64,1024]{1,0} all-gather(%fusion.7), dimensions={0}
  %rs = f32[32]{0} reduce-scatter(f32[512]{0} %y), dimensions={0}
  %cp = collective-permute(bf16[8,8]{1,0} %z), source_target_pairs={{0,1}}
  %ar-start = f32[16]{0} all-reduce-start(f32[16]{0} %w)
  %ar-done = f32[16]{0} all-reduce-done(%ar-start)
"""

# further forms: async start/done pairs of every kind, tuple operands and
# results, unknown and sub-byte dtypes, scalars, layouts, no operands
MORE_HLO = [
    "  %ag-start = (bf16[8,128]{1,0}, bf16[64,128]{1,0}) all-gather-start("
    "bf16[8,128]{1,0} %p0), dimensions={0}",
    "  %ag-done = bf16[64,128]{1,0} all-gather-done(%ag-start)",
    "  %cp-start = (f32[4,4]{1,0}, f32[4,4]{1,0}, u32[], u32[]) "
    "collective-permute-start(f32[4,4]{1,0} %q), source_target_pairs="
    "{{0,1},{1,0}}",
    "  %cp-done = f32[4,4]{1,0} collective-permute-done(%cp-start)",
    "  %ar.7 = (f32[32]{0}, bf16[16,2]{1,0}) all-reduce(f32[32]{0} %a, "
    "bf16[16,2]{1,0} %b), to_apply=%add",
    "  %a2a = (s32[8]{0}, s32[8]{0}) all-to-all(s32[8]{0} %c, s32[8]{0} "
    "%d), dimensions={0}",
    "  %odd = f8e4m3fn[1024]{0} all-gather(f8e4m3fn[128]{0} %e), "
    "dimensions={0}",
    "  %unk = q7[100]{0} all-reduce(q7[100]{0} %f), to_apply=%add",
    "  %s4 = s4[64]{0} all-reduce(s4[64]{0} %g), to_apply=%add",
    "  %scalar = f32[] all-reduce(f32[] %h), to_apply=%add",
    "  %c64 = c64[3,3]{1,0} reduce-scatter(c128[3,3]{1,0} %i), "
    "dimensions={0}",
    "  %rs-start = ((f32[64]{0}), f32[8]{0}) reduce-scatter-start("
    "f32[64]{0} %j), dimensions={0}",
    "  %rs-done = f32[8]{0} reduce-scatter-done(%rs-start)",
    "  %fused = f32[16]{0} fusion(f32[16]{0} %k), kind=kLoop, "
    "calls=%all-reduce-like",
    "  %noop = f32[2]{0} all-gather(), dimensions={0}",
    "ROOT %t = (f32[8]{0}) all-reduce(f32[8]{0} %l), to_apply=%add",
]


@pytest.mark.parametrize("text", [SUBSTRATES_HLO, *MORE_HLO,
                                  "\n".join(MORE_HLO),
                                  SUBSTRATES_HLO + "\n".join(MORE_HLO), ""])
def test_collective_bytes_equal_the_reference(text):
    assert port.collective_bytes(text) == ref.collective_bytes(text)
    assert port._loop_trip_counts(text) == ref._loop_trip_counts(text)


def test_substrates_case_by_hand():
    cb = port.collective_bytes(SUBSTRATES_HLO)
    assert cb["all-reduce"] == 256 * 128 * 4 + 16 * 4
    assert cb["all-gather"] == 64 * 1024 * 2
    assert cb["reduce-scatter"] == 512 * 4
    assert cb["collective-permute"] == 8 * 8 * 2
    assert cb["counts"]["all-reduce"] == 2


@pytest.mark.parametrize("chips", [1, 2, 8, 256, 512])
def test_roofline_terms_equal_the_reference(chips):
    values = [0.0, 1.0, 3.7e9, 1e13, 2.5e15, 1e18]
    for flops, byts, coll in itertools.product(values, values, values[:4]):
        got = port.roofline_terms(flops, byts, coll, chips)
        want = ref.roofline_terms(flops, byts, coll, chips)
        assert got == want, (flops, byts, coll)


def test_hw_and_tables_are_the_reference_s():
    assert dataclasses.asdict(port.HW) == dataclasses.asdict(ref.HW)
    assert dataclasses.asdict(port.HWSpec()) == dataclasses.asdict(
        ref.HWSpec())
    assert [f.name for f in dataclasses.fields(port.HWSpec)] == [
        f.name for f in dataclasses.fields(ref.HWSpec)]
    assert port._DTYPE_BYTES == ref._DTYPE_BYTES
    assert port._COLLECTIVES == ref._COLLECTIVES


def test_h100_specs():
    """NVIDIA's H100 SXM5 datasheet: 989.4 TFLOP/s dense bf16, 66.9
    TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM3, 450 GB/s of
    NVLink each way, 80 GB."""
    h, f = port.H100, port.H100_F32
    assert (h.peak_flops, h.hbm_bw, h.link_bw, h.hbm_bytes) == (
        989.4e12, 3.35e12, 450e9, 80e9)
    assert dataclasses.replace(f, name=h.name, peak_flops=h.peak_flops) == h
    assert f.peak_flops == 66.9e12
    t = port.roofline_terms(989.4e12, 3.35e12, 0.0, 1, h)
    assert t["compute_s"] == 1.0 and t["memory_s"] == 1.0
    t = port.roofline_terms(66.9e12, 1.0, 0.0, 1, f)
    assert t["compute_s"] == 1.0 and t["dominant"] == "compute"


def test_h100_tf32_spec():
    """The same datasheet's dense TF32 tensor-core rate, 494.7 TFLOP/s, on
    the H100's memory and links."""
    h, t = port.H100, port.H100_TF32
    assert t.peak_flops == 494.7e12
    assert dataclasses.replace(t, name=h.name, peak_flops=h.peak_flops) == h


def test_package_exports():
    assert roofline.HW is port.HW
    assert roofline.H100 is port.H100 and roofline.H100_F32 is port.H100_F32
    assert roofline.H100_TF32 is port.H100_TF32
    assert roofline.collective_bytes is port.collective_bytes
    assert roofline.roofline_terms is port.roofline_terms


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_counted_flops_against_cost_analysis(family, kind, ref_dryrun,
                                             auto_mesh):
    from repro.models import unroll
    arch = FAMILY_ARCH[family]
    lo, hi = BANDS[family]
    S = COST_S.get(family, 64)
    unroll.set_unroll(True)
    try:
        for d in DEPTHS.get(family, (1, 2, 3))[:2]:
            r_cfg = at_depth(r_reduced(R_ARCHS[arch]), d)
            r_shape = RShape("t", kind, S, B)
            if kind == "train":
                lw = ref_dryrun.lower_train(r_cfg, r_shape, auto_mesh, 1,
                                            with_opt=False)
            else:
                lw = ref_dryrun.lower_prefill(r_cfg, r_shape, auto_mesh)
            want, _, _ = ref_dryrun._extract(lw.compile())
            want += ref_dryrun._slstm_correction(r_cfg, r_shape)
            got = D.trace_step(at_depth(reduced(ARCHS[arch]), d),
                               ShapeConfig("t", kind, S, B)).fb_flops
            assert lo <= got / want <= hi, (d, got, want, got / want)
    finally:
        unroll.set_unroll(False)
