"""Port parity, host layer: repro_torch's copies of the framework-free
modules (generators, cluster, HEFT, instance build, profiles, EST/LST,
score orders, candidate masks, costs) against repro's, bitwise; the
import boundary; the interop round trip; the device default."""
import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.cluster import make_cluster as r_cluster
from repro.core.carbon import work_timeline as r_timeline
from repro.core.scores import task_order as r_order
from repro.core.subdivide import candidate_mask as r_mask
from repro.workflows import make_workflow as r_workflow
from repro.workflows import wfgen_scale as r_wfgen
from repro_torch import interop
from repro_torch.cluster import make_cluster as t_cluster
from repro_torch.core.carbon import work_timeline as t_timeline
from repro_torch.core.scores import task_order as t_order
from repro_torch.core.subdivide import candidate_mask as t_mask
from repro_torch.workflows import make_workflow as t_workflow
from repro_torch.workflows import wfgen_scale as t_wfgen

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


def _same(a, b, path="obj"):
    """Field-by-field bitwise equality of two dataclass objects (of the
    two packages) or plain values."""
    if dataclasses.is_dataclass(a):
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            _same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, path


def _both(kind, seed, scale=False):
    """The same instance built by both packages: (repro's, port's)."""
    out = []
    for cluster, workflow, wfgen, core in (
            (r_cluster, r_workflow, r_wfgen, rc),
            (t_cluster, t_workflow, t_wfgen, tc)):
        plat = cluster(1, seed=seed)
        wf = wfgen(kind, 60, seed=seed) if scale else \
            workflow(kind, 3, seed=seed)
        mp = core.heft_mapping(wf, plat)
        inst = core.build_instance(wf, mp, plat)
        out.append((plat, wf, mp, inst))
    return out


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("kind", ["atacseq", "bacass", "eager",
                                  "methylseq"])
def test_host_layer_bit_identical(kind, seed):
    (rp, rw, rm, ri), (tp, tw, tm, ti) = _both(kind, seed)
    _same(rp, tp, "platform")
    _same(rw, tw, "workflow")
    _same(rm, tm, "mapping")
    _same(ri, ti, "instance")
    est_r, est_t = rc.compute_est(ri), tc.compute_est(ti)
    assert np.array_equal(est_r, est_t)
    assert np.array_equal(rc.asap_schedule(ri), tc.asap_schedule(ti))
    for factor in (1.0, 1.5, 3.0):
        T = rc.deadline_from_asap(ri, factor)
        assert T == tc.deadline_from_asap(ti, factor)
        lst_r, lst_t = rc.compute_lst(ri, T), tc.compute_lst(ti, T)
        assert np.array_equal(lst_r, lst_t)
        for score in ("slack", "press"):
            for weighted in (False, True):
                assert np.array_equal(
                    r_order(ri, est_r, lst_r, score, weighted, rp),
                    t_order(ti, est_t, lst_t, score, weighted, tp))
        for scen in rc.SCENARIOS:
            pr = rc.generate_profile(scen, T, rp, J=12, seed=seed + 1)
            pt = tc.generate_profile(scen, T, tp, J=12, seed=seed + 1)
            _same(pr, pt, "profile")
            for refined in (False, True):
                assert np.array_equal(r_mask(ri, pr, refined=refined),
                                      t_mask(ti, pt, refined=refined))
            asap = rc.asap_schedule(ri)
            assert rc.schedule_cost(ri, pr, asap) == \
                tc.schedule_cost(ti, pt, asap)
            assert np.array_equal(r_timeline(ri, T, asap),
                                  t_timeline(ti, T, asap))


@pytest.mark.parametrize("kind", ["eager", "methylseq"])
def test_wfgen_scale_bit_identical(kind):
    (_, rw, _, ri), (_, tw, _, ti) = _both(kind, 2, scale=True)
    _same(rw, tw, "workflow")
    _same(ri, ti, "instance")


@pytest.mark.parametrize("kind", ["atacseq", "bacass"])
def test_interop_round_trip(kind):
    """repro object -> fields -> port object -> fields -> repro object,
    equal at every step; asdict-style dicts are accepted too."""
    rp, rw, rm, ri = _both(kind, 1)[0]
    T = rc.deadline_from_asap(ri, 1.5)
    rprof = rc.generate_profile("S2", T, rp, J=12, seed=3)
    for obj in (rp, rw, rm, ri, rprof):
        ported = interop.port(obj)
        assert type(ported).__module__.startswith("repro_torch.")
        _same(obj, ported, type(obj).__name__)
        _same(ported, interop.from_fields(type(obj).__name__,
                                          dataclasses.asdict(obj)))
        back = type(obj)(**interop.fields(ported))
        _same(obj, back, type(obj).__name__)
    # the ported instance schedules exactly like the reference one
    ti, tprof = interop.port(ri), interop.port(rprof)
    start = rc.asap_schedule(ri)
    assert rc.schedule_cost(ri, rprof, start) == \
        tc.schedule_cost(ti, tprof, start)


def test_interop_rejects_bad_input():
    rp = r_cluster(1, seed=0)
    with pytest.raises(ValueError, match="unknown kind"):
        interop.from_fields("Nope", {})
    d = interop.fields(rp)
    d.pop("speed")
    with pytest.raises(ValueError, match="missing"):
        interop.from_fields("Platform", d)


_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None          # any import of them now raises
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "repro")
          and sys.modules[m] is not None]
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25      # every submodule imported


def _imported_roots(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("where", ["src/repro_torch", "chip_smoke.py"])
def test_port_sources_name_no_jax_or_repro(where):
    path = os.path.join(ROOT, where)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
        if f.endswith(".py")]
    assert files
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro"}, (f, roots)


def test_planner_defaults_to_the_card(monkeypatch):
    """device=None means cuda: without a GPU the Planner raises instead of
    running on the CPU; device='cpu' is the explicit opt-in."""
    from repro_torch.api import Planner
    from repro_torch.kernels.backend import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plat = t_cluster(1, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Planner(plat)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Planner(plat, engine="numpy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert Planner(plat, device="cpu").device == torch.device("cpu")


def test_engine_and_mode_resolution():
    from repro.kernels.backend import resolve_engine as r_engine
    from repro_torch.kernels.backend import resolve_engine, resolve_mode

    for fanout in (1, 2, 8):
        want = r_engine("auto", fanout).replace("jax", "torch")
        assert resolve_engine("auto", fanout) == want
        assert resolve_engine(None, fanout) == want
    assert resolve_engine("numpy") == "numpy"
    with pytest.raises(ValueError):
        resolve_engine("jax")
    cpu = torch.zeros(1)
    assert resolve_mode(cpu) == "plain"
    assert resolve_mode(cpu, "plain") == "plain"
    with pytest.raises(ValueError, match="CUDA"):
        resolve_mode(cpu, "kernel")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        resolve_mode(cpu, "pallas")
