"""Port parity, the multi-device scheduler grid: ``devices=`` on
``schedule_portfolio_grid``, ``Planner``/``PlanRequest``, the mapping search
and ``PlanService``, against the port's own ``devices=None`` run and the
reference's ``engine="jax"`` run.

The port runs on the CPU with 8 host devices
(``repro_torch.sharding.ctx.set_host_device_count(8)``), so a split over n
devices is n row shards on the CPU. The reference at ``devices=n`` needs 8
jax host devices: it runs in this process where ``jax.devices()`` already
has 8 entries (``tests/test_sharded_grid.py`` sets the flag when pytest
collects it), else in a subprocess with the flag set. The case is the
reference suite's (``tests/test_sharded_grid.py``): 5 instances x 2
profiles from seeds, ``("asap", "pressWR-LS", "pressW")``,
``make_cluster(1, seed=0)``. Every comparison is bitwise (tolerance 0):
start vectors and int64 costs.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap, generate_profile,
                        heft_mapping)
from repro.core.portfolio import schedule_portfolio_grid as r_grid
from repro.sharding.specs import grid_batch_spec as r_grid_batch_spec
from repro.workflows import make_workflow
from repro_torch import interop
from repro_torch.api import Planner, PlanRequest
from repro_torch.core import greedy_torch
from repro_torch.core.portfolio import schedule_portfolio_grid
from repro_torch.serve import PlanService
from repro_torch.sharding import ctx
from repro_torch.sharding.specs import grid_batch_spec

VARIANTS = ("asap", "pressWR-LS", "pressW")
KINDS = ("eager", "atacseq", "eager", "bacass", "methylseq")
HOST_DEVICES = 8
TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")


def reference_case():
    """The reference suite's 5 x 2 grid (odd count: uneven shards at 2
    and 8 devices)."""
    platform = make_cluster(1, seed=0)
    insts, rows = [], []
    for i, kind in enumerate(KINDS):
        wf = make_workflow(kind, 2, seed=i)
        inst = build_instance(wf, heft_mapping(wf, platform), platform)
        T = deadline_from_asap(inst, 2.0)
        insts.append(inst)
        rows.append([generate_profile("S3", T, platform, J=8, seed=i),
                     generate_profile("S1", T, platform, J=8, seed=i + 50)])
    return platform, insts, rows


def flatten(cells):
    return {(i, p, name): (np.asarray(r.start), int(r.cost))
            for i, row in enumerate(cells)
            for p, cell in enumerate(row)
            for name, r in cell.items()}


def assert_same(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key][0], b[key][0]), key
        assert a[key][1] == b[key][1], key


_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
sys.path.insert(0, {tests!r})
import numpy as np
from test_torch_sharded import VARIANTS, flatten, reference_case
from repro.core.portfolio import schedule_portfolio_grid

platform, insts, rows = reference_case()
out = {{}}
for n in {counts!r}:
    cells = flatten(schedule_portfolio_grid(
        insts, rows, platform, variants=VARIANTS, engine="jax", devices=n))
    for (i, p, name), (start, cost) in cells.items():
        out[f"{{n}}|{{i}}|{{p}}|{{name}}|start"] = start
        out[f"{{n}}|{{i}}|{{p}}|{{name}}|cost"] = np.int64(cost)
np.savez({path!r}, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def host_devices():
    prev = ctx.set_host_device_count(HOST_DEVICES)
    yield HOST_DEVICES
    ctx.set_host_device_count(prev)


@pytest.fixture(scope="module")
def case():
    platform, insts, rows = reference_case()
    return (platform, insts, rows, interop.port(platform),
            [interop.port(x) for x in insts],
            [[interop.port(p) for p in ps] for ps in rows])


@pytest.fixture(scope="module")
def reference_sharded(case, tmp_path_factory):
    """The reference's jax grid at devices 2 and 8, flattened by count."""
    platform, insts, rows = case[:3]
    counts = (2, 8)
    if len(jax.devices()) >= max(counts):
        return {n: flatten(r_grid(insts, rows, platform, variants=VARIANTS,
                                  engine="jax", devices=n))
                for n in counts}
    path = str(tmp_path_factory.mktemp("ref") / "sharded.npz")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT.format(
            src=SRC, tests=TESTS, counts=counts, path=path)],
        env=env, capture_output=True, text=True, timeout=600)
    assert "REF_OK" in out.stdout, out.stdout + out.stderr
    got: dict = {n: {} for n in counts}
    with np.load(path) as z:
        for key in z.files:
            n, i, p, name, field = key.split("|")
            cell = got[int(n)].setdefault((int(i), int(p), name), [None, None])
            cell[0 if field == "start" else 1] = z[key]
    return {n: {k: (v[0], int(v[1])) for k, v in cells.items()}
            for n, cells in got.items()}


def _port_grid(case, **kw):
    tplat, tinsts, trows = case[3:]
    return flatten(schedule_portfolio_grid(
        tinsts, trows, tplat, variants=VARIANTS, engine="torch",
        device="cpu", **kw))


def test_host_devices_and_grid_mesh(host_devices):
    devs = ctx.visible_devices("cpu")
    assert len(devs) == host_devices
    assert all(d.type == "cpu" for d in devs)
    mesh = ctx.grid_mesh(device="cpu")
    assert mesh.axis_names == ("data",)
    assert mesh.shape["data"] == host_devices
    assert ctx.grid_mesh(3, device="cpu").shape == {"data": 3}
    assert tuple(grid_batch_spec()) == tuple(r_grid_batch_spec())
    for bad in (99, 0):
        with pytest.raises(ValueError, match="devices"):
            ctx.grid_mesh(bad, device="cpu")
    for bad in (0, 2.5, True):
        with pytest.raises(ValueError, match="host device count"):
            ctx.set_host_device_count(bad)


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_grid_bitwise_identical(case, host_devices,
                                        reference_sharded, ndev):
    """devices=n == the port at None == the reference's jax engine at
    None and at n."""
    platform, insts, rows = case[:3]
    ref = flatten(r_grid(insts, rows, platform, variants=VARIANTS,
                         engine="jax"))
    base = _port_grid(case)
    shard = _port_grid(case, devices=ndev)
    assert_same(base, ref)
    assert_same(shard, base)
    assert_same(shard, reference_sharded[ndev])


def test_mesh_split_is_uneven_and_skips_empty_shards(case, host_devices,
                                                     monkeypatch):
    """Each bucket's instances split into contiguous shards of sizes
    differing by at most one (the case's buckets hold 2 and 3 instances:
    1 + 1 and 2 + 1 over 2 devices); 1 instance over 8 devices runs one
    shard; each shard lies on its mesh device."""
    shards = []
    real = greedy_torch._DenseShard

    def spy(rows, dev):
        shards.append((len(rows), dev))
        return real(rows, dev)

    monkeypatch.setattr(greedy_torch, "_DenseShard", spy)
    base = _port_grid(case)
    buckets = [n for n, _ in shards]
    assert sorted(buckets) == [2, 3]
    shards.clear()
    assert_same(_port_grid(case, devices=2), base)
    assert [n for n, _ in shards] == [
        len(c) for k in buckets for c in np.array_split(np.arange(k), 2)]
    assert all(d.type == "cpu" for _, d in shards)
    tplat, tinsts, trows = case[3:]
    one = [flatten(schedule_portfolio_grid(
        tinsts[:1], trows[:1], tplat, variants=VARIANTS, engine="torch",
        device="cpu", devices=n)) for n in (None, 8)]
    assert_same(one[1], one[0])
    assert [n for n, _ in shards[-2:]] == [1, 1]


def test_blocked_rows_stay_unsplit(case, host_devices):
    """Instances past the dense envelope stream through BlockedLP on the
    first device; the split of the dense rest changes nothing."""
    tplat, tinsts, trows = case[3:]
    budget = greedy_torch.lp_matrix_bytes(
        max(x.num_tasks for x in tinsts)) - 1
    kw = dict(variants=VARIANTS, engine="torch", device="cpu",
              lp_budget_bytes=budget)
    base = flatten(schedule_portfolio_grid(tinsts, trows, tplat, **kw))
    assert_same(base, _port_grid(case))
    shard = flatten(schedule_portfolio_grid(tinsts, trows, tplat,
                                            devices=8, **kw))
    assert_same(shard, base)


def test_planner_devices_knob_bitwise(case, host_devices):
    tplat, tinsts, trows = case[3:]
    req = PlanRequest(instances=tinsts, profiles=trows, variants=VARIANTS)
    res1 = Planner(tplat, engine="torch", device="cpu").plan(req)
    res8 = Planner(tplat, engine="torch", device="cpu",
                   devices=8).plan(req)
    assert np.array_equal(res1.costs, res8.costs)
    assert_same(flatten(res1.results), flatten(res8.results))


def test_request_devices_overrides_planner(case, host_devices, monkeypatch):
    tplat, tinsts, trows = case[3:]
    planner = Planner(tplat, engine="torch", device="cpu", devices=2)
    assert planner.clone().devices == 2           # clone carries the knob
    assert planner.clone(engine="numpy").devices == 2
    asked = []
    real = ctx.grid_mesh

    def spy(devices=None, device=None):
        asked.append(devices)
        return real(devices, device)

    monkeypatch.setattr(ctx, "grid_mesh", spy)
    res = planner.plan(PlanRequest(instances=tinsts, profiles=trows,
                                   variants=VARIANTS, devices=8))
    assert asked == [8]
    planner.plan(PlanRequest(instances=tinsts, profiles=trows,
                             variants=VARIANTS))
    assert asked == [8, 2]
    base = Planner(tplat, engine="torch", device="cpu").plan(
        instances=tinsts, profiles=trows, variants=VARIANTS)
    assert np.array_equal(res.costs, base.costs)


@pytest.mark.parametrize("bad", [0, 2.5, True])
def test_devices_validation(case, host_devices, bad):
    tplat, tinsts, trows = case[3:]
    with pytest.raises(ValueError, match="devices"):
        PlanRequest(instances=tinsts, profiles=trows, variants=VARIANTS,
                    devices=bad).resolve()
    with pytest.raises(ValueError, match="devices"):
        Planner(tplat, device="cpu", devices=bad)


def test_devices_above_visible_raise(case, host_devices):
    tplat, tinsts, trows = case[3:]
    over = host_devices + 1
    with pytest.raises(ValueError, match=f"devices={over} out of range"):
        Planner(tplat, device="cpu", devices=over)
    with pytest.raises(ValueError, match=f"devices={over} out of range"):
        Planner(tplat, engine="torch", device="cpu").plan(
            instances=tinsts, profiles=trows, variants=VARIANTS,
            devices=over)
    with pytest.raises(ValueError, match=f"devices={over} out of range"):
        _port_grid(case, devices=over)


def _search_request(case, **kw):
    tplat = case[3]
    wf = interop.port(make_workflow("eager", 2, seed=0))
    return wf, PlanRequest(instances=wf, profiles=case[5][0],
                           variants=VARIANTS, mapping="search",
                           mapping_options={"seeds": 4, "rounds": 2,
                                            "neighbors": 6}, **kw)


def test_mapping_search_devices_bitwise(case, host_devices, monkeypatch):
    """search_mapping / resolve_mappings at devices=2 == None: the winner,
    the search's candidates and costs, and the winner's plan."""
    from repro_torch.mapping import search

    tplat = case[3]
    _, req = _search_request(case)
    planner = Planner(tplat, engine="torch", device="cpu")
    base = planner.plan(req)
    seen = []
    real = search._Evaluator.__init__

    def spy(self, *a, devices=None, **kw):
        seen.append(devices)
        real(self, *a, devices=devices, **kw)

    monkeypatch.setattr(search._Evaluator, "__init__", spy)
    _, req2 = _search_request(case, devices=2)
    got = planner.plan(req2)
    assert seen == [2]
    assert np.array_equal(base.costs, got.costs)
    assert_same(flatten(base.results), flatten(got.results))
    a, b = base.mapping_info[0], got.mapping_info[0]
    assert (a.label, a.candidate_labels, a.candidate_costs, a.trace) == \
        (b.label, b.candidate_labels, b.candidate_costs, b.trace)
    assert np.array_equal(base.mappings[0].proc, got.mappings[0].proc)


def test_service_ticket_devices_bitwise(case, host_devices):
    """A PlanService ticket over Planner(devices=2): its rung planners
    keep the base planner's devices, and the plan equals devices=None."""
    tplat, tinsts, trows = case[3:]
    req = PlanRequest(instances=tinsts, profiles=trows, variants=VARIANTS)
    base = Planner(tplat, engine="torch", device="cpu").plan(req)
    planner = Planner(tplat, engine="torch", device="cpu", devices=2)
    with PlanService(planner, compilation_cache=False) as svc:
        res = svc.plan(req)
        assert all(p.devices == 2 for p in svc._planners.values())
        assert svc._planners
    assert not res.degraded
    assert np.array_equal(base.costs, res.costs)
    assert_same(flatten(base.results), flatten(res.results))


def test_common_bucket_rows_match_own_buckets(case, host_devices):
    """``bucket_row(..., Np=)`` pads every instance into one larger bucket
    (the smoke script's split input): its greedy starts, unsplit and over
    2 shards, equal each instance's run in its own bucket, and the split
    run gathers them on the mesh's first device. A bucket smaller than the
    instance raises."""
    import torch

    from repro_torch.core.portfolio import (_needed_combos, bucket_row,
                                            overlay_profile)

    tplat, tinsts, trows = case[3:]
    need = _needed_combos(VARIANTS)
    rvals = tuple(sorted({r for (_, _, r) in need}))
    planner = Planner(tplat, engine="torch", device="cpu")
    graphs = [planner.prepared(x, ps[0].T) for x, ps in zip(tinsts, trows)]
    ovs = [[overlay_profile(g, p, refined_values=rvals) for p in ps]
           for g, ps in zip(graphs, trows)]
    dims = [greedy_torch.pad_dims(x.num_tasks, g.T)
            for x, g in zip(tinsts, graphs)]
    Np = max(n for n, _ in dims) + greedy_torch.N_BUCKET
    Tp = max(t for _, t in dims)
    rows = [bucket_row(g, o, need, Tp, "cpu", Np=Np)
            for g, o in zip(graphs, ovs)]
    mesh = ctx.grid_mesh(2, device="cpu")
    whole = greedy_torch.greedy_fanout_grid_torch(rows, device="cpu")
    split = greedy_torch.greedy_fanout_grid_torch(rows, mesh=mesh)
    assert split.device == mesh.devices.flat[0]
    assert torch.equal(whole, split)
    for i, (g, o, (_, t)) in enumerate(zip(graphs, ovs, dims)):
        N = tinsts[i].num_tasks
        own = greedy_torch.greedy_fanout_grid_torch(
            [bucket_row(g, o, need, t, "cpu")], device="cpu")[0]
        assert torch.equal(whole[i, ..., :N], own[..., :N]), i
    with pytest.raises(ValueError, match="cannot hold"):
        bucket_row(graphs[0], ovs[0], need, Tp, "cpu",
                   Np=tinsts[0].num_tasks - 1)


def test_visible_devices_start_at_callers_card(monkeypatch):
    """On a (faked) 4-card host, the mesh of a caller on ``cuda:1`` starts
    at ``cuda:1`` and wraps round, so a split run gathers on the caller's
    card; asking for more cards than are visible still raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert ctx.visible_devices("cuda:1") == cuda[1:] + cuda[:1]
    assert ctx.visible_devices("cuda") == cuda[2:] + cuda[:2]
    assert list(ctx.grid_mesh(2, "cuda:1").devices.flat) == cuda[1:3]
    assert list(ctx.grid_mesh(device="cuda:3").devices.flat) == \
        cuda[3:] + cuda[:3]
    with pytest.raises(ValueError, match="devices=5 out of range"):
        ctx.grid_mesh(5, "cuda:1")
