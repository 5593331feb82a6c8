"""Port parity, observability: repro_torch's ``obs`` (tracer, metrics
registry, Prometheus text, torch hooks) on the cases of
``tests/test_obs.py`` that need no ``PlanService``, and the metrics and
spans the port's plan paths emit against repro's.

The parity test runs the same heuristic plan (repro's jax engine on the
CPU, the port's torch engine on the CPU), the same exact solve and the
same rolling-horizon session through both packages, each with a fresh
registry and tracer. Counter names, label sets and values are equal, and
so are histogram counts and sums, span names and the span tree's shape.
The exceptions, listed in ``_EXCEPT``:

* histograms of seconds (``planner_plan_seconds``,
  ``cancel_observe_latency_seconds``): wall time differs by machine;
* ``jax_jit_cache_misses_total`` <-> ``torch_bucket_misses_total``, the
  one renamed family: jax counts compiled signatures, the port counts
  first runs of a padded (Npad, Tp) bucket in the process, so the values
  depend on what ran earlier in the process;
* the label value ``engine="jax"`` reads ``engine="torch"`` in the port.
"""
import json
import re
import threading

import numpy as np
import pytest
import torch

from repro import obs as robs
from repro.api import Planner as RPlanner
from repro.api import PlanRequest as RRequest
from repro.api import window_profile as r_window_profile
from repro.cluster import make_cluster
from repro.core import (build_instance, deadline_from_asap, generate_profile,
                        heft_mapping)
from repro.core import solvers as r_solvers
from repro.api import session as r_session
from repro.core.carbon import PowerProfile
from repro.core.dag import trivial_mapping
from repro.workflows import layered_random, make_workflow
from repro_torch import interop, obs
from repro_torch.api import Planner, PlanRequest
from repro_torch.api import session as t_session
from repro_torch.core import solvers as t_solvers
from repro_torch.core.cancel import Cancelled, CancelToken
from repro_torch.kernels import _build
from repro_torch.obs import torch_hooks

_EXCEPT = {
    "skip": {"planner_plan_seconds", "cancel_observe_latency_seconds",
             "jax_jit_cache_misses_total", "torch_bucket_misses_total"},
    "label_values": {"jax": "torch"},
}


def _setup(kind="eager", samples=3, seed=3, factor=1.5, scenario="S3"):
    """tests/test_obs.py's instance, ported."""
    plat = make_cluster(1, seed=seed)
    wf = make_workflow(kind, samples, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, factor)
    prof = generate_profile(scenario, T, plat, J=16, seed=seed)
    return interop.port(plat), interop.port(inst), interop.port(prof)


@pytest.fixture
def traced():
    """A fresh process tracer of the port; fails the test if any span
    leaks open."""
    prev = obs.set_tracer(obs.Tracer())
    tr = obs.tracer()
    try:
        yield tr
        leaked = tr.open_spans()
        assert not leaked, f"leaked open spans: {leaked}"
    finally:
        obs.set_tracer(prev)


# --- tracer primitives -----------------------------------------------------

def test_span_nesting_and_idempotent_end(traced):
    with traced.span("root") as root:
        with traced.span("child", k=1) as child:
            assert child.parent_id == root.span_id
            assert child.trace_id == root.trace_id
    child.end()                                # second end: no-op
    assert len(traced.finished()) == 2
    tree = traced.tree(root.trace_id)
    assert [n["name"] for n in tree] == ["root"]
    assert [n["name"] for n in tree[0]["children"]] == ["child"]


def test_span_records_exception_as_error_attr(traced):
    with pytest.raises(ValueError):
        with traced.span("boom"):
            raise ValueError("x")
    (sp,) = traced.finished()
    assert sp.attrs["error"] == "ValueError"


def test_attach_reanchors_worker_thread(traced):
    with traced.span("parent") as parent:
        seen = {}

        def worker():
            with traced.attach(parent):
                with traced.span("inner") as sp:
                    seen["parent_id"] = sp.parent_id

        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert seen["parent_id"] == parent.span_id


def test_disabled_tracing_returns_null_span():
    prev = obs.set_tracer(None)
    try:
        sp = obs.span("anything", k=1)
        assert sp is obs.NULL_SPAN and not sp
        with sp:
            sp.set(x=2).end()
        assert obs.current_span() is None
        assert obs.start_span("x") is obs.NULL_SPAN
    finally:
        obs.set_tracer(prev)


def test_jsonl_export_loads_line_by_line(traced, tmp_path):
    plat, inst, prof = _setup()
    Planner(plat, engine="numpy", device="cpu").plan(
        PlanRequest(instances=inst, profiles=prof))
    path = tmp_path / "trace.jsonl"
    n = traced.dump_jsonl(str(path))
    lines = path.read_text().strip().split("\n")
    assert len(lines) == n > 0
    events = [json.loads(line) for line in lines]   # every line parses
    for ev in events:
        assert ev["ph"] == "X" and ev["cat"] == "repro_torch"
        assert ev["ts"] >= 0 and ev["dur"] >= 0
        assert "span_id" in ev["args"]
    names = {ev["name"] for ev in events}
    assert {"plan", "prepare_graph", "greedy_numpy"} <= names


# --- metrics -----------------------------------------------------------------

def test_metric_type_and_label_safety():
    reg = obs.MetricsRegistry()
    c = reg.counter("x_total", labels=("a",))
    with pytest.raises(ValueError):
        c.inc(-1, a="v")
    with pytest.raises(ValueError):
        c.inc(a="v", b="w")
    with pytest.raises(TypeError):
        reg.gauge("x_total")
    with pytest.raises(ValueError):
        reg.counter("x_total", labels=("other",))
    g = reg.gauge("depth")
    g.set_max(5)
    g.set_max(3)
    assert g.value() == 5


_SAMPLE_RE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+="[^"]*"'
    r'(,[a-zA-Z0-9_]+="[^"]*")*\})? [^ ]+$')


def test_prometheus_text_from_the_registry():
    plat, inst, prof = _setup()
    prev = obs.set_registry(obs.MetricsRegistry())
    try:
        Planner(plat, engine="torch", device="cpu").plan(
            PlanRequest(instances=inst, profiles=[prof, prof]))
        text = obs.render_prometheus(obs.registry())
    finally:
        obs.set_registry(prev)
    typed = set()
    for line in text.strip().split("\n"):
        if line.startswith("# TYPE "):
            name, kind = line.split()[2:4]
            assert kind in ("counter", "gauge", "histogram")
            typed.add(name)
        elif not line.startswith("#"):
            assert _SAMPLE_RE.match(line), line
            metric = line.split("{")[0].split(" ")[0]
            base = re.sub(r"_(bucket|sum|count)$", "", metric)
            assert metric in typed or base in typed, line
    assert {"planner_plans_total", "planner_plan_seconds",
            "portfolio_cells_total", "ls_device_rounds",
            "ls_polish_rounds_total"} <= typed
    hist = [line for line in text.split("\n")
            if line.startswith("planner_plan_seconds")]
    buckets = [float(line.split()[-1]) for line in hist
               if "_bucket" in line]
    assert buckets == sorted(buckets)
    count = next(float(line.split()[-1]) for line in hist
                 if line.startswith("planner_plan_seconds_count"))
    inf = next(float(line.split()[-1]) for line in hist
               if 'le="+Inf"' in line)
    assert inf == count == 1


def test_cancel_latency_histogram_observes():
    hist = obs.registry().get("cancel_observe_latency_seconds")
    before = hist.count()
    token = CancelToken()
    token.cancel("test")
    with pytest.raises(Cancelled):
        token.check()
    with pytest.raises(Cancelled):
        token.check()                   # latency recorded exactly once
    assert hist.count() == before + 1


def test_planner_metrics_count_plans_and_cache_hits():
    plat, inst, prof = _setup()
    reg = obs.registry()
    plans = reg.counter("planner_plans_total",
                        labels=("solver", "engine"))
    cache = reg.counter("planner_graph_cache_total", labels=("outcome",))
    p0 = plans.value(solver="heuristic", engine="numpy")
    h0, m0 = cache.value(outcome="hit"), cache.value(outcome="miss")
    planner = Planner(plat, engine="numpy", device="cpu")
    planner.plan(PlanRequest(instances=inst, profiles=prof))
    planner.plan(PlanRequest(instances=inst, profiles=prof))
    assert plans.value(solver="heuristic", engine="numpy") == p0 + 2
    assert cache.value(outcome="miss") == m0 + 1      # first prepare
    assert cache.value(outcome="hit") >= h0 + 1       # second reuses


def test_torch_hooks_snapshot_shape():
    reg = obs.MetricsRegistry()
    assert torch_hooks.install(reg)
    assert torch_hooks.install(reg)            # idempotent
    assert torch_hooks.installed()
    plat, inst, prof = _setup()
    Planner(plat, engine="torch", device="cpu").plan(
        PlanRequest(instances=inst, profiles=[prof, prof]))
    recorded = torch_hooks.update_device_gauges(reg)
    if not torch.cuda.is_available():          # nothing on a CPU-only host
        assert not any(k[0].isdigit() for k in recorded)
        assert reg.get("torch_device_memory_bytes") is None
    snap = torch_hooks.snapshot(reg)
    assert set(snap) >= {"hooks_installed", "compile_events",
                         "compile_seconds", "bucket_cache_entries",
                         "device_memory"}
    assert snap["hooks_installed"] is True
    entries = snap["bucket_cache_entries"]
    assert isinstance(entries, dict) and entries["greedy.buckets"] >= 1
    assert entries["kernels.loaded"] == len(_build._LIBS)
    # an nvcc build reaches the installed registry through _build's
    # listener (the first registry installed wins, as in the reference)
    target = torch_hooks._installed_registry
    before = target.value("torch_kernel_builds_total", kernel="gain_scan")
    for fn in list(_build._BUILD_LISTENERS):
        fn("gain_scan", 0.25)
    assert target.value("torch_kernel_builds_total",
                        kernel="gain_scan") == before + 1
    assert torch_hooks.snapshot(target)["compile_events"] >= 1


def test_configure_installs_tracer_and_hooks():
    prev_t = obs.tracer()
    try:
        tr, reg = obs.configure(tracing=True, torch_hooks_on=True,
                                max_finished=16)
        assert obs.tracer() is tr and reg is obs.registry()
        assert torch_hooks.installed()
        tr2, _ = obs.configure(tracing=False)
        assert tr2 is None and obs.tracer() is None
    finally:
        obs.set_tracer(prev_t)


def test_bucket_launch_counts_first_runs_only():
    """A new (Npad, Tp) bucket counts one miss; running it again adds
    none (the torch counterpart of jax_jit_cache_misses_total)."""
    from repro_torch.core.portfolio import bucket_entries_total

    plat, inst, prof = _setup(kind="methylseq", samples=5, seed=11)
    prev = obs.set_registry(obs.MetricsRegistry())
    prev_t = obs.set_tracer(obs.Tracer())
    try:
        planner = Planner(plat, engine="torch", device="cpu")
        n0 = bucket_entries_total()
        planner.plan(PlanRequest(instances=inst, profiles=[prof, prof]))
        first = obs.registry().value("torch_bucket_misses_total",
                                     default=0.0, bucket=_bucket(inst, prof))
        planner.plan(PlanRequest(instances=inst, profiles=[prof, prof]))
        again = obs.registry().value("torch_bucket_misses_total",
                                     default=0.0, bucket=_bucket(inst, prof))
        spans = [s for s in obs.tracer().finished()
                 if s.name == "bucket_launch"]
    finally:
        obs.set_registry(prev)
        obs.set_tracer(prev_t)
    assert first == bucket_entries_total() - n0 <= 1
    assert again == first
    assert [s.attrs["cache_misses"] for s in spans] == [first, 0]


def _bucket(inst, prof):
    from repro_torch.core.greedy_torch import pad_dims

    Npad, Tp = pad_dims(inst.num_tasks, prof.T)
    return f"{Npad}x{Tp}"


# --- parity with repro -------------------------------------------------------

def _tight_profile(inst, plat, T, J=4, seed=0):
    """tests/test_solvers.py's budget (tests/test_torch_solvers.py)."""
    rng = np.random.default_rng(seed)
    bounds = np.unique(np.round(np.linspace(0, T, J + 1)).astype(np.int64))
    budget = plat.idle_total + rng.integers(
        0, max(int(inst.task_work.max()) // 2, 2), size=len(bounds) - 1)
    return PowerProfile(bounds=bounds, budget=budget)


def _parity_inputs():
    plat = make_cluster(1, seed=0)
    insts, grid = [], []
    for j, kind in enumerate(("bacass", "methylseq")):
        wf = make_workflow(kind, 3, seed=j)
        inst = build_instance(wf, heft_mapping(wf, plat), plat)
        T = deadline_from_asap(inst, 2.0)
        insts.append(inst)
        grid.append([generate_profile(s, T, plat, J=12, seed=j + i)
                     for i, s in enumerate(("S1", "S4"))])
    rng = np.random.default_rng(0)
    wf = layered_random(6, 3, seed=0)
    exact = build_instance(wf, trivial_mapping(wf, plat), plat,
                           dur=rng.integers(1, 6, size=wf.n))
    exact_prof = _tight_profile(exact, plat,
                                deadline_from_asap(exact, 1.5))
    W = deadline_from_asap(insts[0], 1.6)
    long = generate_profile("S3", 2 * W, plat, J=32, seed=7)
    windows = [[r_window_profile(long, k * W, W)] for k in range(2)]
    return plat, insts, grid, exact, exact_prof, windows


def _drive(pkg_obs, planner_cls, request_cls, port, heur_engine, inputs):
    """The plan, the exact solve and the session, with a fresh registry
    and tracer; returns (registry, tracer)."""
    plat, insts, grid, exact, exact_prof, windows = inputs
    prev_r = pkg_obs.set_registry(pkg_obs.MetricsRegistry())
    prev_t = pkg_obs.set_tracer(pkg_obs.Tracer())
    kw = {} if heur_engine == "jax" else {"device": "cpu"}
    try:
        planner = planner_cls(port(plat), engine=heur_engine, **kw)
        planner.plan(request_cls(
            instances=[port(i) for i in insts],
            profiles=[[port(p) for p in ps] for ps in grid]))
        planner.plan(request_cls(instances=port(exact),
                                 profiles=port(exact_prof), solver="exact",
                                 solver_options={"time_limit": 60}))
        # lookahead=0: every window is submitted by its own plan_for, so
        # the fetch outcome is "waited" in both packages
        with planner.session(port(insts[0]),
                             [[port(p) for p in ws] for ws in windows],
                             lookahead=0) as sess:
            for k in range(len(windows)):
                sess.plan_for(k)
        return pkg_obs.registry(), pkg_obs.tracer()
    finally:
        pkg_obs.set_registry(prev_r)
        pkg_obs.set_tracer(prev_t)


def _metrics(reg) -> dict:
    """name -> {label key: value}, histograms as (count, sum), with the
    listed exceptions taken out and label values mapped."""
    out = {}
    for name, vals in reg.collect().items():
        if name in _EXCEPT["skip"]:
            continue
        out[name] = {tuple(_EXCEPT["label_values"].get(v, v) for v in key):
                     val for key, val in vals.items()}
    return out


def _module_metrics(solvers, session) -> dict:
    """The metrics both packages bind at import time to their then
    registry (they stay there when a test swaps the registry)."""
    return {"solver_cells_total": dict(solvers._CELLS.values()),
            "session_window_fetch_total": dict(
                session._WINDOW_FETCH.values())}


def _shape(nodes) -> list:
    return [(n["name"], _shape(n["children"])) for n in nodes]


def _delta(after: dict, before: dict) -> dict:
    """What this test added (label sets earlier tests of the process
    touched, and this test did not, drop out)."""
    out = {}
    for name, vals in after.items():
        d = {k: v - before.get(name, {}).get(k, 0) for k, v in vals.items()}
        out[name] = {k: v for k, v in d.items() if v}
    return out


def test_metrics_and_spans_match_reference():
    pytest.importorskip("scipy.optimize", reason="the exact solve needs "
                        "scipy's HiGHS")
    inputs = _parity_inputs()
    r_before = _module_metrics(r_solvers, r_session)
    r_reg, r_tr = _drive(robs, RPlanner, RRequest, lambda x: x, "jax",
                         inputs)
    r_mod = _delta(_module_metrics(r_solvers, r_session), r_before)
    t_before = _module_metrics(t_solvers, t_session)
    t_reg, t_tr = _drive(obs, Planner, PlanRequest, interop.port, "torch",
                         inputs)
    t_mod = _delta(_module_metrics(t_solvers, t_session), t_before)

    want, got = _metrics(r_reg), _metrics(t_reg)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    assert r_mod == t_mod
    assert t_mod["session_window_fetch_total"] == {("waited",): 2}
    assert sum(t_mod["solver_cells_total"].values()) == 1
    # the families the plan paths must have emitted
    assert {"planner_plans_total", "planner_graph_cache_total",
            "portfolio_cells_total", "ls_device_rounds",
            "ls_polish_rounds_total", "ilp_solves_total"} <= set(got)
    assert got["portfolio_cells_total"] == {("torch",): 4 + 2 * 1}

    want_tree, got_tree = _shape(r_tr.tree()), _shape(t_tr.tree())
    assert got_tree == want_tree
    names = {s.name for s in t_tr.finished()}
    assert {"plan", "prepare_graph", "bucket_launch", "ls_climb",
            "ls_device_climb", "ls_polish", "solve_cell", "ilp_build",
            "ilp_milp", "session_window"} <= names
    assert not t_tr.open_spans() and not r_tr.open_spans()
