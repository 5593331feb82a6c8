"""Port parity, the runtime: repro_torch's CarbonGate (make_plan and
replan_session) against repro's on the same chunks, ensemble and variant,
bitwise; StragglerMonitor, FailureInjector and run_with_restarts with the
port's CheckpointManager as in tests/test_substrates.py; checkpoints
written by either package load in the other. On the CPU."""
import json
import os

import numpy as np
import pytest
import torch

import repro.checkpoint as r_ckpt
from repro.api import window_profile as r_window_profile
from repro.core import generate_profile
from repro.runtime import FailureInjector as RFailureInjector
from repro.runtime import run_with_restarts as r_run_with_restarts
from repro.runtime.carbon_gate import CarbonGate as RGate
from repro.runtime.carbon_gate import chunk_workflow as r_chunk_workflow
from repro.runtime.carbon_gate import fleet_platform as r_fleet_platform
import repro_torch.checkpoint as t_ckpt
from repro_torch import interop
from repro_torch.api import window_profile
from repro_torch.checkpoint.ckpt import latest_checkpoint
from repro_torch.runtime import (CarbonGate, FailureInjector,
                                 StragglerMonitor, run_with_restarts)
from repro_torch.runtime.carbon_gate import chunk_workflow, fleet_platform
from repro_torch.runtime.fault import SimulatedFailure

CHUNKS = [[30] * 12, [30] * 12]      # tests/test_substrates.py's gate
HORIZON = 3 * 12 * 30


def _fleet():
    return r_fleet_platform(pods=2, chip_watts_idle=100,
                            chip_watts_work=250, chips_per_pod=4)


def test_fleet_platform_and_chunk_workflow_match_reference():
    want = _fleet()
    got = fleet_platform(pods=2, chip_watts_idle=100, chip_watts_work=250,
                         chips_per_pod=4)
    for f in ("speed", "p_idle", "p_work", "type_of"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    chunks = [[30, 20, 40], [10, 50]]
    rwf, rmap = r_chunk_workflow([3, 2], chunks, barriers=[0])
    wf, mp = chunk_workflow([3, 2], chunks, barriers=[0])
    for f in ("node_w", "edges", "edge_w"):
        assert np.array_equal(getattr(wf, f), getattr(rwf, f)), f
    assert np.array_equal(mp.proc, rmap.proc)
    assert mp.order == rmap.order and mp.comm_order == rmap.comm_order


GATES = {
    # tests/test_substrates.py's gate: nominal profile, one heuristic
    "nominal": dict(variant="pressWR-LS", members=()),
    # an ensemble at the same horizon with the robust pick
    "ensemble-auto": dict(variant="auto", members=(("S2", 1), ("S3", 2))),
    "ensemble-pinned": dict(variant="slackW-LS", members=(("S4", 3),)),
}


@pytest.mark.parametrize("case", sorted(GATES))
def test_carbon_gate_make_plan_matches_reference(case):
    spec = GATES[case]
    plat = _fleet()
    prof = generate_profile("S1", HORIZON, plat, J=24, seed=0)
    members = [generate_profile(s, HORIZON, plat, J=24, seed=seed)
               for s, seed in spec["members"]]
    ref_gate = RGate(prof, plat, variant=spec["variant"],
                     profiles=members or None)
    gate = CarbonGate(interop.port(prof), interop.port(plat),
                      variant=spec["variant"],
                      profiles=[interop.port(m) for m in members] or None,
                      device="cpu")
    assert gate.engine == ("torch" if members else "numpy")
    want = ref_gate.make_plan(CHUNKS, barriers=[5])
    got = gate.make_plan(CHUNKS, barriers=[5])
    assert np.array_equal(got.start, want.start)
    assert (got.cost, got.asap_cost, got.variant, got.robust_cost) == \
        (want.cost, want.asap_cost, want.variant, want.robust_cost)
    assert np.array_equal(got.cost_matrix, want.cost_matrix)
    assert got.variant_names == want.variant_names
    assert got.cost <= got.asap_cost
    for pod in range(2):
        chain = list(got.instance.proc_chains[pod])
        st, dur = got.start[chain], got.instance.dur[chain]
        assert ((st[1:] - (st[:-1] + dur[:-1])) >= 0).all()
        for k in range(len(chain)):
            assert gate.wait_time(pod, k, 0.0) == \
                ref_gate.wait_time(pod, k, 0.0)


def test_carbon_gate_replan_session_matches_reference():
    plat = _fleet()
    chunks = [[30] * 6, [30] * 6]
    W = 3 * 6 * 30
    prof = generate_profile("S1", W, plat, J=12, seed=0)
    long = generate_profile("S3", 3 * W, plat, J=36, seed=5)
    tlong = interop.port(long)
    ref_gate = RGate(prof, plat, variant="pressWR-LS")
    gate = CarbonGate(interop.port(prof), interop.port(plat),
                      variant="pressWR-LS", device="cpu")
    with ref_gate.replan_session(
            chunks, lambda k: r_window_profile(long, k * W, W),
            n_windows=3, barriers=[2], lookahead=0) as ref_sess, \
            gate.replan_session(
                chunks, lambda k: window_profile(tlong, k * W, W),
                n_windows=3, barriers=[2], lookahead=0) as sess:
        for k in range(3):
            want, got = ref_sess.plan_for(k), sess.plan_for(k)
            assert got.variants == want.variants
            assert np.array_equal(got.costs, want.costs)
            for n in want.variants:
                assert np.array_equal(got.results[0][0][n].start,
                                      want.results[0][0][n].start)


def test_straggler_monitor():
    mon = StragglerMonitor(n_pods=2, evict_after=3)
    for _ in range(20):
        assert mon.observe(0, 1.0).action == "ok"
        mon.observe(1, 1.0)
    acts = [mon.observe(1, 3.0).action for _ in range(4)]
    assert "rebalance" in acts
    assert acts[-1] == "evict"


def _toy_training(injector, mgr, total):
    """A deterministic toy trainer: step s adds a seeded vector to the
    state (the stream resumes exactly from any checkpoint)."""
    def step(state, s):
        delta = np.random.default_rng(s).standard_normal(4)
        return {"w": state["w"] + delta, "step": np.asarray(s)}

    def train(state, start, stop):
        for s in range(start, stop):
            if injector is not None:
                injector.maybe_fail(s)
            state = step(state, s)
            mgr.maybe_save(state, s)
        return state

    def init():
        return {"w": np.zeros(4), "step": np.asarray(-1)}

    ref = init()
    for s in range(total):
        ref = step(ref, s)
    return train, init, ref


@pytest.mark.parametrize("port", [False, True])
def test_fault_tolerant_training_resumes(tmp_path, port):
    """Injected failures + restart with each package's CheckpointManager:
    all steps complete, the final state equals an uninterrupted run, and
    the restart count is the reference's for the same seed."""
    ckpt, inj, run = (t_ckpt, FailureInjector, run_with_restarts) if port \
        else (r_ckpt, RFailureInjector, r_run_with_restarts)
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2, every=1)
    train, init, ref = _toy_training(inj(prob_per_step=0.35, seed=3), mgr,
                                     8)
    state, done, restarts = run(train, mgr, init, 8, max_restarts=50)
    assert done == 8 and restarts > 0
    np.testing.assert_array_equal(np.asarray(state["w"]), ref["w"])
    if port:
        rmgr = r_ckpt.CheckpointManager(str(tmp_path / "ref"), keep=2,
                                        every=1)
        rtrain, rinit, _ = _toy_training(
            RFailureInjector(prob_per_step=0.35, seed=3), rmgr, 8)
        assert r_run_with_restarts(rtrain, rmgr, rinit, 8,
                                   max_restarts=50)[2] == restarts


def test_failure_injector_raises_simulated_failure():
    inj = FailureInjector(prob_per_step=1.0, seed=0)
    with pytest.raises(SimulatedFailure, match="step 4"):
        inj.maybe_fail(4)
    FailureInjector(prob_per_step=0.0).maybe_fail(0)


def test_checkpoint_rotation(tmp_path):
    mgr = t_ckpt.CheckpointManager(str(tmp_path), keep=2, every=1)
    for s in range(5):
        mgr.maybe_save({"x": torch.zeros(3)}, s)
    cands = sorted(d for d in os.listdir(tmp_path) if d.startswith("ckpt_"))
    assert len(cands) == 2
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_00000004")


def _state():
    return {"params": {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                       "b": {"c": np.ones(4, dtype=np.int32)}},
            "opt": {"step": np.asarray(7)}}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_checkpoint_loads_in_the_other_package(tmp_path, writer):
    state = _state()
    if writer == "repro":
        path = r_ckpt.save_checkpoint(state, 7, str(tmp_path))
        load = t_ckpt.load_checkpoint
    else:
        # tensors go to the host; the files are the reference's
        path = t_ckpt.save_checkpoint(_as_torch(state), 7, str(tmp_path))
        load = r_ckpt.load_checkpoint
        twin = r_ckpt.save_checkpoint(state, 7, str(tmp_path / "ref"))
        with open(os.path.join(path, "manifest.json")) as f, \
                open(os.path.join(twin, "manifest.json")) as g:
            assert json.load(f) == json.load(g)
    assert os.path.basename(path) == "ckpt_00000007"
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    got, step = load(path, like=state)
    assert step == 7
    for keys in (("params", "a"), ("params", "b", "c"), ("opt", "step")):
        a, b = got, state
        for k in keys:
            a, b = a[k], b[k]
        assert a.dtype == b.dtype and np.array_equal(a, b), keys


def test_checkpoint_bf16_leaf_raises_naming_it(tmp_path):
    state = {"params": {"w": torch.zeros(2, dtype=torch.bfloat16)}}
    with pytest.raises(TypeError, match="params/w"):
        t_ckpt.save_checkpoint(state, 0, str(tmp_path))
