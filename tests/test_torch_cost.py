"""Port parity, carbon-cost oracles: repro_torch's plain deficit_timeline
against repro's Pallas interpreter (interpret=True) and its dense jnp
oracle, ops.carbon_cost, schedule_cost_torch and est_lst_torch against
their jnp counterparts and the numpy oracles, bitwise except where a case
states its tolerance; and the hand-written CUDA kernel against the plain
version on the card."""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core.carbon import schedule_cost_torch
from repro_torch.core.estlst import est_lst_torch
from repro_torch.kernels import carbon_cost as tc
from repro_torch.kernels.ops import carbon_cost as t_carbon_cost
from repro_torch.kernels.ref import deficit_timeline_ref as t_ref

try:
    import jax.numpy as jnp

    from repro.cluster import make_cluster
    from repro.core import (asap_schedule, build_instance, compute_est,
                            compute_lst, deadline_from_asap,
                            generate_profile, heft_mapping, schedule_cost,
                            schedule_cost_jnp)
    from repro.core.carbon import cost_timeline
    from repro.core.estlst import est_lst_jnp
    from repro.kernels.carbon_cost import deficit_timeline as r_timeline
    from repro.kernels.ops import carbon_cost as r_carbon_cost
    from repro.kernels.ref import deficit_timeline_ref as r_ref
    from repro.workflows import make_workflow
except ImportError:
    # the GPU host has no JAX; there `-m cuda` selects only the kernel
    # tests below, which need neither jax nor repro
    jnp = None


def _rand(n, t, seed):
    """tests/test_kernels.py's input generator."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(t - 20, 1), n).astype(np.float32)
    durs = rng.integers(1, 20, n).astype(np.float32)
    works = rng.integers(0, 120, n).astype(np.float32)
    g = rng.integers(0, 2500, t).astype(np.float32)
    return starts, starts + durs, works, g


def _edges(t=300, seed=11, frac_work=False):
    """Fractional and negative starts, ends past the horizon, zero-length
    tasks and a budget that goes negative."""
    rng = np.random.default_rng(seed)
    n = 97
    starts = rng.integers(-40, t + 10, n).astype(np.float32)
    starts[::3] += rng.choice([0.25, 0.5, 0.75], len(starts[::3]))
    durs = rng.integers(0, 60, n).astype(np.float32)
    durs[1::5] += 0.5                       # fractional ends
    durs[2::7] = 0.0                        # zero-length tasks
    ends = starts + durs
    ends[4::9] = t + rng.integers(1, 50, len(ends[4::9]))  # past T
    works = rng.integers(0, 120, n).astype(np.float32)
    if frac_work:
        works = works + rng.random(n).astype(np.float32)
    g = rng.integers(-200, 1500, t).astype(np.float32)    # negative g too
    return starts, ends.astype(np.float32), works, g


def _port(args, mode=None):
    return tc.deficit_timeline(*map(torch.as_tensor, args),
                               mode=mode).numpy()


SWEEP = [(n, t) for n in (1, 7, 63, 300, 1000) for t in (16, 700, 2048)]


@pytest.mark.parametrize("n,t", SWEEP)
def test_deficit_timeline_matches_pallas_interpreter(n, t):
    args = _rand(n, t, seed=n * 1000 + t)
    got = _port(args)
    assert got.shape == (t,) and got.dtype == np.float32
    want = np.asarray(r_timeline(*map(jnp.asarray, args), interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("n,t", SWEEP)
def test_deficit_timeline_matches_dense_oracles(n, t):
    args = _rand(n, t, seed=n * 1000 + t)
    want = np.asarray(r_ref(*map(jnp.asarray, args)))
    assert np.array_equal(_port(args), want)
    assert np.array_equal(t_ref(*map(torch.as_tensor, args)).numpy(), want)


@pytest.mark.parametrize("oracle", ["interpret", "ref"])
def test_deficit_timeline_edge_cases_bitwise(oracle):
    args = _edges()
    got = _port(args)
    fn = (lambda *a: r_timeline(*a, interpret=True)) \
        if oracle == "interpret" else r_ref
    want = np.asarray(fn(*map(jnp.asarray, args)))
    # integer works: every partial sum is exact, so fractional windows
    # change only which units are active, never the arithmetic
    assert np.array_equal(got, want)
    assert (got > 0).any() and (got == 0).any()


def test_deficit_timeline_fractional_works_within_reorder_bound():
    args = _edges(frac_work=True)
    got = _port(args)
    want = np.asarray(r_ref(*map(jnp.asarray, args)))
    # fractional works make f32 sums depend on their order; two orders of
    # an n-term sum differ by at most 2 (n - 1) u sum|w| (u = 2^-24)
    n = len(args[2])
    atol = 2 * (n - 1) * 2.0 ** -24 * float(np.abs(args[2]).sum())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_plain_version_chunks_over_tasks(monkeypatch):
    args = _rand(300, 700, seed=3)
    whole = _port(args)
    monkeypatch.setattr(tc, "PLAIN_ELEMS", 700 * 7)     # 43 chunks of 7
    assert np.array_equal(_port(args), whole)


def test_carbon_cost_matches_reference_and_core_oracle():
    """tests/test_kernels.py::test_kernel_cost_matches_core_oracle's case."""
    plat = make_cluster(1, seed=2)
    wf = make_workflow("eager", 5, seed=4)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, 1.4)
    prof = generate_profile("S3", T, plat, J=12, seed=3)
    start = asap_schedule(inst)
    g = prof.unit_budget(inst.idle_total)
    want = schedule_cost(inst, prof, start)
    ref = np.asarray(r_carbon_cost(start, inst.dur, inst.task_work, g))
    got = t_carbon_cost(start, inst.dur, inst.task_work, g, device="cpu")
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.numpy() == ref
    assert float(got) == want       # below 2^24: exact


def test_carbon_cost_forms_ends_in_f32():
    # starts + durs is taken after the f32 cast: 2^24 + 1 rounds to 2^24,
    # so the task [2^24, 2^24) is empty, as in the reference
    starts = np.array([2.0 ** 24], np.float32)
    durs = np.array([1], np.int64)
    works = np.array([5.0], np.float32)
    g = np.zeros(4, np.float32)
    got = t_carbon_cost(starts, durs, works, g, device="cpu")
    ref = np.asarray(r_carbon_cost(starts, durs, works, g))
    assert got.numpy() == ref == 0.0


@pytest.mark.parametrize("scenario", ["S1", "S2", "S3", "S4"])
@pytest.mark.parametrize("seed", [0, 1])
def test_schedule_cost_torch_matches_jnp(scenario, seed):
    """tests/test_carbon_cost.py::test_oracles_agree's cases."""
    plat = make_cluster(1, seed=seed)
    wf = make_workflow("atacseq", 4, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, 1.3)
    prof = generate_profile(scenario, T, plat, J=16, seed=seed)
    starts = [asap_schedule(inst)]
    rng = np.random.default_rng(seed)
    # shifted schedules: clipped windows and duplicate breakpoints
    starts.append(starts[0] + rng.integers(-3, 6, inst.num_tasks))
    starts.append(np.full(inst.num_tasks, T // 2, np.int64))
    g = prof.effective(inst.idle_total)
    for start in starts:
        want = np.asarray(schedule_cost_jnp(start, inst.dur, inst.task_work,
                                            prof.bounds, g, T))
        got = schedule_cost_torch(start, inst.dur, inst.task_work,
                                  prof.bounds, g, T, device="cpu")
        assert got.dtype == torch.float32
        assert got.numpy() == want
        if (start >= 0).all():
            exact = schedule_cost(inst, prof, start)
            assert exact < 2 ** 24 and float(got) == exact
            assert cost_timeline(inst, prof, start) == exact


@pytest.mark.parametrize("kind,samples,seed", [("eager", 5, 3),
                                               ("atacseq", 4, 0),
                                               ("methylseq", 3, 7)])
def test_est_lst_torch_matches_jnp_and_numpy(kind, samples, seed):
    """tests/test_scheduling.py::test_est_lst_sanity's check, on three
    instances."""
    plat = make_cluster(1, seed=seed)
    wf = make_workflow(kind, samples, seed=seed)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, 1.5)
    ej, lj = est_lst_jnp(inst, T)
    est, lst = est_lst_torch(interop.port(inst), T, device="cpu")
    assert est.dtype == lst.dtype == torch.int32
    assert np.array_equal(est.numpy(), np.asarray(ej))
    assert np.array_equal(lst.numpy(), np.asarray(lj))
    assert np.array_equal(est.numpy(), compute_est(inst))
    assert np.array_equal(lst.numpy(), compute_lst(inst, T))


def test_kernel_wrapper_rejects_what_it_cannot_run():
    args = [torch.as_tensor(a) for a in _rand(5, 16, seed=0)]
    with pytest.raises(ValueError, match="CUDA"):
        tc.deficit_timeline(*args, mode="kernel")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        tc.deficit_timeline(*args, mode="fast")
    launches = tc.LAUNCHES
    tc.deficit_timeline(*args)                     # plain on the CPU
    assert tc.LAUNCHES == launches


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The sm_90a kernel against the plain version on the card: bitwise on
    the sweep, at the plan's shape and on the edge cases; within the
    reorder bound with fractional works."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    dev = torch.device("cuda")
    cases = [_rand(n, t, seed=n * 1000 + t) for n, t in SWEEP]
    cases += [_rand(4304, 776, seed=1), _edges()]
    for args in cases:
        x = [torch.as_tensor(a, device=dev) for a in args]
        launches = tc.LAUNCHES
        got = tc.deficit_timeline(*x)
        assert tc.LAUNCHES == launches + 1
        want = tc.deficit_timeline(*x, mode="plain")
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert np.array_equal(got.cpu().numpy(), _port(args))
    args = _edges(frac_work=True)
    x = [torch.as_tensor(a, device=dev) for a in args]
    n = len(args[2])
    atol = 2 * (n - 1) * 2.0 ** -24 * float(np.abs(args[2]).sum())
    torch.testing.assert_close(tc.deficit_timeline(*x),
                               tc.deficit_timeline(*x, mode="plain"),
                               rtol=0, atol=atol)


@pytest.mark.cuda
def test_cuda_launch_count_is_exact_across_threads():
    """A planning session launches kernels from its worker thread while the
    caller launches its own: no launch may go uncounted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    import sys
    import threading

    x = [torch.as_tensor(a, device="cuda") for a in _rand(63, 700, seed=5)]
    want = tc.deficit_timeline(*x, mode="plain")
    threads, calls, bad = 8, 200, []

    def work():
        for _ in range(calls):
            if not torch.equal(tc.deficit_timeline(*x), want):
                bad.append(1)

    launches = tc.LAUNCHES
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert not bad
    assert tc.LAUNCHES == launches + threads * calls
