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


def _bounds_edges(t=300, seed=12):
    """Windows the kernel's index rule must clamp or drop: starts at -inf
    and exactly at T, ends at +inf, at 1e30 and before their starts, NaN
    starts and ends; integer works."""
    starts, ends, works, g = _rand(40, t, seed)
    starts[0], starts[1], starts[2] = -np.inf, float(t), np.nan
    ends[3], ends[4], ends[5] = np.inf, 1e30, np.nan
    starts[6], ends[6] = 50.0, 20.0                     # ends before start
    starts[7], ends[7] = -np.inf, np.inf                # the whole horizon
    starts[8], ends[8] = -1e30, 3.5
    return starts, ends, works, g


def _nonfinite_works(kind, t=300, seed=13):
    """One non-finite work among finite ones: +inf active on part of the
    horizon (+inf there, NaN elsewhere: inf * 0), +inf and -inf overlapping
    (NaN where both are active), +inf never active (NaN everywhere), a NaN
    work (NaN everywhere)."""
    starts, ends, works, g = _rand(30, t, seed)
    if kind == "inf_partial":
        starts[0], ends[0], works[0] = 40.0, 90.0, np.inf
    elif kind == "inf_both_signs":
        starts[0], ends[0], works[0] = 40.0, 90.0, np.inf
        starts[1], ends[1], works[1] = 70.0, 120.0, -np.inf
    elif kind == "inf_inactive":
        starts[0], ends[0], works[0] = np.nan, 90.0, np.inf
    else:
        works[0] = np.nan
    return starts, ends, works, g


def _emulate_kernel(starts, ends, works, g, tile=tc.KERNEL_TILE):
    """csrc/carbon_cost.cu's arithmetic in torch: per tile of ``tile``
    units, both ends as ceil() clamped to the tile in float, an f64
    difference array (a window open at the tile's first unit lands on index
    0: the carry-in), a scan, one rounding to f32, then max(acc - g, 0).
    Infinite works are counted per unit instead (NaN where fewer of them
    are active than exist); a NaN work makes every unit NaN."""
    s, e, w, g = (torch.as_tensor(a, dtype=torch.float32)
                  for a in (starts, ends, works, g))
    T = g.shape[0]
    inf = torch.isinf(w)
    live = (w != 0) & ~torch.isnan(w) & ~torch.isnan(s) & ~torch.isnan(e)
    out = torch.empty(T, dtype=torch.float32)
    for t0 in range(0, T, tile):
        t1 = min(t0 + tile, T)
        lo = torch.clamp(torch.ceil(s), t0, t1)
        hi = torch.clamp(torch.ceil(e), t0, t1)
        on = live & (lo < hi)
        a, b = lo.long() - t0, hi.long() - t0       # b == t1 - t0: dropped
        diff = torch.zeros(t1 - t0 + 1, dtype=torch.float64)
        fin = on & ~inf
        diff.index_add_(0, a[fin], w[fin].double())
        diff.index_add_(0, b[fin], -w[fin].double())
        acc = torch.cumsum(diff[:-1], 0).to(torch.float32)
        n_active = 0
        for sign in (1, -1):
            cnt = torch.zeros(t1 - t0 + 1, dtype=torch.int64)
            mine = on & inf & (torch.sign(w) == sign)
            cnt.index_add_(0, a[mine], torch.ones_like(a[mine]))
            cnt.index_add_(0, b[mine], -torch.ones_like(b[mine]))
            active = torch.cumsum(cnt[:-1], 0)
            acc = torch.where(active > 0, acc + sign * float("inf"), acc)
            n_active = n_active + active
        acc = torch.where(n_active < int(inf.sum()), float("nan"), acc)
        if bool(torch.isnan(w).any()):
            acc = torch.full_like(acc, float("nan"))
        d = acc - g[t0:t1]
        out[t0:t1] = torch.where(d < 0, torch.zeros_like(d), d)
    return out.numpy()


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


@pytest.mark.parametrize("n,t", SWEEP)
def test_kernel_emulation_matches_interpreter_and_dense_on_sweep(n, t):
    args = _rand(n, t, seed=n * 1000 + t)
    got = _emulate_kernel(*args)
    want = np.asarray(r_timeline(*map(jnp.asarray, args), interpret=True))
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(r_ref(*map(jnp.asarray, args))))


EMULATION_EDGES = {
    "edges": lambda: _edges(),
    "bounds": lambda: _bounds_edges(),
    "multi_tile": lambda: _rand(700, 2 * tc.KERNEL_TILE + 300, seed=4),
}


@pytest.mark.parametrize("tile", [tc.KERNEL_TILE, 64])
@pytest.mark.parametrize("case", sorted(EMULATION_EDGES))
def test_kernel_emulation_matches_interpreter_and_dense_on_edges(case, tile):
    """The index rule, the clamps and the carry-in across tiles, bitwise."""
    args = EMULATION_EDGES[case]()
    got = _emulate_kernel(*args, tile=tile)
    interp = np.asarray(r_timeline(*map(jnp.asarray, args), interpret=True))
    dense = np.asarray(r_ref(*map(jnp.asarray, args)))
    assert np.array_equal(got, interp)
    assert np.array_equal(got, dense)
    assert np.isfinite(got).all() and (got > 0).any() and (got == 0).any()


@pytest.mark.parametrize("tile", [tc.KERNEL_TILE, 64])
@pytest.mark.parametrize("kind", ["inf_partial", "inf_both_signs",
                                  "inf_inactive", "nan_work"])
def test_kernel_emulation_nonfinite_works_follow_dense_form(kind, tile):
    """w * [active] is NaN where an infinite work is inactive: the dense
    oracles (repro's jnp form and the port's plain version) and the kernel
    agree bitwise, NaN for NaN. The Pallas interpreter is no oracle here:
    XLA turns w * [active] into a select, so its inactive infinite and NaN
    works add 0."""
    args = _nonfinite_works(kind)
    got = _emulate_kernel(*args, tile=tile)
    dense = np.asarray(r_ref(*map(jnp.asarray, args)))
    assert np.array_equal(got, dense, equal_nan=True)
    assert np.array_equal(got, _port(args), equal_nan=True)
    if kind == "inf_partial":         # +inf where active, NaN elsewhere
        assert np.isposinf(got[40:90]).all()
        assert np.isnan(got[:40]).all() and np.isnan(got[90:]).all()
    else:
        assert np.isnan(got).all()


def test_kernel_emulation_fractional_works_within_reorder_bound():
    args = _edges(frac_work=True)
    want = np.asarray(r_ref(*map(jnp.asarray, args)))
    n = len(args[2])
    atol = 2 * (n - 1) * 2.0 ** -24 * float(np.abs(args[2]).sum())
    for tile in (tc.KERNEL_TILE, 64):
        np.testing.assert_allclose(_emulate_kernel(*args, tile=tile), want,
                                   rtol=0, atol=atol)


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
    the sweep, at the plan's shape, at N=30000, T=4096, at a T of several
    tiles and on the edge cases (NaN where the plain version is NaN); within
    the reorder bound with fractional works."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    dev = torch.device("cuda")
    cases = [_rand(n, t, seed=n * 1000 + t) for n, t in SWEEP]
    cases += [_rand(4304, 776, seed=1), _rand(30000, 4096, seed=2),
              _rand(700, 2 * tc.KERNEL_TILE + 300, seed=4), _edges(),
              _bounds_edges()]
    cases += [_nonfinite_works(k) for k in ("inf_partial", "inf_both_signs",
                                            "inf_inactive", "nan_work")]
    for args in cases:
        x = [torch.as_tensor(a, device=dev) for a in args]
        launches = tc.LAUNCHES
        got = tc.deficit_timeline(*x)
        assert tc.LAUNCHES == launches + 1
        want = tc.deficit_timeline(*x, mode="plain")
        torch.cuda.synchronize()
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.nan_to_num(), want.nan_to_num())
        assert np.array_equal(got.cpu().numpy(), _port(args), equal_nan=True)
    args = _edges(frac_work=True)
    x = [torch.as_tensor(a, device=dev) for a in args]
    n = len(args[2])
    atol = 2 * (n - 1) * 2.0 ** -24 * float(np.abs(args[2]).sum())
    torch.testing.assert_close(tc.deficit_timeline(*x),
                               tc.deficit_timeline(*x, mode="plain"),
                               rtol=0, atol=atol)


@pytest.mark.cuda
def test_cuda_carbon_cost_of_host_arrays_equals_int64_cost():
    """ops.carbon_cost on numpy input (one packed copy to the card, ends
    formed in the kernel): one launch, and the int64 cost exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    from repro_torch.cluster import make_cluster
    from repro_torch.core import (asap_schedule, build_instance,
                                  deadline_from_asap, generate_profile,
                                  heft_mapping, schedule_cost)
    from repro_torch.workflows import make_workflow

    plat = make_cluster(1, seed=2)
    wf = make_workflow("eager", 5, seed=4)
    inst = build_instance(wf, heft_mapping(wf, plat), plat)
    T = deadline_from_asap(inst, 1.4)
    prof = generate_profile("S3", T, plat, J=12, seed=3)
    g = prof.unit_budget(inst.idle_total)
    rng = np.random.default_rng(0)
    for start in (asap_schedule(inst),
                  asap_schedule(inst) + rng.integers(-3, 6, inst.num_tasks)):
        launches = tc.LAUNCHES
        got = t_carbon_cost(start, inst.dur, inst.task_work, g)
        assert tc.LAUNCHES == launches + 1
        assert got.device.type == "cuda" and got.dtype == torch.float32
        want = t_carbon_cost(start, inst.dur, inst.task_work, g,
                             device="cpu")
        assert float(got) == float(want)
        if (start >= 0).all():
            assert float(got) == schedule_cost(inst, prof, start)
    # the ends are f32 adds, as the reference forms them
    got = t_carbon_cost(np.array([2.0 ** 24], np.float32),
                        np.array([1], np.int64), np.array([5.0], np.float32),
                        np.zeros(4, np.float32))
    assert float(got) == 0.0


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
