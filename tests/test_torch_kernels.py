"""Port parity, gain sweep: repro_torch's plain gain_scan against repro's
jnp twin (interpret=None) and Pallas interpreter (interpret=True), bitwise;
and the hand-written CUDA kernel against the plain version on the card."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gain_scan as tg
from repro_torch.kernels.ops import ls_gains, ls_gains_batched
from repro_torch.kernels.ref import gain_scan_ref as t_ref

try:
    import jax.numpy as jnp

    from repro.kernels import gain_scan as rg
    from repro.kernels.ref import gain_scan_ref as r_ref
except ImportError:
    # the GPU host has no JAX; there `-m cuda` selects only the kernel
    # test below, which needs neither jax nor repro
    jnp = rg = r_ref = None


def _rand(n, t, seed):
    """tests/test_kernels.py's input generator."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, max(t - 20, 1), n).astype(np.float32)
    durs = rng.integers(1, 20, n).astype(np.float32)
    works = rng.integers(0, 120, n).astype(np.float32)
    g = rng.integers(0, 2500, t).astype(np.float32)
    return starts, durs, works, g


def _sweep_case(n, t, mu):
    rng = np.random.default_rng(n + t + mu)
    starts, durs, works, g = _rand(n, t, seed=n + t)
    starts = np.minimum(starts, t - durs - 1)
    power = np.zeros(t, np.float32)
    for s, d, w in zip(starts.astype(int), durs.astype(int), works):
        power[s:s + d] += w
    rem = (g - power).astype(np.float32)
    lo = np.maximum(starts - rng.integers(0, 30, n), 0).astype(np.float32)
    hi = np.minimum(starts + rng.integers(0, 30, n),
                    t - durs).astype(np.float32)
    return rem, starts, durs, works, lo, hi


def _bit_case(n, t, mu, seed):
    """TestGainKernelBitIdentity._case's inputs, as numpy."""
    rng = np.random.default_rng(seed)
    rem = rng.integers(-9, 9, t).astype(np.float32)
    dur = rng.integers(1, 9, n).astype(np.float32)
    start = rng.integers(0, max(t - 10, 1), n).astype(np.float32)
    work = rng.integers(0, 7, n).astype(np.float32)
    lo = np.maximum(start - rng.integers(0, 2 * mu + 5, n), 0)
    hi = start + rng.integers(0, 2 * mu + 5, n)
    return rem, start, dur, work, lo.astype(np.float32), \
        hi.astype(np.float32)


def _jax(args, mu, interpret, batched=False):
    fn = rg.gain_scan_batched if batched else rg.gain_scan
    return np.asarray(fn(*map(jnp.asarray, args), mu=mu,
                         interpret=interpret))


def _port(args, mu, batched=False):
    fn = tg.gain_scan_batched if batched else tg.gain_scan
    return fn(*map(torch.as_tensor, args), mu=mu).numpy()


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("n,t,mu", [(1, 64, 1), (17, 300, 5), (120, 900, 10),
                                    (256, 512, 20), (300, 2048, 42)])
def test_gain_scan_sweep_bit_identical(n, t, mu, interpret):
    args = _sweep_case(n, t, mu)
    got = _port(args, mu)
    assert got.shape == (n, 2 * mu + 1) and got.dtype == np.float32
    assert np.array_equal(got, _jax(args, mu, interpret))


@pytest.mark.parametrize("mu", [1, 5, 10, 21, 42])
@pytest.mark.parametrize("n,t", [(1, 64), (63, 300), (257, 777)])
def test_gain_scan_bit_identity_across_mu(n, t, mu):
    args = _bit_case(n, t, mu, seed=n * t + mu)
    assert np.array_equal(_port(args, mu), _jax(args, mu, None))


def _masked_edges():
    t = 96
    rem = np.tile([-3.0, 2.0, -1.0, 4.0], t // 4).astype(np.float32)
    start = np.array([0.0, 1.0, 90.0, 40.0, 40.0, 88.0], np.float32)
    dur = np.array([4.0, 2.0, 6.0, 5.0, 5.0, 8.0], np.float32)
    work = np.array([3.0, 2.0, 1.0, 2.0, 0.0, 5.0], np.float32)
    lo = np.array([0.0, 0.0, 80.0, 41.0, 30.0, 0.0], np.float32)
    hi = np.array([12.0, 9.0, 90.0, 39.0, 50.0, 88.0], np.float32)
    return rem, start, dur, work, lo, hi


def _ties():
    """A flat timeline: every legal shift of a task ties with its
    mirror, so first-max tie rules downstream see equal gains."""
    t = 128
    rem = np.full(t, 2.0, np.float32)
    start = np.array([0.0, 30.0, 60.0, 100.0, 120.0], np.float32)
    dur = np.array([3.0, 4.0, 1.0, 7.0, 8.0], np.float32)
    work = np.array([2.0, 5.0, 1.0, 3.0, 4.0], np.float32)
    lo = np.zeros(5, np.float32)
    hi = np.full(5, float(t), np.float32) - dur
    return rem, start, dur, work, lo, hi


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("case", ["masked_edges", "ties"])
def test_gain_scan_edges_and_ties_bit_identical(case, interpret):
    mu = 10
    args = {"masked_edges": _masked_edges, "ties": _ties}[case]()
    got = _port(args, mu)
    assert np.array_equal(got, _jax(args, mu, interpret))
    assert (got[:, mu] == tg.NEG).all()          # delta=0 always illegal
    if case == "masked_edges":
        assert (got[3] == tg.NEG).all()          # no legal move: lo > hi
        assert (got[4] == tg.NEG).all()          # zero-work row
    else:
        legal = got > -1e29
        assert legal.sum() > 20 and len(np.unique(got[legal])) < legal.sum()


@pytest.mark.parametrize("interpret", [None, True])
@pytest.mark.parametrize("mu", [3, 17])
def test_gain_scan_batched_bit_identical(mu, interpret):
    rng = np.random.default_rng(mu)
    B, n, t = 3, 40, 256
    rem = rng.integers(-9, 9, (B, t)).astype(np.float32)
    dur = rng.integers(1, 9, n).astype(np.float32)
    work = rng.integers(0, 7, n).astype(np.float32)
    start = rng.integers(0, t - 10, (B, n)).astype(np.float32)
    lo = np.maximum(start - 20, 0).astype(np.float32)
    hi = (start + 20).astype(np.float32)
    args = (rem, start, dur, work, lo, hi)
    got = _port(args, mu, batched=True)
    assert got.shape == (B, n, 2 * mu + 1)
    assert np.array_equal(got, _jax(args, mu, interpret, batched=True))
    via_ops = ls_gains_batched(*args, mu=mu, device="cpu").numpy()
    assert np.array_equal(got, via_ops)


def test_windows_and_prefix_sums_match_reference():
    mu = 8
    rng = np.random.default_rng(0)
    rem = rng.integers(-5, 5, 128).astype(np.float32)
    start = rng.integers(0, 100, 30).astype(np.float32)
    dur = rng.integers(1, 8, 30).astype(np.float32)
    work = rng.integers(0, 6, 30).astype(np.float32)
    ws_r, we_r = rg.gather_windows(jnp.asarray(rem), jnp.asarray(start),
                                   jnp.asarray(dur), mu=mu)
    ws_t, we_t = tg.gather_windows(torch.as_tensor(rem),
                                   torch.as_tensor(start).int(),
                                   torch.as_tensor(dur).int(), mu=mu)
    assert np.array_equal(np.asarray(ws_r), ws_t.numpy())
    assert np.array_equal(np.asarray(we_r), we_t.numpy())
    lo_rel = np.full(30, -5.0, np.float32)
    hi_rel = np.full(30, 5.0, np.float32)
    want = np.asarray(rg.gains_from_windows(
        ws_r, we_r, jnp.asarray(work), jnp.asarray(dur),
        jnp.asarray(lo_rel), jnp.asarray(hi_rel), mu=mu))
    got = tg.gains_from_windows(ws_t, we_t, torch.as_tensor(work),
                                torch.as_tensor(dur), torch.as_tensor(lo_rel),
                                torch.as_tensor(hi_rel), mu=mu)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("n,t,mu", [(17, 300, 5), (120, 900, 10)])
def test_direct_definition_oracle_matches_reference(n, t, mu):
    args = _sweep_case(n, t, mu)
    want = np.asarray(r_ref(*map(jnp.asarray, args), mu=mu))
    got = t_ref(*map(torch.as_tensor, args), mu=mu).numpy()
    legal = want > -1e29
    assert np.array_equal(legal, got > -1e29)
    assert np.array_equal(want[legal], got[legal])
    # the sweep itself agrees with the direct definition on legal moves
    sweep = ls_gains(*args, mu=mu, device="cpu").numpy()
    assert np.array_equal(sweep[legal], got[legal])


def test_gain_sweep_rejects_what_it_cannot_run():
    args = [torch.as_tensor(a) for a in _masked_edges()]
    with pytest.raises(ValueError, match="CUDA"):
        tg.gain_scan(*args, mu=10, mode="kernel")
    with pytest.raises(ValueError, match="mu=43"):
        tg.gain_scan(*args, mu=43)
    launches = tg.LAUNCHES
    tg.gain_scan(*args, mu=10)                     # plain on the CPU
    assert tg.LAUNCHES == launches


def test_build_key_tracks_source_and_flags(monkeypatch):
    from repro_torch.kernels import _build

    path = _build.library_path("gain_scan")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("gain_scan-") and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path("gain_scan") != path


@pytest.mark.cuda
@pytest.mark.parametrize("mu", [1, 10, 42])
def test_cuda_kernel_matches_plain(mu):
    """The sm_90a kernel against the plain version on the card, bitwise,
    at the climb's shapes (R=32, Np=4352, Tp=1024) and on the edge case."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(mu)
    R, N, T = 32, 4352, 1024
    rem = torch.as_tensor(rng.integers(-40, 40, (R, T)), dtype=torch.float32)
    start = torch.as_tensor(rng.integers(0, T - 12, (R, N)),
                            dtype=torch.int32)
    dur = torch.as_tensor(rng.integers(1, 12, N), dtype=torch.int32)
    work = torch.as_tensor(rng.integers(0, 30, N), dtype=torch.float32)
    lo = torch.as_tensor(-rng.integers(0, 2 * mu + 5, (R, N)),
                         dtype=torch.float32)
    hi = torch.as_tensor(rng.integers(0, 2 * mu + 5, (R, N)),
                         dtype=torch.float32)
    args = [a.to(dev) for a in (rem, start, dur, work, lo, hi)]
    launches = tg.LAUNCHES
    got = tg.gain_sweep(*args, mu=mu)
    assert tg.LAUNCHES == launches + 1
    want = tg.gain_sweep(*args, mu=mu, mode="plain")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tg.gain_sweep(rem, start, dur, work, lo,
                                                hi, mu=mu))
    edge = [torch.as_tensor(a).to(dev) for a in _masked_edges()]
    if mu <= 10:
        assert torch.equal(tg.gain_scan(*edge, mu=mu),
                           tg.gain_scan(*edge, mu=mu, mode="plain"))
