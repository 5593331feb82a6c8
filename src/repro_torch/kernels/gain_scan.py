"""Local-search gain sweep (paper §5.3, batched): a hand-written CUDA kernel
and its plain PyTorch version.

For every task i and every shift delta in [-mu, mu], computes the exact
carbon-cost gain of moving task i by delta, given the current remaining-
budget timeline. Only the symmetric difference of the old/new execution
windows contributes, and both difference regions lie within ``mu`` units of
the task's start (s) or end (e). Two executors compute the same matrix
(:func:`repro_torch.kernels.backend.resolve_mode` picks one per call):

* the CUDA kernel ``csrc/gain_scan.cu`` — the Hopper counterpart of the
  reference's Pallas ``_gain_kernel``. It reads the timeline directly and
  gathers each candidate's windows itself, so the two ``[R*N, W]`` window
  tensors of the plain version never exist. It serves CUDA tensors.
* :func:`gather_windows` + :func:`gains_from_windows` — the plain version:
  lane-aligned windows of the timeline around start and end,

      win_s[i, j] = rem[s_i - mu + j],   win_e[i, j] = rem[e_i - mu + j],

  (reads outside ``[0, T)`` give 0), then every delta's masked window sum
  as a difference of four prefix sums. It serves CPU tensors.

All summands are integers below 2^24, so f32 accumulation is exact in any
order and the two executors agree bitwise (tested on the card).

Gain identities (rem includes the task at its old position; the newly
occupied region never overlaps the old window, so rem == rem-without-task
there):
  released(t) = min(max(-rem[t], 0), w)          on vacated units
  incurred(t) = min(max(w - max(rem[t], 0), 0), w)  on newly occupied units
  gain(delta) = sum released - sum incurred ;  illegal shifts -> -BIG.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.backend import resolve_mode

W = 128          # lane-aligned window length of the plain version
MU_MAX = W // 2 - 22   # 42, the reference's limit for W = 128
NEG = -1e30

LAUNCHES = 0     # CUDA kernel launches made by gain_sweep (only there)


def _check_mu(mu: int) -> None:
    if not 1 <= mu <= MU_MAX:
        raise ValueError(f"mu={mu} outside [1, {MU_MAX}] (window W={W})")


def gather_windows(rem, start, dur, *, mu: int):
    """(win_s, win_e) f32[..., N, W] timeline windows around start and end.

    ``rem`` f32[..., T]; ``start`` int[..., N]; ``dur`` int[N] (or
    broadcastable to ``start``). Reads outside ``[0, T)`` give 0.
    """
    T = rem.shape[-1]
    rem_pad = torch.nn.functional.pad(rem, (W, W))
    idx = torch.arange(W, device=rem.device) - mu
    s_i = start.to(torch.int64)
    e_i = s_i + dur.to(torch.int64)
    hi = T + 2 * W - 1

    def win(x):
        pos = (x.unsqueeze(-1) + idx + W).clamp(0, hi)       # [..., N, W]
        src = rem_pad.unsqueeze(-2).expand(*pos.shape[:-1], rem_pad.shape[-1])
        return torch.gather(src, -1, pos)

    return win(s_i), win(e_i)


def gains_from_windows(win_s, win_e, work, dur, lo_rel, hi_rel, *, mu: int):
    """The gain matrix from pre-gathered windows, in plain PyTorch.

    Every delta's vacated/occupied region is a contiguous index range in
    its window, so the masked sums collapse to differences of four prefix
    sums (the reference's ``gains_from_windows``, term for term).

    Args:
      win_s, win_e: f32[N, W] from :func:`gather_windows`.
      work, dur:    f32[N].
      lo_rel, hi_rel: f32[N] legal shift bounds RELATIVE to the current
        start (lo_rel > hi_rel marks a row with no legal move).
    Returns:
      f32[N, 2*mu+1]; illegal moves = -1e30.
    """
    pad = mu
    w = work[:, None]
    zero = torch.zeros((), dtype=win_s.dtype, device=win_s.device)
    released_s = torch.minimum(torch.maximum(-win_s, zero), w)
    released_e = torch.minimum(torch.maximum(-win_e, zero), w)
    incurred_s = torch.minimum(
        torch.maximum(w - torch.maximum(win_s, zero), zero), w)
    incurred_e = torch.minimum(
        torch.maximum(w - torch.maximum(win_e, zero), zero), w)

    def csum(x):                                  # [N, W] -> [N, W+1]
        z = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        return torch.cat([z, torch.cumsum(x, dim=1)], dim=1)

    r_s, r_e = csum(released_s), csum(released_e)
    i_s, i_e = csum(incurred_s), csum(incurred_e)

    delta = torch.arange(-mu, mu + 1, dtype=torch.int32,
                         device=win_s.device)[None, :]           # [1, D]
    ln = torch.minimum(delta.abs(), dur[:, None].to(torch.int32))

    def take(c, i):
        # indices of the inapplicable delta branch may leave [0, W]; they
        # are masked out below, so clip them into range first
        return torch.gather(c, 1, i.clamp(0, W).to(torch.int64)
                            .expand(c.shape[0], -1))

    # delta > 0: vacated [pad, pad+ln) of win_s, occupied
    # [pad+delta-ln, pad+delta) of win_e
    g_pos = (take(r_s, pad + ln) - r_s[:, pad:pad + 1]) \
        - (take(i_e, pad + delta) - take(i_e, pad + delta - ln))
    # delta < 0: vacated [pad-ln, pad) of win_e, occupied
    # [pad+delta, pad+delta+ln) of win_s
    g_neg = (r_e[:, pad:pad + 1] - take(r_e, pad - ln)) \
        - (take(i_s, pad + delta + ln) - take(i_s, pad + delta))
    gain = torch.where(delta > 0, g_pos, torch.where(delta < 0, g_neg, zero))

    deltaf = delta.to(win_s.dtype)
    legal = ((lo_rel[:, None] <= deltaf) & (deltaf <= hi_rel[:, None])
             & (delta != 0) & (work[:, None] > 0))
    return torch.where(legal, gain, torch.full((), NEG, dtype=gain.dtype,
                                               device=gain.device))


def _sweep_plain(rem, start, dur, work, lo_rel, hi_rel, mu):
    R, N = start.shape
    win_s, win_e = gather_windows(rem, start, dur, mu=mu)
    flat = gains_from_windows(
        win_s.reshape(R * N, W), win_e.reshape(R * N, W),
        work.repeat(R), dur.to(work.dtype).repeat(R),
        lo_rel.reshape(R * N), hi_rel.reshape(R * N), mu=mu)
    return flat.reshape(R, N, 2 * mu + 1)


_LAUNCH = None   # the kernel's ctypes entry point, set up at first launch


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from repro_torch.kernels import _build

        fn = _build.load("gain_scan").gain_scan_launch
        # pointers and the stream as c_void_p: left undeclared, ctypes
        # would pass them as 32-bit ints and cut them
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _sweep_kernel(rem, start, dur, work, lo_rel, hi_rel, mu):
    global LAUNCHES
    R, N = start.shape
    dev = rem.device
    want = ((rem, torch.float32, 2), (start, torch.int32, 2),
            (dur, torch.int32, 1), (work, torch.float32, 1),
            (lo_rel, torch.float32, 2), (hi_rel, torch.float32, 2))
    for t, dtype, ndim in want:
        if t.device != dev or t.dtype != dtype or t.dim() != ndim \
                or not t.is_contiguous():
            raise ValueError(
                f"gain_scan kernel takes contiguous {dtype} tensors of "
                f"rank {ndim} on {dev}; got {t.dtype} rank {t.dim()} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    if rem.shape[0] != R or dur.shape[0] != N or work.shape[0] != N \
            or lo_rel.shape != (R, N) or hi_rel.shape != (R, N):
        raise ValueError(
            f"gain_scan kernel shapes disagree: rem {tuple(rem.shape)}, "
            f"start {tuple(start.shape)}, dur {tuple(dur.shape)}, work "
            f"{tuple(work.shape)}, lo/hi {tuple(lo_rel.shape)}/"
            f"{tuple(hi_rel.shape)}")
    out = torch.empty((R, N, 2 * mu + 1), dtype=torch.float32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(rem.data_ptr(), start.data_ptr(), dur.data_ptr(),
                     work.data_ptr(), lo_rel.data_ptr(), hi_rel.data_ptr(),
                     out.data_ptr(), R, N, rem.shape[1], mu, stream)
    if err != 0:
        raise RuntimeError(f"gain_scan kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def gain_sweep(rem, start, dur, work, lo_rel, hi_rel, *, mu: int,
               mode: str | None = None):
    """The climb's gain oracle: all (row, task, shift) gains in one call.

    Args:
      rem:    f32 [R, T] per-row remaining-budget timelines.
      start:  int32 [R, N] per-row start times.
      dur:    int32 [N] durations (shared across rows).
      work:   f32 [N] work power (shared across rows).
      lo_rel, hi_rel: f32 [R, N] legal shift bounds RELATIVE to the
        current start (lo_rel > hi_rel marks a candidate with no move).
      mode:   None = the CUDA kernel on CUDA tensors, the plain version on
        CPU tensors; "plain"/"kernel" force one (see
        :func:`repro_torch.kernels.backend.resolve_mode`).
    Returns:
      f32 [R, N, 2*mu+1]; entry (r, i, d) = gain of moving task i of row r
      by (d - mu); illegal moves = -1e30.
    """
    _check_mu(mu)
    if resolve_mode(rem, mode) == "kernel":
        return _sweep_kernel(rem, start, dur, work, lo_rel, hi_rel, mu)
    return _sweep_plain(rem, start, dur, work, lo_rel, hi_rel, mu)


def gain_scan(rem, start, dur, work, lo, hi, *, mu: int = 10,
              mode: str | None = None):
    """All-pairs (task, shift) gains of one schedule.

    Args:
      rem:  f32[T] remaining-budget timeline (g_eff - active work power).
      start, dur, work: f32[N].
      lo, hi: f32[N] legal *absolute* start-time bounds per task.
      mu: max shift.
    Returns:
      f32[N, 2*mu+1]; entry (i, d) = gain of moving task i by (d - mu);
      illegal moves = -1e30.
    """
    return gain_scan_batched(rem[None], start[None], dur, work, lo[None],
                             hi[None], mu=mu, mode=mode)[0]


def gain_scan_batched(rem, start, dur, work, lo, hi, *, mu: int = 10,
                      mode: str | None = None):
    """Gains for a whole batch of schedules in ONE call.

    Args:
      rem:  f32[B, T] per-row remaining-budget timelines.
      start, lo, hi: f32[B, N] per-row schedules / legal absolute bounds.
      dur, work: f32[N], shared across rows (same instance).
    Returns:
      f32[B, N, 2*mu+1].
    """
    return gain_sweep(
        rem.contiguous(), start.to(torch.int32).contiguous(),
        dur.to(torch.int32).contiguous(), work.contiguous(),
        (lo - start).contiguous(), (hi - start).contiguous(),
        mu=mu, mode=mode)
