"""One round of the device climb's top-K commit scan: a hand-written CUDA
kernel and its plain PyTorch version.

The port of ``repro.core.local_search_jax``'s ``commit_step`` scanned over
a round's proposals (``lax.scan`` inside the climb's ``lax.while_loop``;
XLA loops in the reference, not a Pallas kernel). Each live row walks its
first K proposals in gain order (``order``, a stable descending sort of the
round's best gains), re-clamps each task's proposed move to its CURRENT
legal window (earlier commits of the round may have moved its
neighbours; ``jnp.clip`` semantics, hi wins), re-evaluates the move's gain
exactly over the symmetric difference of the old and new windows, and
commits it when that gain is positive, updating the row's remaining budget
and start in place. The window comes from the direct G_c edges in one of
two forms, each a class here that holds all of what the scan and the climb
know of it: :class:`DenseAdjacency`, bool rows ``(pred, succ)`` [Np, Np],
or :class:`PaddedAdjacency`, the padded CSR tables
``(pidx, pok, sidx, sok)`` [Np, D] of the blocked-lp instances.

Two executors (:func:`repro_torch.kernels.backend.resolve_mode` picks one
per call): the CUDA kernel ``csrc/commit_scan.cu`` on CUDA tensors, and
:func:`_commit_plain`, one batched torch step per commit slot up to the
largest live row's count of positive proposals, on CPU tensors. The kernel
runs one CTA per row, which stops at the row's first non-positive proposal
(no host sync): its warps stage the row in shared memory; then one warp
commits each proposal while seven gather the next one's bounds, one block
barrier a proposal, the dense rows arriving through a ring of
shared-memory stages (Tensor Memory Accelerator bulk copies; they need
``Np % 16 == 0`` and 16-byte aligned ``pred``/``succ``, else the kernel
path raises a ``ValueError``), the padded rows read from device memory.
Every value is int32 (the two sums int64), so the two agree bitwise
(tested on the card).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.backend import resolve_mode

LAUNCHES = 0     # CUDA kernel launches made by commit_scan (only there)
_COUNT_LOCK = threading.Lock()


# elements of the [rows, Np, Np] temporary of one dense round-bound chunk
_DENSE_CHUNK = 1 << 26


class DenseAdjacency:
    """Direct G_c edges as bool [Np, Np] (pred, succ) masks on device."""

    def __init__(self, pred, succ):
        self.pred, self.succ = pred, succ

    def bounds(self, start, dur, t_real):
        """Round-start (pred_lo, succ_hi) int32 [R, Np] of every task,
        chunked over rows so the [rows, Np, Np] temporary stays bounded."""
        R, Np = start.shape
        fin = start + dur
        step = max(1, _DENSE_CHUNK // (Np * Np))
        lo, hi = [], []
        for a in range(0, R, step):
            f, s = fin[a:a + step, None, :], start[a:a + step, None, :]
            lo.append(torch.where(self.pred, f, 0).amax(dim=2))
            hi.append(torch.where(self.succ, s, t_real).amin(dim=2))
        return torch.cat(lo), torch.cat(hi)

    def task_bounds(self, start, dur, t_real, v):
        """(pred_lo, succ_hi) int32 [R] of task ``v[r]`` in row r, from
        the current starts."""
        lo = torch.where(self.pred[v], start + dur, 0).amax(dim=1)
        hi = torch.where(self.succ[v], start, t_real).amin(dim=1)
        return lo, hi

    def kernel_args(self, Np):
        """The kernel's expected (tensor, dtype, shape)s, and its
        ``(pred, succ, pidx, pok, sidx, sok, D)`` arguments. Raises a
        ``ValueError`` where the kernel's bulk copies cannot take the rows
        (Np % 16 != 0, or a table not 16-byte aligned)."""
        if Np % 16 or self.pred.data_ptr() % 16 \
                or self.succ.data_ptr() % 16:
            raise ValueError(
                f"commit_scan kernel bulk-copies dense adjacency rows 16 "
                f"bytes at a time: it needs Np % 16 == 0 (got Np={Np}) and "
                f"16-byte aligned pred/succ")
        want = [(a, torch.bool, (Np, Np)) for a in (self.pred, self.succ)]
        return want, [self.pred.data_ptr(), self.succ.data_ptr(), None,
                      None, None, None, 0]


class PaddedAdjacency:
    """Direct G_c edges as padded-CSR gather tables int32/bool [Np, D]."""

    def __init__(self, pidx, pok, sidx, sok):
        self.tables = (pidx, pok, sidx, sok)    # the kernel's int32 form
        self.pidx, self.pok = pidx.to(torch.int64), pok
        self.sidx, self.sok = sidx.to(torch.int64), sok

    def bounds(self, start, dur, t_real):
        R, Np = start.shape
        fin = start + dur
        D = self.pidx.shape[1]
        pf = fin.gather(1, self.pidx.reshape(1, -1).expand(R, -1))
        ss = start.gather(1, self.sidx.reshape(1, -1).expand(R, -1))
        lo = torch.where(self.pok, pf.reshape(R, Np, D), 0).amax(dim=2)
        hi = torch.where(self.sok, ss.reshape(R, Np, D), t_real).amin(dim=2)
        return lo, hi

    def task_bounds(self, start, dur, t_real, v):
        lo = torch.where(self.pok[v], (start + dur).gather(1, self.pidx[v]),
                         0).amax(dim=1)
        hi = torch.where(self.sok[v], start.gather(1, self.sidx[v]),
                         t_real).amin(dim=1)
        return lo, hi

    def kernel_args(self, Np):
        D = self.pidx.shape[1]
        want = [(a, dt, (Np, D)) for a, dt in zip(
            self.tables, (torch.int32, torch.bool, torch.int32, torch.bool))]
        return want, [None, None, *(a.data_ptr() for a in self.tables), D]


def _commit_plain(rem, start, order, best_delta, best_gain, live, dur, work,
                  t_real, adj):
    R, Np = start.shape
    Tp = rem.shape[1]
    dev = rem.device
    tgrid = torch.arange(Tp, dtype=torch.int32, device=dev)
    rows = torch.arange(R, device=dev)
    zero = torch.zeros((), dtype=rem.dtype, device=dev)
    order = order.to(torch.int64)
    # commit steps past every live row's count of positive proposals
    # cannot commit (their best gain is <= 0): skip them
    npos = ((best_gain > 0) & live[:, None]).sum(dim=1)
    k_eff = min(order.shape[1], int(npos.max()))
    any_commit = torch.zeros(R, dtype=torch.bool, device=dev)
    for j in range(k_eff):
        v = order[:, j]
        s = start[rows, v]
        d_v = dur[v]
        w_v = work[v]
        e = s + d_v
        # current-state legal bounds (commits earlier in this round may
        # have moved neighbours); jnp.clip semantics: hi wins
        dlo, dhi = adj.task_bounds(start, dur, t_real, v)
        dhi = dhi - d_v
        new_s = torch.minimum(torch.maximum(s + best_delta[rows, v], dlo),
                              dhi)
        dd = new_s - s
        ln = torch.minimum(dd.abs(), d_v)
        # symmetric difference of old/new windows (move_gain identities)
        vac_lo = torch.where(dd > 0, s, e - ln)
        occ_hi = torch.where(dd > 0, new_s + d_v, new_s + ln)
        vac = (tgrid >= vac_lo[:, None]) & (tgrid < (vac_lo + ln)[:, None])
        occ = (tgrid >= (occ_hi - ln)[:, None]) & (tgrid < occ_hi[:, None])
        w2 = w_v[:, None]
        released = torch.where(
            vac, torch.minimum(torch.maximum(-rem, zero), w2), 0).sum(1)
        incurred = torch.where(
            occ, torch.minimum(torch.maximum(
                w2 - torch.maximum(rem, zero), zero), w2), 0).sum(1)
        ok = (live & (best_gain[rows, v] > 0) & (dlo <= dhi) & (dd != 0)
              & (released - incurred > 0))
        old = (tgrid >= s[:, None]) & (tgrid < e[:, None])
        new = (tgrid >= new_s[:, None]) & (tgrid < (new_s + d_v)[:, None])
        rem.add_(torch.where(ok[:, None], w2 * (old.to(rem.dtype)
                                                - new.to(rem.dtype)), 0))
        start[rows, v] = torch.where(ok, new_s, s)
        any_commit |= ok
    return any_commit


_LAUNCH = None   # the kernel's ctypes entry point, set up at first launch


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from repro_torch.kernels import _build

        fn = _build.load("commit_scan").commit_scan_launch
        # pointers and the stream as c_void_p: left undeclared, ctypes
        # would pass them as 32-bit ints and cut them
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _commit_kernel(rem, start, order, best_delta, best_gain, live, dur,
                   work, t_real, adj):
    global LAUNCHES
    dev = rem.device
    R, Tp = rem.shape
    Np = start.shape[1]
    i32 = torch.int32
    adj_want, adj_ptrs = adj.kernel_args(Np)
    want = [(rem, i32, (R, Tp)), (start, i32, (R, Np)),
            (order, i32, (R, order.shape[1])), (best_delta, i32, (R, Np)),
            (best_gain, torch.float32, (R, Np)),
            (live, torch.bool, (R,)), (dur, i32, (Np,)), (work, i32, (Np,)),
            *adj_want]
    for t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"commit_scan kernel takes contiguous {dtype} tensors of "
                f"shape {shape} on {dev}; got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    if R == 0:                          # nothing to launch
        return torch.zeros(0, dtype=torch.bool, device=dev)
    any_commit = torch.empty(R, dtype=torch.bool, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev.index):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        err = launch(rem.data_ptr(), start.data_ptr(), any_commit.data_ptr(),
                     order.data_ptr(), best_delta.data_ptr(),
                     best_gain.data_ptr(), live.data_ptr(), dur.data_ptr(),
                     work.data_ptr(), *adj_ptrs, R, Np, Tp, order.shape[1],
                     int(t_real), dev.index, stream)
    if err != 0:
        raise RuntimeError(
            f"commit_scan kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return any_commit


def commit_scan(rem, start, order, best_delta, best_gain, live, dur, work,
                t_real: int, adj, *, mode: str | None = None):
    """One round's commits of R climb rows, in place.

    Args:
      rem:   int32 [R, Tp] remaining budgets (updated).
      start: int32 [R, Np] start times (updated).
      order: int [R, K] the first K of each row's proposals in gain order.
      best_delta: int32 [R, Np] each task's proposed shift.
      best_gain:  f32 [R, Np] its gain (<= 0: no proposal).
      live:  bool [R] rows still climbing (the others commit nothing).
      dur, work: int32 [Np].
      t_real: the real horizon (Tp may be padded).
      adj:   :class:`DenseAdjacency` or :class:`PaddedAdjacency`.
      mode:  None = the CUDA kernel on CUDA tensors, the plain version on
        CPU tensors; "plain"/"kernel" force one (see
        :func:`repro_torch.kernels.backend.resolve_mode`).
    Returns:
      bool [R]: whether each row committed anything.
    """
    if resolve_mode(rem, mode) == "kernel":
        return _commit_kernel(rem, start,
                              order.to(torch.int32).contiguous(),
                              best_delta, best_gain, live, dur, work, t_real,
                              adj)
    return _commit_plain(rem, start, order, best_delta, best_gain, live, dur,
                         work, t_real, adj)
