"""The §5.2 greedy's placement scan: a hand-written CUDA kernel and its
plain PyTorch version.

The port of ``repro.core.greedy_jax._placement_step`` scanned over the
placement order (``lax.scan``; an XLA loop in the reference, not a Pallas
kernel). R independent rows (one (instance, profile, variant) schedule
each) advance through steps ``[t0, t1)`` of their placement orders; at step
t, with v = ``order[r, t]``, row r places v at the first unit of maximal
remaining budget among the feasible candidate points of v's window (or at
its EST when none is), charges its work, marks its start and end as
candidate points, and relaxes every task's EST/LST through v's longest-path
row and column::

    est = max(est, s + lp[v, :])      # descendants of v move right
    lst = min(lst, s - lp[:, v])      # ancestors of v move left

Two forms feed the row and column of lp, one step body for both:

* dense: ``lp``/``lp_t`` int32 [I, Np, Np] (the padded matrix and its
  contiguous transpose), looked up at (``lp_of[r]``, v), with ``t0 = 0``,
  ``t1 = Np``;
* blocked (chunk-streamed): ``lp``/``lp_t`` int32 [S, B, Np], the chunk's
  rows and columns from :meth:`repro_torch.core.greedy_torch.BlockedLP.chunk_tensors`,
  looked up at (``lp_of[r]``, t - t0) for the chunk's steps ``[t0, t0 + B)``.

Two executors (:func:`repro_torch.kernels.backend.resolve_mode` picks one
per call): the CUDA kernel ``csrc/greedy_scan.cu`` on CUDA tensors, and
:func:`_scan_plain`, one batched torch step per placement step, on CPU
tensors. The kernel runs one CTA per row, the step loop inside the block:
a producer warp keeps the next steps' lp rows and columns in flight into a
ring of shared-memory stages (Tensor Memory Accelerator bulk copies), and
8 consumer warps run each step with one block barrier, a 32-bit warp
argmax, 16-byte relaxations of est and lst, and the row's state in shared
memory where it fits (:func:`ring_plan` says what the kernel keeps where).
The bulk copies and 16-byte accesses need ``Np % 4 == 0`` and 16-byte
aligned ``lp``, ``lp_t``, ``est`` and ``lst``: the kernel path raises a
``ValueError`` otherwise (the plan's buckets are multiples of 128).
Every value is int32 and the argmax takes the first max in both
executors, so the two agree bitwise (tested on the card).
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_mode

_BIG = np.iinfo(np.int32).max // 4     # "infeasible" budget marker

LAUNCHES = 0     # CUDA kernel launches made by greedy_scan (only there)
_COUNT_LOCK = threading.Lock()


def _scan_plain(rem, mask, est, lst, start, order, dur, work, inst_of, lp,
                lp_t, lp_of, by_task, t0, t1):
    """One batched torch step per placement step: task ``v[r]`` of every
    row r, its lp row and column gathered from ``lp``/``lp_t``."""
    R, Tp = rem.shape
    dev = rem.device
    ar = torch.arange(R, device=dev)
    tgrid = torch.arange(Tp, dtype=torch.int32, device=dev)
    neg = torch.tensor(-_BIG, dtype=torch.int32, device=dev)
    inst = inst_of.to(torch.int64)
    src = lp_of.to(torch.int64)
    steps = order[:, t0:t1].t().to(torch.int64)       # [t1 - t0, R]
    for j in range(t1 - t0):
        v = steps[j]
        k = v if by_task else j
        row, col = lp[src, k], lp_t[src, k]
        dur_v, work_v = dur[inst, v], work[inst, v]
        est_v = est[ar, v]
        lst_v = lst[ar, v]
        feas = mask[:, :-1] & (tgrid >= est_v[:, None]) \
            & (tgrid <= lst_v[:, None])
        val = torch.where(feas, rem, neg)
        # argmax takes the FIRST max, as jnp.argmax does: earliest tie
        s = torch.where(feas.any(dim=1),
                        val.argmax(dim=1).to(torch.int32), est_v)
        e = s + dur_v
        run = (tgrid >= s[:, None]) & (tgrid < e[:, None])
        rem.sub_(torch.where(run, work_v[:, None], 0).to(rem.dtype))
        # mask.at[s].set(True), dropping an out-of-range s as jnp does
        si = s.clamp(0, Tp).to(torch.int64)
        mask[ar, si] = mask[ar, si] | (s <= Tp)
        # numpy endpoint rule: e splits an interval only when e <= T (the
        # PADDED horizon, as in the reference); an overrunning task must
        # not spuriously mark T a candidate point
        ei = e.clamp(max=Tp).to(torch.int64)
        mask[ar, ei] = mask[ar, ei] | (e <= Tp)
        torch.maximum(est, s[:, None] + row, out=est)
        torch.minimum(lst, s[:, None] - col, out=lst)
        start[ar, v] = s


_LAUNCH = None   # the kernel's ctypes entry point, set up at first launch


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from repro_torch.kernels import _build

        fn = _build.load("greedy_scan").greedy_scan_launch
        # pointers and the stream as c_void_p: left undeclared, ctypes
        # would pass them as 32-bit ints and cut them
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def ring_plan(Np: int, Tp: int, device=None) -> dict:
    """Where the kernel keeps a row's data at (Np, Tp) on a CUDA device
    (default: the current one): ``stage_tasks`` (est and lst in shared
    memory), ``stage_time`` (rem and mask), ``chunk`` (int32 of lp's row,
    and of its column, a ring stage holds; a step walks ``ceil(Np /
    chunk)`` stages), ``stages`` (the ring's depth) and ``smem_bytes``."""
    from repro_torch.kernels import _build

    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    fn = _build.load("greedy_scan").greedy_scan_plan
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 5)()
    err = fn(Np, Tp, index, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"greedy_scan_plan failed: CUDA error {err}")
    return {"stage_tasks": bool(out[0]), "stage_time": bool(out[1]),
            "chunk": out[2], "smem_bytes": out[3], "stages": out[4]}


def _check(tensors, dev) -> None:
    for t, dtype, ndim in tensors:
        if t.device != dev or t.dtype != dtype or t.dim() != ndim \
                or not t.is_contiguous():
            raise ValueError(
                f"greedy_scan kernel takes contiguous {dtype} tensors of "
                f"rank {ndim} on {dev}; got {t.dtype} rank {t.dim()} on "
                f"{t.device} (contiguous={t.is_contiguous()})")


def _scan_kernel(rem, mask, est, lst, start, order, dur, work, inst_of, lp,
                 lp_t, lp_of, by_task, t0, t1):
    global LAUNCHES
    dev = rem.device
    i32 = torch.int32
    _check(((rem, i32, 2), (mask, torch.bool, 2), (est, i32, 2),
            (lst, i32, 2), (start, i32, 2), (order, i32, 2), (dur, i32, 2),
            (work, i32, 2), (inst_of, i32, 1), (lp, i32, 3),
            (lp_t, i32, 3), (lp_of, i32, 1)), dev)
    R, Tp = rem.shape
    Np = est.shape[1]
    if mask.shape != (R, Tp + 1) or lst.shape != (R, Np) \
            or start.shape != (R, Np) or order.shape != (R, Np) \
            or dur.shape[1] != Np or work.shape != dur.shape \
            or inst_of.shape != (R,) or lp_of.shape != (R,) \
            or lp.shape != lp_t.shape or lp.shape[2] != Np \
            or not 0 <= t0 <= t1 <= Np \
            or (lp.shape[1] != Np if by_task else lp.shape[1] < t1 - t0):
        raise ValueError(
            f"greedy_scan kernel shapes disagree: rem {tuple(rem.shape)}, "
            f"mask {tuple(mask.shape)}, est {tuple(est.shape)}, order "
            f"{tuple(order.shape)}, dur {tuple(dur.shape)}, lp "
            f"{tuple(lp.shape)}/{tuple(lp_t.shape)}, steps [{t0}, {t1})")
    if Np % 4 or any(t.data_ptr() % 16 for t in (lp, lp_t, est, lst)):
        raise ValueError(
            f"greedy_scan kernel moves lp rows, est and lst 16 bytes at a "
            f"time: it needs Np % 4 == 0 (got Np={Np}) and 16-byte aligned "
            f"lp, lp_t, est and lst")
    if R == 0 or t1 == t0:              # nothing to launch
        return
    launch = _launcher()
    with torch.cuda.device(dev.index):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        err = launch(rem.data_ptr(), mask.data_ptr(), est.data_ptr(),
                     lst.data_ptr(), start.data_ptr(), order.data_ptr(),
                     dur.data_ptr(), work.data_ptr(), inst_of.data_ptr(),
                     lp.data_ptr(), lp_t.data_ptr(), lp_of.data_ptr(),
                     lp.shape[1], int(by_task), R, Np, Tp, t0, t1, dev.index,
                     stream)
    if err != 0:
        raise RuntimeError(
            f"greedy_scan kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1


def greedy_scan(rem, mask, est, lst, start, order, dur, work, inst_of, lp,
                lp_t, *, lp_of=None, t0: int = 0, t1: int | None = None,
                mode: str | None = None) -> None:
    """Steps ``[t0, t1)`` of R greedy rows, in place.

    Args:
      rem:   int32 [R, Tp] remaining budgets (updated).
      mask:  bool [R, Tp+1] candidate points (updated).
      est, lst: int32 [R, Np] task windows (updated).
      start: int32 [R, Np] start times (written at each placed task).
      order: int32 [R, Np] placement orders.
      dur, work: int32 [I, Np] per-instance durations and work powers.
      inst_of: int32 [R] each row's instance.
      lp, lp_t: the dense form's int32 [I, Np, Np] matrix and transpose
        (``lp_of`` None: looked up by ``inst_of`` and the task), or the
        blocked form's chunk rows and columns int32 [S, t1 - t0, Np]
        (looked up by ``lp_of`` int32 [R] and the step within the chunk).
      t0, t1: the steps to run (``t1`` None: ``t0 + lp.shape[1]`` blocked,
        ``Np`` dense).
      mode:  None = the CUDA kernel on CUDA tensors, the plain version on
        CPU tensors; "plain"/"kernel" force one (see
        :func:`repro_torch.kernels.backend.resolve_mode`).
    """
    by_task = lp_of is None
    if by_task:
        lp_of = inst_of
        if t1 is None:
            t1 = est.shape[1]
    elif t1 is None:
        t1 = t0 + lp.shape[1]
    if resolve_mode(rem, mode) == "kernel":
        _scan_kernel(rem, mask, est, lst, start, order, dur, work, inst_of,
                     lp, lp_t, lp_of, by_task, t0, t1)
    else:
        _scan_plain(rem, mask, est, lst, start, order, dur, work, inst_of,
                    lp, lp_t, lp_of, by_task, t0, t1)
