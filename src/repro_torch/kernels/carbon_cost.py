"""Per-unit carbon-deficit timeline (paper §3): a hand-written CUDA kernel
and its plain PyTorch version.

For every time unit ``t`` (taken as an f32), computes
``max(sum_i w_i * [s_i <= t < e_i] - g_eff(t), 0)`` — the paper's carbon
cost integrand; the schedule's cost is its sum
(:func:`repro_torch.kernels.ops.carbon_cost`). Two executors compute the
same timeline (:func:`repro_torch.kernels.backend.resolve_mode` picks one
per call):

* the CUDA kernel ``csrc/carbon_cost.cu`` — the Hopper counterpart of the
  reference's Pallas ``_kernel``: one thread per time unit, the task arrays
  staged through shared memory and walked in ascending order. It serves
  CUDA tensors.
* :func:`timeline_plain` — the dense ``[s <= t < e]`` form, chunked over
  tasks so no intermediate exceeds :data:`PLAIN_ELEMS` elements. It serves
  CPU tensors.

With integer inputs whose sums stay below 2^24 the f32 accumulation is
exact in any order, so the two executors agree bitwise (tested on the
card). Unlike the reference, neither pads: the output is ``[T]`` for any
``N >= 1`` and ``T``.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.backend import resolve_mode

PLAIN_ELEMS = 1 << 26   # largest [chunk, T] block the plain version builds

LAUNCHES = 0     # CUDA kernel launches made by deficit_timeline (only there)
_COUNT_LOCK = threading.Lock()   # launches may come from several threads


def timeline_plain(starts, ends, works, g_eff):
    """The deficit timeline in plain PyTorch, in task chunks of at most
    :data:`PLAIN_ELEMS` ``[chunk, T]`` elements (ascending task order)."""
    T = g_eff.shape[0]
    t = torch.arange(T, dtype=torch.float32, device=g_eff.device)
    acc = torch.zeros(T, dtype=torch.float32, device=g_eff.device)
    chunk = max(PLAIN_ELEMS // max(T, 1), 1)
    for i in range(0, starts.shape[0], chunk):
        s = starts[i:i + chunk, None]
        e = ends[i:i + chunk, None]
        active = ((s <= t) & (t < e)).to(torch.float32)
        acc += (works[i:i + chunk, None] * active).sum(0)
    return torch.clamp(acc - g_eff, min=0.0)


_LAUNCH = None   # the kernel's ctypes entry point, set up at first launch


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from repro_torch.kernels import _build

        fn = _build.load("carbon_cost").deficit_timeline_launch
        # pointers and the stream as c_void_p: left undeclared, ctypes
        # would pass them as 32-bit ints and cut them
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _timeline_kernel(starts, ends, works, g_eff):
    """Launch ``csrc/carbon_cost.cu`` on the current stream."""
    global LAUNCHES
    dev = g_eff.device
    for name, x in (("starts", starts), ("ends", ends), ("works", works),
                    ("g_eff", g_eff)):
        if x.device != dev or x.dtype != torch.float32 or x.dim() != 1 \
                or not x.is_contiguous():
            raise ValueError(
                f"carbon_cost kernel takes contiguous float32 vectors on "
                f"{dev}; {name} is {x.dtype} rank {x.dim()} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    N, T = starts.shape[0], g_eff.shape[0]
    if ends.shape[0] != N or works.shape[0] != N:
        raise ValueError(
            f"carbon_cost kernel shapes disagree: starts {N}, ends "
            f"{ends.shape[0]}, works {works.shape[0]}")
    if N < 1:
        raise ValueError("carbon_cost kernel needs at least one task")
    out = torch.empty(T, dtype=torch.float32, device=dev)
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(starts.data_ptr(), ends.data_ptr(), works.data_ptr(),
                     g_eff.data_ptr(), out.data_ptr(), N, T, stream)
    if err != 0:
        raise RuntimeError(
            f"carbon_cost kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def deficit_timeline(starts, ends, works, g_eff, *, mode: str | None = None):
    """Per-unit deficit (cost) timeline.

    Args:
      starts, ends, works: f32[N] task windows and work powers; a task is
        active on unit t where ``starts <= t < ends`` (compared in f32).
      g_eff: f32[T] effective green budget per unit.
      mode: None = the CUDA kernel on CUDA tensors, the plain version on
        CPU tensors; "plain"/"kernel" force one (see
        :func:`repro_torch.kernels.backend.resolve_mode`).
    Returns:
      f32[T] with ``max(power(t) - g_eff(t), 0)``.
    """
    if resolve_mode(g_eff, mode) == "kernel":
        return _timeline_kernel(starts, ends, works, g_eff)
    return timeline_plain(starts, ends, works, g_eff)
