"""Per-unit carbon-deficit timeline (paper §3): a hand-written CUDA kernel
and its plain PyTorch version.

For every time unit ``t`` (taken as an f32), computes
``max(sum_i w_i * [s_i <= t < e_i] - g_eff(t), 0)`` — the paper's carbon
cost integrand; the schedule's cost is its sum
(:func:`repro_torch.kernels.ops.carbon_cost`). Two executors compute the
same timeline (:func:`repro_torch.kernels.backend.resolve_mode` picks one
per call):

* the CUDA kernel ``csrc/carbon_cost.cu`` — the Hopper counterpart of the
  reference's Pallas ``_kernel``: a difference array of the windows in
  shared memory (f64) and a block-wide scan, one CTA per tile of
  :data:`KERNEL_TILE` units, O(N + T) work. It serves CUDA tensors.
* :func:`timeline_plain` — the dense ``[s <= t < e]`` form, chunked over
  tasks so no intermediate exceeds :data:`PLAIN_ELEMS` elements. It serves
  CPU tensors.

With integer inputs whose sums stay below 2^24 the dense f32 sum and the
kernel's f64 sum are both exact, so the two executors agree bitwise
(tested on the card); non-finite works give the dense form's inf and NaN.
Unlike the reference, neither pads: the output is ``[T]`` for any ``N``
and ``T``. :func:`deficit_timeline_from_durs` takes durations in place of
ends (``ops.carbon_cost``'s form), and the kernel then forms the ends
itself.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.backend import resolve_mode

PLAIN_ELEMS = 1 << 26   # largest [chunk, T] block the plain version builds
KERNEL_TILE = 1024      # units per CTA of the kernel (kTile in the source)
T_MAX = 1 << 24         # the kernel's units must be exact in f32

LAUNCHES = 0     # CUDA kernel launches (one per timeline, only there)
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
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _timeline_kernel(starts, second, works, g_eff, durs):
    """Launch ``csrc/carbon_cost.cu`` on the current stream; ``second``
    holds the ends, or the durations when ``durs``."""
    global LAUNCHES
    dev = g_eff.device
    for name, x in (("starts", starts), ("durs" if durs else "ends", second),
                    ("works", works), ("g_eff", g_eff)):
        if x.device != dev or x.dtype != torch.float32 or x.dim() != 1 \
                or not x.is_contiguous():
            raise ValueError(
                f"carbon_cost kernel takes contiguous float32 vectors on "
                f"{dev}; {name} is {x.dtype} rank {x.dim()} on {x.device} "
                f"(contiguous={x.is_contiguous()})")
    N, T = starts.shape[0], g_eff.shape[0]
    if second.shape[0] != N or works.shape[0] != N:
        raise ValueError(
            f"carbon_cost kernel shapes disagree: starts {N}, "
            f"{'durs' if durs else 'ends'} {second.shape[0]}, works "
            f"{works.shape[0]}")
    if T >= T_MAX:
        raise ValueError(f"carbon_cost kernel takes T < 2^24 units, got {T}")
    out = torch.empty(T, dtype=torch.float32, device=dev)
    launch = _launcher()
    # by index: a torch.device argument costs several microseconds here
    with torch.cuda.device(dev.index):
        stream = torch.cuda.current_stream(dev.index).cuda_stream
        err = launch(starts.data_ptr(), second.data_ptr(), works.data_ptr(),
                     g_eff.data_ptr(), out.data_ptr(), N, T, int(durs),
                     stream)
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
        return _timeline_kernel(starts, ends, works, g_eff, durs=False)
    return timeline_plain(starts, ends, works, g_eff)


def deficit_timeline_from_durs(starts, durs, works, g_eff):
    """:func:`deficit_timeline` of the windows ``[starts, starts + durs)``,
    the ends formed as one f32 add (in the kernel on the card)."""
    if resolve_mode(g_eff) == "kernel":
        return _timeline_kernel(starts, durs, works, g_eff, durs=True)
    return timeline_plain(starts, starts + durs, works, g_eff)
