"""Fused forward attention: a hand-written CUDA kernel and its plain
PyTorch version.

For q, k, v of shape ``[B, S, H, hd]`` (kv heads already expanded), computes
exact softmax attention, causal or not, with ``scale = hd**-0.5`` applied
after the dot and the result in q's dtype. Two executors compute it
(:func:`repro_torch.kernels.backend.resolve_mode` picks one per call):

* the CUDA kernels of ``csrc/flash_attention.cu`` — the Hopper
  counterparts of the reference's Pallas ``_kernel``
  (``repro.kernels.flash_attention``): an online softmax with f32 running
  max, sum and accumulator, the ragged S edge and the causal triangle
  masked in the kernel, ``[B, S, H, hd]`` read through its strides. bf16
  inputs go to ``flash_fwd_kernel_wgmma`` (bf16 ``wgmma`` products on the
  tensor cores, K/V tiles fed by TMA through a shared-memory ring), f32
  inputs to ``flash_fwd_kernel`` (products on the CUDA cores in f32). Both
  take hd 64 and 128; anything else raises. They serve CUDA tensors.
* :func:`attention_plain` — the dense-softmax definition in f32, chunked
  over queries so no score block exceeds :data:`PLAIN_ELEMS` elements (it
  fits at S = 2048). It serves CPU tensors.

In f32 the kernel and the plain version differ only in the order of f32
sums. In bf16 the output rounds once, at the end, in both; the bf16 kernel
also rounds the softmax weights P to bf16 before the PV product, as the
reference's model attention does.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.backend import resolve_mode

NEG = -1e30             # initial running max and mask value, as the reference
BQ = 64                 # the smaller of the kernels' query tiles
PLAIN_ELEMS = 1 << 26   # largest [B, H, chunk, S] score block (plain form)
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0     # CUDA kernel launches made by flash_attention (only there)
_COUNT_LOCK = threading.Lock()   # launches may come from several threads


def attention_plain(q, k, v, *, causal: bool = True):
    """Exact attention by its dense-softmax definition, in f32, in query
    chunks of at most :data:`PLAIN_ELEMS` score elements. Masked scores
    are set to :data:`NEG` before the softmax, as the reference does."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    chunk = max(PLAIN_ELEMS // max(B * H * S, 1), 1)
    kpos = torch.arange(S, device=q.device)
    for i0 in range(0, S, chunk):
        qc = q[:, i0:i0 + chunk].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
        if causal:
            qpos = kpos[i0:i0 + qc.shape[1], None]
            s = s.masked_fill(kpos[None, :] > qpos, NEG)
        w = torch.softmax(s, dim=-1)
        out[:, i0:i0 + qc.shape[1]] = torch.einsum(
            "bhqk,bkhd->bqhd", w, vf).to(q.dtype)
    return out


_LAUNCH = None   # the kernel's ctypes entry point, set up at first launch


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from repro_torch.kernels import _build

        fn = _build.load("flash_attention").flash_attention_launch
        # pointers and the stream as c_void_p: left undeclared, ctypes
        # would pass them as 32-bit ints and cut them
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _rows_aligned(x: torch.Tensor) -> bool:
    """Whether every hd-row of ``x`` starts on a 16-byte boundary and is
    contiguous: what the f32 kernel's vector loads need, and what the bf16
    kernel's tensor maps need (a 16-byte-aligned base, strides that are
    multiples of 16 bytes)."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in x.stride()[:3]))


def _flash_kernel(q, k, v, causal: bool):
    """Launch ``csrc/flash_attention.cu`` on the current stream: the
    ``wgmma`` kernel for bf16, the CUDA-core kernel for f32."""
    global LAUNCHES
    B, S, H, hd = q.shape
    dev = q.device
    for name, x in (("k", k), ("v", v)):
        if x.device != dev or x.dtype != q.dtype:
            raise ValueError(
                f"flash_attention kernel: {name} is {x.dtype} on {x.device}, "
                f"q is {q.dtype} on {dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"flash_attention kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if -(-S // BQ) > 65535 or B * H >= 2 ** 31:
        raise ValueError(f"flash_attention kernel: S={S}, B*H={B * H} "
                         f"exceed its grid")
    # the kernels read through strides; a tensor whose rows are not
    # 16-byte aligned and contiguous is copied into the plain layout first
    q, k, v = (x if _rows_aligned(x)
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    launch = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), B, S, H, hd, KERNEL_DTYPES[q.dtype],
                     int(causal), strides, hd ** -0.5, stream)
    if err < 0:
        raise RuntimeError(f"flash_attention kernel: the driver refused a "
                           f"tensor map (CUresult {-err})")
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    mode: str | None = None):
    """Fused attention. q/k/v: [B, S, H, hd] (kv heads already expanded).

    Returns [B, S, H, hd] in q's dtype. ``mode``: None = the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors; "plain"/"kernel" force
    one (see :func:`repro_torch.kernels.backend.resolve_mode`).
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes q, k, v of one shape "
                         f"[B, S, H, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if resolve_mode(q, mode) == "kernel":
        return _flash_kernel(q, k, v, causal)
    return attention_plain(q, k, v, causal=causal)
