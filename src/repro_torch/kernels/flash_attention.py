"""Fused attention, forward and backward: hand-written CUDA kernels and
their plain PyTorch versions.

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
  inputs to ``flash_fwd_kernel_tf32`` (``mma.sync`` TF32 products on the
  tensor cores, each f32 product split into three: a_lo b_hi + a_hi b_lo +
  a_hi b_hi with x_hi = rna_tf32(x), x_lo = rna_tf32(x - x_hi)). Both
  take hd 64 and 128; anything else raises. They serve CUDA tensors.
* :func:`attention_plain` — the dense-softmax definition in f32, chunked
  over queries so no score block exceeds :data:`PLAIN_ELEMS` elements (it
  fits at S = 2048). It serves CPU tensors.

In f32 the kernel and the plain version differ in the order of f32 sums
and in the split products' dropped terms (~2^-22 of each product). In bf16
the output rounds once, at the end, in both; the bf16 kernel also rounds
the softmax weights P to bf16 before the PV product, as the reference's
model attention does.

Both forward kernels also write the rows' log-sum-exp of the scaled scores
(``lse`` [B, H, S], f32) when asked. The backward has no TPU counterpart:
the reference's Pallas kernel is forward-only, and its training
differentiates the plain chunked attention of
``repro.models.layers.attention_train`` (``layers.py:112``) through XLA.
The port's model attention runs through the forward kernel, so a gradient
through it needs kernels of its own, in three stages: ``flash_bwd_dot``
(``D = rowsum(dO O)``), then FlashAttention-2's two passes, a dK/dV pass
and a dQ pass, each gradient summed by one CTA in a fixed order (no
atomics: the same bits on every run). bf16 inputs go to
``flash_bwd_dkdv_wgmma`` and ``flash_bwd_dq_wgmma`` (``wgmma`` on the
tensor cores, fed by a TMA ring; P and dS rounded to bf16 before their
products), f32 inputs to ``flash_bwd_dkdv_tf32`` and ``flash_bwd_dq_tf32``
(split TF32 on the tensor cores, as the f32 forward). :data:`COUNTS`
holds the launches by input type; ``LAUNCHES`` and ``BWD_LAUNCHES`` read
their totals. :class:`FlashAttentionFn` saves ``q, k, v, o, lse`` in the
forward and launches them in the backward; :func:`flash_attention` takes it
only when the mode resolves to the kernel and a gradient is needed, so
serving keeps the forward without the LSE store. On the CPU autograd runs
through :func:`attention_plain`; :func:`attention_bwd_plain` is the
backward's explicit formula, the kernels' yardstick on the card.
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

BWD_KERNELS = ("flash_bwd_dot", "flash_bwd_dkdv", "flash_bwd_dq")
# the kernel each backward stage launches, by input type (the names the
# profiler shows; the stages' counts stay under BWD_KERNELS)
BWD_KERNEL_NAMES = {
    torch.bfloat16: ("flash_bwd_dot", "flash_bwd_dkdv_wgmma",
                     "flash_bwd_dq_wgmma"),
    torch.float32: ("flash_bwd_dot", "flash_bwd_dkdv_tf32",
                    "flash_bwd_dq_tf32"),
}
ROWS_PAD = 128   # the bf16 passes' lse and D rows: padded to a multiple

# launches made by the wrappers (only there), by input type: the forward
# kernel's under "flash_fwd", each backward stage's under its BWD_KERNELS
# name
COUNTS = {dt: dict.fromkeys(("flash_fwd",) + BWD_KERNELS, 0)
          for dt in ("bfloat16", "float32")}
_COUNT_LOCK = threading.Lock()   # launches may come from several threads


def __getattr__(name: str):
    """``LAUNCHES``, the forward kernel's launches, and ``BWD_LAUNCHES``,
    each backward stage's: :data:`COUNTS` summed over the input types."""
    if name == "LAUNCHES":
        return sum(c["flash_fwd"] for c in COUNTS.values())
    if name == "BWD_LAUNCHES":
        return {k: sum(c[k] for c in COUNTS.values()) for k in BWD_KERNELS}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_launches() -> None:
    """Set the forward and backward launch counts to 0."""
    with _COUNT_LOCK:
        for counts in COUNTS.values():
            for name in counts:
                counts[name] = 0


def _chunk(B, S, H) -> int:
    """Query rows per chunk of the plain forms."""
    return max(PLAIN_ELEMS // max(B * H * S, 1), 1)


def attention_plain(q, k, v, *, causal: bool = True,
                    return_lse: bool = False):
    """Exact attention by its dense-softmax definition, in f32, in query
    chunks of at most :data:`PLAIN_ELEMS` score elements. Masked scores
    are set to :data:`NEG` before the softmax, as the reference does.
    ``return_lse``: also return the rows' log-sum-exp of the scaled scores,
    [B, H, S] f32. Autograd differentiates it (the CPU training path)."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    chunk = _chunk(B, S, H)
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
        if return_lse:
            lse[:, :, i0:i0 + qc.shape[1]] = torch.logsumexp(s, dim=-1)
    return (out, lse) if return_lse else out


def attention_bwd_plain(q, k, v, o, lse, do, *, causal: bool = True):
    """The gradients (dq, dk, dv) of :func:`attention_plain` at output
    gradient ``do``, by the explicit formula in f32, in the same query
    chunks: with P = exp(scale q k^T - lse) (masked entries 0) and D =
    rowsum(do o), dv = P^T do, dS = P (do v^T - D), dq = scale dS k, dk =
    scale dS^T q. ``o`` and ``lse`` are the forward's; the gradients come
    back in the inputs' dtypes."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    kf, vf = k.float(), v.float()
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2)    # [B, H, S]
    dq = torch.empty((B, S, H, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, S, H, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, S, H, hd), dtype=torch.float32, device=q.device)
    chunk = _chunk(B, S, H)
    kpos = torch.arange(S, device=q.device)
    for i0 in range(0, S, chunk):
        i1 = min(i0 + chunk, S)
        qc, gc = q[:, i0:i1].float(), do[:, i0:i1].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
        p = torch.exp(s - lse[:, :, i0:i1, None])
        if causal:
            p = p.masked_fill(kpos[None, :] > kpos[i0:i1, None], 0.0)
        dv += torch.einsum("bhqk,bqhd->bkhd", p, gc)
        dp = torch.einsum("bqhd,bkhd->bhqk", gc, vf)
        ds = p * (dp - dsum[:, :, i0:i1, None])
        dq[:, i0:i1] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qc) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_LAUNCH = None   # the kernels' ctypes entry points, set up at first launch


def _launcher():
    global _LAUNCH
    if _LAUNCH is None:
        from repro_torch.kernels import _build

        lib = _build.load("flash_attention")
        # pointers and the stream as c_void_p: left undeclared, ctypes
        # would pass them as 32-bit ints and cut them
        strides = ctypes.POINTER(ctypes.c_longlong)
        fwd = lib.flash_attention_launch
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                        + [strides, ctypes.c_float, ctypes.c_void_p])
        dot = lib.flash_attention_bwd_dot_launch
        dot.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                        + [strides, ctypes.c_void_p])
        bwd = lib.flash_attention_bwd_launch
        bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                        + [ctypes.c_int] * 7
                        + [strides, ctypes.c_float, ctypes.c_void_p])
        for fn in (fwd, dot, bwd):
            fn.restype = ctypes.c_int
        _LAUNCH = {"fwd": fwd, "dot": dot, "bwd": bwd}
    return _LAUNCH


def _rows_aligned(x: torch.Tensor) -> bool:
    """Whether every hd-row of ``x`` starts on a 16-byte boundary and is
    contiguous: what the f32 kernels' 16-byte copies need, and what the bf16
    kernel's tensor maps need (a 16-byte-aligned base, strides that are
    multiples of 16 bytes)."""
    vec = 16 // x.element_size()
    return (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in x.stride()[:3]))


def _check_inputs(q, others, what: str):
    """Raise unless every tensor of ``others`` (name, tensor) has q's shape,
    dtype and device, and the kernels take q's dtype, head dim and grid."""
    B, S, H, hd = q.shape
    dev = q.device
    for name, x in others:
        if x.device != dev or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(
                f"{what} kernel: {name} is {x.dtype} {tuple(x.shape)} on "
                f"{x.device}, q is {q.dtype} {tuple(q.shape)} on {dev}")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, "
                         f"got {q.dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} kernel takes head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {hd}")
    if -(-S // BQ) > 65535 or B * H >= 2 ** 31:
        raise ValueError(f"{what} kernel: S={S}, B*H={B * H} exceed its "
                         f"grid")


def _raise_on(err: int, what: str) -> None:
    if err < 0:
        raise RuntimeError(f"{what} kernel: the driver refused a tensor map "
                           f"(CUresult {-err})")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _count(dtype: torch.dtype, name: str = "flash_fwd") -> None:
    with _COUNT_LOCK:
        COUNTS[str(dtype).removeprefix("torch.")][name] += 1


def _flash_kernel(q, k, v, causal: bool, want_lse: bool = False):
    """Launch ``csrc/flash_attention.cu`` on the current stream: the
    ``wgmma`` kernel for bf16, the split-TF32 kernel for f32. Returns the
    output, and with ``want_lse`` also the rows' log-sum-exp [B, H, S]
    f32."""
    B, S, H, hd = q.shape
    dev = q.device
    _check_inputs(q, (("k", k), ("v", v)), "flash_attention")
    # the kernels read through strides; a tensor whose rows are not
    # 16-byte aligned and contiguous is copied into the plain layout first
    q, k, v = (x if _rows_aligned(x)
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if want_lse else None)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    launch = _launcher()["fwd"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                     B, S, H, hd, KERNEL_DTYPES[q.dtype], int(causal),
                     strides, hd ** -0.5, stream)
    _raise_on(err, "flash_attention")
    _count(q.dtype)
    return (out, lse) if want_lse else out


def _flash_bwd_kernel(q, k, v, o, lse, do, causal: bool):
    """Launch the three backward kernels of ``csrc/flash_attention.cu`` on
    the current stream; returns (dq, dk, dv), contiguous, in q's dtype.
    The kernels read q, k, v, o and do through their strides
    (``flash_bwd_dot`` with 16-byte loads, the bf16 passes through TMA
    tensor maps), so a tensor is copied first unless :func:`_rows_aligned`
    (a transposed dO is read in place). For bf16, ``flash_bwd_dot`` also
    writes lse in log2 units; both its outputs have rows of ``S`` rounded
    up to :data:`ROWS_PAD` (D = 0 and lse = +inf past S)."""
    B, S, H, hd = q.shape
    dev = q.device
    _check_inputs(q, (("k", k), ("v", v), ("o", o), ("do", do)),
                  "flash attention backward")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != dev:
        raise ValueError(f"flash attention backward: lse is {lse.dtype} "
                         f"{tuple(lse.shape)} on {lse.device}, expected a "
                         f"contiguous float32 {(B, H, S)} on {dev}")
    q, k, v, o, do = (x if _rows_aligned(x)
                      else x.clone(memory_format=torch.contiguous_format)
                      for x in (q, k, v, o, do))
    bf16 = q.dtype == torch.bfloat16
    pitch = -(-S // ROWS_PAD) * ROWS_PAD if bf16 else S
    dsum = torch.empty((B, H, pitch), dtype=torch.float32, device=dev)
    lse2 = torch.empty_like(dsum) if bf16 else None
    dq, dk, dv = (torch.empty((B, S, H, hd), dtype=q.dtype, device=dev)
                  for _ in range(3))
    fns = _launcher()
    dt = KERNEL_DTYPES[q.dtype]
    dot_strides = (ctypes.c_longlong * 6)(*o.stride()[:3], *do.stride()[:3])
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3])
    rows = lse2 if bf16 else lse      # the passes' LSE rows
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            rows.data_ptr(), dsum.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _raise_on(fns["dot"](o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                             dsum.data_ptr(),
                             0 if lse2 is None else lse2.data_ptr(), B, S, H,
                             hd, dt, pitch, dot_strides, stream),
                  "flash_bwd_dot")
        _count(q.dtype, "flash_bwd_dot")
        _raise_on(fns["bwd"](0, *ptrs, dk.data_ptr(), dv.data_ptr(), B, S,
                             H, hd, dt, int(causal), pitch, strides,
                             hd ** -0.5, stream), "flash_bwd_dkdv")
        _count(q.dtype, "flash_bwd_dkdv")
        _raise_on(fns["bwd"](1, *ptrs, dq.data_ptr(), 0, B, S, H, hd, dt,
                             int(causal), pitch, strides, hd ** -0.5,
                             stream), "flash_bwd_dq")
        _count(q.dtype, "flash_bwd_dq")
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        mode: str | None = None):
    """The gradients (dq, dk, dv) of attention at output gradient ``do``,
    given the forward's output ``o`` and log-sum-exp ``lse`` [B, H, S]:
    the backward kernels on CUDA tensors, :func:`attention_bwd_plain` on
    CPU tensors (``mode`` as for :func:`flash_attention`)."""
    if resolve_mode(q, mode) == "kernel":
        return _flash_bwd_kernel(q, k, v, o, lse, do, causal)
    return attention_bwd_plain(q, k, v, o, lse, do, causal=causal)


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel with its LSE store, differentiated by the
    backward kernels; saves q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = _flash_kernel(q, k, v, causal, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_kernel(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal: bool = True,
                    mode: str | None = None, return_lse: bool = False):
    """Fused attention. q/k/v: [B, S, H, hd] (kv heads already expanded).

    Returns [B, S, H, hd] in q's dtype. ``mode``: None = the CUDA kernel on
    CUDA tensors, the plain version on CPU tensors; "plain"/"kernel" force
    one (see :func:`repro_torch.kernels.backend.resolve_mode`). On the
    kernel, a call that needs a gradient goes through
    :class:`FlashAttentionFn`; any other launches the forward alone, with
    no LSE store. ``return_lse``: return (out, lse [B, H, S] f32) instead,
    with no gradient through the kernel (the comparisons of the LSE).
    """
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention takes q, k, v of one shape "
                         f"[B, S, H, hd]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if resolve_mode(q, mode) == "kernel":
        if return_lse:
            return _flash_kernel(q, k, v, causal, want_lse=True)
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v)):
            return FlashAttentionFn.apply(q, k, v, causal)
        return _flash_kernel(q, k, v, causal)
    return attention_plain(q, k, v, causal=causal, return_lse=return_lse)
