"""Port parity, flash attention: repro_torch's plain attention against
repro's Pallas flash_attention (run in interpret mode on the CPU, as
tests/test_kernels.py runs it) and its dense jnp oracle, at the reference
sweep's five shapes and tolerances (2e-5 for f32, 2e-2 for bf16); an
emulation of the bf16 CUDA kernel's arithmetic (P rounded to bf16 before
PV) against the same interpreter; the wrapper's dispatch and checks; and
the hand-written CUDA kernels against the plain version on the card.

The backward: the plain version's explicit formula
(``attention_bwd_plain``) and torch autograd through ``attention_plain``
against ``jax.vjp`` of repro's dense oracle and of its model attention
(``repro.models.layers._gqa_scores_out``), at the sweep's shapes, f32 and
bf16, within the sweep's tolerances (the reference's bf16 forms round the
scores, or the softmax weights, to bf16: 2e-2 covers it as it does the
forward); the plain LSE against ``jax.nn.logsumexp`` of the reference's
scores (2e-5: f32 sums in another order); and on the card, the kernels'
LSE and backward against the plain versions (f32 allclose 1e-4, bf16
2e-2 in relative norm, the LSE 1e-4 absolute)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tf
from repro_torch.kernels.ref import flash_attention_ref as t_ref

try:
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import flash_attention as r_flash
    from repro.kernels.ref import flash_attention_ref as r_ref
    from repro.models.layers import _gqa_scores_out as r_gqa
except ImportError:
    # the GPU host has no JAX; there `-m cuda` selects only the kernel
    # tests below, which need neither jax nor repro
    jnp = None

SWEEP = [                      # tests/test_kernels.py's flash sweep
    (2, 128, 2, 64, True, "float32"),
    (1, 256, 4, 128, True, "float32"),
    (2, 200, 2, 64, False, "float32"),     # non-multiple S (padding path)
    (1, 384, 1, 128, True, "bfloat16"),
    (1, 130, 3, 64, True, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bf16 twins of the sweep's f32 shapes (non-causal, ragged, S = 128 / 256)
BF16_TWINS = [c[:5] + ("bfloat16",) for c in SWEEP if c[5] == "float32"]
# keys per tile of the bf16 kernel (csrc/flash_attention.cu, Layout<HD>::kBK)
WGMMA_BK = {64: 128, 128: 64}
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# the bf16 backward kernels' tiles (csrc/flash_attention.cu): queries per
# ring tile of the dK/dV pass (kBwdQ) and keys per ring tile of the dQ pass
# (BwdQLayout<HD>::kBK)
WGMMA_BWD_BQ = 64
WGMMA_BWD_BK = {64: 128, 128: 64}


def _inputs(B, S, H, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(3)]


def _torch(xs, dtype):
    return [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]


def _jax(xs, dtype):
    return [jnp.asarray(x, getattr(jnp, dtype)) for x in xs]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("B,S,H,hd,causal,dtype", SWEEP)
def test_plain_matches_pallas_interpreter(B, S, H, hd, causal, dtype):
    xs = _inputs(B, S, H, hd, seed=B * S + H)
    got = tf.flash_attention(*_torch(xs, dtype), causal=causal)
    assert got.shape == (B, S, H, hd)
    assert got.dtype == getattr(torch, dtype)
    want = r_flash(*_jax(xs, dtype), causal=causal, interpret=True)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,hd,causal,dtype", SWEEP)
def test_plain_matches_jnp_oracle(B, S, H, hd, causal, dtype):
    xs = _inputs(B, S, H, hd, seed=B * S + H + 1)
    got = t_ref(*_torch(xs, dtype), causal=causal)
    want = r_ref(*_jax(xs, dtype), causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _emulate_bf16_kernel(q, k, v, causal, return_lse=False):
    """The bf16 kernel's arithmetic in torch: key tiles of WGMMA_BK[hd], an
    online softmax in f32 in base 2 (the running max, from NEG, of the raw
    dots times scale * log2 e; P = exp2(dot * scale * log2 e - max)),
    masked scores as an explicit 0, P rounded to bf16 before the PV product
    with f32 accumulation, l the f32 sum of the unrounded P, and
    acc / max(l, 1e-30) rounded once. ``return_lse``: also the rows' LSE
    as the kernel stores it, (max + log2 l) ln 2, [B, H, S] f32. Only this
    test file uses it."""
    B, S, H, hd = q.shape
    bk = WGMMA_BK[hd]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B,H,S,hd]
    sl2 = (torch.tensor(hd ** -0.5, dtype=torch.float32)
           * torch.tensor(LOG2E, dtype=torch.float32))
    m = torch.full((B, H, S, 1), tf.NEG)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = (kpos <= qpos if causal
              else torch.ones(S, kt.shape[2], dtype=torch.bool))
        s = torch.where(ok, qf @ kt.transpose(-1, -2), tf.NEG)   # raw dots
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        # s * sl2 - m_new rounded once, as the kernel's fused multiply-add
        x = (s.double() * sl2.double() - m_new.double()).float()
        p = torch.where(ok, torch.exp2(x), 0.0)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vt
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype).transpose(1, 2)
    if return_lse:
        return out, ((m + torch.log2(l)) * LN2)[..., 0]
    return out


@pytest.mark.parametrize("B,S,H,hd,causal", [c[:5] for c in SWEEP])
def test_bf16_kernel_arithmetic_matches_pallas_interpreter(B, S, H, hd,
                                                          causal):
    """Rounding P to bf16 before PV, as the bf16 kernel does, keeps the
    result within the sweep's bf16 tolerance of the reference kernel."""
    xs = _inputs(B, S, H, hd, seed=B * S + H + 2)
    got = _emulate_bf16_kernel(*_torch(xs, "bfloat16"), causal=causal)
    assert got.shape == (B, S, H, hd) and got.dtype == torch.bfloat16
    want = r_flash(*_jax(xs, "bfloat16"), causal=causal, interpret=True)
    tol = TOL["bfloat16"]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_query_chunks_change_nothing(causal, monkeypatch):
    """The plain version's query chunking (forced to 7 rows) gives the
    unchunked result bit for bit: each query row is computed alone."""
    q, k, v = _torch(_inputs(2, 45, 3, 16, seed=5), "float32")
    whole = tf.attention_plain(q, k, v, causal=causal)
    monkeypatch.setattr(tf, "PLAIN_ELEMS", 2 * 3 * 45 * 7)
    chunked = tf.attention_plain(q, k, v, causal=causal)
    assert torch.equal(whole, chunked)


def test_plain_is_causal():
    """Keys after a query do not move its output."""
    q, k, v = _torch(_inputs(1, 40, 2, 16, seed=9), "float32")
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:] = 3.0
    v2[:, 20:] = -7.0
    a = tf.flash_attention(q, k, v, causal=True)
    b = tf.flash_attention(q, k2, v2, causal=True)
    assert torch.equal(a[:, :20], b[:, :20])
    assert not torch.equal(a[:, 20:], b[:, 20:])


def test_dispatch_and_checks():
    q, k, v = _torch(_inputs(1, 8, 2, 64, seed=1), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        tf.flash_attention(q, k, v, mode="kernel")
    with pytest.raises(ValueError, match="unknown kernel mode"):
        tf.flash_attention(q, k, v, mode="fast")
    with pytest.raises(ValueError, match="one shape"):
        tf.flash_attention(q, k[:, :4], v)
    before = tf.LAUNCHES
    out = tf.flash_attention(q, k, v, mode="plain")
    assert torch.equal(out, tf.flash_attention(q, k, v))   # CPU = plain
    assert tf.LAUNCHES == before                            # no kernel


def test_rows_aligned():
    """What the kernel may read through its strides without a copy."""
    x = torch.zeros(2, 16, 3, 4, 64)
    q = x[:, :, 0]                              # rows 3 * 4 * 64 apart
    assert not q.is_contiguous() and tf._rows_aligned(q)
    assert not tf._rows_aligned(x.flatten()[1:1 + 2 * 16 * 4 * 64]
                                .view(2, 16, 4, 64))
    assert not tf._rows_aligned(x[..., 0, :].transpose(-1, -2)
                                .contiguous().transpose(-1, -2))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernels against the plain version on the card: the sweep's
    shapes and tolerances, their bf16 twins, the model's shape in bf16 and
    f32, strided views in f32 and bf16, and one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = SWEEP + BF16_TWINS + [(4, 2048, 16, 64, True, dt)
                                  for dt in ("bfloat16", "float32")]
    before = tf.LAUNCHES
    for B, S, H, hd, causal, dtype in cases:
        q, k, v = (x.to(dev) for x in _torch(_inputs(B, S, H, hd, seed=S),
                                               dtype))
        got = tf.flash_attention(q, k, v, causal=causal)
        want = tf.flash_attention(q, k, v, causal=causal, mode="plain")
        torch.cuda.synchronize()
        tol = TOL[dtype]
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                                   rtol=tol, atol=tol)
    qkv = torch.randn(2, 300, 3, 4, 128, device=dev)
    for dtype in ("float32", "bfloat16"):     # rows 3 H hd apart: no copy
        q, k, v = qkv.to(getattr(torch, dtype)).unbind(2)
        assert not q.is_contiguous() and tf._rows_aligned(q)
        got = tf.flash_attention(q, k, v, causal=False)
        want = tf.flash_attention(q, k, v, causal=False, mode="plain")
        tol = TOL[dtype]
        np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                                   rtol=tol, atol=tol)
    assert tf.LAUNCHES - before == len(cases) + 2
    with pytest.raises(ValueError, match="head_dim"):
        tf.flash_attention(*[x[..., :32].contiguous() for x in (q, k, v)])
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tf.flash_attention(*[x.half() for x in (q, k, v)])


# -- backward ----------------------------------------------------------------

BWD_F32_TOL = 1e-4        # kernels vs plain on the card (f32, allclose)
LSE_TOL = 1e-4            # kernels' LSE vs plain on the card (absolute)


@pytest.mark.parametrize("reference", ["oracle", "model_attention"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,hd,causal", [c[:5] for c in SWEEP])
def test_plain_backward_matches_jax_grad(B, S, H, hd, causal, dtype,
                                         reference):
    xs = _inputs(B, S, H, hd, seed=B * S + H + 3)
    g = np.random.default_rng(S).standard_normal((B, S, H, hd)) \
        .astype(np.float32)
    fn = r_ref if reference == "oracle" else r_gqa
    _, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal=causal),
                     *_jax(xs, dtype))
    want = vjp(jnp.asarray(g, getattr(jnp, dtype)))
    q, k, v = _torch(xs, dtype)
    do = torch.from_numpy(g).to(q.dtype)
    o, lse = tf.attention_plain(q, k, v, causal=causal, return_lse=True)
    explicit = tf.attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(
        tf.flash_attention(*leaves, causal=causal), leaves, do)
    tol = TOL[dtype]
    for got in (explicit, auto):
        for a, b in zip(got, want):
            assert a.dtype == q.dtype and a.shape == q.shape
            np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _emulate_bf16_bwd_kernels(q, k, v, o, lse, do, causal):
    """The bf16 backward kernels' arithmetic in torch: D = rowsum(do o) and
    lse2 = lse * log2 e in f32 (flash_bwd_dot); P = exp2(dot * scale *
    log2 e - lse2) from the raw f32 dots (the fused multiply-add rounded
    once), masked entries 0; dS = P (dP - D) from the f32 P; P and dS
    rounded to bf16 before their products, with f32 sums over the dK/dV
    pass's query tiles of WGMMA_BWD_BQ and the dQ pass's key tiles of
    WGMMA_BWD_BK[hd]; dq and dk times scale, then each gradient rounded
    once. Only this test file uses it."""
    B, S, H, hd = q.shape
    qf, kf, vf, gf = (x.float().transpose(1, 2) for x in (q, k, v, do))
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    lse2 = lse[..., None] * torch.tensor(LOG2E, dtype=torch.float32)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    s = qf @ kf.transpose(-1, -2)                       # [B, H, S, S]
    p = torch.exp2((s.double() * sl2.double() - lse2.double()).float())
    if causal:
        p = p.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), 0.0)
    ds = p * (gf @ vf.transpose(-1, -2) - dsum)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dq, dk, dv = (torch.zeros_like(qf) for _ in range(3))
    for i0 in range(0, S, WGMMA_BWD_BQ):        # the dK/dV pass's ring
        i1 = min(i0 + WGMMA_BWD_BQ, S)
        dv += pb[..., i0:i1, :].transpose(-1, -2) @ gf[..., i0:i1, :]
        dk += dsb[..., i0:i1, :].transpose(-1, -2) @ qf[..., i0:i1, :]
    bk = WGMMA_BWD_BK[hd]
    for k0 in range(0, S, bk):                  # the dQ pass's ring
        dq += dsb[..., k0:k0 + bk] @ kf[..., k0:k0 + bk, :]
    return tuple(x.transpose(1, 2).to(q.dtype)
                 for x in (dq * scale, dk * scale, dv))


@pytest.mark.parametrize("reference", ["oracle", "model_attention"])
@pytest.mark.parametrize("B,S,H,hd,causal", [c[:5] for c in SWEEP])
def test_bf16_bwd_kernel_arithmetic_matches_jax_grad(B, S, H, hd, causal,
                                                     reference):
    """Rounding P and dS to bf16 before their products, as the bf16
    backward kernels do, on the (o, lse) of the bf16 forward kernel's
    arithmetic, keeps the gradients within the sweep's bf16 tolerance of
    jax.vjp of the reference's attention (computed as
    test_plain_backward_matches_jax_grad computes it)."""
    xs = _inputs(B, S, H, hd, seed=B * S + H + 3)
    g = np.random.default_rng(S).standard_normal((B, S, H, hd)) \
        .astype(np.float32)
    fn = r_ref if reference == "oracle" else r_gqa
    _, vjp = jax.vjp(lambda q, k, v: fn(q, k, v, causal=causal),
                     *_jax(xs, "bfloat16"))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    q, k, v = _torch(xs, "bfloat16")
    do = torch.from_numpy(g).to(torch.bfloat16)
    o, lse = _emulate_bf16_kernel(q, k, v, causal, return_lse=True)
    got = _emulate_bf16_bwd_kernels(q, k, v, o, lse, do, causal)
    tol = TOL["bfloat16"]
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16 and a.shape == q.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,hd,causal", [c[:5] for c in SWEEP])
def test_plain_lse_matches_jax_logsumexp(B, S, H, hd, causal):
    xs = _inputs(B, S, H, hd, seed=B * S + H + 4)
    q, k, _ = (jnp.asarray(x) for x in xs)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None], s,
                      -1e30)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    _, lse = tf.flash_attention(*_torch(xs, "float32"), causal=causal,
                                return_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=TOL["float32"],
                               atol=TOL["float32"])


def test_backward_dispatch_on_the_cpu():
    """On CPU tensors every entry point takes the plain version and counts
    no launch; asking for the kernels raises."""
    q, k, v = (x.requires_grad_() for x in _torch(_inputs(1, 24, 2, 64, 6),
                                                  "float32"))
    tf.reset_launches()
    o, lse = tf.flash_attention(q, k, v, return_lse=True)
    assert torch.equal(o, tf.attention_plain(q, k, v))
    do = torch.ones_like(o)
    got = tf.flash_attention_bwd(q, k, v, o, lse, do)
    want = tf.attention_bwd_plain(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.autograd.grad(tf.flash_attention(q, k, v).sum(), (q, k, v))
    assert tf.LAUNCHES == 0
    assert tf.BWD_LAUNCHES == dict.fromkeys(tf.BWD_KERNELS, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tf.flash_attention_bwd(q, k, v, o, lse, do, mode="kernel")


@pytest.mark.parametrize("shape", [(0, 32, 2, 64), (2, 0, 2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_shard_launches_nothing(shape, dtype, monkeypatch):
    """An empty local shard (B == 0: a rank that holds no rows of a
    microbatch split unevenly; or S == 0): the kernel paths (the forward,
    its LSE, the backward and FlashAttentionFn, called as the wrappers
    call them on CUDA tensors) return the plain version's empty outputs,
    of its shapes and dtypes, and empty (all-zero) gradients, without a
    launch: the launcher is never reached and no count moves. The public
    wrapper on such CPU tensors (the plain version) gives the same."""
    def no_launch():
        raise AssertionError("an empty shard reached the launcher")

    monkeypatch.setattr(tf, "_launcher", no_launch)
    dt = getattr(torch, dtype)
    q, k, v = (torch.zeros(shape, dtype=dt).requires_grad_()
               for _ in range(3))
    tf.reset_launches()
    o_p, lse_p = tf.attention_plain(q, k, v, return_lse=True)
    o, lse = tf._flash_kernel(q, k, v, True, want_lse=True)
    assert (o.shape, o.dtype, lse.shape, lse.dtype) \
        == (o_p.shape, o_p.dtype, lse_p.shape, lse_p.dtype)
    assert tf._flash_kernel(q, k, v, True).shape == o_p.shape
    do = torch.zeros_like(o_p)
    want = tf.attention_bwd_plain(q, k, v, o_p, lse_p, do)
    got = tf._flash_bwd_kernel(q, k, v, o, lse, do, True)
    fn = tf.FlashAttentionFn.apply(q, k, v, True)
    through = torch.autograd.grad(fn.sum(), (q, k, v))
    out = tf.flash_attention(q, k, v)
    assert (out.shape, out.dtype) == (o_p.shape, o_p.dtype)
    # the plain version's S == 0 output takes no part in the graph (its
    # query loop never runs); its B == 0 one does
    public = torch.autograd.grad(out.sum(), (q, k, v)) if shape[0] == 0 \
        else want
    for grads in (got, through, public):
        for g, w in zip(grads, want):
            assert (g.shape, g.dtype) == (w.shape, w.dtype) == (q.shape, dt)
            assert not g.any()
    assert tf.LAUNCHES == 0
    assert tf.BWD_LAUNCHES == dict.fromkeys(tf.BWD_KERNELS, 0)


@pytest.mark.parametrize("chunk_rows", [7, 45])
def test_plain_backward_chunks_change_nothing(chunk_rows, monkeypatch):
    """The plain backward's query chunks sum dk and dv chunk by chunk; the
    gradients stay within f32 reordering of the unchunked ones."""
    q, k, v, do = _torch(_inputs(2, 45, 3, 16, seed=8) + [
        np.random.default_rng(9).standard_normal((2, 45, 3, 16))
        .astype(np.float32)], "float32")
    o, lse = tf.attention_plain(q, k, v, return_lse=True)
    whole = tf.attention_bwd_plain(q, k, v, o, lse, do)
    monkeypatch.setattr(tf, "PLAIN_ELEMS", 2 * 3 * 45 * chunk_rows)
    chunked = tf.attention_bwd_plain(q, k, v, o, lse, do)
    for a, b in zip(chunked, whole):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.cuda
def test_cuda_backward_matches_plain():
    """The forward kernels' LSE and the backward kernels against the plain
    versions on the card: the sweep's shapes and their bf16 twins, the
    model's shape in both types and in bf16 at hd=128, the training cell's
    shape (B=8, S=256, H=16, bf16), strided views and output gradients (one
    transposed, read in place; one with a strided head dim and one whose
    rows are not 16-byte aligned, both copied), each backward bitwise equal
    to a second one of the same inputs, and autograd through
    FlashAttentionFn, one launch of each backward kernel per backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on the GPU host)")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = SWEEP + BF16_TWINS + [(4, 2048, 16, 64, True, dt)
                                  for dt in ("bfloat16", "float32")]
    cases += [(4, 2048, 8, 128, True, "bfloat16"),
              (8, 256, 16, 64, True, "bfloat16")]

    def check(q, k, v, do, causal):
        o, lse = tf.flash_attention(q, k, v, causal=causal, return_lse=True)
        _, lse_p = tf.flash_attention(q, k, v, causal=causal, mode="plain",
                                      return_lse=True)
        assert float((lse - lse_p).abs().max()) <= LSE_TOL
        got = tf.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        again = tf.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        want = tf.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                      mode="plain")
        for a, b in zip(got, want):
            assert a.dtype == q.dtype and a.shape == q.shape
            if q.dtype == torch.float32:
                np.testing.assert_allclose(_np(a.cpu()), _np(b.cpu()),
                                           rtol=BWD_F32_TOL, atol=BWD_F32_TOL)
            else:
                assert float((a.float() - b.float()).norm()
                             / b.float().norm()) <= TOL["bfloat16"]

    tf.reset_launches()
    for B, S, H, hd, causal, dtype in cases:
        q, k, v, do = (x.to(dev) for x in _torch(
            _inputs(B, S, H, hd, seed=S) + _inputs(B, S, H, hd, seed=S + 1)
            [:1], dtype))
        check(q, k, v, do, causal)
    qkv = torch.randn(2, 300, 3, 4, 128, device=dev)
    for dtype in ("float32", "bfloat16"):
        q, k, v = qkv.to(getattr(torch, dtype)).unbind(2)
        do_t = torch.randn(2, 4, 300, 128, device=dev).to(q.dtype) \
            .transpose(1, 2)
        do_s = torch.randn(2, 300, 4, 256, device=dev).to(q.dtype)[..., ::2]
        # rows 132 elements apart: 264 bytes in bf16, not a multiple of 16
        do_u = torch.randn(2, 300, 4, 132, device=dev).to(q.dtype)[..., :128]
        assert do_u.stride(-1) == 1 and (q.dtype == torch.float32
                                         or not tf._rows_aligned(do_u))
        for do in (do_t, do_s, do_u):
            check(q, k, v, do, causal=True)
    n = 2 * (len(cases) + 6)         # check() runs two backwards
    assert tf.BWD_LAUNCHES == dict.fromkeys(tf.BWD_KERNELS, n)
    x = torch.randn(2, 300, 3, 4, 64, device=dev, requires_grad=True)
    w = torch.randn(2, 300, 4, 64, device=dev)
    got = torch.autograd.grad((tf.flash_attention(*x.unbind(2)) * w).sum(),
                              x)[0]
    assert tf.BWD_LAUNCHES == dict.fromkeys(tf.BWD_KERNELS, n + 1)
    want = torch.autograd.grad((tf.flash_attention(
        *x.unbind(2), mode="plain") * w).sum(), x)[0]
    np.testing.assert_allclose(_np(got.cpu()), _np(want.cpu()),
                               rtol=BWD_F32_TOL, atol=BWD_F32_TOL)
