"""Port parity, the f32 flash kernels' arithmetic: a torch emulation of the
three-term split TF32 products that ``csrc/flash_attention.cu`` runs on
the tensor cores for f32 inputs (each operand split as x_hi = rna_tf32(x),
x_lo = rna_tf32(x - x_hi), rounded to 10 mantissa bits by bit operations
on an int32 view; a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32),
held against the reference: the forward, with the kernel's key tiles and
base-2 online softmax, against repro's Pallas ``flash_attention`` in
interpret mode at the sweep's f32 shapes within 2e-5; the backward (its
five products split the same way, on the emulated forward's output and
LSE) against ``jax.vjp`` of repro's dense oracle within 1e-4. One case
shows that a single TF32 product a_hi b_hi misses the 2e-5 gate that the
split holds, so the kernels need all three."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tf

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
from repro.kernels.flash_attention import flash_attention as r_flash  # noqa: E402
from repro.kernels.ref import flash_attention_ref as r_ref  # noqa: E402

F32_SWEEP = [                  # tests/test_kernels.py's f32 flash shapes
    (2, 128, 2, 64, True),
    (1, 256, 4, 128, True),
    (2, 200, 2, 64, False),
    (1, 130, 3, 64, True),
]
FWD_TOL = 2e-5                 # the sweep's f32 tolerance
BWD_TOL = 1e-4                 # the card's f32 backward gate
# keys per tile of the f32 forward kernel (csrc/flash_attention.cu,
# TfTiles<HD>::kFwdBK)
TF32_FWD_BK = {64: 32, 128: 16}
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = tf.NEG


def _inputs(B, S, H, hd, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, hd)).astype(np.float32)
            for _ in range(n)]


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero (``cvt.rna.tf32.f32``'s rounding of a finite value) with the
    low 13 bits cleared, as the kernels round: half a unit of the 13th bit
    added to the magnitude's bit pattern, the low 13 bits masked off."""
    u = x.float().contiguous().view(torch.int32)
    return ((u + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm3(a, b):
    """a @ b in three TF32 products summed in f32, the small terms first."""
    ah, al = split(a)
    bh, bl = split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a, b):
    """a @ b as one TF32 product."""
    return rna_tf32(a) @ rna_tf32(b)


def emulate_forward(q, k, v, causal, mm=mm3):
    """The f32 forward kernel's arithmetic: key tiles of TF32_FWD_BK[hd];
    S = Q K^T through ``mm``; an online softmax in base 2 (running max,
    from NEG, of the raw dots times scale * log2 e; P = exp2(dot * scale
    * log2 e - max), the fused multiply-add rounded once); masked scores
    an explicit 0; O += P V through ``mm`` on the unrounded f32 P; l the f32
    sum of P; acc / max(l, 1e-30). Returns (out [B, S, H, hd], lse [B, H,
    S]) with the LSE as the kernel stores it, (max + log2 l) ln 2."""
    B, S, H, hd = q.shape
    bk = TF32_FWD_BK[hd]
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    sl2 = (torch.tensor(hd ** -0.5, dtype=torch.float32)
           * torch.tensor(LOG2E, dtype=torch.float32))
    m = torch.full((B, H, S, 1), NEG)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, S, bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = (kpos <= qpos if causal
              else torch.ones(S, kt.shape[2], dtype=torch.bool))
        s = torch.where(ok, mm(qf, kt.transpose(-1, -2)), NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
        x = (s.double() * sl2.double() - m_new.double()).float()
        p = torch.where(ok, torch.exp2(x), 0.0)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm(p, vt)
        m = m_new
    out = (acc / l.clamp_min(1e-30)).transpose(1, 2)
    return out, ((m + torch.log2(l)) * LN2)[..., 0]


def emulate_backward(q, k, v, o, lse, do, causal):
    """The f32 backward kernels' arithmetic: D = rowsum(dO o) in f32; S =
    Q K^T and dP = dO V^T, P = exp2(S scale log2 e - lse log2 e) (masked
    entries 0), dS = P (dP - D); dV = P^T dO, dK = scale dS^T Q, dQ =
    scale dS K; every product split into three TF32 products."""
    B, S, H, hd = q.shape
    qf, kf, vf, gf = (x.float().transpose(1, 2) for x in (q, k, v, do))
    dsum = (do.float() * o.float()).sum(-1).transpose(1, 2)[..., None]
    lse2 = lse[..., None] * torch.tensor(LOG2E, dtype=torch.float32)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    s = mm3(qf, kf.transpose(-1, -2))
    p = torch.exp2((s.double() * sl2.double() - lse2.double()).float())
    if causal:
        p = p.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1), 0.0)
    ds = p * (mm3(gf, vf.transpose(-1, -2)) - dsum)
    dv = mm3(p.transpose(-1, -2), gf)
    dk = mm3(ds.transpose(-1, -2), qf) * scale
    dq = mm3(ds, kf) * scale
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _close_err(got, want, tol) -> float:
    """Largest |got - want| - tol |want|: allclose(rtol = atol = tol)
    holds when it is <= tol (chip_smoke.close_err)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float((np.abs(g - w) - tol * np.abs(w)).max())


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),          # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                         # below half: down
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),        # above half: up
    (2.0 - 2.0 ** -23, 2.0),                         # carries into the exponent
    (0.0, 0.0),
])
def test_rna_tf32_rounds_to_ten_mantissa_bits(x, want):
    got = rna_tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert int(got.view(torch.int32).item()) & 0x1FFF == 0


def test_split_keeps_f32_products():
    """hi + lo holds x to ~2^-22 of |x| (f32 keeps 2^-24), and a three-term
    product of two vectors stays within f32's reach of the f64 dot where
    one TF32 product does not."""
    x = torch.from_numpy(_inputs(1, 64, 1, 64, seed=3, n=1)[0]).reshape(-1)
    hi, lo = split(x)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0 ** -21
    a, b = x[:2048].reshape(32, 64), x[2048:].reshape(64, 32)
    exact = a.double() @ b.double()
    err3 = float((mm3(a, b).double() - exact).abs().max())
    err1 = float((mm1(a, b).double() - exact).abs().max())
    assert err3 < 1e-5 < err1


@pytest.mark.parametrize("B,S,H,hd,causal", F32_SWEEP)
def test_tf32_forward_matches_pallas_interpreter(B, S, H, hd, causal):
    xs = _inputs(B, S, H, hd, seed=B * S + H)
    got, _ = emulate_forward(*(torch.from_numpy(x) for x in xs), causal)
    want = r_flash(*(jnp.asarray(x) for x in xs), causal=causal,
                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("B,S,H,hd,causal", F32_SWEEP)
def test_tf32_backward_matches_jax_grad(B, S, H, hd, causal):
    xs = _inputs(B, S, H, hd, seed=B * S + H + 3)
    g = np.random.default_rng(S).standard_normal((B, S, H, hd)) \
        .astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: r_ref(q, k, v, causal=causal),
                     *(jnp.asarray(x) for x in xs))
    want = vjp(jnp.asarray(g))
    q, k, v = (torch.from_numpy(x) for x in xs)
    o, lse = emulate_forward(q, k, v, causal)
    got = emulate_backward(q, k, v, o, lse, torch.from_numpy(g), causal)
    for a, b in zip(got, want):
        assert a.shape == q.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   rtol=BWD_TOL, atol=BWD_TOL)


def test_one_tf32_product_misses_the_f32_gate():
    """The same forward with one TF32 product in place of three misses the
    2e-5 gate by far, on the same inputs the split holds it on: the kernels
    cannot drop the small terms."""
    B, S, H, hd, causal = F32_SWEEP[0]
    xs = _inputs(B, S, H, hd, seed=B * S + H)
    want = np.asarray(r_flash(*(jnp.asarray(x) for x in xs), causal=causal,
                              interpret=True), np.float32)
    q, k, v = (torch.from_numpy(x) for x in xs)
    three, _ = emulate_forward(q, k, v, causal)
    one, _ = emulate_forward(q, k, v, causal, mm=mm1)
    assert _close_err(three.numpy(), want, FWD_TOL) <= FWD_TOL
    assert _close_err(one.numpy(), want, FWD_TOL) > 10 * FWD_TOL
