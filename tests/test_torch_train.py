"""Port parity, LLM training: repro_torch's optimizer, train step, data
iterator, checkpoints of training states and train driver against repro's,
on the CPU (the port's attention runs its plain version under autograd).

Both packages start from one state: the reference's ``init_state`` (its
``m.init(PRNGKey(0))`` parameters) carried across with
``interop.load_state``. Tolerances, each with its reason:

* the learning rate, the global norm and one AdamW update on equal inputs:
  rtol 1e-6 (f32 ``cos``/``pow`` and sums in another order, a few ulps);
  the learning rate also atol 4 ulps of ``peak`` (near the end of a cosine
  to floor 0, 1 + cos(pi t) cancels and a relative bound alone is wrong);
* the loss: 1e-5 relative (f32 sums in another order through 4 layers,
  measured ~1e-7);
* the gradients and the moments m (= 0.1 x the clipped gradient after one
  step): allclose with rtol 1e-4 and atol 1e-5 x the leaf's largest
  magnitude (measured ~1e-6); v (the squares) rtol 2e-4. Under mixed
  precision the gradients are bf16 leaves, and a leaf's gradient is a sum
  of bf16-rounded parts (the microbatches' gradients, the embedding's
  scatter-add of token gradients) added in another order: rtol 2^-7 (two
  bf16 ulps) and atol 2^-7 x the leaf's largest gradient (the rounding of
  parts up to that size), the same for m (2^-6 for v); the global norm of
  those gradients rtol 2^-8. Gradient compression rounds every gradient
  to bf16 before m and v: the same tolerance there;
* the new parameters: Adam moves each by lr x m^/(sqrt(v^) + eps), and a
  tiny gradient that rounds to the other sign moves it by 2 lr, so no
  fixed tolerance is both safe and tight. Each parameter is held instead
  to the bound its own moments give: with a, x the port's m^ and sqrt(v^)
  and b, y the reference's, a/(x+e) - b/(y+e) = (a-b)/(x+e) +
  b (y-x)/((x+e)(y+e)), so |p - p_ref| <= lr (|a-b|/(x+e) +
  |b||y-x|/((x+e)(y+e))) plus f32 rounding (4 ulps of p and of the
  update).
  A bf16 live parameter is its master's rounding, at most half a bf16
  spacing (2^-8 |p|) from it, on each side: 2^-8 (|p| + |p_ref|) more
  (of the masters).

The reference's own training recipes run on the port too (the loss falls,
microbatch equivalence, fault-tolerant resume), and the driver
``launch.train.train`` runs reduced on the CPU: its CarbonGate plan equals
the reference's, and it resumes from its own checkpoint.
"""
import dataclasses
import json
import math
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro.checkpoint import load_checkpoint as r_load
from repro.checkpoint import save_checkpoint as r_save
from repro.configs import ARCHS, reduced
from repro.configs.base import ShapeConfig as RShape
from repro.core import generate_profile as r_generate_profile
from repro.data import SyntheticTokens as RTokens
from repro.data import make_batch_iter as r_batch_iter
from repro.models import build_model as r_build
from repro.runtime.carbon_gate import CarbonGate as RGate
from repro.runtime.carbon_gate import fleet_platform as r_fleet_platform
from repro.train import optimizer as ropt
from repro.train.step import init_state as r_init
from repro.train.step import make_train_step as r_make
from repro_torch import interop
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.data import SyntheticTokens as TTokens
from repro_torch.data import make_batch_iter as t_batch_iter
from repro_torch.launch import train as tl
from repro_torch.models import build_model as t_build
from repro_torch.runtime import FailureInjector, run_with_restarts
from repro_torch.train import optimizer as topt
from repro_torch.train.step import init_state as t_init
from repro_torch.train.step import loss_and_grads
from repro_torch.train.step import make_train_step as t_make

DENSE = ["smollm-360m", "qwen1.5-0.5b", "qwen2.5-3b", "granite-34b"]
# (arch, microbatches, grad_compress, mixed_precision): every architecture
# at 1 and 2 microbatches, with compression and mixed precision off and
# on; SmolLM also with each one switched on alone
STEP_CASES = [(arch, *c) for arch in DENSE
              for c in ((1, False, False), (2, True, True))]
STEP_CASES += [("smollm-360m", 2, False, False),
               ("smollm-360m", 1, True, False),
               ("smollm-360m", 1, False, True)]
LR_RTOL = 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_GRAD_TOL = 2.0 ** -7
BF16_NORM_RTOL = 2.0 ** -8
B1, B2, EPS = 0.9, 0.95, 1e-8       # adamw_update's defaults


def _cfgs(arch):
    return reduced(ARCHS[arch]), TC.reduced(TC.ARCHS[arch])


def _batch(vocab, B=4, S=16, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _np(tree):
    """Nested dicts of jax arrays or tensors as dotted name -> f32 numpy."""
    def f32(x):
        if isinstance(x, torch.Tensor):
            return x.detach().float().numpy()
        return np.asarray(x, np.float32)
    return {k: f32(v) for k, v in interop.flatten_params(tree).items()}


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rtol, atol_frac=GRAD_ATOL, what="", floor=0.0):
    """Every leaf allclose with ``rtol`` and an atol of ``atol_frac`` x the
    leaf's largest magnitude, or x ``floor`` times the tree's largest
    magnitude where that is more (a leaf whose gradient is zero by
    symmetry holds only f32 noise)."""
    got, want = _np(got), _np(want)
    assert sorted(got) == sorted(want), what
    top = max(float(np.abs(w).max()) for w in want.values())
    for name in want:
        atol = atol_frac * max(float(np.abs(want[name]).max()), floor * top)
        np.testing.assert_allclose(got[name], want[name], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {name}")


def _r_split(x, mb):
    """The reference train step's ``split_mb``: a [3, B, S] leaf (the VLM's
    M-RoPE positions) split on axis 1, any other leaf on axis 0."""
    if x.ndim == 3 and x.shape[0] == 3:
        return x.reshape((3, mb, -1) + x.shape[2:]).swapaxes(0, 1)
    return x.reshape((mb, x.shape[0] // mb) + x.shape[1:])


def _r_grads(rm, params, batch, mb):
    """The reference's loss and gradients, accumulated over microbatches
    as its train step does (split by its rule, f32 zeros, summed, then
    divided)."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: rm.loss(p, b)))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    if mb == 1:
        return vg(params, batch)
    gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    lsum = 0.0
    for i in range(mb):
        part = {k: _r_split(v, mb)[i] for k, v in batch.items()}
        loss, g = vg(params, part)
        gsum = jax.tree.map(jnp.add, gsum, g)
        lsum = lsum + loss
    return lsum / mb, jax.tree.map(lambda g: g / mb, gsum)


def _check_params(t_state, r_state, r_old, lr):
    """Each new parameter within the bound its moments give (module
    docstring); ``r_old`` is the common starting state."""
    t_opt, r_opt = t_state["opt"], r_state["opt"]
    t = float(np.asarray(r_opt["step"]))
    assert int(t_opt["step"]) == int(t)
    c1, c2 = 1 - B1 ** t, 1 - B2 ** t
    m_t, v_t = _np(t_opt["m"]), _np(t_opt["v"])
    m_r, v_r = _np(r_opt["m"]), _np(r_opt["v"])
    mp = "master" in r_opt
    new_t = _np(t_opt["master"] if mp else t_state["params"])
    new_r = _np(r_opt["master"] if mp else r_state["params"])
    live_t, live_r = _np(t_state["params"]), _np(r_state["params"])
    old = _np(r_old["opt"]["master"] if mp else r_old["params"])
    for name in new_r:
        a, b = m_t[name] / c1, m_r[name] / c1
        x = np.sqrt(v_t[name] / c2)
        y = np.sqrt(v_r[name] / c2)
        tol = lr * (np.abs(a - b) / (x + EPS)
                    + np.abs(b) * np.abs(y - x) / ((x + EPS) * (y + EPS)))
        # f32 rounding of the new parameter and of the update
        step_r = np.abs(b) / (y + EPS) + 0.1 * np.abs(old[name])
        tol += 4 * 2.0 ** -24 * (np.abs(new_r[name]) + lr * step_r)
        err = np.abs(new_t[name] - new_r[name])
        assert (err <= tol).all(), (name, float((err - tol).max()))
        if mp:
            tol_live = tol + 2.0 ** -8 * (np.abs(new_t[name])
                                          + np.abs(new_r[name]))
            assert (np.abs(live_t[name] - live_r[name]) <= tol_live).all(), \
                name


def _step_parity(arch, mb, gc, mp, r_state, steps_done=0, batch=None,
                 floor=0.0):
    """One train step of both packages from ``r_state``: loss, gnorm, lr,
    the gradients, m, v and the parameters. ``batch``: a token batch of
    seed ``steps_done + 1`` unless given; ``floor``: :func:`_close`'s, for
    the gradients and moments."""
    rc, tc = _cfgs(arch)
    rm = r_build(rc, tp=16)
    tm = t_build(tc, tp=16, device="cpu")
    if batch is None:
        batch = _batch(rc.vocab, seed=steps_done + 1)
    kw = dict(microbatches=mb, grad_compress=gc, warmup=2, total_steps=50)
    r_new, r_met = jax.jit(r_make(rm, **kw))(
        r_state, {k: jnp.asarray(v) for k, v in batch.items()})
    t_state = interop.load_state(tm, _host(r_state))
    t_new, t_met = t_make(tm, **kw)(t_state, batch)

    lr = float(r_met["lr"])
    np.testing.assert_allclose(float(t_met["lr"]), lr, rtol=LR_RTOL)
    np.testing.assert_allclose(float(t_met["loss"]), float(r_met["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(t_met["gnorm"]), float(r_met["gnorm"]),
                               rtol=BF16_NORM_RTOL if mp else 1e-5)
    # the gradients themselves (before compression)
    r_loss, r_g = _r_grads(rm, r_state["params"], batch, mb)
    t_loss, t_g = loss_and_grads(tm, t_state["params"], batch, mb)
    np.testing.assert_allclose(float(t_loss), float(r_loss), rtol=LOSS_RTOL)
    tol = (BF16_GRAD_TOL, BF16_GRAD_TOL) if mp else (GRAD_RTOL, GRAD_ATOL)
    _close(t_g, r_g, *tol, what="grad", floor=floor)
    # the moments carry the (compressed, clipped) gradients
    if gc:
        tol = (BF16_GRAD_TOL, BF16_GRAD_TOL)
    _close(t_new["opt"]["m"], r_new["opt"]["m"], *tol, what="m",
           floor=floor)
    _close(t_new["opt"]["v"], r_new["opt"]["v"], 2 * tol[0], 2 * tol[1],
           what="v", floor=floor ** 2)
    for name, leaf in interop.flatten_params(t_new["params"]).items():
        assert leaf.dtype == (torch.bfloat16 if mp else torch.float32), name
    _check_params(t_new, r_new, r_state, lr)


@pytest.mark.parametrize("arch,mb,gc,mp", STEP_CASES)
def test_train_step_matches_reference(arch, mb, gc, mp):
    rc, _ = _cfgs(arch)
    r_state = r_init(r_build(rc, tp=16), jax.random.PRNGKey(0),
                     mixed_precision=mp)
    _step_parity(arch, mb, gc, mp, r_state)


@pytest.mark.parametrize("mp", [False, True])
def test_step_from_a_state_after_three_reference_steps(mp):
    """A reference state taken after 3 of its steps (nonzero moments, step
    3) carries across with load_state; the fourth step matches."""
    arch = "smollm-360m"
    rc, _ = _cfgs(arch)
    rm = r_build(rc, tp=16)
    state = r_init(rm, jax.random.PRNGKey(0), mixed_precision=mp)
    step = jax.jit(r_make(rm, warmup=2, total_steps=50))
    for s in range(3):
        batch = _batch(rc.vocab, seed=s + 1)
        state, _ = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    assert int(state["opt"]["step"]) == 3
    _step_parity(arch, 1, False, mp, state, steps_done=3)


def test_remat_changes_no_gradient():
    """Per-layer recomputation (torch.utils.checkpoint) gives the gradients
    of the plain backward, within f32 reordering; the serving loss of the
    module's own parameters builds no graph."""
    tm, state = _port_state("qwen2.5-3b", 6)
    batch = _batch(tm.cfg.vocab, seed=3)
    _, g_remat = loss_and_grads(tm, state["params"], batch)
    live = topt.tree_map(lambda p: p.detach().requires_grad_(),
                         state["params"])
    loss = tm.loss(batch, params=live, remat=False)
    g = torch.autograd.grad(loss, topt.tree_leaves(live))
    for a, b in zip(topt.tree_leaves(g_remat), g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)
    served = tm.loss(batch)
    assert not served.requires_grad
    assert not any(p.requires_grad for p in tm.parameters())
    np.testing.assert_allclose(float(served), float(loss.detach()),
                               rtol=LOSS_RTOL)


def test_load_state_carries_every_leaf():
    rc, tc = _cfgs("qwen2.5-3b")
    r_state = _host(r_init(r_build(rc, tp=16), jax.random.PRNGKey(1),
                           mixed_precision=True))
    tm = t_build(tc, tp=16, device="cpu")
    state = interop.load_state(tm, r_state)
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 0
    for group in ("m", "v", "master"):
        for name, leaf in interop.flatten_params(
                state["opt"][group]).items():
            assert leaf.dtype == torch.float32, (group, name)
    flat = interop.flatten_params(r_state["params"])
    for name, leaf in interop.flatten_params(state["params"]).items():
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            leaf.view(torch.int16).numpy(),
            flat[name].view(np.int16))
    # the model holds the f32 master
    master = interop.flatten_params(r_state["opt"]["master"])
    for name, p in tm.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), master[name])
    bad = dict(r_state, opt=dict(r_state["opt"], m={
        **r_state["opt"]["m"], "ln1": r_state["opt"]["m"]["ln1"][:, :-1]}))
    with pytest.raises(ValueError, match="ln1"):
        interop.load_state(tm, bad)


# -- optimizer ---------------------------------------------------------------

def test_lr_schedule_matches_reference():
    steps = np.arange(301)
    for kw in (dict(), dict(peak=1e-2, warmup=2, total=50),
               dict(peak=3e-4, warmup=50, total=300, floor=0.0)):
        want = np.asarray(ropt.lr_schedule(jnp.asarray(steps), **kw))
        got = topt.lr_schedule(torch.as_tensor(steps), **kw)
        assert got.dtype == torch.float32
        atol = 4 * 2.0 ** -24 * kw.get("peak", 3e-4)
        np.testing.assert_allclose(got.numpy(), want, rtol=LR_RTOL,
                                   atol=atol)
    assert float(topt.lr_schedule(7, warmup=2)) == pytest.approx(
        float(ropt.lr_schedule(7, warmup=2)), rel=LR_RTOL)


def _opt_inputs(seed, mp=False):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 4)}}

    def draw(scale):
        return jax.tree.map(lambda s: (scale * rng.standard_normal(s))
                            .astype(np.float32), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))
    params, grads = draw(0.5), draw(2.0)
    opt = {"m": draw(0.1), "v": jax.tree.map(np.abs, draw(0.01)),
           "step": np.asarray(3, np.int32)}
    if mp:
        opt["master"] = params
        params = jax.tree.map(lambda p: np.asarray(p, jnp.bfloat16), params)
    return params, grads, opt


def _to_torch(tree):
    return jax.tree.map(lambda x: interop.to_tensor(x), tree)


def test_global_norm_matches_reference():
    _, grads, _ = _opt_inputs(0)
    np.testing.assert_allclose(
        float(topt.global_norm(_to_torch(grads))),
        float(ropt.global_norm(grads)), rtol=LR_RTOL)


def test_global_norm_sums_in_sorted_key_order():
    """The norm adds the leaves in sorted key order, as jax.tree.leaves
    does, whatever order the dicts were built in (a restored state's keys
    are sorted, a live one's are the model's): the same bits either
    way."""
    rng = np.random.default_rng(4)
    leaves = {k: torch.from_numpy((rng.standard_normal((50, 37)) * 10.0 **
                                   rng.uniform(-3, 3)).astype(np.float32))
              for k in "zyxwvutsrq"}
    a = topt.global_norm(leaves)
    b = topt.global_norm({k: leaves[k] for k in sorted(leaves)})
    assert torch.equal(a, b)
    np.testing.assert_allclose(float(a), float(ropt.global_norm(
        {k: v.numpy() for k, v in leaves.items()})), rtol=LR_RTOL)


def test_train_step_ignores_the_state_dicts_order():
    """A step from a state whose dicts hold their keys in another order
    (a checkpoint's sorted order) gives the same bits."""
    tm, state = _port_state("smollm-360m", 5)
    batch = _batch(tm.cfg.vocab, seed=2)

    def reorder(tree):
        if isinstance(tree, dict):
            return {k: reorder(tree[k]) for k in reversed(list(tree))}
        return tree

    step = t_make(tm)
    a, ma = step(state, batch)
    b, mb = step(reorder(state), batch)
    assert torch.equal(ma["gnorm"], mb["gnorm"])
    for name, leaf in interop.flatten_params(a).items():
        assert torch.equal(leaf, interop.flatten_params(b)[name]), name


@pytest.mark.parametrize("mp", [False, True])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference(mp, clip):
    params, grads, opt = _opt_inputs(1, mp)
    r_p, r_opt, r_n = ropt.adamw_update(params, grads, opt, 1e-3, clip=clip)
    t_p, t_opt, t_n = topt.adamw_update(
        _to_torch(params), _to_torch(grads), _to_torch(opt),
        torch.tensor(1e-3, dtype=torch.float32), clip=clip)
    np.testing.assert_allclose(float(t_n), float(r_n), rtol=LR_RTOL)
    assert int(t_opt["step"]) == int(r_opt["step"]) == 4
    assert sorted(t_opt) == sorted(r_opt)
    for key in ("m", "v") + (("master",) if mp else ()):
        _close(t_opt[key], r_opt[key], LR_RTOL, 1e-9, what=key)
    for name, leaf in interop.flatten_params(t_p).items():
        assert leaf.dtype == (torch.bfloat16 if mp else torch.float32)
    # bf16 live parameters: one rounding of masters equal to a few ulps
    _close(t_p, r_p, 2.0 ** -8 if mp else LR_RTOL, 1e-9, what="params")


def test_adamw_init_and_cast_match_reference():
    params, _, _ = _opt_inputs(2)
    for mp in (False, True):
        r = ropt.adamw_init(params, mixed_precision=mp)
        t = topt.adamw_init(_to_torch(params), mixed_precision=mp)
        assert sorted(t) == sorted(r)
        assert t["step"].dtype == torch.int32 and int(t["step"]) == 0
        for key in ("m", "v") + (("master",) if mp else ()):
            _close(t[key], r[key], 0.0, 0.0, what=key)
    cast = topt.cast_params(_to_torch(params))
    want = ropt.cast_params(params)
    for name, leaf in interop.flatten_params(cast).items():
        assert leaf.dtype == torch.bfloat16
    _close(cast, want, 0.0, 0.0, what="cast")


@pytest.mark.parametrize("enabled", [True, False])
def test_compress_grads_matches_reference(enabled):
    _, grads, _ = _opt_inputs(3)
    got = topt.compress_grads(_to_torch(grads), enabled)
    want = ropt.compress_grads(grads, enabled)
    _close(got, want, 0.0, 0.0, what="compressed")


# -- the reference's recipes on the port ----------------------------------

def _port_state(arch, seed, mp=False):
    _, tc = _cfgs(arch)
    tm = t_build(tc, tp=16, device="cpu")
    return tm, t_init(tm, torch.Generator().manual_seed(seed),
                      mixed_precision=mp)


def test_loss_decreases_when_training():
    """tests/test_models_smoke.py's recipe: a tiny dense model memorizes a
    fixed batch in a few steps."""
    tm, state = _port_state("smollm-360m", 2)
    batch = _batch(tm.cfg.vocab, seed=0)
    step = t_make(tm, microbatches=1, peak_lr=1e-2, warmup=2)
    losses = []
    for _ in range(15):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_microbatch_equivalence():
    """tests/test_models_smoke.py's recipe: mb=2 grad accumulation ~ mb=1
    on the same global batch."""
    tm, state = _port_state("qwen1.5-0.5b", 3)
    batch = _batch(tm.cfg.vocab, seed=1)
    s1, m1 = t_make(tm, microbatches=1)(state, batch)
    s2, m2 = t_make(tm, microbatches=2)(state, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-2
    a, b = _np(s1["params"]), _np(s2["params"])
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=2e-2, atol=2e-3)


def test_fault_tolerant_training_resumes(tmp_path):
    """tests/test_substrates.py's recipe: injected failures + restarts from
    checkpoints end equal to an uninterrupted run."""
    _, tc = _cfgs("smollm-360m")
    tm = t_build(tc, tp=16, device="cpu")
    src = TTokens(tc, TC.ShapeConfig("tiny", "train", 16, 4), seed=5)
    step_fn = t_make(tm, microbatches=1)
    total = 8

    def fresh():
        return t_init(tm, torch.Generator().manual_seed(0))

    ref = fresh()
    for s in range(total):
        ref, _ = step_fn(ref, src.batch(s))
    mgr = CheckpointManager(str(tmp_path), keep=2, every=1)
    inj = FailureInjector(prob_per_step=0.35, seed=3)

    def train(state, start, stop):
        for s in range(start, stop):
            inj.maybe_fail(s)
            state, _ = step_fn(state, src.batch(s))
            mgr.maybe_save(state, s)
        return state

    state, done, restarts = run_with_restarts(train, mgr, fresh, total,
                                              max_restarts=50)
    assert done == total
    assert restarts > 0, "test should exercise at least one restart"
    a, b = _np(ref["params"]), _np(state["params"])
    for name in a:
        np.testing.assert_allclose(a[name], b[name], rtol=1e-5, atol=1e-6)


def test_batch_iter_matches_reference():
    """tests/test_substrates.py's prefetch case, against the reference."""
    r, t = reduced(ARCHS["qwen1.5-0.5b"]), TC.reduced(TC.ARCHS["qwen1.5-0.5b"])
    shape = RShape("tiny", "train", 8, 2)
    want_it = r_batch_iter(RTokens(r, shape, seed=1), start_step=3)
    got_it = t_batch_iter(TTokens(t, TC.ShapeConfig("tiny", "train", 8, 2),
                                  seed=1), start_step=3)
    for _ in range(3):
        (s_w, b_w), (s_g, b_g) = next(want_it), next(got_it)
        assert s_g == s_w
        assert sorted(b_g) == sorted(b_w)
        for key in b_w:
            np.testing.assert_array_equal(b_g[key], b_w[key])
    want_it.close()
    got_it.close()


# -- checkpoints of training states -------------------------------------------

def _members(path):
    with zipfile.ZipFile(os.path.join(path, "arrays.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_checkpoint_members_are_np_savez_bytes(tmp_path):
    """The port writes each npz member itself (straight from the array);
    the bytes are np.savez's, the reference's writer, for every layout a
    leaf can have."""
    leaves = {"f": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
              "s": np.asarray(7, np.int32),
              "e": np.zeros((0, 3), np.float32),
              "v": np.arange(10, dtype=np.float32)[::2],
              "b": np.array([True, False]),
              "t": np.random.default_rng(0).standard_normal((3, 4, 5))}
    path = save_checkpoint(leaves, 1, str(tmp_path / "port"))
    keys = {p: m["key"] for p, m in _manifest(path)["leaves"].items()}
    np.savez(tmp_path / "ref.npz", **{keys[p]: v for p, v in leaves.items()})
    with zipfile.ZipFile(tmp_path / "ref.npz") as z:
        want = {n: z.read(n) for n in z.namelist()}
    assert _members(path) == want
    got, _ = load_checkpoint(path)
    for p, v in leaves.items():
        np.testing.assert_array_equal(got[p], v)
        assert got[p].dtype == v.dtype and got[p].flags.writeable


def test_checkpoint_bf16_round_trip(tmp_path):
    """A --mp state (bf16 live parameters, f32 master and moments) saved by
    the port reads back bit for bit, bf16 leaves as bf16 tensors."""
    _, state = _port_state("smollm-360m", 0, mp=True)
    got, step = load_checkpoint(save_checkpoint(state, 4, str(tmp_path)))
    assert step == 4
    for name, leaf in interop.flatten_params(state["params"]).items():
        back = interop.flatten_params(got["params"])[name]
        assert back.dtype == torch.bfloat16
        assert torch.equal(back.view(torch.int16), leaf.view(torch.int16))
    for name, leaf in interop.flatten_params(state["opt"]["master"]).items():
        np.testing.assert_array_equal(
            interop.flatten_params(got["opt"]["master"])[name], leaf.numpy())
    assert int(got["opt"]["step"]) == 0


def test_checkpoint_bf16_across_packages(tmp_path):
    """The reference's --mp state written by the reference reads back in
    the port bit for bit; written by the port, the reference reads the same
    shapes, and both packages write the same manifest and the same npy
    members, byte for byte."""
    rc, tc = _cfgs("smollm-360m")
    r_state = r_init(r_build(rc, tp=16), jax.random.PRNGKey(0),
                     mixed_precision=True)
    r_path = r_save(r_state, 2, str(tmp_path / "ref"))
    got, step = load_checkpoint(r_path)
    assert step == 2
    flat = interop.flatten_params(_host(r_state["params"]))
    for name, leaf in interop.flatten_params(got["params"]).items():
        assert leaf.dtype == torch.bfloat16
        np.testing.assert_array_equal(leaf.view(torch.int16).numpy(),
                                      flat[name].view(np.int16))
    t_state = interop.load_state(t_build(tc, tp=16, device="cpu"),
                                 _host(r_state))
    t_path = save_checkpoint(t_state, 2, str(tmp_path / "port"))
    assert _manifest(t_path) == _manifest(r_path)
    assert _members(t_path) == _members(r_path)
    back, _ = r_load(t_path)
    want, _ = r_load(r_path)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.tobytes() == b.tobytes()


# -- the train driver ----------------------------------------------------------

def _reduced_cfg():
    return dataclasses.replace(TC.reduced(TC.ARCHS["smollm-360m"]),
                               dtype="float32")


def test_train_driver_gate_plan_matches_reference(tmp_path):
    """``train(carbon_gate=True)`` on the CPU: finite losses, and the gate
    plan's cost and ASAP cost equal the reference CLI's CarbonGate for the
    same horizon (launch/train.py: one pod, S1 over 3 x steps, chunks of
    ``gate_chunk`` steps)."""
    steps, chunk = 6, 2
    out = tl.train(_reduced_cfg(), steps=steps, batch=4, seq=16,
                   carbon_gate=True, gate_chunk=chunk,
                   ckpt_dir=str(tmp_path), ckpt_every=50, device="cpu",
                   log=lambda m: None)
    assert out["start"] == 0 and len(out["losses"]) == steps
    assert all(math.isfinite(x) for x in out["losses"] + out["gnorms"])
    assert abs(out["losses"][0] - math.log(512)) < 0.5
    plat = r_fleet_platform(1, 100, 250, chips_per_pod=256)
    prof = r_generate_profile("S1", 3 * steps, plat, J=24, seed=7,
                              work_capacity=int(plat.p_work[0]))
    plan = RGate(prof, plat).make_plan([[chunk] * -(-steps // chunk)])
    assert out["gate"]["cost"] == plan.cost
    assert out["gate"]["asap_cost"] == plan.asap_cost


@pytest.mark.parametrize("mp", [False, True])
def test_train_driver_resumes_from_its_checkpoint(tmp_path, mp):
    cfg = _reduced_cfg()
    kw = dict(batch=4, seq=16, ckpt_dir=str(tmp_path), ckpt_every=2,
              device="cpu", mp=mp, log=lambda m: None)
    first = tl.train(cfg, steps=4, **kw)       # saves steps 0 and 2
    assert first["start"] == 0 and len(first["losses"]) == 4
    again = tl.train(cfg, steps=6, **kw)
    assert again["start"] == 3 and len(again["losses"]) == 3
    leaf = again["state"]["params"]["embed"]
    assert leaf.dtype == (torch.bfloat16 if mp else torch.float32)
    assert int(again["state"]["opt"]["step"]) == 6


def test_train_cli_mesh_is_the_multi_device_slice():
    """``--mesh single`` on a one-process world stops with the production
    mesh's ``ValueError`` naming (16, 16), as the reference does without
    the chips, and leaves no process group behind."""
    import torch.distributed as dist
    with pytest.raises(ValueError, match=r"\(16, 16\)"):
        tl.main(["--mesh", "single"])
    assert not dist.is_initialized()


def test_train_needs_the_card(monkeypatch, tmp_path):
    """``device=None`` means the card: without one, training raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.train(_reduced_cfg(), steps=1, ckpt_dir=str(tmp_path))


@pytest.mark.parametrize("mp", [False, True])
def test_donating_step_is_the_functional_step(mp):
    """``make_train_step(donate=True)`` writes the new parameters and
    moments into the state it is given: the same bits as the functional
    step, returned in the given tensors."""
    tm, state = _port_state("qwen2.5-3b", 7, mp=mp)
    batch = _batch(tm.cfg.vocab, seed=5)
    want, m_want = t_make(tm, microbatches=2)(state, batch)
    given = topt.tree_map(lambda x: x.clone(), state)
    got, m_got = t_make(tm, microbatches=2, donate=True)(given, batch)
    assert torch.equal(m_got["gnorm"], m_want["gnorm"])
    flat_want = interop.flatten_params(want)
    flat_got = interop.flatten_params(got)
    flat_given = interop.flatten_params(given)
    assert sorted(flat_got) == sorted(flat_want)
    for name, leaf in flat_want.items():
        assert torch.equal(flat_got[name], leaf), name
        if not name.endswith("step"):
            assert flat_got[name].data_ptr() == flat_given[name].data_ptr()
