"""Port parity, training of every model family beyond the dense decoder:
repro_torch's train step against repro's train step and ``jax.grad`` on the
CPU. This file holds the shared helpers, the VLM and Whisper step cases,
the microbatch split, the train CLI for every family and a family's state
through a checkpoint; ``test_torch_train_moe.py`` holds the MoE families
and ``test_torch_train_ssm.py`` Jamba and xLSTM (split so that each file
stays short on one test worker).

Reduced f32 configurations of every non-dense arch (granite-moe-1b-a400m,
arctic-480b, qwen2-vl-7b, jamba-v0.1-52b, xlstm-125m, whisper-large-v3).
Both packages start from the reference's ``init_state`` carried across with
``interop.load_state``, and take family batches drawn from a numpy seed
(``test_torch_families._batch``: VLM embeddings with three M-RoPE streams
that differ, Whisper frames and decoder tokens). One step of each package
compares the loss, the gradients' global norm, the learning rate, the
first step's gradients, the moments m and v and the new parameters
(``test_torch_train._step_parity``), at ``test_torch_train.py``'s
tolerances: f32 gradients allclose with rtol 1e-4 and atol 1e-5 of the
leaf's largest magnitude (the Mamba scan's Hillis-Steele order, the xLSTM
recurrences and the MoE combine all stay inside it, so no family needs a
looser bound), with one floor: a leaf whose gradient is zero by symmetry
(:data:`ZERO_LEAF_FLOOR`); bf16 ones (``--mp``) and compressed ones at two
bf16 ulps. Every family also trains with two microbatches (the VLM's
positions [3, B, S] split on their batch axis, as the reference's
``split_mb`` does), and one MoE and one non-MoE case (Whisper) run
``--mp`` with gradient compression. The train CLI takes every family, and
a family's training state carried across from the reference and saved by
the port reads back bit for bit, in the reference's bytes.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.configs as TC
from repro.checkpoint import save_checkpoint as r_save
from repro.configs import ARCHS, reduced
from repro.models import build_model as r_build
from repro.train.step import init_state as r_init
from repro_torch import interop
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.launch import train as tl
from repro_torch.models import build_model as t_build
from repro_torch.train.step import _split
from test_torch_families import _batch
from test_torch_train import (GRAD_ATOL, GRAD_RTOL, _close, _host,
                              _manifest, _members, _r_split, _step_parity)

FAMILIES = ["granite-moe-1b-a400m", "arctic-480b", "qwen2-vl-7b",
            "jamba-v0.1-52b", "xlstm-125m", "whisper-large-v3"]
B, S = 4, 16        # S a multiple of the reduced Mamba chunk (16)
# (arch, microbatches, grad_compress, mixed_precision): the VLM and
# Whisper at 1 and 2 microbatches, Whisper with --mp and compression
STEP_CASES = [(arch, mb, False, False)
              for arch in ("qwen2-vl-7b", "whisper-large-v3")
              for mb in (1, 2)]
STEP_CASES += [("whisper-large-v3", 1, True, True)]


# a leaf whose gradient is zero by symmetry holds f32 noise only (Whisper's
# key biases: a shift shared by every key leaves the softmax as it is, and
# the reference's and the port's noise differ, ~1e-9): every leaf's atol is
# at least GRAD_ATOL x this fraction of the tree's largest gradient
ZERO_LEAF_FLOOR = 1e-3


@functools.lru_cache(maxsize=None)
def r_state_of(arch, mp):
    """The reference's initial training state of ``arch`` (reduced), its
    ``init_state`` under ``jax.jit`` (one compile, not one per random
    draw), as numpy; shared by the cases of one arch."""
    rm = r_build(reduced(ARCHS[arch]), tp=16)
    return _host(jax.jit(lambda key: r_init(rm, key, mixed_precision=mp))(
        jax.random.PRNGKey(0)))


def family_step_parity(arch, mb, gc, mp):
    """One train step of both packages from the reference's initial state,
    on a family batch of seed 1 (``test_torch_train._step_parity``)."""
    _step_parity(arch, mb, gc, mp, r_state_of(arch, mp),
                 batch=_batch(reduced(ARCHS[arch]), seed=1, B=B, S=S),
                 floor=ZERO_LEAF_FLOOR)


@pytest.mark.parametrize("arch,mb,gc,mp", STEP_CASES)
def test_family_train_step_matches_reference(arch, mb, gc, mp):
    family_step_parity(arch, mb, gc, mp)


def test_split_takes_positions_on_their_batch_axis():
    """The VLM's [3, B, S] positions split on axis 1 and every other leaf
    on axis 0, as the reference's ``split_mb``; each part keeps its three
    streams."""
    batch = _batch(reduced(ARCHS["qwen2-vl-7b"]), seed=2, B=B, S=S)
    for key, leaf in batch.items():
        got = _split(key, leaf, 2)
        want = np.asarray(_r_split(jnp.asarray(leaf), 2))
        np.testing.assert_array_equal(got, want, err_msg=key)
    pos = _split("positions", batch["positions"], 2)
    assert pos.shape == (2, 3, B // 2, S)
    np.testing.assert_array_equal(pos[1], batch["positions"][:, B // 2:])


# -- helpers of the modules' backward tests --------------------------------

def _grads_close(t_grads, r_grads, what):
    _close({k: v for k, v in t_grads.items()},
           {k: np.asarray(v) for k, v in r_grads.items()},
           GRAD_RTOL, GRAD_ATOL, what=what)


def _torch_grads(fn, params, x, w):
    """Gradients of sum(fn(params, x) * w) in ``params`` and ``x``."""
    live = {k: torch.from_numpy(v.copy()).requires_grad_()
            for k, v in params.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()
    out = fn(live, xt)
    g = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                            [*live.values(), xt])
    return {**dict(zip(live, g[:-1])), "x": g[-1]}, out.detach()


def _jax_grads(fn, params, x, w):
    def f(p, x):
        return jnp.sum(fn(p, x) * w)
    gp, gx = jax.grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return {**gp, "x": gx}


# -- the driver ------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_train_cli_takes_every_family(arch, monkeypatch, tmp_path):
    """``python -m repro_torch.launch.train --arch <family> --reduced``
    trains (on the CPU here: the device resolves to it), with finite
    losses, the first within 0.5 of ln V."""
    seen = {}
    real = tl.train

    def run(cfg, **kw):
        out = real(cfg, **{**kw, "device": "cpu", "log": lambda m: None})
        seen.update(out)
        return out

    monkeypatch.setattr(tl, "train", run)
    tl.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
             "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert len(seen["losses"]) == 2
    assert all(math.isfinite(v) for v in seen["losses"] + seen["gnorms"])
    assert abs(seen["losses"][0] - math.log(512)) < 0.5


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "whisper-large-v3"])
def test_family_state_checkpoint_round_trip(arch, tmp_path):
    """A family's --mp training state (the reference's, carried across
    with load_state) saved by the port holds the reference's manifest and
    npy members byte for byte and reads back bit for bit."""
    rc = reduced(ARCHS[arch])
    r_state = r_init(r_build(rc, tp=16), jax.random.PRNGKey(2),
                     mixed_precision=True)
    tm = t_build(TC.reduced(TC.ARCHS[arch]), tp=16, device="cpu")
    state = interop.load_state(tm, _host(r_state))
    t_path = save_checkpoint(state, 3, str(tmp_path / "port"))
    r_path = r_save(r_state, 3, str(tmp_path / "ref"))
    assert _manifest(t_path) == _manifest(r_path)
    assert _members(t_path) == _members(r_path)
    back, step = load_checkpoint(t_path)
    assert step == 3
    want = interop.flatten_params(state)
    got = interop.flatten_params(back)
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        b = torch.as_tensor(got[name])
        assert b.dtype == leaf.dtype, name
        if leaf.dtype == torch.bfloat16:
            assert torch.equal(b.view(torch.int16), leaf.view(torch.int16))
        else:
            assert torch.equal(b, leaf), name
