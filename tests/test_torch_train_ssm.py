"""Port parity, training of the families whose backward runs through a
scan or a recurrence: Jamba (attention + Mamba + MoE groups) and xLSTM
(sLSTM + chunkwise mLSTM), one train step of each package against the
reference's (``test_torch_train_families.family_step_parity``: loss, global
norm, learning rate, gradients, m, v, parameters at the f32 tolerances
stated there), at 1 and 2 microbatches; the Mamba block's and the xLSTM
blocks' backward passes against ``jax.grad`` of the reference's functions;
(The other families' step cases are in ``test_torch_train_families.py``
and ``test_torch_train_moe.py``; split so each file stays short.)

The Mamba chunk scan is a Hillis-Steele prefix scan where the reference
runs ``lax.associative_scan``, and its products and sums run in another
order: still within rtol 1e-4, atol 1e-5 of the leaf's scale (the hybrid's
first-step gradients and the single block's agree to a few 1e-6), so no
looser bound is needed.
"""

import jax
import numpy as np
import pytest

from repro.configs import ARCHS, reduced
from repro.models import mamba as RM
from repro.models import xlstm as RX
from repro_torch.models import mamba as TM
from repro_torch.models import xlstm as TX
from test_torch_train_families import (_grads_close, _jax_grads,
                                       _torch_grads, family_step_parity)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
@pytest.mark.parametrize("mb", [1, 2])
def test_family_train_step_matches_reference(arch, mb):
    family_step_parity(arch, mb, False, False)


def test_mamba_backward_matches_reference():
    """The Mamba block (conv, the SSM's parameters, the chunk scan carried
    over three chunks) against jax.grad through ``lax.associative_scan``:
    the two scans sum in other orders, within the f32 tolerance."""
    cfg = reduced(ARCHS["jamba-v0.1-52b"])
    d = cfg.d_model
    p = jax.tree.map(lambda a: np.asarray(a[0]), RM.init_mamba(
        jax.random.PRNGKey(7), d, cfg.mamba, layers=1))
    rng = np.random.default_rng(8)
    # every constant leaf varied, so each one's gradient is tested
    p = {k: (v + rng.uniform(-0.3, 0.3, v.shape)).astype(np.float32)
         if np.ptp(v) == 0 else v for k, v in p.items()}
    S3 = 3 * cfg.mamba.chunk
    x = rng.standard_normal((2, S3, d)).astype(np.float32)
    w = rng.standard_normal((2, S3, d)).astype(np.float32)
    got, _ = _torch_grads(lambda p, x: TM.mamba_train(p, x, cfg.mamba), p,
                          x, w)
    want = _jax_grads(lambda p, x: RM.mamba_train(p, x, cfg.mamba), p, x, w)
    _grads_close(got, want, "mamba")


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_backward_matches_reference(block):
    """The chunkwise mLSTM (two chunks of 64) and the step-by-step sLSTM
    against jax.grad of the reference's (no remat in either package)."""
    cfg = reduced(ARCHS["xlstm-125m"])
    init = RX.init_mlstm if block == "mlstm" else RX.init_slstm
    p = jax.tree.map(lambda a: np.asarray(a[0]),
                     init(jax.random.PRNGKey(9), cfg, 1))
    rng = np.random.default_rng(10)
    p = {k: (v + rng.uniform(-0.3, 0.3, v.shape)).astype(np.float32)
         if np.ptp(v) == 0 else v for k, v in p.items()}
    S2 = 2 * TX.CHUNK if block == "mlstm" else 12
    x = rng.standard_normal((2, S2, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S2, cfg.d_model)).astype(np.float32)
    t_fn = TX.mlstm_train if block == "mlstm" else TX.slstm_train
    r_fn = RX.mlstm_train if block == "mlstm" else RX.slstm_train
    got, _ = _torch_grads(lambda p, x: t_fn(p, x, cfg), p, x, w)
    want = _jax_grads(lambda p, x: r_fn(p, x, cfg), p, x, w)
    _grads_close(got, want, block)
