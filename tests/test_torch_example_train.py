"""The port's training example (``repro_torch.examples.train_carbon_aware``)
against the reference's ``examples/train_carbon_aware.py`` on the CPU, at
``--steps 70 --chunk 10 --batch 2 --seq 32 --inject-failure``, each side
with its own fresh checkpoint directory: the same printed lines (the
carbon plan's costs, the gate's waits, the parameter count, each logged
step's lr as printed, the one restart at step 61 and the simulated
clock), with the wall times masked and the logged losses within
``LOSS_RTOL``. The reference's initial state is carried across
(``interop.load_state``)."""
import re

import jax
import numpy as np

from repro_torch import interop
from test_torch_example_quickstart import (  # noqa: F401
    load_reference, masked, one_torch_thread, port_example, printed,
    run_reference)

ARGV = ["--steps", "70", "--chunk", "10", "--batch", "2", "--seq", "32",
        "--inject-failure"]
# 70 steps of AdamW from one state: the loss of two frameworks drifts
# further than one step's (tests/test_torch_train.py's LOSS_RTOL, 1e-5)
LOSS_RTOL = 1e-4
LOSS = re.compile(r"loss=(\d+\.\d{4})")
MASKS = [(r"\(\d+\.\ds wall\)", "(<s> wall)"), (LOSS.pattern, "loss=<loss>")]


def _losses(lines):
    return [float(m.group(1)) for line in lines
            for m in [LOSS.search(line)] if m]


def test_train_prints_the_reference_s_lines(monkeypatch, capsys, tmp_path):
    ref, port = load_reference("train_carbon_aware"), \
        port_example("train_carbon_aware")
    want = run_reference(ref, monkeypatch, capsys,
                         ARGV + ["--ckpt-dir", str(tmp_path / "ref")])
    # the reference's initial state, as its example draws it
    r_model = ref.build_model(ref.model_config("10m"), tp=16)
    ref_state = jax.tree.map(np.asarray,
                             ref.init_state(r_model, jax.random.PRNGKey(0)))

    args = port.parse_args(ARGV + ["--ckpt-dir", str(tmp_path / "port"),
                                   "--device", "cpu"])
    out, got = printed(capsys, port.run, args,
                       init=lambda m: interop.load_state(m, ref_state))
    assert masked(got, MASKS) == masked(want, MASKS)
    losses = _losses(got)
    assert len(losses) == 7
    np.testing.assert_allclose(losses, _losses(want), rtol=LOSS_RTOL)
    assert [round(v[0], 4) for v in out["logged"].values()] == losses

    assert (out["cost"], out["asap_cost"]) == (33374, 66412)
    assert [c for c, _ in out["waits"]] == [0, 3]
    assert (out["steps"], out["restarts"], out["clock"]) == (70, 1, 164.0)
    assert sorted(out["logged"]) == list(range(0, 70, 10))
