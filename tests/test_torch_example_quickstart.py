"""The port's quickstart example (``repro_torch.examples.quickstart``)
against the reference's ``examples/quickstart.py`` on the CPU: the same
printed lines, with only the variant table's ``ms`` column masked (wall
time). Every cost, ratio, variant name and the exact audit are equal.

Also the helpers the other example tests share (the reference example
loaded from its file, its ``main`` run with a command line and its lines
captured), and the rule every example keeps: without ``--device`` it runs
on the card and raises where there is none.

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q \
        tests/test_torch_example_*.py
"""
import importlib
import importlib.util
import os
import re
import sys

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXAMPLES = ("quickstart", "fleet_scheduler", "serve_batched",
            "train_carbon_aware")

# the reference's output on the CPU, as quoted in the port's chip_smoke.py
QUICKSTART_COSTS = {
    "slack": 154, "slack-LS": 154, "slackR": 0, "slackR-LS": 0,
    "slackW": 1145, "slackW-LS": 689, "slackWR": 1145, "slackWR-LS": 689,
    "press": 308, "press-LS": 308, "pressR": 264, "pressR-LS": 264,
    "pressW": 308, "pressW-LS": 286, "pressWR": 44, "pressWR-LS": 44}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: at these sizes the
    examples gain little from more, and the suite runs several test
    processes side by side, where threads beyond the cores only contend
    (the fleet's port half: 12.8 CPU-s for 3.9 s of wall with 8 threads,
    3.2 for 3.2 with one)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def load_reference(name):
    """The reference's ``examples/<name>.py`` as a module (``examples/``
    is not a package)."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def printed(capsys, fn, *args, **kw):
    """``fn(*args, **kw)``'s return value and the lines it printed."""
    capsys.readouterr()
    out = fn(*args, **kw)
    return out, capsys.readouterr().out.splitlines()


def run_reference(mod, monkeypatch, capsys, argv=()):
    """The reference example's ``main()`` under the command line ``argv``;
    returns the lines it printed."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    return printed(capsys, mod.main)[1]


def masked(lines, masks):
    """``lines`` with every ``(pattern, replacement)`` of ``masks``
    applied."""
    out = []
    for line in lines:
        for pattern, repl in masks:
            line = re.sub(pattern, repl, line)
        out.append(line)
    return out


# the variant table's rows: name, cost, ratio, ms (the compare table's
# rows have an integer third column and are not touched)
MS_COLUMN = (r"^(\S+ +\d+ +\d+\.\d{3}) +\d+\.\d$", r"\1 <ms>")


def test_quickstart_prints_the_reference_s_lines(monkeypatch, capsys):
    want = run_reference(load_reference("quickstart"), monkeypatch, capsys)
    out, got = printed(capsys, port_example("quickstart").main,
                       ["--device", "cpu"])
    assert masked(got, [MS_COLUMN]) == masked(want, [MS_COLUMN])
    assert sum("<ms>" in line for line in masked(got, [MS_COLUMN])) == 16
    assert out["asap"] == 17966 and out["costs"] == QUICKSTART_COSTS
    assert out["best"] == "slackR"
    assert out["optimum"] == 1101 and round(out["gap"], 3) == 1.011
    assert sorted(set(out["audit"].values())) == [1113, 1120, 1142]
    assert len(out["audit"]) == 17


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_defaults_to_the_card(name, monkeypatch):
    """No ``--device``: the example resolves the card, and without a GPU
    it raises before doing any work."""
    mod = port_example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = mod.parse_args([])
    assert args.device is None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(args)
