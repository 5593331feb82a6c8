"""The port's serving example (``repro_torch.examples.serve_batched``)
against the reference's ``examples/serve_batched.py`` on the CPU, at
``--requests 4 --slots 2 --max-new 4``: the same printed lines (the
admission plan's chunks, costs and starts, the coalescing, the forced
degradation, the span count, the served model and requests), with only
the rung durations of the trace line and the serving time and rate
masked. The reference's parameters are carried into the port's model
(``interop.load_params``), and every request's greedy tokens are equal,
not only the ones printed. Both write their trace to the same path, read
back after each run: 26 spans of parseable JSONL. The process's tracer is
the one it had before the port's example ran."""
import dataclasses
import json

import numpy as np

import repro_torch.configs as TC
from repro_torch import interop, obs
from repro_torch.models import build_model as t_build
from test_torch_example_quickstart import (  # noqa: F401
    load_reference, masked, one_torch_thread, port_example, printed,
    run_reference)

ARGV = ["--requests", "4", "--slots", "2", "--max-new", "4"]
MASKS = [(r"(\w+:\w+) \d+\.\dms", r"\1 <ms>"),
         (r"in \d+\.\ds \(\d+\.\d tok/s aggregate\)",
          "in <s> (<rate> tok/s aggregate)")]


def _recording(batcher_cls, seen):
    """A subclass of the reference's batcher that keeps its parameters and
    every request it was given."""

    class Recording(batcher_cls):
        def __init__(self, model, params, **kw):
            super().__init__(model, params, **kw)
            seen["params"], seen["requests"] = params, []

        def submit(self, req):
            seen["requests"].append(req)
            super().submit(req)

    return Recording


def _spans(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_serve_prints_the_reference_s_lines(monkeypatch, capsys, tmp_path):
    ref, port = load_reference("serve_batched"), \
        port_example("serve_batched")
    trace = str(tmp_path / "serve_trace.jsonl")
    seen = {}
    monkeypatch.setattr(ref, "ContinuousBatcher",
                        _recording(ref.ContinuousBatcher, seen))
    want = run_reference(ref, monkeypatch, capsys,
                         ARGV + ["--trace-out", trace])
    want_spans = _spans(trace)

    cfg = dataclasses.replace(TC.reduced(TC.ARCHS["qwen1.5-0.5b"]),
                              dtype="float32")
    model = interop.load_params(t_build(cfg, tp=16, device="cpu"),
                                _numpy(seen["params"]))
    mine = obs.Tracer()
    prev = obs.set_tracer(mine)
    try:
        args = port.parse_args(ARGV + ["--trace-out", trace,
                                       "--device", "cpu"])
        out, got = printed(capsys, port.run, args, model=model)
        assert obs.tracer() is mine and not mine.finished()
    finally:
        obs.set_tracer(prev)
    assert masked(got, MASKS) == masked(want, MASKS)
    assert sum("<ms>" in line for line in masked(got, MASKS)) == 1
    got_spans = _spans(trace)
    assert len(got_spans) == len(want_spans) == out["admission"]["spans"] \
        == 26
    assert sorted(s["name"] for s in got_spans) == \
        sorted(s["name"] for s in want_spans)

    adm = out["admission"]
    assert (adm["chunks"], adm["cost"], adm["asap_cost"], adm["starts"]) == \
        (2, 2685, 5213, [12, 17])
    assert (adm["coalesced"], adm["batches"]) == (4, 2)
    assert adm["fallback_stage"] == "asap" and not adm["degraded"]
    assert adm["attempts"] == ["heuristic:skipped", "asap:ok"]
    assert len(out["requests"]) == len(seen["requests"]) == 4
    for a, b in zip(seen["requests"], out["requests"]):
        assert a.done and b.done
        assert (a.rid, a.prompt, a.out) == (b.rid, b.prompt, b.out)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.asarray(tree)
