"""The port's fleet example (``repro_torch.examples.fleet_scheduler``)
against the reference's ``examples/fleet_scheduler.py`` on the CPU: the
same printed lines (robust variants, worst-member and ASAP costs, chunk
starts, the joint mapping search, the rolling-horizon windows), with only
``engine=`` and the windows' planning times masked. Both read their
dry-run records from an empty directory, so every step takes the 1-s
fallback on both sides. Also the port's ``step_seconds``: it takes only
its own one-card records rated on an H100 spec."""
import json

from test_torch_example_quickstart import (  # noqa: F401
    load_reference, masked, one_torch_thread, port_example, printed,
    run_reference)

MASKS = [(r"\(engine=\w+\)", "(engine=<engine>)"),
         (r"\(planned in \d+ ms\)", "(planned in <ms> ms)")]


def test_fleet_prints_the_reference_s_lines(monkeypatch, capsys, tmp_path):
    ref, port = load_reference("fleet_scheduler"), \
        port_example("fleet_scheduler")
    monkeypatch.setattr(ref, "DRYRUN", str(tmp_path))
    monkeypatch.setattr(port, "DRYRUN", str(tmp_path))
    want = run_reference(ref, monkeypatch, capsys)
    out, got = printed(capsys, port.main, ["--device", "cpu"])
    assert masked(got, MASKS) == masked(want, MASKS)
    assert set(out["step_sources"].values()) == {port.FALLBACK}
    heavy, mixed = out["fleets"]["train-heavy"], out["fleets"]["mixed-serve"]
    assert (heavy["robust"], heavy["worst"], heavy["asap_worst"]) == \
        ("press-LS", 11168470, 58483778)
    assert heavy["starts"][0][:3] == [516, 566, 802]
    assert heavy["starts"][1][:2] == [1202, 1227]
    assert (mixed["robust"], mixed["worst"], mixed["asap_worst"]) == \
        ("press-LS", 41010010, 70932450)
    assert out["joint"] == {"fixed": 8103099, "searched": 5513727,
                            "candidates": 15, "rounds": 2,
                            "winner": "r1:swap"}
    assert out["windows"] == [("press-LS", 26099599),
                              ("press-LS", 10541339),
                              ("pressR-LS", 31701720)]


def _record(path, hw, bound_s):
    with open(path, "w") as f:
        json.dump({"roofline": {"hw": hw, "bound_s": bound_s}}, f)


def test_step_seconds_reads_only_the_port_s_h100_records(monkeypatch,
                                                         tmp_path):
    port = port_example("fleet_scheduler")
    monkeypatch.setattr(port, "DRYRUN", str(tmp_path))
    assert port.step_seconds("qwen2.5-3b", "train_4k") == \
        (1.0, port.FALLBACK)
    # the reference's record name and a TPU-rated one are not read
    _record(tmp_path / "qwen2.5-3b_train_4k_single.json", "h100-sxm5", 2.5)
    _record(tmp_path / "smollm-360m_train_4k_none.json", "tpu-v5e", 2.5)
    assert port.step_seconds("qwen2.5-3b", "train_4k") == \
        (1.0, port.FALLBACK)
    assert port.step_seconds("smollm-360m", "train_4k") == \
        (1.0, port.FALLBACK)
    # a one-card record on an H100 spec, its bound floored at 0.05 s
    path = tmp_path / "qwen2.5-3b_train_4k_none.json"
    _record(path, "h100-sxm5", 2.5)
    assert port.step_seconds("qwen2.5-3b", "train_4k") == (2.5, str(path))
    _record(path, "h100-sxm5-f32", 0.01)
    assert port.step_seconds("qwen2.5-3b", "train_4k") == (0.05, str(path))
    sources = {}
    assert port.chunks([("qwen2.5-3b", "train_4k", 3, 100),
                        ("smollm-360m", "train_4k", 2, 10)], sources) == \
        [5, 5, 5, 10, 10]
    assert sources == {"qwen2.5-3b/train_4k": str(path),
                       "smollm-360m/train_4k": port.FALLBACK}
