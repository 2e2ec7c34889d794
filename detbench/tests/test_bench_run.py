"""A whole run at test sizes on the CPU, through ``run.run``: the result
line carries exactly the contract's keys, the check's numbers last; the
command refuses to run without a card."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("cell", ["yolox_s.train_b64", "yolox_s.infer_b32"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(tiny_f32, cell, trace):
    import run

    result, numbers = run.run(cell, 2 ** 31 + 99, 0.2, bool(trace), device="cpu", manifest_path=tiny_f32)
    line = json.loads(json.dumps(result))
    assert list(line) == (KEYS[:5] + ["breakdown", "check"] if trace else KEYS)
    assert isinstance(line["correct"], bool) and line["attempted"] >= 1 and line["failed"] == 0
    manifest = json.loads(tiny_f32.read_text())
    group = "per_layer" if trace else "end_to_end"
    declared = {m["name"]: m["unit"] for m in manifest[group] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= set(declared)
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == declared[name]
    if not trace:
        assert set(line["metrics"]) == set(declared)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    assert [n["name"] for n in numbers] == list(line["check"])
    for v in line["check"].values():
        assert set(v) == {"value", "limit"}


def test_refuses_without_a_card(capsys):
    import torch

    import run

    if torch.cuda.is_available():
        pytest.skip("a card is here: the refusal is for machines without one")
    assert run.main(["--workload", "yolox_s.train_b64", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_refuses_an_unknown_cell(capsys):
    import run

    assert run.main(["--workload", "no_such.cell", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_cell_on_the_card_at_test_size(tiny_amp, cuda_device):
    import run

    result, _ = run.run("yolox_s.train_b64", 5, 1.0, True, device=cuda_device, manifest_path=tiny_amp)
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert "launches_per_step.train" in result["metrics"]
    assert (ROOT / "basedet_tpu_torch" / "_build").is_dir()
