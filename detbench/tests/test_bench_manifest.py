"""The manifest and the files it names: the contract's names, units and
keys, and a new configuration, traffic mix, cell and metric found by name
with no edit to any file already there."""
from __future__ import annotations

import json
import re
import shutil

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_names_and_units():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["detbench"] and m["command"][1] == "detbench/run.py"
    names = [c["name"] for c in m["configs"]] + [w["name"] for w in m["workloads"]]
    names += [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    names += [w[k] for w in m["workloads"] for k in ("config", "traffic")]
    for n in names:
        assert NAME.match(n), n
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("detbench/")
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in m["workloads"]:
        cell = w["name"]
        mine = [x for x in m["end_to_end"] if cell in x.get("workloads", [cell])]
        assert {"setup_s"} < {x["name"] for x in mine}
        layers = [x for x in m["per_layer"] if cell in x.get("workloads", [cell])]
        assert layers
        for x in layers:  # a layer metric moves an end-to-end metric its cells report
            assert cell in e2e[x["moves"]].get("workloads", [cell])
    for x in m["per_layer"]:
        assert (BENCH / "metrics" / f"{x['name']}.py").is_file()
    for w in m["workloads"]:
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()


def test_new_files_are_found_by_name(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell, its limits
    and a per-layer metric as new files and manifest entries only."""
    from core import manifest as mf
    from core.trace import Trace

    bench = tmp_path / "detbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    cfg = json.loads((BENCH / "configs" / "yolox_s.json").read_text())
    cfg["name"] = "yolox_s_crowd"
    (bench / "configs" / "yolox_s_crowd.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "coco_train.json").read_text())
    traffic["gt_per_image"]["mean"] = 22.6
    (bench / "traffic" / "crowd_train.json").write_text(json.dumps(traffic))
    (bench / "limits" / "yolox_s_crowd.train_b64.json").write_text(json.dumps({"loss_gap": 1.0}))
    (bench / "metrics" / "device_ops.train.py").write_text(
        "def read(tr):\n    return float(len(tr.device_ops)) or None\n")
    m = manifest()
    m["configs"].append({"name": "yolox_s_crowd", "source": "x", "file": "detbench/configs/yolox_s_crowd.json",
                         "reduced": [], "why": "x"})
    m["workloads"].append({"name": "yolox_s_crowd.train_b64", "config": "yolox_s_crowd", "traffic": "crowd_train",
                           "chips": 1, "why": "x"})
    for x in m["end_to_end"]:
        if "workloads" in x and "yolox_s.train_b64" in x["workloads"]:
            x["workloads"].append("yolox_s_crowd.train_b64")
    m["per_layer"].append({"name": "device_ops.train", "unit": "ops", "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "train_img_per_s", "workloads": ["yolox_s_crowd.train_b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = mf.load_cell("yolox_s_crowd.train_b64", tmp_path / "BENCHMARK.json", bench)
    assert cell.traffic["gt_per_image"]["mean"] == 22.6 and cell.limits == {"loss_gap": 1.0}
    assert cell.kind == "train" and mf.kind_module(cell.kind, bench).Run
    assert [x["name"] for x in cell.per_layer if x["name"] == "device_ops.train"]
    assert {x["name"] for x in cell.end_to_end} == {"train_img_per_s", "train_peak_gib", "setup_s"}
    trace = Trace(steps=1, stretch_s=1.0, device_ops=[("k", 0.0, 1.0)] * 3, gap_labels=[], calls={})
    assert mf.metric_reader("device_ops.train", bench).read(trace) == 3.0
