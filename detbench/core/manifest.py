"""The benchmark's files, found by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; a configuration names its
reference (``reference/<name>.py``), a traffic mix the kind of run that
drives it (``kinds/<kind>.py``); each per-layer metric has a reader
``metrics/<metric name>.py``; each cell its limits ``limits/<cell>.json``.
Adding any of them is adding files and manifest entries.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent  # detbench/
REPO = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class ManifestError(RuntimeError):
    pass


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None) -> ModuleType:
    """Import the file at ``path`` (a name may hold dots, so by location)."""
    name = name or f"detbench_file_{re.sub(r'[^A-Za-z0-9_]', '_', str(path.resolve()))}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ManifestError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    limits: Dict

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, manifest_path: Optional[Path] = None, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of the manifest (``BENCHMARK.json`` at the
    repository root unless given): its configuration file where the manifest
    puts it, its traffic, kind and limits under ``bench_dir``."""
    manifest_path = manifest_path or REPO / "BENCHMARK.json"
    if not manifest_path.exists():
        raise ManifestError(f"no manifest at {manifest_path}")
    manifest = load_json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise ManifestError(f"no workload {workload!r} in {manifest_path}; there are {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(manifest_path.parent / configs[w["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in manifest["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in manifest["per_layer"] if _applies(m, workload)]
    limits = load_json(bench_dir / "limits" / f"{workload}.json")
    return Cell(workload, int(w["chips"]), w["config"], config, w["traffic"], traffic, e2e, per_layer, limits)


def kind_module(kind: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "kinds" / f"{kind}.py")


def reference_module(config: Dict) -> ModuleType:
    """The plain reference a configuration names, as ``reference.<name>``."""
    return importlib.import_module(f"reference.{config['reference']}")


def metric_reader(metric: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(bench_dir / "metrics" / f"{metric}.py")
