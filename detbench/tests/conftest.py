"""Tests of the benchmark itself, on the CPU at tiny sizes (the repository's
``tests/`` does not collect them): ``python -m pytest detbench/tests``.
Tests that need a card are marked ``cuda`` and skip without one."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device here: run on the card")
    return "cuda"


def tiny_configs(amp: bool):
    """The two configurations at test sizes: YOLOX-S at width 0.125 on
    64x64, R50-FPN at 128x160, batch 2, the solver scaled to that batch as
    the port scales it."""
    out = {}
    y = json.loads((BENCH / "configs" / "yolox_s.json").read_text())
    y["width_factor"] = 0.125
    y["train"].update(batch=2, image=[64, 64], amp=amp, start_step=5 * 60000)
    y["infer"].update(batch=2, image=[64, 64])
    y["solver"].update(base_lr=0.01 / 64 * 2, warmup_iters=5 * 60000, total_iters=300 * 60000,
                       no_aug_iters=15 * 60000)
    out["yolox_s"] = y
    f = json.loads((BENCH / "configs" / "frcnn_r50.json").read_text())
    f["train"].update(batch=2, image=[128, 160], amp=amp)
    f["infer"].update(batch=2, image=[128, 160])
    f["solver"].update(base_lr=0.02 / 16 * 2, total_iters=18 * 40000, milestones=[12 * 40000, 16 * 40000])
    out["frcnn_r50"] = f
    return out


def write_tiny(tmp_path: Path, amp: bool) -> Path:
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in manifest["configs"]:
        c["file"] = f"{c['name']}.json"
    for name, cfg in tiny_configs(amp).items():
        (tmp_path / f"{name}.json").write_text(json.dumps(cfg))
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    return path


@pytest.fixture
def tiny_f32(tmp_path):
    """A manifest of the four cells at test sizes, training in f32."""
    return write_tiny(tmp_path, amp=False)


@pytest.fixture
def tiny_amp(tmp_path):
    """The same, training under the bf16 policy as the configurations state."""
    return write_tiny(tmp_path, amp=True)
