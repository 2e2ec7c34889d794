"""The port's benchmark tool (``basedet_tpu_torch/tools/benchmark.py``)
against the JAX package's (``basedet_tpu/tools/benchmark.py``) on the CPU:
``_build``'s config tree for each of the eleven names, the four batches byte
for byte, the flags and their defaults, the keys of the rows; then train and
eval rows of tiny YOLOX-S and tiny Faster R-CNN (``tests/tiny.shrink``
patched into ``_build``; YOLOX-S's EMA burn-in set to 0, so that its EMA
moves apart from the parameters at once) on ``--device cpu``, and the sweep
appending to an existing file and logging past a model that raises. Every
file is written under ``tmp_path``.
"""
import argparse
import ast
import inspect
import json

import numpy as np
import pytest

from basedet_tpu_torch.tools import benchmark
from tests.tiny import shrink
from tests.torch_threads import torch_threads  # noqa: F401

NAMES = ("RetinaNet", "FCOS", "ATSS", "FreeAnchor", "FasterRCNN", "YOLOX-S", "YOLOX-M", "YOLOv3", "CenterNet",
         "OTA", "DETR")
TINY_SIZE = {"YOLOX-S": 64, "FasterRCNN": 128}


def _jax_tool():
    from basedet_tpu.tools import benchmark as jbenchmark

    return jbenchmark


def _row_keys(cls):
    """The keys of the dict literal that ``cls.run`` returns, read from its source."""
    tree = ast.parse(inspect.getsource(cls.run).replace("\n    ", "\n")[4:])
    returns = [n.value for n in ast.walk(tree) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(returns) == 1
    return [k.value for k in returns[0].keys]


def test_the_eleven_names_are_the_jax_tools():
    src = inspect.getsource(_jax_tool()._build)
    assert set(NAMES) == set(benchmark.MODELS) == {n for n in NAMES if f'"{n}"' in src}


@pytest.mark.parametrize("name", NAMES)
def test_build_gives_the_jax_config_tree(name):
    got = benchmark._build(name, 640, 8)
    want = _jax_tool()._build(name, 640, 8)
    assert got.MODEL.BATCHSIZE == 8 and got.DATA.MAX_INSTANCES == 32
    assert got.to_dict() == want.to_dict()


def test_unknown_name_raises_key_error_in_both():
    for tool in (benchmark, _jax_tool()):
        with pytest.raises(KeyError):
            tool._build("NoSuchModel", 640, 8)


def test_batches_equal_the_jax_dummy_loaders():
    import torch

    from basedet_tpu.utils.dummy import DummyLoader

    got = benchmark._device_batches(8, 640, torch.device("cpu"), 4)
    loader = DummyLoader(batch_size=8, image_size=(640, 640), max_instances=32)
    assert len(got) == 4
    for i, batch in enumerate(got):
        want = loader.make_batch(i)
        assert sorted(batch) == sorted(want)
        for k, v in want.items():
            assert batch[k].device.type == "cpu" and batch[k].numpy().dtype == v.dtype, k
            assert batch[k].numpy().tobytes() == v.tobytes(), (i, k)


def _jax_parser(monkeypatch):
    """The parser that the JAX tool's ``main`` builds, caught at its
    ``parse_args`` before anything runs."""
    caught = []

    def catch(self, args=None, namespace=None):
        caught.append(self)
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(SystemExit):
        _jax_tool().main([])
    monkeypatch.undo()
    return caught[0]


def _flags(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.type, a.const)
            for a in parser._actions if a.dest != "help"}


def test_parser_has_the_jax_flags_and_defaults_plus_device(monkeypatch):
    port, want = _flags(benchmark.make_parser()), _flags(_jax_parser(monkeypatch))
    assert port.pop("device") == (("--device",), "cuda", None, None, None)
    assert port == want
    args = benchmark.make_parser().parse_args([])
    assert args.models == ["RetinaNet", "ATSS", "FCOS", "FreeAnchor"] and args.modes == ["train", "eval"]
    assert (args.image_size, args.batch, args.amp, args.out, args.eval_batch) == (640, 8, False, "benchmark.json", 1)


def test_rows_have_the_jax_rows_keys():
    jax_tool = _jax_tool()
    assert _row_keys(benchmark.TrainBenchmark) == _row_keys(jax_tool.TrainBenchmark) == [
        "model", "mode", "image_size", "batch", "amp", "images_per_sec", "step_ms", "warmup_s"]
    assert _row_keys(benchmark.EvalBenchmark) == _row_keys(jax_tool.EvalBenchmark) == [
        "model", "mode", "image_size", "batch", "images_per_sec", "latency_ms"]


@pytest.fixture
def tiny_build(monkeypatch):
    build = benchmark._build

    def shrunk(name, image_size, batch):
        cfg = shrink(build(name, image_size, batch))
        cfg.TRAINER.EMA.BURNIN_ITER = 0
        return cfg

    monkeypatch.setattr(benchmark, "_build", shrunk)


@pytest.mark.parametrize("name", ["YOLOX-S", "FasterRCNN"])
def test_train_and_eval_rows_on_the_cpu(name, tiny_build):
    size = TINY_SIZE[name]
    train = benchmark.TrainBenchmark(name, size, 2, warmup=1, iters=1, device="cpu")
    row = train.run()
    assert list(row) == _row_keys(benchmark.TrainBenchmark)
    assert {k: row[k] for k in ("model", "mode", "image_size", "batch", "amp")} == dict(
        model=name, mode="train", image_size=size, batch=2, amp=False)
    assert row["images_per_sec"] > 0 and row["step_ms"] > 0 and row["warmup_s"] >= 0
    assert train.steps == 2 and np.isfinite(train.loss)
    # YOLOX-S's EMA moved off the parameters once its burn-in is over;
    # Faster R-CNN's config has EMA off, so the state's copy stays at the start
    assert train.ema_gap > 0
    assert train.peak_gib is None and train.built == []

    evaluate = benchmark.EvalBenchmark(name, size, 1, warmup=1, iters=1, device="cpu")
    row = evaluate.run()
    assert list(row) == _row_keys(benchmark.EvalBenchmark)
    assert {k: row[k] for k in ("model", "mode", "image_size", "batch")} == dict(
        model=name, mode="eval", image_size=size, batch=1)
    assert row["images_per_sec"] > 0 and row["latency_ms"] > 0
    assert evaluate.dets["boxes"].shape[:1] == (1,) and set(evaluate.dets) == {
        "boxes", "box_scores", "box_labels", "valid"}


def test_sweep_appends_and_logs_past_a_failing_model(tmp_path, tiny_build, monkeypatch):
    out = tmp_path / "sweep.json"
    out.write_text(json.dumps([{"model": "earlier"}]))
    warned = []
    monkeypatch.setattr(benchmark.logger, "warning", warned.append)
    rows = benchmark.benchmark_all_models(["NoSuchModel", "YOLOX-S"], 64, 2, False, str(out), modes=("eval",),
                                          device="cpu")
    assert rows == json.loads(out.read_text())
    assert [r["model"] for r in rows] == ["earlier", "YOLOX-S"] and rows[1]["mode"] == "eval"
    assert warned == ["eval bench NoSuchModel failed: 'NoSuchModel'"]


def test_main_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        benchmark.main(["--out", str(tmp_path / "b.json")])
    assert not any(tmp_path.iterdir())
