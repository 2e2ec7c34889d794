"""Throughput benchmark of the port (counterpart of ``basedet_tpu/tools/benchmark.py``):

    python -m basedet_tpu_torch.tools.benchmark [--models RetinaNet ATSS FCOS FreeAnchor] \
        [--image-size 640] [--batch 8] [--amp] [--out benchmark.json] [--modes train eval] \
        [--eval-batch 1] [--device cuda]

For each model of ``--models`` (the eleven names of :func:`_build`): a train
row (:class:`TrainBenchmark`: ``warmup`` steps, then ``iters`` timed steps of
the model's train step at ``--batch`` images of ``--image-size`` squared, in
IEEE f32 or, with ``--amp``, under the bf16 policy) and an eval row
(:class:`EvalBenchmark`: ``inference`` at ``--eval-batch``), appended to the
JSON list in ``--out`` and written after each row. A model that raises is
logged and skipped, as in the JAX package.

The batches are ``utils/dummy.py``'s, moved to the device before any timing.
The clock is fenced by ``torch.cuda.synchronize`` before it starts and
after the last step, and nowhere in between: a step that syncs by itself
(a tensor made on the card from Python values, DETR's auction reading its
convergence) does so inside the timed loop; ``chip_smoke.py`` phase 50
names those syncs. The first step on the card loads the CUDA
kernels, and builds with ``nvcc`` those not yet on disk (``ops/_build.py``):
then ``warmup_s`` includes the build, which the log line of the row names.
The device defaults to ``cuda`` and is never swapped for another.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import time
from typing import Dict, List

import torch

from basedet_tpu_torch import configs as C
from basedet_tpu_torch.layers.common.function import full_f32
from basedet_tpu_torch.tools.misc import resolve_device
from basedet_tpu_torch.utils.logger import logger, setup_logger

_CONFIGS = {
    "RetinaNet": C.RetinaNetConfig,
    "FCOS": C.FCOSConfig,
    "ATSS": C.ATSSConfig,
    "FreeAnchor": C.FreeAnchorConfig,
    "FasterRCNN": C.FasterRCNNConfig,
    "YOLOX-S": C.YOLOXSConfig,
    "YOLOX-M": C.YOLOXMConfig,
    "YOLOv3": C.YOLOv3Config,
    "CenterNet": C.CenterNetConfig,
    "OTA": C.OTAConfig,
    "DETR": C.DETRConfig,
}
MODELS = tuple(_CONFIGS)


def _build(model_name: str, image_size: int, batch: int):
    cfg = _CONFIGS[model_name]()
    cfg.MODEL.BATCHSIZE = batch
    cfg.DATA.MAX_INSTANCES = 32
    return cfg


def _device_batches(batch_size: int, image_size: int, device: torch.device, count: int) -> List[Dict]:
    from basedet_tpu_torch.utils.dummy import DummyLoader

    loader = DummyLoader(batch_size=batch_size, image_size=(image_size,) * 2, max_instances=32)
    return [{k: torch.as_tensor(v).to(device) for k, v in loader.make_batch(i).items()} for i in range(count)]


class _Row:
    """What the rows share: the device, its fence, and per row the allocator
    emptied, the peak statistics reset and read (``peak_gib``: the most
    allocated above what was held before the model was built) and the kernel
    libraries built during the warm-up (``built``). After ``run`` a train
    row keeps the steps its state took (``steps``), the last loss and how
    far the EMA trails the parameters (``ema_gap``), an eval row the last
    detections on the CPU (``dets``); nothing of either stays on the card."""

    def __init__(self, device):
        self.device = resolve_device(device) if isinstance(device, str) else torch.device(device)
        self.peak_gib = None
        self.built: List[str] = []

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _begin(self):
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
            self._held = torch.cuda.memory_allocated(self.device)
        self._on_disk = _kernel_libraries()

    def _warm(self):
        self.built = [name for name, there in _kernel_libraries().items() if there and not self._on_disk[name]]

    def _end(self):
        if self.device.type == "cuda":
            self.peak_gib = (torch.cuda.max_memory_allocated(self.device) - self._held) / 2 ** 30
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _kernel_libraries() -> Dict[str, bool]:
    """{kernel source: whether its library is on disk}."""
    from basedet_tpu_torch.ops import _build

    return {src.name: _build.library_path(src).exists() for src in sorted(_build.CSRC.glob("*.cu"))}


class TrainBenchmark(_Row):
    def __init__(self, model_name: str, image_size: int = 640, batch: int = 8,
                 warmup: int = 5, iters: int = 20, amp: bool = False, device="cuda"):
        super().__init__(device)
        self.model_name = model_name
        self.image_size = image_size
        self.batch = batch
        self.warmup = warmup
        self.iters = iters
        self.amp = amp

    def run(self) -> Dict:
        from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
        from basedet_tpu_torch.layers.precision import policy_from_cfg
        from basedet_tpu_torch.utils.registry import build_model, registers

        self._begin()
        cfg = _build(self.model_name, self.image_size, self.batch)
        if self.amp:
            cfg.TRAINER.AMP.ENABLE = True
        # the JAX tool's configure_from_cfg: the train step enters the policy
        # itself, so this only refuses a bad TRAINER.AMP before the build
        policy_from_cfg(cfg)
        model = build_model(cfg, self.device).train()
        solver = registers.solvers.get(cfg.SOLVER.BUILDER_NAME).build(cfg, 1)
        state = TrainState(model, solver, ema=True)
        step_fn = make_train_step(model, solver, cfg)
        batches = _device_batches(self.batch, self.image_size, self.device, 4)

        self.sync()
        t_compile = time.perf_counter()
        for i in range(self.warmup):
            metrics = step_fn(state, batches[i % 4])
        self.sync()
        compile_time = time.perf_counter() - t_compile
        self._warm()

        t0 = time.perf_counter()
        for i in range(self.iters):
            metrics = step_fn(state, batches[i % 4])
        self.sync()
        dt = time.perf_counter() - t0
        self.steps, self.loss = state.step, float(metrics["total_loss"])
        with torch.no_grad():  # how far the EMA trails the live parameters
            self.ema_gap = max(float((state.ema_params[n] - p).abs().max())
                               for n, p in model.module.named_parameters())
        del model, solver, state, step_fn, batches, metrics
        self._end()
        ips = self.batch * self.iters / dt
        return {
            "model": self.model_name,
            "mode": "train",
            "image_size": self.image_size,
            "batch": self.batch,
            "amp": self.amp,
            "images_per_sec": round(ips, 2),
            "step_ms": round(dt / self.iters * 1000, 2),
            "warmup_s": round(compile_time, 1),
        }


class EvalBenchmark(_Row):
    def __init__(self, model_name: str, image_size: int = 640, batch: int = 1,
                 warmup: int = 3, iters: int = 20, device="cuda"):
        super().__init__(device)
        self.model_name = model_name
        self.image_size = image_size
        self.batch = batch
        self.warmup = warmup
        self.iters = iters

    def run(self) -> Dict:
        from basedet_tpu_torch.utils.registry import build_model

        self._begin()
        cfg = _build(self.model_name, self.image_size, self.batch)
        model = build_model(cfg, self.device).eval()
        # device-resident batch: measure compute, not host→device transfer
        batch = _device_batches(self.batch, self.image_size, self.device, 1)[0]
        with torch.inference_mode(), full_f32():
            for _ in range(self.warmup):
                dets = model.inference(batch)
            self.sync()
            self._warm()
            t0 = time.perf_counter()
            for _ in range(self.iters):
                dets = model.inference(batch)
            self.sync()
            dt = time.perf_counter() - t0
        self.dets = {k: v.cpu() for k, v in dets.items()}
        del model, batch, dets
        self._end()
        return {
            "model": self.model_name,
            "mode": "eval",
            "image_size": self.image_size,
            "batch": self.batch,
            "images_per_sec": round(self.batch * self.iters / dt, 2),
            "latency_ms": round(dt / self.iters * 1000, 2),
        }


def _note(bench) -> str:
    peak = "" if bench.peak_gib is None else f"; peak {bench.peak_gib:.3f} GiB"
    built = f"; warmup_s includes the nvcc build of {', '.join(bench.built)}" if bench.built else ""
    return peak + built


def benchmark_all_models(models: List[str], image_size: int, batch: int,
                         amp: bool, out_path: str, modes=("train", "eval"),
                         eval_batch: int = 1, device="cuda"):
    results = []
    if os.path.exists(out_path):  # append to an existing sweep
        with open(out_path) as f:
            results = json.load(f)

    def flush():
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)

    for name in models:
        if "train" in modes:
            try:
                bench = TrainBenchmark(name, image_size, batch, amp=amp, device=device)
                r = bench.run()
                logger.info(f"{r}{_note(bench)}")
                results.append(r)
                flush()
            except Exception as e:
                logger.warning(f"train bench {name} failed: {e}")
        if "eval" in modes:
            try:
                bench = EvalBenchmark(name, image_size, batch=eval_batch, device=device)
                r = bench.run()
                logger.info(f"{r}{_note(bench)}")
                results.append(r)
                flush()
            except Exception as e:
                logger.warning(f"eval bench {name} failed: {e}")
    flush()
    logger.info(f"wrote {out_path}")
    return results


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("basedet_tpu_torch benchmark")
    parser.add_argument(
        "--models", nargs="+",
        default=["RetinaNet", "ATSS", "FCOS", "FreeAnchor"],
    )
    parser.add_argument("--image-size", type=int, default=640)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--amp", action="store_true")
    parser.add_argument("--out", type=str, default="benchmark.json")
    parser.add_argument("--modes", nargs="+", default=["train", "eval"])
    parser.add_argument(
        "--eval-batch", type=int, default=1,
        help="eval batch size (the reference protocol is 1)",
    )
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    return parser


def main(args=None):
    args = make_parser().parse_args(args)
    device = resolve_device(args.device)
    setup_logger()
    return benchmark_all_models(
        args.models, args.image_size, args.batch, args.amp, args.out,
        modes=tuple(args.modes), eval_batch=args.eval_batch, device=device,
    )


if __name__ == "__main__":
    main()
