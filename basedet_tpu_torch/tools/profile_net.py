"""Profiling CLI of the port (counterpart of ``basedet_tpu/tools/profile_net.py``):

    python -m basedet_tpu_torch.tools.profile_net -f <config.py> [--iters 5] \
        [--trace-dir logs/profile] [--device cuda] [KEY VALUE ...]

One warm train step on a dummy batch of ``MODEL.BATCHSIZE`` images of
``DATA.DUMMY_IMAGE_SIZE`` outside the trace, then ``--iters`` steps on it
under ``torch.profiler`` (CPU and, on a card, CUDA activities), fenced by
reading one loss, written as a Chrome trace (``trace.json`` under
``--trace-dir``; open it in Perfetto or ``chrome://tracing``). The device
defaults to ``cuda`` and is never swapped for another.
"""
from __future__ import annotations

import os
import time

import torch

from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
from basedet_tpu_torch.tools.misc import apply_common_flags, default_parser, import_config, resolve_device
from basedet_tpu_torch.utils.dummy import DummyLoader
from basedet_tpu_torch.utils.logger import logger, setup_logger
from basedet_tpu_torch.utils.registry import build_model, registers

# idle seconds inside the profiler's window before and after the steps: the
# profiler drops device records whose timestamps, converted to the host's
# clock, fall outside its window, and they can land milliseconds off
WINDOW_PAD_S = 0.05


def profile_training(cfg, device: torch.device, trace_dir: str, n_iters: int = 5) -> str:
    """Trace ``n_iters`` train steps after a warm one → the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    model = build_model(cfg, device)
    solver = registers.solvers.get(cfg.SOLVER.BUILDER_NAME).build(cfg, 1)
    model.train()
    state = TrainState(model, solver, ema=False)
    step = make_train_step(model, solver, cfg)
    size = tuple(cfg.DATA.get("DUMMY_IMAGE_SIZE", (640, 640)))
    batch = DummyLoader(batch_size=cfg.MODEL.BATCHSIZE, image_size=size,
                        max_instances=cfg.DATA.get("MAX_INSTANCES", 32)).make_batch()
    float(step(state, batch)["total_loss"])  # warm-up outside the trace; reading a loss fences the step
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    with profile(activities=activities) as prof:
        time.sleep(WINDOW_PAD_S)
        for _ in range(n_iters):
            metrics = step(state, batch)
        float(metrics["total_loss"])
        sync()
        time.sleep(WINDOW_PAD_S)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info(f"wrote the profiler trace of {n_iters} train steps to {path}")
    return path


def main(args=None):
    parser = default_parser("basedet_tpu_torch profile")
    parser.add_argument("--trace-dir", type=str, default="logs/profile")
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--device", default="cuda", help="torch device to run on")
    args = parser.parse_args(args)
    device = resolve_device(args.device)
    cfg = import_config(args.file)
    apply_common_flags(cfg, args)
    setup_logger(cfg.GLOBAL.OUTPUT_DIR, file_prefix="profile_log")
    return profile_training(cfg, device, args.trace_dir, args.iters)


if __name__ == "__main__":
    main()
