"""DetTrainer: the training loop around the train step (counterpart of
``basedet_tpu/engine/trainer.py``). The world size is the data-parallel
one (``basedet_tpu_torch/parallel``: the data group's size, 1 without a
process group; with ``TRAINER.TP_SIZE`` the ranks of a model group count
once, as the JAX trainer's ``mesh.shape["data"]``): each data rank steps
``MODEL.BATCHSIZE`` rows of a global batch of ``MODEL.BATCHSIZE`` times the
world size, from the same state, which ``init_state`` broadcasts from rank
0; the logged losses are averaged over ranks.

Each step moves the rank's batch to the model's device first. Under a
process group of more than one data rank it then pads the batch's images at
the bottom and right to the data group's largest canvas (``pad_to_group``),
so that every rank's anchors and points, and DETR's mask, are those one
process has on the global batch. ``last_batch`` keeps the step's batch on
the device (the loader reuses its pinned slots) for the hooks that read it
(``TBDetectionImageHook``).

Where ``TEST.EVAL_EPOCH_INTERVAL`` is set or ``DATA.TEST.name`` is not
``dummy``, the trainer builds the evaluator and the test loader for
``EvalHook``. The JAX package logs a failure to build them and trains on;
the port raises."""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from basedet_tpu_torch import parallel
from basedet_tpu_torch.data.build import build_test_dataloader
from basedet_tpu_torch.layers.common.pre_processing import to_device
from basedet_tpu_torch.utils.logger import logger
from basedet_tpu_torch.utils.meters import MeterBuffer
from basedet_tpu_torch.engine.progress import Progress
from basedet_tpu_torch.engine.train_state import TrainState, make_train_step
from basedet_tpu_torch.solver.build import iters_per_epoch
from basedet_tpu_torch.utils.registry import build_evaluator, registers


@registers.trainers.register()
class DetTrainer:
    def __init__(self, cfg, model, dataloader, solver, hooks: List = ()):
        self.cfg = cfg
        self.model = model
        self.dataloader = dataloader
        self.solver = solver
        self.log_interval = cfg.GLOBAL.get("LOG_INTERVAL", 20)
        self.meters = MeterBuffer(window_size=self.log_interval)
        self.world_size = parallel.world_size()
        self.global_batch_size = cfg.MODEL.BATCHSIZE * self.world_size
        self.progress = Progress(max_epoch=cfg.SOLVER.MAX_EPOCH, max_iter=iters_per_epoch(cfg, self.world_size))
        self.ema_enabled = bool(cfg.TRAINER.EMA.get("ENABLE", False))
        self.train_step = make_train_step(model, solver, cfg)
        # models may map batches per step (YOLOX's multiscale resize, from
        # the step alone, so every rank resizes alike)
        self.batch_mapper = getattr(model, "train_batch_mapper", None)
        self.state: Optional[TrainState] = None
        self.last_batch: Optional[Dict] = None
        self._last_fence = None
        self.evaluator = None
        self.test_dataloader = None
        self.eval_results: Dict[str, Dict[str, float]] = {}  # EvalHook's latest, by weights
        if cfg.TEST.get("EVAL_EPOCH_INTERVAL", None) or cfg.DATA.TEST.get("name", "dummy") != "dummy":
            self.evaluator = build_evaluator(cfg)
            self.test_dataloader = build_test_dataloader(cfg, device=model.device)
        self.hooks = list(hooks)
        for h in self.hooks:
            h.trainer = self

    def init_state(self):
        weights = self.cfg.MODEL.get("WEIGHTS", None)
        if weights:
            logger.info(f"loading weights from {weights}")
            self.model.load_weights(weights)
        parallel.broadcast_module(self.model.module)
        self.state = TrainState(self.model, self.solver, ema=self.ema_enabled)

    def train(self):
        if self.state is None:
            self.init_state()
        self.model.train()
        data_iter = iter(self.dataloader)
        try:
            self._call_hooks("before_train")
            for epoch in range(self.progress.epoch, self.progress.max_epoch + 1):
                self.progress.epoch = epoch
                self._call_hooks("before_epoch")
                for it in range(1, self.progress.max_iter + 1):
                    self.progress.inner_iter = it
                    self._call_hooks("before_iter")
                    self.train_one_iter(data_iter)
                    self._call_hooks("after_iter")
                self._call_hooks("after_epoch")
                if epoch < self.progress.max_epoch:
                    self.progress.epoch_done()
            self._call_hooks("after_train")
        finally:  # the loader's worker processes end with the training
            close = getattr(self.dataloader, "close", None)
            if close is not None:
                close()
        self.model.eval()
        logger.info("training finished")

    def train_one_iter(self, data_iter):
        t0 = time.perf_counter()
        batch = dict(next(data_iter))
        batch.pop("image_id", None)
        batch = {k: to_device(v, self.model.device) if isinstance(v, (np.ndarray, torch.Tensor)) else v
                 for k, v in batch.items()}
        if self.world_size > 1:
            batch = self.pad_to_group(batch)
        if self.batch_mapper is not None:
            batch = self.batch_mapper(batch, self.progress.current_iter)  # 1-based
        self.last_batch = batch
        t1 = time.perf_counter()
        metrics = self.train_step(self.state, batch)
        # reading the losses waits for the device: only at the log interval
        if self.progress.current_iter % self.log_interval == 0:
            metrics = {k: float(v) for k, v in parallel.reduce_metrics(metrics).items()}
            t2 = time.perf_counter()
            if self._last_fence is not None:
                self.meters.update(train_time=(t2 - self._last_fence) / self.log_interval)
            self._last_fence = t2
            self.meters.update(metrics)
            self.meters.update(getattr(self.model, "extra_meter", None) or {})
        self.meters.update(data_time=t1 - t0)

    def pad_to_group(self, batch: Dict) -> Dict:
        """The batch with its images padded at the bottom and right, with the
        collator's pad value, and DETR's mask with zeros, to the data group's
        largest (H, W) (one all-reduce of two integers); ``im_info`` and the
        gts as they are."""
        h, w = batch["data"].shape[1:3]
        H, W = parallel.group_max((h, w))
        if (H, W) == (h, w):
            return batch
        pad_value = getattr(getattr(self.dataloader, "collator", None), "pad_value", 0.0)
        out = dict(batch, data=F.pad(batch["data"], (0, 0, 0, W - w, 0, H - h), value=pad_value))
        if "mask" in batch:
            out["mask"] = F.pad(batch["mask"], (0, W - w, 0, H - h), value=0)
        return out

    def _call_hooks(self, phase: str):
        for h in self.hooks:
            getattr(h, phase)()
