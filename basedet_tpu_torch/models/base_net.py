"""BaseNet protocol for the port's detection models (counterpart of
``basedet_tpu/models/base_net.py``).

The batch dict keeps the JAX package's layout: ``data`` (B, H, W, 3) raw
pixels, ``im_info`` (B, 5) ``[cur_h, cur_w, orig_h, orig_w, num_inst]`` and,
to train, ``gt_boxes`` (B, K, 5) ``[x1, y1, x2, y2, class]`` (classes 1-based,
rows past ``num_inst`` padding), as numpy arrays or tensors. ``pre_process``
moves them to the model's device and transposes the image to NCHW. Class
labels out of ``inference`` are 0-based head indices.

Where the JAX package builds its flax module with ``train=True`` or
``False``, the port switches its one module with :meth:`BaseNet.train` and
:meth:`BaseNet.eval` (BN batch statistics and their running update in train
mode). A model is built in eval mode.
"""
from __future__ import annotations

import pickle
import zipfile
from typing import Any, Dict, Tuple

import torch

from basedet_tpu_torch.layers.common.pre_processing import data_to_input
from basedet_tpu_torch.utils.weights import state_dict_from_jax


class BaseNet:
    # True for a model whose losses sample: the train step then hands
    # ``get_losses`` the config's seed and the step (``seed=``, ``step=``)
    draws_per_step = False
    # True for a model whose every layer follows the bf16 compute policy
    # (``layers/precision.py``); the train step refuses TRAINER.AMP for the others
    follows_compute_policy = False

    def __init__(self, cfg, device: torch.device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.img_mean = cfg.MODEL.BACKBONE.get("IMG_MEAN", None)
        self.img_std = cfg.MODEL.BACKBONE.get("IMG_STD", None)
        self.num_classes = cfg.DATA.NUM_CLASSES
        self.module: torch.nn.Module

    def train(self, mode: bool = True) -> "BaseNet":
        self.module.train(mode)
        return self

    def eval(self) -> "BaseNet":
        return self.train(False)

    def get_losses(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch → (total_loss, loss_dict); differentiable in the module's
        parameters."""
        raise NotImplementedError

    def inference(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """batch → padded detections per image {boxes (B, D, 4), box_scores
        (B, D), box_labels (B, D), valid (B, D)} in original-image
        coordinates."""
        raise NotImplementedError

    def pre_process(self, batch: Dict[str, Any], train: bool = False) -> Dict[str, torch.Tensor]:
        """Pad to x32 and normalize in NHWC, then transpose to NCHW; with
        ``train``, carry the gt boxes."""
        image = torch.as_tensor(batch["data"]).to(self.device)
        image = data_to_input(image, self.img_mean, self.img_std)
        img_info = torch.as_tensor(batch["im_info"], dtype=torch.float32).to(self.device)
        out = {"image": image.permute(0, 3, 1, 2).contiguous(), "img_info": img_info}
        if train:
            out["gt_boxes"] = torch.as_tensor(batch["gt_boxes"], dtype=torch.float32).to(self.device)
        return out

    def load_weights(self, weight_path: str, ema: bool = False) -> None:
        """Load a ``torch.save``d state_dict, a training checkpoint of the
        port's ``CheckpointHook`` (its live weights, or with ``ema`` its EMA
        parameters beside the live BN statistics), or a pickle of the JAX
        variable tree with numpy leaves. Keys and shapes must match exactly."""
        if zipfile.is_zipfile(weight_path):
            sd = torch.load(weight_path, map_location="cpu", weights_only=True)
        else:
            with open(weight_path, "rb") as f:
                sd = state_dict_from_jax(pickle.load(f), self.module.state_dict())
        if "model" in sd:  # a training checkpoint
            if ema and sd.get("ema") is None:
                raise ValueError(f"{weight_path} was trained without EMA")
            sd = {**sd["model"], **sd["ema"]} if ema else sd["model"]
        elif ema:
            raise ValueError(f"{weight_path} is not a training checkpoint: it holds no EMA weights")
        self.module.load_state_dict(sd, strict=True)
