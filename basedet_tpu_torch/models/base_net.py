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

import inspect
import pickle
import zipfile
from typing import Any, Dict, Optional, Tuple

import torch

from basedet_tpu_torch.layers.common.function import full_f32
from basedet_tpu_torch.layers.common.pre_processing import data_to_input, to_device
from basedet_tpu_torch.utils.checkpoint import load_matched_weights
from basedet_tpu_torch.utils.convert_weights import convert_reference_detector_state
from basedet_tpu_torch.utils.logger import logger
from basedet_tpu_torch.utils.weights import state_dict_from_jax


_JAX_COLLECTIONS = {"params", "batch_stats", "frozen"}  # the top keys of a flax variable tree


class BaseNet:
    # True for a model whose losses sample: the train step then hands
    # ``get_losses`` the config's seed and the step (``seed=``, ``step=``)
    draws_per_step = False

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
        """Move the batch to the model's device (a pinned batch without
        blocking the host, ``to_device``), pad to x32 and normalize in NHWC,
        then transpose to NCHW; with ``train``, carry the gt boxes."""
        image = data_to_input(to_device(batch["data"], self.device), self.img_mean, self.img_std)
        img_info = to_device(batch["im_info"], self.device, torch.float32)
        out = {"image": image.permute(0, 3, 1, 2).contiguous(), "img_info": img_info}
        if train:
            out["gt_boxes"] = to_device(batch["gt_boxes"], self.device, torch.float32)
        return out

    def load_weights(self, weight_path: str, ema: bool = False) -> Optional[Dict[str, Any]]:
        """Load a training checkpoint of the port's ``CheckpointHook`` exactly
        (its live weights, or with ``ema`` its EMA parameters beside the live
        BN statistics), or load by matching (``utils/checkpoint.py``, as the
        JAX package loads ``MODEL.WEIGHTS`` and ``det_test``'s payloads): a
        ``torch.save``d state_dict, a pickle of the JAX variable tree with
        numpy leaves, or a pickled flat state dict in the reference's
        (torch/MegEngine) layout, e.g. a backbone-only ImageNet checkpoint.
        Flat states go through the reference detector renames first
        (``utils/convert_weights.py``), which leave the port's own names as
        they are. Returns the matcher's stats, or None for a training
        checkpoint."""
        if zipfile.is_zipfile(weight_path):
            sd = torch.load(weight_path, map_location="cpu", weights_only=True)
        else:
            with open(weight_path, "rb") as f:
                sd = pickle.load(f)
        if sd and set(sd) <= _JAX_COLLECTIONS:
            sd = state_dict_from_jax(sd)
        if "model" in sd and "ema" in sd:  # a training checkpoint
            if ema and sd.get("ema") is None:
                raise ValueError(f"{weight_path} was trained without EMA")
            sd = {**sd["model"], **sd["ema"]} if ema else sd["model"]
            self.module.load_state_dict(sd, strict=True)
            return None
        if ema:
            raise ValueError(f"{weight_path} is not a training checkpoint: it holds no EMA weights")
        matched, stats = load_matched_weights(self.module.state_dict(), convert_reference_detector_state(sd))
        self.module.load_state_dict(matched, strict=True)
        logger.info(f"loaded {weight_path} by matching: {stats['matched']} matched, "
                    f"{len(stats['missing'])} missing, {len(stats['unused'])} unused")
        return stats

    def example_inputs(self, image_size: Tuple[int, int] = (640, 640)) -> Tuple[torch.Tensor, ...]:
        """The arguments of the module's eval forward for one zero image of
        ``image_size`` (a multiple of 32, as ``pre_process`` pads): the image
        (1, 3, H, W), then ``img_info`` (1, 5) or the pixel ``mask`` (1, H, W)
        where the family's forward takes one."""
        H, W = image_size
        args = [torch.zeros((1, 3, H, W), device=self.device)]
        params = inspect.signature(self.module.forward).parameters
        if "img_info" in params:
            args.append(torch.tensor([[H, W, H, W, 0.0]], device=self.device))
        if "mask" in params:
            args.append(torch.ones((1, H, W), device=self.device))
        return tuple(args)

    def dump_static_graph(self, path: str, image_size: Tuple[int, int] = (640, 640)):
        """Export the module's eval forward with ``torch.export.export`` at
        :meth:`example_inputs` and save it to ``path`` with
        ``torch.export.save`` (counterpart of the JAX package's StableHLO
        export). The NMS and RoIAlign kernels appear in the program as the
        custom ops ``basedet::nms_keep`` and ``basedet::roi_align``; a process
        that loads it (:func:`load_static_graph`) registers them by importing
        ``basedet_tpu_torch.ops``. Returns the exported program."""
        training = self.module.training
        self.module.eval()
        try:
            with torch.no_grad():
                program = torch.export.export(self.module, self.example_inputs(image_size))
        finally:
            self.module.train(training)
        torch.export.save(program, path)
        logger.info(f"dumped the exported program to {path}")
        return program


class StaticGraph(torch.nn.Module):
    """A reloaded exported program, called in IEEE f32 (``full_f32``): the
    models' forwards set that around themselves, which a program does not
    record, and on a card PyTorch's default would let cuDNN use TF32."""

    def __init__(self, program: torch.nn.Module):
        super().__init__()
        self.program = program

    def forward(self, *args):
        with full_f32():
            return self.program(*args)


def load_static_graph(path: str) -> StaticGraph:
    """The module of a program that :meth:`BaseNet.dump_static_graph` saved,
    its custom ops registered first."""
    import basedet_tpu_torch.ops  # noqa: F401  (registers basedet::nms_keep and basedet::roi_align)

    return StaticGraph(torch.export.load(path).module())
