"""basedet_tpu_torch: the PyTorch/CUDA port of basedet_tpu, beside it.

It imports ``torch`` and never ``jax``, ``flax``, ``optax``, ``cv2`` or the
JAX package ``basedet_tpu``: the host code it shares in purpose (configs,
ConfigDict, registry, logger, meters, the dummy loader, the CLI plumbing,
the COCO records and metrics) is its own copy. Today it trains YOLOX through
``tools/det_train.py``, with SimOTA's dynamic-k matching in the CUDA kernel
``csrc/matching.cu``; and it runs YOLOX and Faster R-CNN inference through
``tools/det_test.py``, with NMS in ``csrc/nms.cu`` and Faster R-CNN's
multilevel RoIAlign in ``csrc/roi_align.cu``. User configs live in
``basedet_tpu_torch/playground/<model>/config.py``.
"""
from basedet_tpu_torch.utils.registry import build_evaluator, build_model, build_trainer, registers

__all__ = ["build_evaluator", "build_model", "build_trainer", "registers"]
