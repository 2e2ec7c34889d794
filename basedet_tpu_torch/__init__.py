"""basedet_tpu_torch: the PyTorch/CUDA port of basedet_tpu, beside it.

It imports ``torch`` and never ``jax``, ``flax``, ``optax`` or ``cv2``; of
``basedet_tpu`` it uses only host code that needs none of them (configs,
utils, the dummy loader, the CLI plumbing, the COCO records and metrics).
Today it trains YOLOX through ``tools/det_train.py``, with SimOTA's dynamic-k
matching in the CUDA kernel ``csrc/matching.cu``, and runs YOLOX inference
through ``tools/det_test.py``, with NMS in the CUDA kernel ``csrc/nms.cu``.
"""
from basedet_tpu_torch.utils.registry import build_evaluator, build_model, build_trainer, registers

__all__ = ["build_evaluator", "build_model", "build_trainer", "registers"]
