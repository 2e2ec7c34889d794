"""basedet_tpu_torch: the PyTorch/CUDA port of basedet_tpu, beside it.

It imports ``torch`` and never ``jax``, ``flax``, ``optax``, ``cv2`` or the
JAX package ``basedet_tpu``: the host code it shares in purpose (configs,
ConfigDict, registry, logger, meters, the dummy loader, the CLI plumbing,
the COCO records and metrics) is its own copy. It trains YOLOX, Faster
R-CNN, CenterNet and RetinaNet through ``tools/det_train.py`` and serves them
through ``tools/det_test.py``; every Pallas kernel of the JAX package has a
hand-written CUDA counterpart in ``csrc/`` (NMS, SimOTA matching, RoIAlign
forward and backward, the fused 1x1-GEMM + BN statistics forward and
backward, the DCN row scatter, pairwise IoU), built at first use. User
configs live in ``basedet_tpu_torch/playground/<model>/config.py``.
"""
from basedet_tpu_torch.utils.registry import build_evaluator, build_model, build_trainer, registers

__all__ = ["build_evaluator", "build_model", "build_trainer", "registers"]
