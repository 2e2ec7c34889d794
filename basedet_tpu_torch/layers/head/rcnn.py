"""R-CNN box predictor (counterpart of ``RCNNPredictor`` in
``basedet_tpu/layers/head/rcnn.py``): flatten → fc1 (1024) → fc2 (1024) →
class logits (C + 1) and class-specific deltas (C, 4). RoI sampling and the
losses come with training.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class RCNNPredictor(nn.Module):
    def __init__(self, in_features: int, num_classes: int, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.fc1 = nn.Linear(in_features, 1024, device=device)
        self.fc2 = nn.Linear(1024, 1024, device=device)
        self.pred_cls = nn.Linear(1024, num_classes + 1, device=device)
        self.pred_delta = nn.Linear(1024, num_classes * 4, device=device)

    def forward(self, pooled: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """pooled (R, ph, pw, C), channels last as the JAX package pools →
        (logits (R, C + 1), deltas (R, C, 4)). The flatten is in (h, w, c)
        order, the order of the flax ``fc1`` kernel's rows."""
        x = pooled.reshape(pooled.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.pred_cls(x), self.pred_delta(x).reshape(-1, self.num_classes, 4)
