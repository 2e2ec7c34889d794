"""Label assignment (counterpart of ``basedet_tpu/layers/common/matcher.py``).
Only SimOTA's dynamic-k matching is ported; the batch dimension is written
out where the JAX package vmaps over images."""
from __future__ import annotations

from typing import Tuple

import torch

from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching


def topk_dynamic_k_matching(
    cost: torch.Tensor, ious: torch.Tensor, gt_valid: torch.Tensor, candidate_topk: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cost, ious (B, K, M), gt_valid (B, K) → (matched_gt (B, M) int32,
    fg_mask (B, M) bool). A CUDA tensor goes through the matching kernel, a
    CPU tensor through its plain version (``ops/matching_kernel.py``)."""
    return dynamic_k_matching(cost.contiguous(), ious.contiguous(), gt_valid.contiguous(),
                              candidate_topk)
