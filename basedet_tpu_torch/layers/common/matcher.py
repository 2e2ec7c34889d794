"""Label assignment (counterpart of ``basedet_tpu/layers/common/matcher.py``).
Ported: the IoU-threshold ``Matcher`` of the anchor-based detectors and
SimOTA's dynamic-k matching; the batch dimension is written out where the JAX
package vmaps over images."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from basedet_tpu_torch.layers.common.function import first_argmax
from basedet_tpu_torch.ops.matching_kernel import dynamic_k_matching

_NEG = -1e8


@dataclass(frozen=True)
class Matcher:
    """IoU-threshold matcher with optional low-quality matches.

    thresholds: ascending bin edges, e.g. (0.3, 0.7); labels: one per bin,
    e.g. (0, -1, 1): below 0.3 background, [0.3, 0.7) ignored, from 0.7
    foreground. With ``allow_low_quality_matches`` every candidate that
    equals a valid gt's best quality becomes foreground, ties all of them,
    also when that best is 0 (a gt that nothing overlaps marks every
    candidate of quality 0), as the JAX package has it."""

    thresholds: Sequence[float]
    labels: Sequence[int]
    allow_low_quality_matches: bool = False

    def __call__(self, matrix: torch.Tensor, row_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """matrix (B, K, M) quality (IoU) of K padded gts against M
        candidates, row_valid (B, K) bool → (match_indices (B, M) int64, the
        lowest index among equally good gts, labels (B, M) int64)."""
        assert len(self.thresholds) + 1 == len(self.labels)
        masked = torch.where(row_valid[:, :, None], matrix, _NEG)
        max_scores = masked.amax(dim=1)
        match_indices = first_argmax(masked, dim=1)

        labels = torch.full_like(match_indices, -1)
        edges = [-torch.inf, *self.thresholds, torch.inf]
        for label, low, high in zip(self.labels, edges[:-1], edges[1:]):
            labels = torch.where((max_scores >= low) & (max_scores < high), label, labels)

        if self.allow_low_quality_matches:
            row_max = masked.amax(dim=2, keepdim=True)
            is_best = (masked == row_max) & row_valid[:, :, None]
            labels = torch.where(is_best.any(dim=1), 1, labels)
        return match_indices, labels


def topk_dynamic_k_matching(
    cost: torch.Tensor, ious: torch.Tensor, gt_valid: torch.Tensor, candidate_topk: int = 10
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cost, ious (B, K, M), gt_valid (B, K) → (matched_gt (B, M) int32,
    fg_mask (B, M) bool). A CUDA tensor goes through the matching kernel, a
    CPU tensor through its plain version (``ops/matching_kernel.py``)."""
    return dynamic_k_matching(cost.contiguous(), ious.contiguous(), gt_valid.contiguous(),
                              candidate_topk)
