"""Label assignment (counterpart of ``basedet_tpu/layers/common/matcher.py``).
Ported: the IoU-threshold ``Matcher`` of the anchor-based detectors, the
dynamic-k matching of SimOTA and OTA (kernel #2 on the card) and OTA's
Sinkhorn matcher; the batch dimension is written out where the JAX package
vmaps over images. DETR's auction matching is not ported."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from basedet_tpu_torch.layers.common.function import extract_topk_mask, first_argmax
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


def sinkhorn_log(mu: torch.Tensor, nu: torch.Tensor, cost: torch.Tensor, eps: float = 0.1,
                 n_iters: int = 50) -> torch.Tensor:
    """Log-domain Sinkhorn transport plan with a fixed number of iterations:
    mu (B, K+1) supply, nu (B, M) demand, cost (B, K+1, M) → plan (B, K+1,
    M). Plain PyTorch: no TPU kernel computes it."""
    log_mu = torch.log(mu.clamp(min=1e-12))
    log_nu = torch.log(nu.clamp(min=1e-12))
    m = -cost / eps
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(n_iters):
        u = log_mu - torch.logsumexp(m + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(m + u[:, :, None], dim=1)
    return torch.exp(m + u[:, :, None] + v[:, None, :])


@dataclass(frozen=True)
class SinkhornMatcher:
    """OTA's Sinkhorn matcher: each valid gt supplies floor(max(1, the sum of
    its ``topk`` largest ious)) units, the background the rest of the M
    anchors, each anchor demands one; the plan's rows are scaled to a
    maximum of 1 and each anchor goes to its largest entry (the lowest row
    among ties), foreground where that is a valid gt."""

    eps: float = 0.1
    n_iters: int = 50
    topk: int = 20

    def __call__(self, cost: torch.Tensor, bg_cost: torch.Tensor, gt_valid: torch.Tensor,
                 ious: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """cost (B, K, M) foreground costs, bg_cost (B, M), gt_valid (B, K),
        ious (B, K, M) → (matched_gt (B, M) int64, fg_mask (B, M) bool)."""
        B, K, M = cost.shape
        topk_ious, _ = extract_topk_mask(ious, min(self.topk, M))
        ks = torch.where(gt_valid, torch.floor(topk_ious.sum(dim=2).clamp(min=1.0)), 0.0)
        mu = torch.cat([ks, M - ks.sum(dim=1, keepdim=True)], dim=1)
        nu = torch.ones((B, M), dtype=cost.dtype, device=cost.device)
        full_cost = torch.cat([torch.where(gt_valid[:, :, None], cost, 1e6), bg_cost[:, None, :]], dim=1)
        plan = sinkhorn_log(mu, nu, full_cost, self.eps, self.n_iters)
        plan = plan / plan.amax(dim=2, keepdim=True).clamp(min=1e-12)
        assigned = first_argmax(plan, dim=1)
        matched = assigned.clamp(max=K - 1)
        fg_mask = (assigned < K) & torch.gather(gt_valid, 1, matched)
        return matched, fg_mask
