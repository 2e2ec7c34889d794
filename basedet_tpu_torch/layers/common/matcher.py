"""Label assignment (counterpart of ``basedet_tpu/layers/common/matcher.py``).
Ported: the IoU-threshold ``Matcher`` of the anchor-based detectors, the
dynamic-k matching of SimOTA and OTA (kernel #2 on the card), OTA's
Sinkhorn matcher and DETR's auction (``hungarian_match_owner``); the batch
dimension is written out where the JAX package vmaps over images."""
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


# the auction's host reads of its convergence test: after this many rounds, then after chunks
# doubling up to the last
AUCTION_FIRST_CHECK, AUCTION_MAX_CHUNK = 4, 16


class AuctionStats:
    """What the last :func:`hungarian_match_owner` call did: ``rounds`` run on
    the device, ``syncs`` (host reads of the convergence test), whether the
    greedy completion ran (``completed``), and ``needed``, a (P,) device
    tensor of the rounds each problem took before it converged (at most the
    cap)."""

    rounds = 0
    syncs = 0
    completed = False
    needed: torch.Tensor = torch.zeros(0)


def hungarian_match_owner(cost: torch.Tensor, valid: torch.Tensor, n_iters: int = 1500,
                          eps_scale: float = 2e-3) -> torch.Tensor:
    """DETR's asymmetric auction (``basedet_tpu/layers/common/matcher.py::
    hungarian_match_owner``), batched over P independent problems as the
    JAX package vmaps it: cost (P, Q, K), valid (P, K) bool → (P, K) int64,
    the query owned by each valid target, -2 for an invalid one.

    Targets bid: each unassigned valid target bids for its best query net of
    prices, ``best - second + eps``, with eps ``eps_scale`` times the range
    of the problem's valid costs; the highest bid wins a query (the lowest
    target among equal bids) and evicts its owner. Best and second follow
    ``lax.top_k``: the best is the first maximum, the second the maximum of
    the rest. After at most ``n_iters`` rounds, a greedy completion gives any
    target still unassigned its best free query, target by target.

    The JAX ``while_loop`` ends when no valid target of the problem is
    unassigned; a problem in that state is a fixed point of a round (no bid,
    no win, no price change), so the rounds run for every problem together
    and the host reads the test after ``AUCTION_FIRST_CHECK`` rounds, then
    after chunks that double up to ``AUCTION_MAX_CHUNK`` rounds: the owners
    are the same as long as the cap holds. The completion runs only when a target is
    still unassigned at the cap. Plain PyTorch: no TPU kernel computes it.
    ``AuctionStats`` keeps the call's counts."""
    P, Q, K = cost.shape
    device = cost.device
    valid = valid.to(torch.bool)
    inf = torch.tensor(torch.inf, dtype=cost.dtype, device=device)
    vmax = torch.where(valid[:, None, :], cost, -inf).amax(dim=(1, 2))
    vmin = torch.where(valid[:, None, :], cost, inf).amin(dim=(1, 2))
    vmax = torch.where(torch.isfinite(vmax), vmax, 0.0)
    vmin = torch.where(torch.isfinite(vmin), vmin, 0.0)
    eps = eps_scale * torch.clamp(vmax - vmin, min=1e-6)  # (P,)
    value = torch.where(valid[:, None, :], -cost, 0.0).transpose(1, 2)  # (P, K, Q) benefits

    q_idx = torch.arange(Q, device=device).expand(P, Q)
    q_of_k = torch.where(valid, -1, -2).long()
    k_of_q = torch.full((P, Q), -1, dtype=torch.long, device=device)
    prices = torch.zeros((P, Q), dtype=cost.dtype, device=device)
    needed = torch.zeros(P, dtype=torch.long, device=device)
    dump = torch.full((P, 1), -3, dtype=torch.long, device=device)  # column K: dropped writes

    def round_():
        nonlocal q_of_k, k_of_q, prices, needed
        unassigned = q_of_k == -1
        needed = needed + unassigned.any(dim=1)
        net = value - prices[:, None, :]
        best_q = first_argmax(net, dim=2)  # (P, K)
        best = net.gather(2, best_q[..., None])[..., 0]
        second = net.scatter(2, best_q[..., None], -torch.inf).amax(dim=2)
        bid = torch.where(unassigned, best - second + eps[:, None], 0.0)
        bids = torch.zeros_like(net).scatter_(2, best_q[..., None], bid[..., None])  # (P, K, Q)
        win_bid = bids.amax(dim=1)
        winner = first_argmax(bids, dim=1)  # (P, Q)
        won = win_bid > 0
        prev = torch.where(won, k_of_q, -1)
        q_of_k = torch.cat([q_of_k, dump], 1).scatter(1, torch.where(prev >= 0, prev, K), -1)[:, :K]
        q_of_k = torch.cat([q_of_k, dump], 1).scatter(1, torch.where(won, winner, K), q_idx)[:, :K]
        k_of_q = torch.where(won, winner, k_of_q)
        stale = (k_of_q >= 0) & (q_of_k.gather(1, k_of_q.clamp(0, K - 1)) != q_idx)
        k_of_q = torch.where(stale, -1, k_of_q)
        prices = torch.where(won, prices + win_bid, prices)

    rounds = syncs = 0
    chunk, left = AUCTION_FIRST_CHECK, True
    while left and rounds < n_iters:
        for _ in range(min(chunk, n_iters - rounds)):
            round_()
            rounds += 1
        syncs += 1
        left = bool((q_of_k == -1).any())
        chunk = min(2 * chunk, AUCTION_MAX_CHUNK)
    completed = left
    if completed:
        owned = torch.zeros((P, Q + 1), dtype=torch.bool, device=device)
        owned = owned.scatter(1, torch.where(q_of_k >= 0, q_of_k, Q), True)[:, :Q]
        rows = torch.arange(P, device=device)
        for k in range(K):
            need = q_of_k[:, k] == -1
            q = first_argmax(torch.where(owned, -torch.inf, value[:, k]), dim=1)
            q_of_k[:, k] = torch.where(need, q, q_of_k[:, k])
            owned[rows, q] |= need
    AuctionStats.rounds, AuctionStats.syncs, AuctionStats.completed = rounds, syncs, completed
    AuctionStats.needed = needed
    return q_of_k
