"""Random subsampling of labels with static shapes (counterpart of
``basedet_tpu/layers/common/sampling.py``), batched over images where the JAX
package vmaps.

The randomness is explicit. The sampling functions take their uniform noise
as arguments; :func:`draw_sampling_noise` draws all of one train step's noise
from a generator seeded by (seed, step), as the JAX package folds the step
into its key, so a step's draw does not depend on what ran before it. A CPU
and a CUDA generator give different streams from one seed: to compare the two
devices, draw once and copy.
"""
from __future__ import annotations

from typing import Dict, Union

import torch


def sample_mask(noise: torch.Tensor, candidates: torch.Tensor,
                quota: Union[int, torch.Tensor], cap: int) -> torch.Tensor:
    """Pick at most ``quota`` True entries of ``candidates`` (B, N) uniformly:
    those whose ``noise`` (B, N, uniform in [0, 1)) is among the ``quota``
    largest of the candidates'. ``quota`` is an int or a (B,) tensor, at most
    ``cap``. Returns (B, N) bool.

    The threshold is the quota-th largest score; equal noise at the threshold
    keeps one element more, in both packages alike. When the quota exceeds
    the number of candidates the threshold lands on a -1 filler and every
    candidate is kept. Only the *value* of the quota-th largest score is
    used and no index, so ``torch.topk``, which promises no order among
    ties, is safe here."""
    B, n = candidates.shape
    scores = torch.where(candidates, noise, -1.0)
    cap = min(cap, n)
    top = torch.topk(scores, cap, dim=1).values  # descending
    q = torch.as_tensor(quota, device=scores.device).expand(B).clamp(0, cap)
    kth = top.gather(1, (q - 1).clamp(min=0)[:, None])[:, 0]
    thr = torch.where(q > 0, kth, torch.inf)
    return candidates & (scores >= thr[:, None])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by (seed, step) alone."""
    # the CPU generator keeps the low 32 bits of its seed only: mix the seed
    # into those too (a multiplicative hash), and add the step
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(step)) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def draw_sampling_noise(seed: int, step: int, batch: int, num_anchors: int, num_candidates: int,
                        device) -> Dict[str, torch.Tensor]:
    """One train step's sampling noise for a two-stage detector, uniform in
    [0, 1): ``rpn_pos`` and ``rpn_neg`` (batch, num_anchors) for the RPN's
    positives and negatives, ``rcnn_fg``, ``rcnn_bg`` and ``rcnn_tie``
    (batch, num_candidates) for the R-CNN's foreground, background and the
    order within a tier, from ``step_generator(seed, step, device)``."""
    generator = step_generator(seed, step, device)

    def uniform(n):
        return torch.rand((batch, n), generator=generator, device=device)

    return {"rpn_pos": uniform(num_anchors), "rpn_neg": uniform(num_anchors),
            "rcnn_fg": uniform(num_candidates), "rcnn_bg": uniform(num_candidates),
            "rcnn_tie": uniform(num_candidates)}
