"""The one generator of the traffic files: COCO-like training batches on
the device, and host batches of images to serve.

Every seed gets the same multiset of gt counts (the distribution's
quantiles over the pool's images, in an order drawn from the seed), so that
the work of a step does not move from seed to seed; the seed draws where
the boxes lie, their sizes, their classes and the pixels.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


def gt_counts(dist: Dict, n: int, cap: int) -> List[int]:
    """The ``n`` quantiles ``(i + 0.5) / n`` of ``1 + NegBin(r, mean - 1)``,
    capped: a heavy-tailed count with the stated mean and at least 1."""
    r, m = float(dist["dispersion"]), float(dist["mean"]) - 1.0
    p = r / (r + m)
    cdf, k, out = 0.0, 0, []
    log_pmf = lambda j: (math.lgamma(j + r) - math.lgamma(r) - math.lgamma(j + 1)  # noqa: E731
                         + r * math.log(p) + j * math.log1p(-p))
    targets = [(i + 0.5) / n for i in range(n)]
    cdf = math.exp(log_pmf(0))
    for t in targets:
        while cdf < t and k < cap - 1:
            k += 1
            cdf += math.exp(log_pmf(k))
        out.append(min(1 + k, cap))
    return out


def train_pool(traffic: Dict, batch: int, image_hw, max_instances: int, num_classes: int, seed: int,
               device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool_batches"]`` distinct training batches on ``device``:
    data (B, H, W, 3) uint8, im_info (B, 5), gt_boxes (B, K, 5)."""
    P, (H, W), K = int(traffic["pool_batches"]), image_hw, max_instances
    n = P * batch
    gen = torch.Generator(device=device).manual_seed(int(seed))
    counts = torch.tensor(gt_counts(traffic["gt_per_image"], n, K), device=device)
    counts = counts[torch.randperm(n, generator=gen, device=device)]
    # box sizes: the area class, then sqrt(area) log-uniform inside it, then an aspect ratio
    areas = traffic["box_area"]
    edges = torch.tensor([a["sqrt_area"] for a in areas], dtype=torch.float32, device=device)  # (3, 2)
    edges[:, 1].clamp_(max=float(traffic["max_side_share"]) * min(H, W))
    share = torch.tensor([a["share"] for a in areas], dtype=torch.float32, device=device)
    u = torch.rand((6, n, K), generator=gen, device=device)
    cls_of = torch.searchsorted(torch.cumsum(share / share.sum(), 0), u[0].contiguous()).clamp(max=len(areas) - 1)
    lo, hi = edges[cls_of, 0].log(), edges[cls_of, 1].log()
    side = torch.exp(lo + (hi - lo) * u[1])
    ratio = torch.exp(math.log(traffic["aspect_max"]) * (2 * u[2] - 1))  # h / w
    w = (side / ratio.sqrt()).clamp(2.0, W - 2.0)
    h = (side * ratio.sqrt()).clamp(2.0, H - 2.0)
    x1 = u[3] * (W - 1 - w)
    y1 = u[4] * (H - 1 - h)
    labels = (1 + (u[5] * num_classes).long().clamp(max=num_classes - 1)).float()
    gt = torch.stack([x1, y1, x1 + w, y1 + h, labels], -1)
    gt = torch.where((torch.arange(K, device=device)[None, :] < counts[:, None])[..., None], gt, 0.0)
    data = torch.randint(0, 256, (n, H, W, 3), generator=gen, device=device, dtype=torch.uint8)
    info = torch.tensor([H, W, H, W], dtype=torch.float32, device=device).repeat(n, 1)
    info = torch.cat([info, counts[:, None].float()], 1)
    return [{"data": data[i * batch:(i + 1) * batch], "im_info": info[i * batch:(i + 1) * batch],
             "gt_boxes": gt.view(n, K, 5)[i * batch:(i + 1) * batch]} for i in range(P)]


def infer_pool(traffic: Dict, batch: int, image_hw, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``traffic["pool_batches"]`` distinct host batches, page-locked as the
    port's collator pins them: data (B, H, W, 3) uint8, im_info (B, 5)."""
    P, (H, W) = int(traffic["pool_batches"]), image_hw
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pin = torch.device(device).type == "cuda"
    out = []
    for _ in range(P):
        data = torch.randint(0, 256, (batch, H, W, 3), generator=gen, device=device, dtype=torch.uint8)
        info = torch.tensor([[H, W, H, W, 0.0]] * batch)
        out.append({"data": data.cpu().pin_memory() if pin else data.cpu(),
                    "im_info": info.pin_memory() if pin else info})
    return out
