"""The NMS and RoIAlign kernels' outputs on seeded inputs, to hold two trees
of the port to each other bit for bit on an NVIDIA GPU:

    PYTHONPATH=<tree A> python scripts/kernel_bits.py save A.pt
    PYTHONPATH=<tree B> python scripts/kernel_bits.py save B.pt
    python scripts/kernel_bits.py compare A.pt B.pt

``save`` runs ``nms_keep`` at Faster R-CNN's and YOLOX's shapes ((1, 4819),
(2, 8819), (8, 3000)) and ``multilevel_roi_align`` forward and backward, f32
and bf16, on P2-P5 of an 800x1344 image with 256 channels at (B, R) = (1,
1000) and (2, 512), from a generator seeded 0, and saves every output on the
CPU. ``compare`` prints each output and whether the two files hold the same
bits, and exits nonzero if any differs. To check a change against its parent:
unpack ``git archive HEAD basedet_tpu_torch`` into a directory that
``.gitignore`` lists and save once with each tree on ``PYTHONPATH``.
"""
from __future__ import annotations

import sys

import torch

SIZES = [(200, 336), (100, 168), (50, 84), (25, 42)]  # P2-P5 at 800x1344
STRIDES = (4, 8, 16, 32)


def save(path: str) -> None:
    from basedet_tpu_torch.ops.nms_kernel import nms_keep
    from basedet_tpu_torch.ops.roi_align import roi_level_assignment
    from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for B, K in ((1, 4819), (2, 8819), (8, 3000)):
        xy = torch.rand(B, K, 2, generator=g, device="cuda") * 800
        wh = torch.rand(B, K, 2, generator=g, device="cuda") * 200 + 1
        boxes = torch.cat([xy, xy + wh], -1).contiguous()
        valid = torch.rand(B, K, generator=g, device="cuda") < 0.95
        out[f"nms_{B}_{K}"] = nms_keep(boxes, valid, 0.7)
    for dtype in (torch.float32, torch.bfloat16):
        for B, R in ((1, 1000), (2, 512)):
            feats = [torch.randn(B, 256, h, w, generator=g, device="cuda").to(dtype).requires_grad_(True)
                     for h, w in SIZES]
            xy = torch.rand(B, R, 2, generator=g, device="cuda") * torch.tensor([1300.0, 780.0], device="cuda")
            wh = torch.rand(B, R, 2, generator=g, device="cuda") * 400 + 2
            rois = torch.cat([xy, xy + wh], -1)
            levels = roi_level_assignment(rois, 2, 5)
            y = multilevel_roi_align(feats, rois, levels, STRIDES)
            dy = torch.randn(y.shape, generator=g, device="cuda").to(dtype)
            tag = f"{str(dtype)[6:]}_{B}_{R}"
            out[f"roi_align_{tag}"] = y.detach()
            for level, d in enumerate(torch.autograd.grad(y, feats, dy)):
                out[f"roi_align_backward_{tag}_P{level + 2}"] = d
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    print(f"saved {len(out)} outputs to {path}")


def compare(path_a: str, path_b: str) -> int:
    a, b = torch.load(path_a), torch.load(path_b)
    differ = 0
    for k in a:
        same = torch.equal(a[k], b[k])
        differ += not same
        print(f"{k} {tuple(a[k].shape)} {a[k].dtype}: {'bit-equal' if same else 'DIFFERENT'}")
    print(f"{len(a) - differ} of {len(a)} outputs bit-equal")
    return 1 if differ or a.keys() != b.keys() else 0


if __name__ == "__main__":
    if sys.argv[1] == "save":
        save(sys.argv[2])
    else:
        raise SystemExit(compare(sys.argv[2], sys.argv[3]))
