"""The NMS, RoIAlign and row-scatter kernels' outputs on seeded inputs, to hold
two trees of the port to each other bit for bit on an NVIDIA GPU:

    PYTHONPATH=<tree A> python scripts/kernel_bits.py save A.pt
    PYTHONPATH=<tree B> python scripts/kernel_bits.py save B.pt
    python scripts/kernel_bits.py compare A.pt B.pt

``save`` runs ``nms_keep`` at Faster R-CNN's and YOLOX's shapes ((1, 4819),
(2, 8819), (8, 3000)) and ``multilevel_roi_align`` forward and backward, f32
and bf16, on P2-P5 of an 800x1344 image with 256 channels at (B, R) = (1,
1000) and (2, 512), and ``scatter_rows`` (kernel #9) at CenterNet's three DCN
stage shapes at batch 16 of 512x512 ((16, 2304, 8192) into 289 rows, (16,
9216, 1024) into 1089, (16, 36864, 512) into 4225) on ids spread over the rows
with some out of range, and on one case with every entry of an image on one
row and one with ~115 entries a row: f32 values to f32, bf16 values to f32 and
to bf16. A tree whose ``scatter_rows`` has no ``out_dtype`` saves its f32 sum
cast to bf16 for the last, the same function. Inputs come from a generator
seeded 0; every output is saved on the CPU. ``compare`` prints each output and
whether the two files hold the same bits, and exits nonzero if any differs. To
check a change against its parent: unpack ``git archive HEAD
basedet_tpu_torch`` into a directory that ``.gitignore`` lists and save once
with each tree on ``PYTHONPATH``.
"""
from __future__ import annotations

import inspect
import sys

import torch

SIZES = [(200, 336), (100, 168), (50, 84), (25, 42)]  # P2-P5 at 800x1344
STRIDES = (4, 8, 16, 32)
# (B, N, D, R): CenterNet's DCN stages at batch 16 of 512x512, then every entry on one row, and ~115 a row
SCATTER_CASES = [(16, 2304, 8192, 289), (16, 9216, 1024, 1089), (16, 36864, 512, 4225), (4, 2304, 1024, 289),
                 (4, 2304, 1024, 20)]


def save_scatter(g, out):
    """Kernel #9's outputs at SCATTER_CASES into out."""
    from basedet_tpu_torch.ops.scatter_rows_kernel import scatter_rows

    has_out_dtype = "out_dtype" in inspect.signature(scatter_rows).parameters
    for case, (B, N, D, R) in enumerate(SCATTER_CASES):
        if case == 3:
            idx = torch.full((B, N), 7, dtype=torch.int32, device="cuda")
        else:  # spread, some of them outside [0, R)
            idx = torch.randint(-2, R + 2, (B, N), generator=g, device="cuda", dtype=torch.int32)
        values = torch.randn(B, N, D, generator=g, device="cuda")
        tag = f"scatter_rows_{B}_{N}_{D}_{R}"
        out[f"{tag}_f32"] = scatter_rows(idx, values, R)
        low = values.bfloat16()
        out[f"{tag}_bf16_to_f32"] = scatter_rows(idx, low, R)
        out[f"{tag}_bf16_to_bf16"] = (scatter_rows(idx, low, R, out_dtype=torch.bfloat16) if has_out_dtype
                                      else scatter_rows(idx, low, R).to(torch.bfloat16))


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
    save_scatter(g, out)
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
