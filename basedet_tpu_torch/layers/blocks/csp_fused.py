"""The train-mode CSP layer over the fused 1x1-GEMM + BN-statistics kernels
(counterpart of ``csp_layer_fused`` in ``basedet_tpu/layers/blocks/csp_fused.py``).

Same function as ``CSPLayer`` in train mode under the bf16 policy (conv1 and
conv2 1x1 splits, n bottlenecks of a 1x1 and a 3x3 conv with an optional
residual, the concat, conv3 1x1), with its memory traffic restructured:

  * every 1x1 conv is a fused call carrying its BN statistics out of its
    epilogue and its input's BN affine + SiLU in its prologue;
  * only raw (pre-BN) tensors are stored; the bottleneck shortcut sums are
    prologues over several raw inputs, and conv3 over the concat is a
    split-K pair of terms;
  * the 3x3 conv stays ``F.conv2d`` in bf16 on one materialised activation,
    its statistics one reduction.

M-tensors are ``(B·H·W, C)`` views of channels-last NCHW tensors, so the
layer's input and output change layout for free. The JAX package's lane
packing (``_pack_factor``, block-diagonal ``kron`` weights) is a TPU layout
device and is not carried over: without it the values are the same.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from basedet_tpu_torch.ops.fused_bn import moments_to_affine, stats_to_moments
from basedet_tpu_torch.ops.fused_bn_kernel import fused_gemm_stats


def _silu_bf16(pre: torch.Tensor) -> torch.Tensor:
    return (pre * torch.sigmoid(pre)).to(torch.bfloat16)


def rows_of(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → the (B·H·W, C) rows of its channels-last layout."""
    B, C, H, W = x.shape
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1).reshape(B * H * W, C)


def nchw_of(rows: torch.Tensor, B: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`rows_of`: a channels-last (B, C, H, W) view."""
    return rows.view(B, H, W, rows.shape[1]).permute(0, 3, 1, 2)


def csp_layer_fused(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    n: int,
    *,
    shortcut: bool = True,
    eps: float = 1e-3,
) -> Tuple[torch.Tensor, Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
    """Train-mode fused CSP forward.

    params: ``{conv1,conv2,m{i}a,m{i}b,conv3}/{w,g,b}``, w the conv weight
    (co, ci, k, k) and g, b the BN weight and bias, all f32; x (B, C, H, W)
    bf16. Returns (out (B, out_ch, H, W) bf16, channels-last; {key: (batch
    mean, biased batch variance)}), the moments for the running statistics."""
    B, _, H, W = x.shape
    h = params["conv1/w"].shape[0]
    M = B * H * W
    moments: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def w2d(key):  # (co, ci, 1, 1) → (ci, co) bf16
        w = params[key + "/w"]
        return w.reshape(w.shape[0], w.shape[1]).t().to(torch.bfloat16).contiguous()

    def affine(key, s, ss):
        mean, var = stats_to_moments(s, ss, M)
        moments[key] = (mean, var)
        return moments_to_affine(mean, var, params[key + "/g"], params[key + "/b"], eps)

    def g1x1(key, terms):
        w = w2d(key)
        y, s, ss = fused_gemm_stats([(kind, inp, w) for kind, inp in terms])
        return (y, *affine(key, s, ss))

    rows = rows_of(x.to(torch.bfloat16))
    y1, sc1, sh1 = g1x1("conv1", [("act", rows)])
    y2, sc2, sh2 = g1x1("conv2", [("act", rows)])

    left = [(y1, sc1, sh1)]
    for i in range(n):
        ya, sca, sha = g1x1(f"m{i}a", [("raw", list(left))])
        a = _silu_bf16(ya.float() * sca + sha)
        yb4 = F.conv2d(nchw_of(a, B, H, W), params[f"m{i}b/w"].to(torch.bfloat16), padding=1)
        yb = rows_of(yb4)
        ybf = yb.float()
        scb, shb = affine(f"m{i}b", ybf.sum(0), (ybf * ybf).sum(0))
        left = [*left, (yb, scb, shb)] if shortcut else [(yb, scb, shb)]

    w3 = w2d("conv3")  # conv3 over the concat: left terms hit w3[:h], y2 hits w3[h:]
    y3, s3, ss3 = fused_gemm_stats([("raw", left, w3[:h]), ("raw", [(y2, sc2, sh2)], w3[h:])])
    sc3, sh3 = affine("conv3", s3, ss3)
    out = _silu_bf16(y3.float() * sc3 + sh3)
    return nchw_of(out, B, H, W), moments
