"""Fused 1x1-GEMM + train-BN statistics: the terms API, the plain versions
of the two kernels and the BN-statistics glue (counterpart of
``basedet_tpu/ops/fused_bn.py``). The kernels and their autograd Function
are in ``ops/fused_bn_kernel.py``.

A fused call is a list of *terms*, each adding ``a_t @ w_t`` to one output:

  ("act", x (M, K) bf16, w (K, N) bf16)           # x is already an activation
  ("raw", [(x (M, K) bf16, scale (K,) f32, shift (K,) f32), ...], w (K, N) bf16)
      # a = bf16(sum_j silu(x_j * scale_j + shift_j)), in f32: a BN affine +
      # SiLU prologue over raw (pre-BN) inputs, and shortcut sums

and gives ``(y (M, N) bf16, s (N,) f32, ss (N,) f32)``: the raw output and
the per-channel sum and sum of squares of the bf16-rounded y, the values its
consumers read back.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from basedet_tpu_torch.layers.common.function import full_f32


def flatten_terms(terms) -> Tuple[tuple, List[torch.Tensor]]:
    """terms → (spec, flat tensors): spec is ``("act",)`` or ``("raw", n)``
    per term, flat the tensors in order (x, w; or x, scale, shift per raw
    input, then w)."""
    spec, flat = [], []
    for t in terms:
        if t[0] == "act":
            spec.append(("act",))
            flat += [t[1], t[2]]
        elif t[0] == "raw":
            spec.append(("raw", len(t[1])))
            for x, scale, shift in t[1]:
                flat += [x, scale, shift]
            flat.append(t[2])
        else:
            raise ValueError(f"unknown term kind {t[0]!r}")
    return tuple(spec), flat


def unflatten_terms(spec, flat: Sequence[torch.Tensor]) -> list:
    """The inverse of :func:`flatten_terms`."""
    terms, i = [], 0
    for s in spec:
        if s[0] == "act":
            terms.append(("act", flat[i], flat[i + 1]))
            i += 2
        else:
            raws = [tuple(flat[i + 3 * j:i + 3 * j + 3]) for j in range(s[1])]
            i += 3 * s[1]
            terms.append(("raw", raws, flat[i]))
            i += 1
    if i != len(flat):
        raise ValueError(f"spec {spec} takes {i} tensors, got {len(flat)}")
    return terms


def _silu(p: torch.Tensor) -> torch.Tensor:
    return p * torch.sigmoid(p)


def _dsilu(p: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(p)
    return s * (1.0 + p * (1.0 - s))


def _prologue(raws) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """(a bf16, pre-activations f32, inputs f32) of a raw term."""
    a, pres, xfs = None, [], []
    for x, scale, shift in raws:
        xf = x.float()
        pre = xf * scale + shift
        xfs.append(xf)
        pres.append(pre)
        a = _silu(pre) if a is None else a + _silu(pre)
    return a.to(torch.bfloat16), pres, xfs


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 product of bf16 operands: the products are exact in f32, the sums
    f32, TF32 off (``preferred_element_type=jnp.float32``)."""
    with full_f32():
        return a.float() @ b.float()


def fused_gemm_stats_plain(terms) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused forward, kernel #3
    (``fused_gemm_stats_oracle`` and ``_fwd_kernel`` of the JAX package;
    ``fused_gemm_stats_plain.calls`` counts its calls). No gradient of its
    own: ``ops/fused_bn_kernel.py``'s Function pairs it with
    :func:`fused_gemm_stats_backward_plain`."""
    fused_gemm_stats_plain.calls += 1
    acc = None
    for t in terms:
        a = t[1] if t[0] == "act" else _prologue(t[1])[0]
        d = _mm(a, t[2])
        acc = d if acc is None else acc + d
    y = acc.to(torch.bfloat16)
    yf = y.float()
    return y, yf.sum(0), (yf * yf).sum(0)


fused_gemm_stats_plain.calls = 0


def fused_gemm_stats_backward_plain(terms, y: torch.Tensor, dy: torch.Tensor, ds: torch.Tensor,
                                    dss: torch.Tensor) -> List[torch.Tensor]:
    """Plain PyTorch version of the fused backward, kernel #4, step by step
    as ``_bwd_kernel`` of the JAX package computes it
    (``fused_gemm_stats_backward_plain.calls`` counts its calls): the forward's
    output y (M, N) bf16 and the cotangents dy (M, N) bf16, ds and dss (N,)
    f32 → the cotangent of every flat input, in :func:`flatten_terms` order.

    ``dy_eff = bf16(dy + ds + 2·y·dss)`` (the JAX VJP rounds it to bf16, where
    autodiff of the forward would not); per act term ``dx = bf16(dy_eff @
    wᵀ)``, ``dw = xᵀ @ dy_eff``; per raw term the prologue is recomputed,
    ``dact = dy_eff @ wᵀ`` in f32, ``dw = a16ᵀ @ dy_eff``, and per raw input
    ``g = dact·dsilu(pre)``, ``dx = bf16(g·scale)``, ``dscale = Σ_rows
    g·x``, ``dshift = Σ_rows g``. Each cotangent takes its input's dtype, dw
    that of w (bf16), as the JAX VJP casts them."""
    fused_gemm_stats_backward_plain.calls += 1
    dy16 = (dy.float() + ds + 2.0 * y.float() * dss).to(torch.bfloat16)
    cts: List[torch.Tensor] = []
    for t in terms:
        w = t[2]
        dact = _mm(dy16, w.t())
        if t[0] == "act":
            x = t[1]
            cts += [dact.to(x.dtype), _mm(x.t(), dy16).to(w.dtype)]
            continue
        a16, pres, xfs = _prologue(t[1])
        for (x, scale, shift), pre, xf in zip(t[1], pres, xfs):
            g = dact * _dsilu(pre)
            cts += [(g * scale).to(x.dtype), (g * xf).sum(0).to(scale.dtype),
                    g.sum(0).to(shift.dtype)]
        cts.append(_mm(a16.t(), dy16).to(w.dtype))
    return cts


fused_gemm_stats_backward_plain.calls = 0


def stats_to_moments(s: torch.Tensor, ss: torch.Tensor, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares, n) → (mean, biased variance), differentiable."""
    mean = s / count
    var = torch.clamp_min(ss / count - mean * mean, 0.0)
    return mean, var


def moments_to_affine(mean, var, gamma, beta, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The BN affine prefold ``x_hat = x·scale + shift``, differentiable."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale
