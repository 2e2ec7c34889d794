"""Fused 1x1-GEMM + BN statistics, forward and backward: the two CUDA kernels
in ``csrc/fused_bn.cu``, their wrappers, and the ``torch.autograd.Function``
that joins them (the JAX package's ``jax.custom_vjp`` over
``_fwd_call``/``_bwd_call``).

The forward replaces ``basedet_tpu/ops/fused_bn.py::_fwd_kernel`` (kernel
#3), the backward ``::_bwd_kernel`` (kernel #4). Their plain versions are
``ops/fused_bn.py::fused_gemm_stats_plain`` and
``fused_gemm_stats_backward_plain``.

On the card both are bound by bytes: at YOLOX-S's widths (K, N 32-512) a
tile does a few hundred flops per bf16 element read, under the ~295 per byte
at which the tensor cores would bound it. The forward reads every input once
per 64-column tile of the output and writes y once; the backward reads x, y
and dy for its input-gradient pass and again for its weight-gradient pass.
Sums across blocks go through partial rows and a second pass in a fixed
order, so two runs give the same bits.

The wrappers take M-tensors as row-major (M, K) bf16 (the port holds them as
``(B·H·W, C)`` views of channels-last NCHW tensors), weights (K, N) bf16 and
per-channel vectors (K,) f32, all contiguous and on one device. A CUDA
tensor goes through the kernels, a CPU tensor through the plain versions;
any other device raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from basedet_tpu_torch.ops._build import CSRC, load_library
from basedet_tpu_torch.ops.fused_bn import (
    flatten_terms,
    fused_gemm_stats_backward_plain,
    fused_gemm_stats_plain,
    unflatten_terms,
)

SOURCE = CSRC / "fused_bn.cu"
MAX_TERMS, MAX_RAW = 4, 16  # kMaxTerms, kMaxRaw of the source
TILE = 64  # kTile: output tile, and the forward's rows per partial-sum row
SPLIT_BLOCKS = 4 * 132  # weight-gradient blocks aimed at: four per SM of an H100

_P = ctypes.c_void_p


class _Term(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("n_raw", ctypes.c_int), ("K", ctypes.c_int),
                ("part_off", ctypes.c_int), ("dw_off", ctypes.c_longlong),
                ("x", _P * MAX_RAW), ("scale", _P * MAX_RAW), ("shift", _P * MAX_RAW),
                ("w", _P), ("dx", _P * MAX_RAW)]


class _Problem(ctypes.Structure):
    _fields_ = [("M", ctypes.c_int), ("N", ctypes.c_int), ("n_terms", ctypes.c_int),
                ("t", _Term * MAX_TERMS)]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.basedet_fused_gemm_stats_fwd.argtypes = [ctypes.POINTER(_Problem), _P, _P, _P, _P]
    lib.basedet_fused_gemm_stats_fwd.restype = ctypes.c_int
    lib.basedet_fused_gemm_stats_bwd.argtypes = [
        ctypes.POINTER(_Problem), _P, _P, _P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_longlong,
        _P, ctypes.c_int, ctypes.c_int, _P]
    lib.basedet_fused_gemm_stats_bwd.restype = ctypes.c_int
    return lib


def _check(terms) -> Tuple[tuple, List[torch.Tensor], int, int, torch.device]:
    """Shapes, dtypes and devices of a fused call's terms, and on a CUDA
    tensor what the kernels need beyond → (spec, flat, M, N, device)."""
    spec, flat = flatten_terms(terms)
    if not 1 <= len(spec) <= MAX_TERMS:
        raise ValueError(f"a fused call takes 1-{MAX_TERMS} terms, got {len(spec)}")
    M, N = flat[0].shape[0], terms[0][2].shape[1]
    device = flat[0].device
    for t in terms:
        raws = [(t[1], None, None)] if t[0] == "act" else t[1]
        w = t[2]
        if not 1 <= len(raws) <= MAX_RAW:
            raise ValueError(f"a raw term takes 1-{MAX_RAW} inputs, got {len(raws)}")
        if w.dim() != 2 or w.shape[1] != N or w.dtype != torch.bfloat16:
            raise ValueError(f"weights must be bf16 (K, {N}), got {w.dtype} {tuple(w.shape)}")
        K = w.shape[0]
        for x, scale, shift in raws:
            if x.dim() != 2 or tuple(x.shape) != (M, K) or x.dtype != torch.bfloat16:
                raise ValueError(f"M-tensors must be bf16 ({M}, {K}), got {x.dtype} {tuple(x.shape)}")
            for v in (scale, shift):
                if v is not None and (tuple(v.shape) != (K,) or v.dtype != torch.float32):
                    raise ValueError(f"scale and shift must be f32 ({K},), got {v.dtype} {tuple(v.shape)}")
    if any(a.device != device for a in flat):
        raise ValueError("the tensors of a fused call lie on different devices")
    if device.type == "cuda":
        _check_card(flat, M, N)
    elif device.type != "cpu":
        raise ValueError(f"no fused GEMM kernel for device {device}")
    return spec, flat, M, N, device


def _check_card(tensors: Sequence[torch.Tensor], M: int, N: int) -> None:
    """What the kernels need beyond the shapes and dtypes."""
    for a in tensors:
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError("the fused kernels need contiguous tensors on 16-byte boundaries")
        if a.dim() == 2 and a.shape[1] % 8:
            raise ValueError(f"the fused kernels need K and N multiples of 8, got {tuple(a.shape)}")
    if M >= 2**31 // 2 or N % 8:
        raise ValueError(f"the fused kernels take M < 2**30 and N a multiple of 8, got M={M} N={N}")


def _problem(terms, M: int, N: int) -> Tuple[_Problem, list]:
    """The C description of the terms, and per term its raw inputs."""
    p = _Problem(M=M, N=N, n_terms=len(terms))
    per_term = []
    for i, t in enumerate(terms):
        raws = [(t[1], None, None)] if t[0] == "act" else t[1]
        c = p.t[i]
        c.kind, c.n_raw, c.K = (0 if t[0] == "act" else 1), len(raws), t[2].shape[0]
        c.w = t[2].data_ptr()
        for j, (x, scale, shift) in enumerate(raws):
            c.x[j] = x.data_ptr()
            if scale is not None:
                c.scale[j], c.shift[j] = scale.data_ptr(), shift.data_ptr()
        per_term.append(raws)
    return p, per_term


def _launch_forward(terms, M: int, N: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    p, _ = _problem(terms, M, N)
    y = torch.empty((M, N), dtype=torch.bfloat16, device=device)
    part = torch.empty((-(-M // TILE), 2 * N), dtype=torch.float32, device=device)
    sums = torch.empty(2 * N, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().basedet_fused_gemm_stats_fwd(ctypes.byref(p), y.data_ptr(), part.data_ptr(),
                                                      sums.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fused GEMM + stats kernel launch failed: CUDA error {err}")
    fused_gemm_stats.launches += 1
    return y, sums[:N], sums[N:]


def _launch_backward(terms, M: int, N: int, device: torch.device, y, dy, ds, dss) -> List[torch.Tensor]:
    _check_card((y, dy, ds, dss), M, N)
    p, per_term = _problem(terms, M, N)
    n_tiles = -(-N // TILE)
    # per term: its dx tensors; its dscale/dshift rows (raw) and dw rows in the partial sums
    dx_len, dw_len, kn_tiles, dxs = 0, 0, 0, []
    for c, raws in zip(p.t, per_term):
        dxs.append([torch.empty((M, c.K), dtype=torch.bfloat16, device=device) for _ in raws])
        for j, dx in enumerate(dxs[-1]):
            c.dx[j] = dx.data_ptr()
        if c.kind == 1:
            c.part_off = dx_len
            dx_len += 2 * c.K * len(raws)
        c.dw_off = dw_len
        dw_len += c.K * N
        kn_tiles += -(-c.K // TILE) * n_tiles
    # split the rows so that about SPLIT_BLOCKS blocks share the weight gradients
    rows = -(-M // max(1, min(-(-M // 32), -(-SPLIT_BLOCKS // kn_tiles))))
    splits = -(-M // rows)
    dx_part = torch.empty((-(-M // TILE), max(dx_len, 1)), dtype=torch.float32, device=device)
    dx_sums = torch.empty(max(dx_len, 1), dtype=torch.float32, device=device)
    dw_part = torch.empty((splits, dw_len), dtype=torch.float32, device=device)
    dw_sums = torch.empty(dw_len, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _library().basedet_fused_gemm_stats_bwd(
            ctypes.byref(p), y.data_ptr(), dy.data_ptr(), ds.data_ptr(), dss.data_ptr(),
            dx_part.data_ptr(), dx_len, dx_sums.data_ptr(), dw_part.data_ptr(), dw_len,
            dw_sums.data_ptr(), splits, rows, stream)
    if err != 0:
        raise RuntimeError(f"fused GEMM + stats backward kernel launch failed: CUDA error {err}")
    fused_gemm_stats_backward.launches += 1

    cts: List[torch.Tensor] = []
    for c, t, term_dxs in zip(p.t, terms, dxs):
        K = c.K
        if c.kind == 0:
            cts.append(term_dxs[0])
        for j, dx in enumerate(term_dxs if c.kind == 1 else ()):
            base = c.part_off + 2 * j * K
            cts += [dx, dx_sums[base:base + K], dx_sums[base + K:base + 2 * K]]
        cts.append(dw_sums[c.dw_off:c.dw_off + K * N].view(K, N).to(t[2].dtype))
    return cts


def _backward(terms, M: int, N: int, device: torch.device, y, dy, ds, dss) -> List[torch.Tensor]:
    if device.type == "cpu":
        return fused_gemm_stats_backward_plain(terms, y, dy, ds, dss)
    return _launch_backward(terms, M, N, device, y, dy, ds, dss)


def fused_gemm_stats_backward(terms, y: torch.Tensor, dy: torch.Tensor, ds: torch.Tensor,
                              dss: torch.Tensor) -> List[torch.Tensor]:
    """The fused backward (kernel #4): the forward's terms and output y, the
    cotangents dy (M, N) bf16, ds and dss (N,) f32 → the cotangent of every
    flat input, as :func:`~basedet_tpu_torch.ops.fused_bn.fused_gemm_stats_backward_plain`
    defines them. A CUDA tensor goes through the kernels
    (``fused_gemm_stats_backward.launches`` counts the calls: four launches
    each, the input-gradient, weight-gradient and two partial-sum passes); a
    CPU tensor through the plain version."""
    _, _, M, N, device = _check(terms)
    for v, shape, dtype in ((y, (M, N), torch.bfloat16), (dy, (M, N), torch.bfloat16),
                            (ds, (N,), torch.float32), (dss, (N,), torch.float32)):
        if tuple(v.shape) != shape or v.dtype != dtype or v.device != device:
            raise ValueError(f"y, dy must be bf16 ({M}, {N}), ds, dss f32 ({N},) beside the "
                             f"inputs, got {v.dtype} {tuple(v.shape)} on {v.device}")
    return _backward(terms, M, N, device, y, dy, ds, dss)


fused_gemm_stats_backward.launches = 0


class _FusedGemmStats(torch.autograd.Function):
    """The custom VJP of the JAX package (``fused_bn.py:460-483``): the
    forward saves its inputs and y; the backward takes cotangents of y, s and
    ss (zeros where one arrives as None) and gives one to every input,
    per-channel scale and shift included. ``call`` is (spec, M, N, device)
    of inputs that :func:`_check` has passed."""

    @staticmethod
    def forward(ctx, call, *flat):
        spec, M, N, device = call
        terms = unflatten_terms(spec, flat)
        if device.type == "cpu":
            y, s, ss = fused_gemm_stats_plain(terms)
        else:
            y, s, ss = _launch_forward(terms, M, N, device)
        ctx.call = call
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*flat, y)
        return y, s, ss

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor], ds: Optional[torch.Tensor],
                 dss: Optional[torch.Tensor]):
        *flat, y = ctx.saved_tensors
        spec, M, N, device = ctx.call
        dy = torch.zeros_like(y) if dy is None else dy.to(torch.bfloat16).contiguous()
        ds = y.new_zeros(N, dtype=torch.float32) if ds is None else ds.float().contiguous()
        dss = y.new_zeros(N, dtype=torch.float32) if dss is None else dss.float().contiguous()
        return (None, *_backward(unflatten_terms(spec, flat), M, N, device, y, dy, ds, dss))


def fused_gemm_stats(terms) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused forward (kernel #3), differentiable: terms (see
    ``ops/fused_bn.py``) → y (M, N) bf16, s, ss (N,) f32. A CUDA tensor goes
    through the kernel (``fused_gemm_stats.launches`` counts its calls: a
    GEMM launch and a partial-sum pass each) and its backward through
    :func:`fused_gemm_stats_backward`; a CPU tensor through the plain
    versions. The inputs are checked once, here."""
    spec, flat, M, N, device = _check(terms)
    return _FusedGemmStats.apply((spec, M, N, device), *flat)


fused_gemm_stats.launches = 0
