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
per 64-row strip (all N columns up to 128, column groups beyond that or
where M is too small to fill the card), multiplies with wgmma and writes y
once, in one launch; the backward reads x, y and dy for its input-gradient
pass and again for its weight-gradient pass. Sums across blocks go through
partial rows added in a fixed order, so two runs give the same bits.

The forward's host side is kept short: its C description (``_Problem``) is a
template cached per call signature of which only the pointers change, y, the
partial rows and the sums are one allocation, the plan (column groups,
persistent blocks) is cached with the template, the inputs are checked once,
in one pass, in :func:`fused_gemm_stats`, and no device context is entered
when the tensors' device is current.

The wrappers take M-tensors as row-major (M, K) bf16 (the port holds them as
``(B·H·W, C)`` views of channels-last NCHW tensors), weights (K, N) bf16 and
per-channel vectors (K,) f32, all contiguous and on one device. A CUDA
tensor goes through the kernels, a CPU tensor through the plain versions;
any other device raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
TILE = 64  # kTile: the backward's output tile, and its rows per partial-sum row
SPLIT_BLOCKS = 4 * 132  # weight-gradient blocks aimed at: four per SM of an H100
STRIP, PANEL, MAX_PANELS = 64, 64, 2  # kFwdRows, kPanel and the largest NP of the forward
GROUP, MAX_GROUPS = 32, 16  # kGroup, kMaxGroups: the forward's cross-block sums, at most 512 strip blocks

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
    lib.basedet_fused_gemm_stats_fwd.argtypes = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                 _P, _P, _P, _P, _P]
    lib.basedet_fused_gemm_stats_fwd.restype = ctypes.c_int
    lib.basedet_fused_fwd_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.basedet_fused_fwd_blocks_per_sm.restype = ctypes.c_int
    lib.basedet_fused_gemm_stats_bwd.argtypes = [
        ctypes.POINTER(_Problem), _P, _P, _P, _P, _P, ctypes.c_int, _P, _P, ctypes.c_longlong,
        _P, ctypes.c_int, ctypes.c_int, _P]
    lib.basedet_fused_gemm_stats_bwd.restype = ctypes.c_int
    return lib


class _Call(NamedTuple):
    """A checked fused call: its terms flattened (``flatten_terms`` order),
    their shapes, device and data pointers (on the card)."""

    spec: tuple
    flat: List[torch.Tensor]
    M: int
    N: int
    ks: tuple
    device: torch.device
    ptrs: List[int]


def _check(terms) -> _Call:
    """Shapes, dtypes and devices of a fused call's terms, and on a CUDA
    tensor what the kernels need beyond: contiguous tensors on 16-byte
    boundaries, K and N multiples of 8, M < 2**30. One pass over the tensors,
    each attribute read once: it runs on every call."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"a fused call takes 1-{MAX_TERMS} terms, got {len(terms)}")
    spec, flat = flatten_terms(terms)
    bf16, f32 = torch.bfloat16, torch.float32
    M, N, device = flat[0].shape[0], terms[0][2].shape[-1], flat[0].device
    card = device.type == "cuda"
    if not card and device.type != "cpu":
        raise ValueError(f"no fused GEMM kernel for device {device}")
    ks, i = [], 0
    for s, (_, _, w) in zip(spec, terms):
        n_raw = 1 if s[0] == "act" else s[1]
        if not 1 <= n_raw <= MAX_RAW:
            raise ValueError(f"a raw term takes 1-{MAX_RAW} inputs, got {n_raw}")
        if w.dim() != 2 or w.shape[1] != N or w.dtype != bf16:
            raise ValueError(f"weights must be bf16 (K, {N}), got {w.dtype} {tuple(w.shape)}")
        K = w.shape[0]
        if card and K % 8:
            raise ValueError(f"the fused kernels need K a multiple of 8, got {K}")
        ks.append(K)
        for _ in range(n_raw):
            x = flat[i]
            if x.shape != (M, K) or x.dtype != bf16:
                raise ValueError(f"M-tensors must be bf16 ({M}, {K}), got {x.dtype} {tuple(x.shape)}")
            if s[0] == "raw":
                for v in flat[i + 1:i + 3]:
                    if not isinstance(v, torch.Tensor) or v.shape != (K,) or v.dtype != f32:
                        raise ValueError(f"a raw input's scale and shift must be f32 ({K},), got "
                                         f"{getattr(v, 'dtype', None)} {tuple(getattr(v, 'shape', ()))}")
            i += 1 if s[0] == "act" else 3
        i += 1
    if card:
        _check_size(M, N)
    ptrs = []
    for a in flat:
        if a.device != device:
            raise ValueError("the tensors of a fused call lie on different devices")
        if card:
            ptr = a.data_ptr()
            if ptr % 16 or not a.is_contiguous():
                raise ValueError("the fused kernels need contiguous tensors on 16-byte boundaries")
            ptrs.append(ptr)
    return _Call(spec, flat, M, N, tuple(ks), device, ptrs)


def _check_size(M: int, N: int) -> None:
    """The kernels' limits on M and N (K's is checked per term)."""
    if M >= 2**31 // 2 or N % 8:
        raise ValueError(f"the fused kernels take M < 2**30 and N a multiple of 8, got M={M} N={N}")


def _check_card(tensors: Sequence[torch.Tensor]) -> None:
    """What the kernels need of the backward's extra tensors beyond their
    shapes and dtypes (M and N went through :func:`_check` with the
    forward's terms)."""
    for a in tensors:
        if not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError("the fused kernels need contiguous tensors on 16-byte boundaries")


def _problem(terms, M: int, N: int) -> Tuple[_Problem, list]:
    """The C description of the terms, and per term its raw inputs (the
    backward's, built afresh for each call)."""
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


class _Template:
    """A forward call signature's cached ``_Problem``: ``words`` aliases it as
    64-bit words, and flat tensor i's pointer goes to ``words[slots[i]]``."""

    __slots__ = ("problem", "words", "slots", "plan")

    def __init__(self, spec, M: int, N: int, ks):
        p = self.problem = _Problem(M=M, N=N, n_terms=len(spec))
        self.words = (ctypes.c_int64 * (ctypes.sizeof(_Problem) // 8)).from_buffer(p)
        term, field = ctypes.sizeof(_Term), {f: getattr(_Term, f).offset for f in ("x", "scale", "shift", "w")}
        slots = []
        for i, (s, K) in enumerate(zip(spec, ks)):
            c, base = p.t[i], _Problem.t.offset + i * term
            c.kind, c.n_raw, c.K = (0, 1, K) if s[0] == "act" else (1, s[1], K)
            for j in range(c.n_raw):
                slots.append((base + field["x"]) // 8 + j)
                if s[0] == "raw":
                    slots += [(base + field["scale"]) // 8 + j, (base + field["shift"]) // 8 + j]
            slots.append((base + field["w"]) // 8)
        self.slots = tuple(slots)
        self.plan = None

    def fill(self, ptrs: Sequence[int]) -> _Problem:
        if len(ptrs) != len(self.slots):
            raise ValueError(f"the template takes {len(self.slots)} pointers, got {len(ptrs)}")
        words = self.words
        for i, ptr in zip(self.slots, ptrs):
            words[i] = ptr
        return self.problem


_TEMPLATES = {}


def _forward_problem(call: _Call) -> Tuple[_Template, _Problem]:
    """The cached template of this call's signature, its pointers set to the
    call's (``call.ptrs``, or the tensors' own where the call lies on the
    CPU)."""
    key = (call.spec, call.M, call.N, call.ks)
    tpl = _TEMPLATES.get(key)
    if tpl is None:
        tpl = _TEMPLATES[key] = _Template(call.spec, call.M, call.N, call.ks)
    return tpl, tpl.fill(call.ptrs or [a.data_ptr() for a in call.flat])


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[int, Tuple[int, ...]]:
    """(SMs, forward blocks per SM for 1..MAX_PANELS panels) of CUDA device ``index``."""
    lib, blocks = _library(), ctypes.c_int()
    per_sm = []
    with torch.cuda.device(index):
        for np_ in range(1, MAX_PANELS + 1):
            err = lib.basedet_fused_fwd_blocks_per_sm(np_, ctypes.byref(blocks))
            if err != 0 or blocks.value < 1:
                raise RuntimeError(f"fused GEMM + stats kernel with {np_} panels does not fit an SM "
                                   f"(CUDA error {err}, {blocks.value} blocks)")
            per_sm.append(blocks.value)
    return torch.cuda.get_device_properties(index).multi_processor_count, tuple(per_sm)


def forward_plan(M: int, N: int, sms: int, per_sm: Sequence[int]) -> Tuple[int, int, int]:
    """(panels per block, persistent strip blocks, column groups) of a
    forward call: the widest column group (up to MAX_PANELS panels of 64,
    groups of equal width) that still gives every SM a block, else one panel;
    then as many strip blocks as fit on the card at once, at most one per
    strip."""
    panels, strips = -(-N // PANEL), -(-M // STRIP)
    widths = sorted({-(-panels // g) for g in range(1, panels + 1)} & set(range(1, MAX_PANELS + 1)), reverse=True)
    np_ = next((w for w in widths if strips * -(-panels // w) >= sms), 1)
    groups = -(-panels // np_)
    return np_, max(1, min(strips, per_sm[np_ - 1] * sms // groups, GROUP * MAX_GROUPS)), groups


_COUNTERS = {}


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    """The forward's counters of one stream (one for the second level of its
    cross-block sums, one per first-level group): int32s at 0 between calls
    (the kernel's last blocks reset them)."""
    key = (device.index, stream)
    c = _COUNTERS.get(key)
    if c is None:
        c = _COUNTERS[key] = torch.zeros(1 + MAX_GROUPS, dtype=torch.int32, device=device)
    return c


def _launch_forward(call: _Call):
    M, N, device = call.M, call.N, call.device
    tpl, p = _forward_problem(call)
    if tpl.plan is None:
        tpl.plan = forward_plan(M, N, *_card(device.index))
    np_, gx, gy = tpl.plan
    # one allocation, in bf16 elements: y (M, N), partial rows (gx + ceil(gx / GROUP), 2N) f32,
    # sums (2N,) f32
    y_len, part_len = M * N, 4 * (gx - (-gx // GROUP)) * N
    buf = torch.empty(y_len + part_len + 4 * N, dtype=torch.bfloat16, device=device)
    base = buf.data_ptr()
    if device.index == torch.cuda.current_device():
        err = _call_forward(p, np_, gx, gy, base, y_len, part_len, device)
    else:
        with torch.cuda.device(device):
            err = _call_forward(p, np_, gx, gy, base, y_len, part_len, device)
    if err != 0:
        raise RuntimeError(f"fused GEMM + stats kernel launch failed: CUDA error {err}")
    fused_gemm_stats.launches += 1
    s, ss = buf.view(torch.float32).as_strided((2, N), (N, 1), (y_len + part_len) // 2).unbind()
    return buf.as_strided((M, N), (N, 1)), s, ss


def _call_forward(p, np_, gx, gy, base, y_len, part_len, device) -> int:
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    return _library().basedet_fused_gemm_stats_fwd(
        ctypes.addressof(p), np_, gx, gy, base, base + 2 * y_len, base + 2 * (y_len + part_len),
        _counter(device, stream).data_ptr(), stream)


def _launch_backward(terms, M: int, N: int, device: torch.device, y, dy, ds, dss) -> List[torch.Tensor]:
    _check_card((y, dy, ds, dss))
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
    call = _check(terms)
    M, N, device = call.M, call.N, call.device
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
    per-channel scale and shift included. ``call`` is what :func:`_check`
    made of the inputs, which are ``flat``: nothing here checks them again."""

    @staticmethod
    def forward(ctx, call, *flat):
        if call.device.type == "cpu":
            y, s, ss = fused_gemm_stats_plain(unflatten_terms(call.spec, flat))
        else:
            y, s, ss = _launch_forward(call)
        ctx.shape = call.spec, call.M, call.N, call.device  # the tensors go by save_for_backward
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*flat, y)
        return y, s, ss

    @staticmethod
    def backward(ctx, dy: Optional[torch.Tensor], ds: Optional[torch.Tensor],
                 dss: Optional[torch.Tensor]):
        *flat, y = ctx.saved_tensors
        spec, M, N, device = ctx.shape
        dy = torch.zeros_like(y) if dy is None else dy.to(torch.bfloat16).contiguous()
        ds = y.new_zeros(N, dtype=torch.float32) if ds is None else ds.float().contiguous()
        dss = y.new_zeros(N, dtype=torch.float32) if dss is None else dss.float().contiguous()
        return (None, *_backward(unflatten_terms(spec, flat), M, N, device, y, dy, ds, dss))


def fused_gemm_stats(terms) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fused forward (kernel #3), differentiable: terms (see
    ``ops/fused_bn.py``) → y (M, N) bf16, s, ss (N,) f32. A CUDA tensor goes
    through the kernel (``fused_gemm_stats.launches`` counts its calls, one
    launch each) and its backward through :func:`fused_gemm_stats_backward`;
    a CPU tensor through the plain versions. The inputs are checked once,
    here."""
    call = _check(terms)
    return _FusedGemmStats.apply(call, *call.flat)


fused_gemm_stats.launches = 0
