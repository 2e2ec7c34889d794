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
once, in one launch. The backward gives a block a column group (a 64-wide
k-panel of one term, up to 128 columns of N) and persistent 64-row strips:
per strip it forms dy_eff once from one read of y and dy, computes dact by
wgmma (w's k-panel rows resident in shared memory, or, past N = 640, streamed
with y and dy), runs the epilogue and a raw term's prologue on one read of
each M-tensor, and accumulates its dW tile in registers; a second launch adds the
blocks' partial dW tiles and dscale/dshift rows and writes dW rounded to
bf16. Sums across blocks go through partial rows added in a fixed order (the
forward's by its last blocks to finish), so two runs give the same bits.

The host side is kept short: each direction's C description (``_Problem``)
is a template cached per call signature of which only the pointers change
(the backward's dx pointers too), the outputs, partial rows and sums are one
allocation, the plan is cached with the template, the inputs are checked
once, in one pass, in :func:`fused_gemm_stats`, and no device context is
entered when the tensors' device is current.

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
STRIP, PANEL, MAX_PANELS = 64, 64, 2  # kFwdRows, kPanel and the largest NP of the forward
GROUP, MAX_GROUPS = 32, 16  # kGroup, kMaxGroups: the forward's cross-block sums, at most 512 strip blocks
# the backward: kBwdStage, kBwdStageWin, kPanelBytes; the shared memory a block of an H100 may use
# (kMaxSmem), less room for the kernel's static shared variables
BWD_STAGE, BWD_STAGE_WIN, PANEL_BYTES = 16384, 24576, 8192
MAX_SMEM = 232448 - 1024

_P = ctypes.c_void_p


class _Term(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("n_raw", ctypes.c_int), ("K", ctypes.c_int),
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
    lib.basedet_fused_bwd_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                                    ctypes.POINTER(ctypes.c_int)]
    lib.basedet_fused_bwd_blocks_per_sm.restype = ctypes.c_int
    lib.basedet_fused_gemm_stats_bwd.argtypes = [_P, *[ctypes.c_int] * 7, *[_P] * 8]
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


class _Template:
    """A call signature's cached ``_Problem``: ``words`` aliases it as 64-bit
    words, and pointer i of a call goes to ``words[slots[i]]``: flat tensor
    i's, then for the backward each M-tensor's dx, in flat order. ``plan``
    and, for the backward, ``layout`` are filled at the first launch."""

    __slots__ = ("problem", "words", "slots", "plan", "layout")

    def __init__(self, spec, M: int, N: int, ks, backward: bool = False):
        p = self.problem = _Problem(M=M, N=N, n_terms=len(spec))
        self.words = (ctypes.c_int64 * (ctypes.sizeof(_Problem) // 8)).from_buffer(p)
        term, field = ctypes.sizeof(_Term), {f: getattr(_Term, f).offset for f in ("x", "scale", "shift", "w", "dx")}
        slots, dx_slots = [], []
        for i, (s, K) in enumerate(zip(spec, ks)):
            c, base = p.t[i], _Problem.t.offset + i * term
            c.kind, c.n_raw, c.K = (0, 1, K) if s[0] == "act" else (1, s[1], K)
            for j in range(c.n_raw):
                slots.append((base + field["x"]) // 8 + j)
                if s[0] == "raw":
                    slots += [(base + field["scale"]) // 8 + j, (base + field["shift"]) // 8 + j]
                dx_slots.append((base + field["dx"]) // 8 + j)
            slots.append((base + field["w"]) // 8)
        self.slots = tuple(slots + dx_slots if backward else slots)
        self.plan = self.layout = None

    def fill(self, ptrs: Sequence[int]) -> _Problem:
        if len(ptrs) != len(self.slots):
            raise ValueError(f"the template takes {len(self.slots)} pointers, got {len(ptrs)}")
        words = self.words
        for i, ptr in zip(self.slots, ptrs):
            words[i] = ptr
        return self.problem


_TEMPLATES = {}


def _template(spec, M: int, N: int, ks, backward: bool) -> _Template:
    """The cached template of a call signature and direction."""
    key = (spec, M, N, ks, backward)
    tpl = _TEMPLATES.get(key)
    if tpl is None:
        tpl = _TEMPLATES[key] = _Template(spec, M, N, ks, backward)
    return tpl


def _forward_problem(call: _Call) -> Tuple[_Template, _Problem]:
    """The cached forward template of this call's signature, its pointers
    set to the call's (``call.ptrs``, or the tensors' own where the call lies
    on the CPU)."""
    tpl = _template(call.spec, call.M, call.N, call.ks, False)
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


def backward_smem(N: int, spec, stages: int, window: bool = False) -> int:
    """The backward kernel's dynamic shared memory in bytes, as ``bwd_kernel``
    lays it out: 1 KB of alignment, the ring, dy_eff and the k-panel's rows
    of w (a 64-column panel each per 64 columns of N; in the streamed
    variant, ``window``, three dy_eff panels and w's rows in the ring's
    larger stages), a zero slice, and the act staging tile or the per-warp
    dscale/dshift sums of the most raw inputs a term has."""
    n_raw = max([s[1] for s in spec if s[0] == "raw"], default=0)
    aux = max(PANEL_BYTES if any(s[0] == "act" for s in spec) else 0, 2048 * n_raw)
    if window:
        return 1024 + stages * BWD_STAGE_WIN + 3 * PANEL_BYTES + 2048 + aux
    return 1024 + stages * BWD_STAGE + 2 * -(-N // PANEL) * PANEL_BYTES + 2048 + aux


def backward_columns(spec, ks, N: int, npn: int, gx: int) -> List[dict]:
    """The backward's column groups in ``blockIdx.y`` order, as ``column_of``
    in the source computes them: those that own their k-panel's input
    gradients (n0 = 0) first, one per k-panel of every term, then the other
    n-groups k-panel by k-panel. Each is term t, k-panel k0, columns [n0, n0 +
    width) of N, its gx strip blocks' partial rows, gx rows of len floats
    from base (ds_len floats of dscale/dshift where the group owns a raw
    term's k-panel, then the dW tile, 64 x width), and the term's first row
    of dW and first element of dscale/dshift in the outputs."""
    NP = -(-N // PANEL)
    ngn = -(-NP // npn)
    panels = []  # (t, q, dw_row, dsc_off, ds)
    dw_row, dsc_off = 0, 0
    for t, (s, K) in enumerate(zip(spec, ks)):
        ds = 128 * s[1] if s[0] == "raw" else 0
        panels += [(t, q, dw_row, dsc_off, ds) for q in range(-(-K // PANEL))]
        dw_row += K
        dsc_off += 2 * s[1] * K if s[0] == "raw" else 0
    cols, base = [], 0
    for ng, (t, q, dw_row, dsc_off, ds) in [(0, pn) for pn in panels] + \
            [(ng, pn) for pn in panels for ng in range(1, ngn)]:
        n0 = PANEL * npn * ng
        width = min(PANEL * npn, N - n0)
        ds_len = ds if ng == 0 else 0
        cols.append(dict(t=t, k0=PANEL * q, n0=n0, width=width, ds_len=ds_len, len=ds_len + PANEL * width,
                         base=base, dw_row=dw_row, dsc_off=dsc_off))
        base += gx * (ds_len + PANEL * width)
    return cols


class BackwardPlan(NamedTuple):
    """A backward call's launch: panels per column group, w streamed through
    the ring (``window``) or resident, ring stages, persistent strip blocks,
    column groups, dynamic shared memory in bytes."""

    npn: int
    window: bool
    stages: int
    gx: int
    gy: int
    smem: int


def backward_plan(M: int, N: int, spec, ks, sms: int, blocks_for) -> BackwardPlan:
    """The plan of a backward call; ``blocks_for(npn, window, smem)`` is how
    many blocks fit on an SM. Column groups are 64 or 128 columns wide; w's
    rows stay resident unless that does not fit a block at any depth of the
    ring (N past 640, or many raw inputs at 640), and then stream; the ring
    takes the stages (2-6) that let the most blocks share an SM (more warps
    beat more stages ahead), the most of those; strip blocks fill the card,
    twice over where the column groups' work differs (several terms, or
    groups that do not own their k-panel's input gradients), and where w
    streams, enough more that the owners of the k-panels, which stream all of
    N each strip, do not finish last; at most one per strip and 512."""
    NP = -(-N // PANEL)
    npn = 1 if NP == 1 else 2
    window = backward_smem(N, spec, 2) > MAX_SMEM
    fits = [s for s in range(6, 1, -1) if backward_smem(N, spec, s, window) <= MAX_SMEM]
    stages = max(fits, key=lambda s: (blocks_for(npn, window, backward_smem(N, spec, s, window)), s))
    smem = backward_smem(N, spec, stages, window)
    ngn = -(-NP // npn)
    gy = sum(-(-K // PANEL) for K in ks) * ngn
    waves = 2 if len(spec) > 1 or NP > npn else 1
    slots = blocks_for(npn, window, smem) * sms
    gx = max(1, min(-(-M // STRIP), waves * slots // gy, 512))
    if window:
        # an owner's strip takes NP y/dy items and its M-tensors, another group's npn and its
        # M-tensors: enough strip blocks that one owner's strips take no longer than the card's
        # share of every group's items
        n_raw = [s[1] if s[0] == "raw" else 1 for s in spec]
        items = sum(-(-K // PANEL) * (2 * NP - npn + ngn * n) for K, n in zip(ks, n_raw))
        gx = max(gx, min(-(-M // STRIP), -(-(NP + max(n_raw)) * slots // items), 512))
    return BackwardPlan(npn, window, stages, gx, gy, smem)


class _Layout(NamedTuple):
    """The backward's one allocation, in bf16 elements: the dx tensors (flat
    order), every term's dW (bf16), every raw term's dscale/dshift (f32) and
    the partial rows (f32, per column group); ``outputs`` holds the
    cotangents as (f32, offset in elements of their dtype, shape, stride), in
    the Function's order; ``max_len`` is the longest column group's row."""

    dx: Tuple[int, ...]
    dw: int
    dsc: int
    part: int
    total: int
    outputs: tuple
    max_len: int


def backward_layout(spec, M: int, N: int, ks, npn: int, gx: int) -> _Layout:
    """The backward's allocation for a call signature and its plan."""
    cols = backward_columns(spec, ks, N, npn, gx)
    dx, at = [], 0
    for s, K in zip(spec, ks):
        for _ in range(1 if s[0] == "act" else s[1]):
            dx.append(at)
            at += M * K
    dw = at
    dsc = dw + sum(ks) * N
    part = dsc + 2 * sum(2 * s[1] * K for s, K in zip(spec, ks) if s[0] == "raw")
    outputs, i, dw_row, dsc_off = [], 0, 0, dsc // 2
    for s, K in zip(spec, ks):
        if s[0] == "act":
            outputs.append((False, dx[i], (M, K), (K, 1)))
            i += 1
        for _ in range(s[1] if s[0] == "raw" else 0):
            outputs += [(False, dx[i], (M, K), (K, 1)), (True, dsc_off, (K,), (1,)),
                        (True, dsc_off + K, (K,), (1,))]
            i += 1
            dsc_off += 2 * K
        outputs.append((False, dw + dw_row * N, (K, N), (N, 1)))
        dw_row += K
    part_len = cols[-1]["base"] + gx * cols[-1]["len"]
    return _Layout(tuple(dx), dw, dsc, part, part + 2 * part_len, tuple(outputs), max(c["len"] for c in cols))


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


@functools.lru_cache(maxsize=None)
def _bwd_blocks(index: int, npn: int, window: bool, smem: int) -> int:
    """Backward blocks of npn panels, w resident or streamed, and smem bytes
    that fit on an SM of CUDA device ``index``."""
    blocks = ctypes.c_int()
    with torch.cuda.device(index):
        err = _library().basedet_fused_bwd_blocks_per_sm(npn, int(window), smem, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"fused GEMM + stats backward kernel with {npn} panels (window {window}) and {smem} "
                           f"bytes of shared memory does not fit an SM (CUDA error {err}, {blocks.value} blocks)")
    return blocks.value


def _launch_backward(terms, M: int, N: int, device: torch.device, y, dy, ds, dss) -> List[torch.Tensor]:
    _check_card((y, dy, ds, dss))
    spec, flat = flatten_terms(terms)
    ks = tuple(t[2].shape[0] for t in terms)
    tpl = _template(spec, M, N, ks, True)
    if tpl.plan is None:
        index = device.index
        tpl.plan = backward_plan(M, N, spec, ks, _card(index)[0], functools.partial(_bwd_blocks, index))
        tpl.layout = backward_layout(spec, M, N, ks, tpl.plan.npn, tpl.plan.gx)
    lay = tpl.layout
    buf = torch.empty(lay.total, dtype=torch.bfloat16, device=device)
    base = buf.data_ptr()
    p = tpl.fill([a.data_ptr() for a in flat] + [base + 2 * off for off in lay.dx])
    if device.index == torch.cuda.current_device():
        err = _call_backward(p, tpl.plan, base, lay, device, y, dy, ds, dss)
    else:
        with torch.cuda.device(device):
            err = _call_backward(p, tpl.plan, base, lay, device, y, dy, ds, dss)
    if err != 0:
        raise RuntimeError(f"fused GEMM + stats backward kernel launch failed: CUDA error {err}")
    fused_gemm_stats_backward.launches += 1
    f32 = buf.view(torch.float32)
    return [(f32 if is_f32 else buf).as_strided(shape, stride, off) for is_f32, off, shape, stride in lay.outputs]


def _call_backward(p, plan, base, lay, device, y, dy, ds, dss) -> int:
    return _library().basedet_fused_gemm_stats_bwd(
        ctypes.addressof(p), plan.npn, int(plan.window), plan.gx, plan.gy, plan.stages, plan.smem, lay.max_len,
        y.data_ptr(), dy.data_ptr(), ds.data_ptr(), dss.data_ptr(), base + 2 * lay.dw, base + 2 * lay.dsc,
        base + 2 * lay.part,
        torch._C._cuda_getCurrentRawStream(device.index))


def _backward(terms, M: int, N: int, device: torch.device, y, dy, ds, dss) -> List[torch.Tensor]:
    if device.type == "cpu":
        return fused_gemm_stats_backward_plain(terms, y, dy, ds, dss)
    return _launch_backward(terms, M, N, device, y, dy, ds, dss)


def fused_gemm_stats_backward(terms, y: torch.Tensor, dy: torch.Tensor, ds: torch.Tensor,
                              dss: torch.Tensor) -> List[torch.Tensor]:
    """The fused backward (kernel #4): the forward's terms and output y, the
    cotangents dy (M, N) bf16, ds and dss (N,) f32 → the cotangent of every
    flat input, as :func:`~basedet_tpu_torch.ops.fused_bn.fused_gemm_stats_backward_plain`
    defines them. A CUDA tensor goes through the kernel
    (``fused_gemm_stats_backward.launches`` counts its calls: two launches
    each, the strips and the cross-block sums, which write dW rounded to bf16
    themselves); a CPU tensor through the plain version."""
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
