"""The port's RoIAlign in bf16 (the JAX package's Pallas kernels' own dtype)
against the JAX package on the CPU: the plain forward and its gradient
(autograd of the plain forward, and the plain backward the card's backward
kernel is held to) against ``multilevel_roi_align_batched`` on bf16 features
and its ``jax.vjp``, and against the window Pallas kernel
(``pool_rois_window``) in interpret mode, forward and backward, on random
RoIs.

Tolerance: one bf16 ulp, elementwise, of the larger of the two values. Both
sides round the per-axis weights to bf16 (``_axis_weights(...).astype``), sum
their products in f32 and round the output (or each level's dF) to bf16 once;
only the order of the f32 sums differs, which can move a value across one
rounding boundary (measured: the separable version bit-equal, forward and
backward, at these sizes).

The bf16 kernels (``csrc/roi_align.cu``) run only on the card: the ``-m
cuda`` tests at the end hold them to the plain bf16 versions with the gate of
``chip_smoke.py``'s phase 4d (one bf16 ulp, or the f32 kernels' own
tolerance where a value near 0 is smaller than the f32 sums' order can
resolve) and check that a bf16 CUDA tensor never takes the f32 kernels or a
plain version. JAX is imported inside the tests only.
"""
import numpy as np
import pytest
import torch

from basedet_tpu_torch.ops.roi_align import (
    multilevel_roi_align_backward_plain,
    multilevel_roi_align_plain,
    roi_level_assignment,
)
from basedet_tpu_torch.ops.roi_align_kernel import (
    multilevel_roi_align,
    multilevel_roi_align_backward,
    pool_rois_multilevel,
)
from tests.test_torch_amp import one_torch_thread  # noqa: F401 (an autouse fixture)
from tests.test_torch_roi_align import B, IMG, STRIDES, _edge_rois, _feats, _one_level_rois, _random_rois
from tests.torch_threads import torch_threads  # noqa: F401

C = 16
ROI_BWD_RTOL = 2e-5  # the f32 backward's tolerance, chip_smoke.py's ROI_BWD_RTOL
ROI_FWD_RTOL = 1e-5  # the f32 forward's, chip_smoke.py's phase 4b

CASES = {
    "random": lambda rng: _random_rois(rng, 24),
    "edges": lambda rng: _edge_rois(),
    "one_level": _one_level_rois,
}
# every case against the separable reference; the window kernel in interpret
# mode (seconds a call) on the random RoIs
JAX_CASES = [("separable", case) for case in CASES] + [("window", "random")]


def bf16_ulp(t):
    """The spacing of bf16 at |t| (t rounded to bf16 first), f32."""
    a = t.float().abs().bfloat16()
    return (a.view(torch.int16) + 1).view(torch.bfloat16).float() - a.float()


def assert_within_ulp(got, want, what, floor=0.0):
    """|got - want| at most one bf16 ulp of the larger of the two, or ``floor``."""
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    ulp = torch.maximum(bf16_ulp(got), bf16_ulp(want))
    diff = (got - want).abs()
    assert bool((diff <= torch.clamp_min(ulp, floor)).all()), (what, float((diff / ulp).max()))


def _bf16_case(seed, case, c=C):
    """bf16 features (NCHW for the port, NHWC numpy of the same values for
    JAX), the rois and their level ids."""
    rng = np.random.RandomState(seed)
    feats = [torch.from_numpy(f).bfloat16() for f in _feats(rng, IMG, c)]  # NHWC
    rois = torch.from_numpy(CASES[case](rng))
    nchw = [f.permute(0, 3, 1, 2).contiguous() for f in feats]
    return feats, nchw, rois, roi_level_assignment(rois, 2, 5)


def _jax_bf16(feats):
    import jax.numpy as jnp

    return [jnp.asarray(f.float().numpy(), jnp.bfloat16) for f in feats]


def _to_torch(x, nchw=False):
    import jax.numpy as jnp

    t = torch.from_numpy(np.asarray(x.astype(jnp.float32)))
    return t.permute(0, 3, 1, 2) if nchw else t


def _jax_forward(kind):
    """The JAX package's function of ``kind`` on (bf16 NHWC features, rois):
    the separable reference, or the window Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    if kind == "separable":
        from basedet_tpu.ops.roi_align_separable import multilevel_roi_align_batched

        return lambda fs, rois: multilevel_roi_align_batched(fs, jnp.asarray(rois), STRIDES)
    from basedet_tpu.ops import roi_align_window as window

    return lambda fs, rois: window.pool_rois_window(fs, jnp.asarray(rois), STRIDES, (7, 7), interpret=True)


@pytest.mark.parametrize("kind,case", JAX_CASES)
def test_plain_bf16_forward_matches_jax(kind, case):
    """The plain forward on bf16 features gives bf16, within one bf16 ulp of
    the JAX package's bf16 output; the CPU wrapper takes the plain version."""
    feats, nchw, rois, levels = _bf16_case(1, case)
    want = _jax_forward(kind)(_jax_bf16(feats), rois.numpy())
    assert str(want.dtype) == "bfloat16"
    got = multilevel_roi_align_plain(nchw, rois, levels, STRIDES)
    assert got.dtype == torch.bfloat16
    assert_within_ulp(got, _to_torch(want), f"{kind} {case}")
    assert torch.equal(pool_rois_multilevel(nchw, rois, STRIDES), got)


@pytest.mark.parametrize("kind,case", JAX_CASES)
def test_plain_bf16_backward_matches_jax_vjp(kind, case):
    """The gradient in the features of a bf16 cotangent: autograd of the plain
    forward and the plain backward, each dF bf16 and within one bf16 ulp of
    ``jax.vjp`` of the JAX package's bf16 function, level by level."""
    import jax
    import jax.numpy as jnp

    feats, nchw, rois, levels = _bf16_case(2, case)
    rng = np.random.RandomState(3)
    g = torch.from_numpy(rng.randn(B, rois.shape[1], 7, 7, C).astype(np.float32)).bfloat16()
    fn = _jax_forward(kind)
    _, vjp = jax.vjp(lambda *fs: fn(list(fs), rois.numpy()), *_jax_bf16(feats))
    want = vjp(jnp.asarray(g.float().numpy(), jnp.bfloat16))
    leaves = [f.clone().requires_grad_() for f in nchw]
    multilevel_roi_align_plain(leaves, rois, levels, STRIDES).backward(g)
    plain = multilevel_roi_align_backward_plain(g, rois, levels, STRIDES, [f.shape[-2:] for f in nchw])
    for lv, (w, leaf, p) in enumerate(zip(want, leaves, plain)):
        assert str(w.dtype) == "bfloat16" and leaf.grad.dtype == p.dtype == torch.bfloat16
        assert_within_ulp(leaf.grad, _to_torch(w, nchw=True), f"{kind} {case} autograd level {lv}")
        assert_within_ulp(p, _to_torch(w, nchw=True), f"{kind} {case} plain backward level {lv}")


def test_plain_bf16_rounds_the_weights_once():
    """The bf16 output is the f32 sum of bf16-rounded weights times the
    features, rounded once: not the f32 output rounded (its weights are not
    rounded), and off it by no more than the weights' rounding (2^-9 of each
    of Py and Px: 2^-8 of each |weight · feature|) and the output's (a bf16
    ulp)."""
    feats, nchw, rois, levels = _bf16_case(4, "random")
    got = multilevel_roi_align_plain(nchw, rois, levels, STRIDES)
    f32 = multilevel_roi_align_plain([f.float() for f in nchw], rois, levels, STRIDES)
    terms = multilevel_roi_align_plain([f.float().abs() for f in nchw], rois, levels, STRIDES)
    assert f32.dtype == torch.float32 and not torch.equal(got, f32.bfloat16())
    assert bool(((got.float() - f32).abs() <= 2**-8 * terms + bf16_ulp(got)).all())


def test_wrappers_refuse_mixed_dtypes():
    _, nchw, rois, levels = _bf16_case(5, "random")
    with pytest.raises(ValueError, match="one B, C and dtype"):
        multilevel_roi_align([nchw[0].float(), *nchw[1:]], rois, levels, STRIDES)
    with pytest.raises(ValueError, match="f32 or bf16"):
        multilevel_roi_align([f.half() for f in nchw], rois, levels, STRIDES)
    g = torch.zeros(B, rois.shape[1], 7, 7, C, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        multilevel_roi_align_backward(g, rois, levels, STRIDES, [f.shape[-2:] for f in nchw])


def _cuda_case(seed, case, c=C):
    feats, nchw, rois, levels = _bf16_case(seed, case, c)
    return [f.cuda() for f in nchw], rois.cuda(), levels.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [C, 100, 6])
def test_bf16_forward_kernel_matches_plain_on_gpu(c):
    """The bf16 forward kernel against the plain bf16 forward on the card,
    one launch of the bf16 kernel a call and none of the f32 kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the bf16 RoIAlign kernel has no CPU mode")
    for case in CASES:
        feats, rois, levels = _cuda_case(6, case, c)
        launches = (multilevel_roi_align.launches, multilevel_roi_align.launches_bf16)
        got = multilevel_roi_align(feats, rois, levels, STRIDES)
        torch.cuda.synchronize()
        assert (multilevel_roi_align.launches - launches[0], multilevel_roi_align.launches_bf16 - launches[1]) == (0, 1)
        want = multilevel_roi_align_plain(feats, rois, levels, STRIDES)
        assert got.dtype == torch.bfloat16
        floor = ROI_FWD_RTOL * max(1.0, max(float(f.float().abs().max()) for f in feats))
        assert_within_ulp(got.cpu(), want.cpu(), case, floor)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [C, 100, 6])
def test_bf16_backward_kernel_matches_plain_on_gpu(c):
    """The bf16 backward kernel against the plain bf16 backward, and through
    ``pool_rois_multilevel``'s Function against autograd of the plain forward:
    dF bf16, NCHW-contiguous, two runs bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the bf16 RoIAlign backward kernel has no CPU mode")
    for case in CASES:
        feats, rois, levels = _cuda_case(7, case, c)
        g = torch.randn(B, rois.shape[1], 7, 7, c, device="cuda").bfloat16()
        sizes = [f.shape[-2:] for f in feats]
        got = multilevel_roi_align_backward(g, rois, levels, STRIDES, sizes)
        again = multilevel_roi_align_backward(g, rois, levels, STRIDES, sizes)
        want = multilevel_roi_align_backward_plain(g, rois, levels, STRIDES, sizes)
        floor = ROI_BWD_RTOL * max(1.0, max(float(w.float().abs().max()) for w in want))
        for a, b, w in zip(got, again, want):
            assert a.dtype == torch.bfloat16 and a.is_contiguous() and torch.equal(a, b)
            assert_within_ulp(a.cpu(), w.cpu(), case, floor)
        leaves = [f.clone().requires_grad_() for f in feats]
        before = multilevel_roi_align_backward.launches_bf16
        pool_rois_multilevel(leaves, rois, STRIDES).backward(g)
        assert multilevel_roi_align_backward.launches_bf16 == before + 1
        for leaf, w in zip(leaves, want):
            assert leaf.grad.dtype == torch.bfloat16
            assert_within_ulp(leaf.grad.cpu(), w.cpu(), case, floor)


# -- the bf16 kernels' own edge cases, at Faster R-CNN's 800x1344 canvas ------------------------


def _edge_windows(name, C=256):
    """``chip_smoke.bf16_edge_rois()[name]``, its level ids, the windows of
    its RoIs on P2-P5 of 800x1344 (``tap_windows``) and the forward's staging
    groups for NCHW features at ``C`` channels."""
    from chip_smoke import ROI_LEVELS, ROI_STRIDES, bf16_edge_rois
    from basedet_tpu_torch.ops.roi_align_kernel import forward_stage_groups, tap_windows

    rois = torch.from_numpy(bf16_edge_rois()[name])
    levels = roi_level_assignment(rois, 2, 5)
    windows = tap_windows(rois, levels, ROI_STRIDES, ROI_LEVELS, (7, 7))
    return rois, levels, windows, forward_stage_groups(windows, C)


def test_bf16_edge_rois_reach_the_cases_they_name():
    """The RoI sets that ``chip_smoke.py`` and the ``cuda`` tests below hold
    the bf16 kernels to on the card: large windows staged a group of
    channels at a time, windows from odd columns of P4 and P5 (rows of 168
    and 84 bytes, which no 16-byte copy starts on), and two images with
    different levels."""
    from chip_smoke import ROI_LEVELS

    _, levels, windows, groups = _edge_windows("large windows")
    assert set(levels.flatten().tolist()) >= {0, 1, 3}
    assert int(groups[..., 0].min()) < 8 and int(groups[..., 0].max()) == 16  # 5 channels a group: 4 rounds
    _, levels, windows, groups = _edge_windows("unaligned rows")
    for level in (2, 3):
        assert ROI_LEVELS[level][1] * 2 % 16 != 0
        first = windows[..., 3][levels.numpy() == level]
        assert len(set((first % 2).tolist())) == 2 and len(set(first.tolist())) >= 8
    assert (groups == 16).all()  # every channel at once: the alignment is all that is tested
    _, levels, _, _ = _edge_windows("two level mixes")
    assert set(levels[0].tolist()) == {0, 1} and set(levels[1].tolist()) == {2, 3}


def test_forward_stages_every_window_of_a_detectors_levels():
    """``forward_stage_groups``, the bf16 forward's staging rule: at 800x1344
    with NCHW features every RoI, proposal-like or edge case, stages its
    window (global memory only where not one channel's window fits); a slab
    whose 16 windows do not fit at once stages fewer channels a round, and
    the last slab of C = 100 (4 channels) takes the whole-P5 box at once;
    channels-last features are read from global memory."""
    from chip_smoke import ROI_LEVELS, ROI_STRIDES, _proposal_rois
    from basedet_tpu_torch.ops.roi_align_kernel import FWD_SLAB, FWD_STAGE_BYTES, forward_stage_groups, tap_windows

    rois = torch.from_numpy(_proposal_rois(np.random.RandomState(0), 2, 512))
    levels = roi_level_assignment(rois, 2, 5)
    windows = tap_windows(rois, levels, ROI_STRIDES, ROI_LEVELS, (7, 7))
    groups = forward_stage_groups(windows, 256)
    assert groups.shape == (2, 512, 256 // FWD_SLAB) and (groups >= 1).all()
    assert (groups == FWD_SLAB).mean() > 0.9
    _, _, windows, groups = _edge_windows("large windows")
    rows, span = windows[..., 2] - windows[..., 1] + 1, windows[..., 4] - windows[..., 3] + 1
    assert ((groups >= 1) & (groups <= FWD_SLAB)).all()
    few = groups[..., 0] < FWD_SLAB  # six of the seven boxes: 2-4 rounds
    assert few.sum() == 6 and (FWD_SLAB * rows * span * 2 > FWD_STAGE_BYTES / 2)[few].all()
    last = forward_stage_groups(windows, 100)[..., -1]
    assert (last == 4).all()
    assert not forward_stage_groups(windows, 256, unit_x_stride=False).any()


def _full_size_case(name, C, channels_last, seed=8):
    """bf16 features P2-P5 of 800x1344 on the card (NCHW or channels-last),
    ``bf16_edge_rois()[name]`` and their level ids."""
    from chip_smoke import ROI_LEVELS, bf16_edge_rois

    rois = torch.from_numpy(bf16_edge_rois()[name]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    feats = [torch.randn(rois.shape[0], C, h, w, device="cuda", generator=gen).bfloat16() for h, w in ROI_LEVELS]
    if channels_last:
        feats = [f.contiguous(memory_format=torch.channels_last) for f in feats]
    return feats, rois, roi_level_assignment(rois, 2, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels-last"])
@pytest.mark.parametrize("c", [256, 100, 6, 7])  # 7: g's rows copied element by element
@pytest.mark.parametrize("name", ["large windows", "unaligned rows", "two level mixes"])
def test_bf16_kernels_on_the_edge_cases_on_gpu(name, c, layout):
    """The bf16 forward kernel against the plain bf16 forward on the full
    canvas: windows staged a group of channels at a time, rows off 16 bytes,
    two level mixes, C off the slab, channels-last features (read from
    global memory); one bf16 launch a call. The backward kernel (NCHW only:
    it reads g, not the features) against the plain backward: dF bf16,
    NCHW-contiguous, two runs bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the bf16 RoIAlign kernels have no CPU mode")
    from chip_smoke import ROI_STRIDES

    feats, rois, levels = _full_size_case(name, c, layout == "channels-last")
    before = multilevel_roi_align.launches_bf16
    got = multilevel_roi_align(feats, rois, levels, ROI_STRIDES)
    torch.cuda.synchronize()
    assert multilevel_roi_align.launches_bf16 == before + 1 and got.dtype == torch.bfloat16
    want = multilevel_roi_align_plain(feats, rois, levels, ROI_STRIDES)
    floor = ROI_FWD_RTOL * max(1.0, max(float(f.float().abs().max()) for f in feats))
    assert_within_ulp(got.cpu(), want.cpu(), f"{name} C={c} {layout}", floor)
    if layout != "nchw":
        return
    g = torch.randn(*rois.shape[:2], 7, 7, c, generator=torch.Generator(device="cuda").manual_seed(9),
                    device="cuda").bfloat16()
    sizes = [f.shape[-2:] for f in feats]
    got = multilevel_roi_align_backward(g, rois, levels, ROI_STRIDES, sizes)
    again = multilevel_roi_align_backward(g, rois, levels, ROI_STRIDES, sizes)
    want = multilevel_roi_align_backward_plain(g, rois, levels, ROI_STRIDES, sizes)
    floor = ROI_BWD_RTOL * max(1.0, max(float(w.float().abs().max()) for w in want))
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and a.is_contiguous() and torch.equal(a, b)
        assert_within_ulp(a.cpu(), w.cpu(), f"{name} C={c} backward", floor)
