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
