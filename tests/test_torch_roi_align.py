"""The port's multilevel RoIAlign (basedet_tpu_torch/ops/roi_align.py, the
plain versions of the two CUDA kernels in csrc/roi_align.cu) against the JAX
package on the CPU: its separable version, and both Pallas kernels in
interpret mode (the window kernel with 16x16 windows, as
tests/ops/test_roi_align_window.py runs it, and the dense fused kernel),
forward and backward.

Forward: tolerance 2e-5 absolute on features of unit scale: the same bilinear
terms summed in another order (torch's einsum against XLA's dot, and the
Pallas kernels' own blockings). Level ids must be equal, on the sqrt(area)
boundaries too, where one ulp of ``log`` decides the level.

Backward: the plain backward is held to autograd of the plain forward within
1e-6 of max(1, max|dF|) (the same weights, contracted in another order), and
to ``jax.grad`` of the separable version and of both Pallas kernels within
1e-5 of max(1, max|dF|): a feature row collects up to a few hundred weighted
terms of unit-scale gradients, summed in each implementation's own order.
The RoIs get no gradient anywhere.

The kernels themselves run only on the card: ``-m cuda`` there. JAX is
imported inside the fixtures, so the CUDA tests at the end also run on the
card's machine, which has no JAX.
"""
import types

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

STRIDES = (4, 8, 16, 32)
IMG = 128
C = 8
B = 2
ATOL = 2e-5


def _feats(rng, img=IMG, c=C, b=B):
    """Per level (B, H, W, C) numpy, the JAX layout."""
    return [rng.randn(b, img // s, img // s, c).astype(np.float32) for s in STRIDES]


def _nchw(feats):
    return [torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2))) for f in feats]


def _random_rois(rng, R, img=IMG):
    sa = np.exp(rng.uniform(np.log(4), np.log(img), (B, R)))
    ar = np.exp(rng.uniform(np.log(0.5), np.log(2.0), (B, R)))
    w, h = sa * np.sqrt(ar), sa / np.sqrt(ar)
    cx, cy = rng.uniform(0, img, (B, R)), rng.uniform(0, img, (B, R))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1).astype(np.float32)


def _edge_rois(img=IMG):
    """Zero-area padding, boxes partly or wholly outside the image, sub-pixel
    boxes, boxes on the last row and column, and sqrt(area) exactly on the
    level boundaries (112, 224: levels 3/4 of strides 4-32)."""
    r = np.float32([
        [0, 0, 0, 0], [0, 0, 0, 0], [50, 60, 50, 60],               # padded / zero area
        [-20, -30, 40, 50], [100, 90, 170, 160], [-50, -50, -10, -5],  # partly / wholly outside
        [10.2, 20.7, 10.6, 21.0], [3.0, 3.0, 3.25, 3.5],            # sub-pixel
        [img - 3, img - 2, img, img], [0, img - 1, img, img],        # last row / column
        [img - 1, 0, img, img], [0, 0, img, img],
        [0, 0, 112, 112], [8, 8, 120, 120], [0, 0, 224, 224], [-50, -40, 174, 184],
    ])
    return np.stack([r, r[::-1].copy()])


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    import basedet_tpu.ops.roi_align_window as window
    from basedet_tpu.ops.roi_align_pallas import multilevel_roi_align_fused
    from basedet_tpu.ops.roi_align_separable import multilevel_roi_align_batched, roi_level_assignment

    import jax

    return types.SimpleNamespace(jax=jax, jnp=jnp, window=window, fused=multilevel_roi_align_fused,
                                 batched=multilevel_roi_align_batched, levels=roi_level_assignment)


@pytest.fixture
def small_windows(jx, monkeypatch):
    # 16x16 windows, so that the finest level (32x32) is really windowed
    monkeypatch.setattr(jx.window, "_HW", 16)
    monkeypatch.setattr(jx.window, "_WW", 16)
    return jx.window


def _one_level_rois(rng, R=16):
    """Every RoI on P3 (sqrt(area) in 112-224 px maps to level 1 of 0-3):
    the other three levels get no RoI and a zero gradient."""
    side = rng.uniform(120, 200, (B, R))
    x1, y1 = rng.uniform(-40, IMG - 100, (B, R)), rng.uniform(-40, IMG - 100, (B, R))
    return np.stack([x1, y1, x1 + side, y1 + side], -1).astype(np.float32)


CASES = {
    "random": lambda rng: _random_rois(rng, 16),
    "edges": lambda rng: _edge_rois(),
}
GRAD_CASES = {**CASES, "one_level": _one_level_rois}
SIZES = [(IMG // s, IMG // s) for s in STRIDES]


def _grad_inputs(case, seed):
    rng = np.random.RandomState(seed)
    feats, rois = _feats(rng), GRAD_CASES[case](rng)
    g = rng.randn(B, rois.shape[1], 7, 7, C).astype(np.float32)
    return feats, rois, g


def _plain_backward(rois, g):
    rois = torch.from_numpy(rois)
    levels = roi_level_assignment(rois, 2, 5)
    return [d.permute(0, 2, 3, 1).numpy() for d in
            multilevel_roi_align_backward_plain(torch.from_numpy(g), rois, levels, STRIDES, SIZES)]


def _assert_grads_close(got, want, rel):
    assert len(got) == len(want) == len(STRIDES)
    scale = max(1.0, max(float(np.abs(np.asarray(w)).max()) for w in want))
    for lvl, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=rel * scale, err_msg=f"level {lvl}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_separable(jx, case):
    rng = np.random.RandomState(0)
    feats, rois = _feats(rng), CASES[case](rng)
    want = np.asarray(jx.batched([jx.jnp.asarray(f) for f in feats], jx.jnp.asarray(rois), STRIDES))
    got = pool_rois_multilevel(_nchw(feats), torch.from_numpy(rois), STRIDES)
    assert got.shape == (B, rois.shape[1], 7, 7, C)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_window_kernel_interpret(jx, small_windows, case):
    rng = np.random.RandomState(1)
    feats, rois = _feats(rng), CASES[case](rng)
    want = np.asarray(small_windows.pool_rois_window(
        [jx.jnp.asarray(f) for f in feats], jx.jnp.asarray(rois), STRIDES, (7, 7), interpret=True))
    got = pool_rois_multilevel(_nchw(feats), torch.from_numpy(rois), STRIDES)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_fused_kernel_interpret(jx, case):
    rng = np.random.RandomState(2)
    feats, rois = _feats(rng), CASES[case](rng)
    want = np.asarray(jx.fused(tuple(jx.jnp.asarray(f) for f in feats), jx.jnp.asarray(rois),
                               STRIDES, (7, 7), interpret=True))
    got = pool_rois_multilevel(_nchw(feats), torch.from_numpy(rois), STRIDES)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_backward_matches_autograd_of_plain_forward(case):
    feats, rois, g = _grad_inputs(case, 10)
    nchw = [f.requires_grad_() for f in _nchw(feats)]
    rois_t = torch.from_numpy(rois)
    out = pool_rois_multilevel(nchw, rois_t, STRIDES)
    want = torch.autograd.grad(out, nchw, torch.from_numpy(g))
    got = _plain_backward(rois, g)
    _assert_grads_close(got, [w.permute(0, 2, 3, 1).numpy() for w in want], 1e-6)
    levels = roi_level_assignment(rois_t, 2, 5)
    for lvl, d in enumerate(got):  # a level with no RoI gets an exact zero
        assert (np.abs(d).max() > 0) == bool((levels == lvl).any()), lvl
    if case == "one_level":
        assert [bool((levels == lvl).any()) for lvl in range(4)] == [False, True, False, False]


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_backward_matches_jax_grad_of_separable(jx, case):
    feats, rois, g = _grad_inputs(case, 11)
    want = jx.jax.grad(lambda fs: jx.jnp.sum(jx.batched(list(fs), jx.jnp.asarray(rois), STRIDES) * g))(
        tuple(jx.jnp.asarray(f) for f in feats))
    _assert_grads_close(_plain_backward(rois, g), want, 1e-5)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_backward_matches_window_kernel_backward_interpret(jx, small_windows, case):
    feats, rois, g = _grad_inputs(case, 12)
    want = jx.jax.grad(lambda fs: jx.jnp.sum(small_windows.pool_rois_window(
        fs, jx.jnp.asarray(rois), STRIDES, (7, 7), interpret=True) * g))(
        tuple(jx.jnp.asarray(f) for f in feats))
    _assert_grads_close(_plain_backward(rois, g), want, 1e-5)


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_plain_backward_matches_fused_kernel_backward_interpret(jx, case):
    feats, rois, g = _grad_inputs(case, 13)
    want = jx.jax.grad(lambda fs: jx.jnp.sum(jx.fused(
        fs, jx.jnp.asarray(rois), STRIDES, (7, 7), interpret=True) * g))(
        tuple(jx.jnp.asarray(f) for f in feats))
    _assert_grads_close(_plain_backward(rois, g), want, 1e-5)


def test_backward_wrapper_takes_the_plain_version_on_cpu():
    feats, rois, g = _grad_inputs("random", 14)
    rois, g = torch.from_numpy(rois), torch.from_numpy(g)
    levels = roi_level_assignment(rois, 2, 5)
    before = multilevel_roi_align_backward_plain.calls
    got = multilevel_roi_align_backward(g, rois, levels, STRIDES, SIZES)
    assert multilevel_roi_align_backward_plain.calls == before + 1
    assert multilevel_roi_align_backward.launches == 0
    assert [tuple(d.shape) for d in got] == [(B, C, h, w) for h, w in SIZES]
    for d, want in zip(got, multilevel_roi_align_backward_plain(g, rois, levels, STRIDES, SIZES)):
        assert torch.equal(d, want)
    with pytest.raises(ValueError):
        multilevel_roi_align_backward(g.double(), rois, levels, STRIDES, SIZES)
    with pytest.raises(ValueError):
        multilevel_roi_align_backward(g[:, :3], rois, levels, STRIDES, SIZES)


@pytest.mark.parametrize("side", [56.0, 112.0, 224.0, 448.0, 896.0])
def test_level_ids_equal_on_the_boundaries(jx, side):
    """Boxes whose sqrt(area) is exactly ``side``: integer corners, aspect
    ratios whose square roots are powers of two, so every area is exact."""
    rng = np.random.RandomState(3)
    xy = rng.randint(-100, 800, (60, 2)).astype(np.float32)
    root = np.tile(np.float32([0.25, 0.5, 1.0, 2.0, 4.0]), 12)
    w, h = side * root, side / root
    rois = np.stack([xy[:, 0], xy[:, 1], xy[:, 0] + w, xy[:, 1] + h], 1).astype(np.float32)
    assert np.all((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]) == np.float32(side * side))
    want = np.asarray(jx.levels(jx.jnp.asarray(rois), 2, 5))
    got = roi_level_assignment(torch.from_numpy(rois), 2, 5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    expected = int(np.clip(np.floor(4 + np.log2(side / 224)), 2, 5)) - 2
    assert np.all(want == expected)


def test_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.RandomState(4)
    feats, rois = _nchw(_feats(rng)), torch.from_numpy(_random_rois(rng, 8))
    before = multilevel_roi_align_plain.calls
    got = pool_rois_multilevel(feats, rois, STRIDES)
    assert multilevel_roi_align_plain.calls == before + 1
    levels = roi_level_assignment(rois, 2, 5)
    assert torch.equal(got, multilevel_roi_align_plain(feats, rois, levels, STRIDES))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rng = np.random.RandomState(5)
    feats, rois = _nchw(_feats(rng)), torch.from_numpy(_random_rois(rng, 8))
    levels = roi_level_assignment(rois, 2, 5)
    with pytest.raises(NotImplementedError, match="no gradient"):  # the RoIs get none
        multilevel_roi_align(feats, rois.clone().requires_grad_(), levels, STRIDES)
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, rois.double(), levels, STRIDES)
    with pytest.raises(ValueError):
        multilevel_roi_align(feats, rois, levels.long(), STRIDES)
    with pytest.raises(ValueError):
        multilevel_roi_align(feats + feats[:1], rois, levels, STRIDES + (64,))


@pytest.mark.cuda
def test_roi_align_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the RoIAlign kernel has no CPU mode")
    rng = np.random.RandomState(6)
    for img, c, rois in [(IMG, C, _edge_rois()), (IMG, C, _random_rois(rng, 300)),
                         (512, 64, _random_rois(rng, 500, img=512))]:
        feats = [f.cuda() for f in _nchw(_feats(rng, img, c))]
        rois = torch.from_numpy(rois).cuda()
        levels = roi_level_assignment(rois, 2, 5)
        got = multilevel_roi_align(feats, rois, levels, STRIDES)
        torch.cuda.synchronize()
        want = multilevel_roi_align_plain(feats, rois, levels, STRIDES)
        tol = 1e-5 * max(1.0, max(float(f.abs().max()) for f in feats))
        assert float((got - want).abs().max()) <= tol


@pytest.mark.cuda
def test_roi_align_backward_kernel_matches_plain_on_gpu():
    """The backward kernel against the plain backward, and the Function's
    backward through ``pool_rois_multilevel`` against autograd of the plain
    forward. The tolerance covers the atomics' order of summation."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the RoIAlign backward kernel has no CPU mode")
    rng = np.random.RandomState(7)
    same = np.broadcast_to(np.float32([20.3, 31.7, 90.1, 77.4]), (B, 200, 4)).copy()
    for img, c, rois in [(IMG, C, _edge_rois()), (IMG, C, _random_rois(rng, 300)), (IMG, C, same),
                         (IMG, C, _one_level_rois(rng)), (512, 64, _random_rois(rng, 500, img=512))]:
        feats = [f.cuda().requires_grad_() for f in _nchw(_feats(rng, img, c))]
        sizes = [tuple(f.shape[-2:]) for f in feats]
        rois = torch.from_numpy(rois).cuda()
        levels = roi_level_assignment(rois, 2, 5)
        g = torch.from_numpy(rng.randn(B, rois.shape[1], 7, 7, c).astype(np.float32)).cuda()
        launches = multilevel_roi_align_backward.launches
        got = multilevel_roi_align_backward(g, rois, levels, STRIDES, sizes)
        torch.cuda.synchronize()
        assert multilevel_roi_align_backward.launches == launches + 1
        want = multilevel_roi_align_backward_plain(g, rois, levels, STRIDES, sizes)
        tol = 1e-5 * max(1.0, max(float(w.abs().max()) for w in want))
        for a, b in zip(got, want):
            assert a.shape == b.shape and float((a - b).abs().max()) <= tol
        through = torch.autograd.grad(pool_rois_multilevel(feats, rois, STRIDES), feats, g)
        assert multilevel_roi_align_backward.launches == launches + 2
        plain = multilevel_roi_align_plain(feats, rois, levels, STRIDES)
        for a, b in zip(through, torch.autograd.grad(plain, feats, g)):
            assert a.shape == b.shape and float((a - b).abs().max()) <= tol
    with pytest.raises(NotImplementedError, match="no gradient"):
        pool_rois_multilevel(feats, rois.clone().requires_grad_(), STRIDES)


@pytest.mark.cuda
def test_roi_align_kernel_edges_off_the_slab_and_strided_on_gpu():
    """The forward kernel reads each level through its own strides and pools
    64 channels a block: edge RoIs with C off the slab (100, and 6, which is
    not a multiple of 4 either), channels-last and sliced features, and a
    pooled width of 8 (one lane per x tap), against the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the RoIAlign kernel has no CPU mode")
    rng = np.random.RandomState(8)
    rois = torch.from_numpy(_edge_rois()).cuda()
    levels = roi_level_assignment(rois, 2, 5)
    cases = []
    for c in (100, 6, 64, 65):
        cases.append(([f.cuda() for f in _nchw(_feats(rng, IMG, c))], (7, 7)))
    cases.append(([f.cuda().contiguous(memory_format=torch.channels_last) for f in _nchw(_feats(rng, IMG, 72))],
                  (7, 7)))
    cases.append(([f.cuda()[:, 5:77] for f in _nchw(_feats(rng, IMG, 96))], (7, 7)))  # channel slices
    cases.append(([f.cuda() for f in _nchw(_feats(rng, IMG, 16))], (8, 8)))
    cases.append(([f.cuda() for f in _nchw(_feats(rng, IMG, 16))], (14, 3)))
    for feats, size in cases:
        launches = multilevel_roi_align.launches
        got = multilevel_roi_align(feats, rois, levels, STRIDES, size)
        torch.cuda.synchronize()
        assert multilevel_roi_align.launches == launches + 1
        want = multilevel_roi_align_plain(feats, rois, levels, STRIDES, size)
        tol = 1e-5 * max(1.0, max(float(f.abs().max()) for f in feats))
        assert got.shape == want.shape and float((got - want).abs().max()) <= tol, (feats[0].shape, size)
    with pytest.raises(ValueError, match="bins across"):
        multilevel_roi_align(cases[0][0], rois, levels, STRIDES, (7, 9))
