"""The port's multilevel RoIAlign (basedet_tpu_torch/ops/roi_align.py, the
plain version of the CUDA kernel in csrc/roi_align.cu) against the JAX
package on the CPU: its separable version, and both Pallas forwards in
interpret mode (the window kernel with 16x16 windows, as
tests/ops/test_roi_align_window.py runs it, and the dense fused kernel).

Tolerance 2e-5 absolute on features of unit scale: the same bilinear terms
summed in another order (torch's einsum against XLA's dot, and the Pallas
kernels' own blockings). Level ids must be equal, on the sqrt(area)
boundaries too, where one ulp of ``log`` decides the level.

The kernel itself runs only on the card: ``-m cuda`` there. JAX is imported
inside the fixtures, so the CUDA test at the end also runs on the card's
machine, which has no JAX.
"""
import types

import numpy as np
import pytest
import torch

from basedet_tpu_torch.ops.roi_align import multilevel_roi_align_plain, roi_level_assignment
from basedet_tpu_torch.ops.roi_align_kernel import multilevel_roi_align, pool_rois_multilevel

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

    return types.SimpleNamespace(jnp=jnp, window=window, fused=multilevel_roi_align_fused,
                                 batched=multilevel_roi_align_batched, levels=roi_level_assignment)


@pytest.fixture
def small_windows(jx, monkeypatch):
    # 16x16 windows, so that the finest level (32x32) is really windowed
    monkeypatch.setattr(jx.window, "_HW", 16)
    monkeypatch.setattr(jx.window, "_WW", 16)
    return jx.window


CASES = {
    "random": lambda rng: _random_rois(rng, 16),
    "edges": lambda rng: _edge_rois(),
}


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
    with pytest.raises(NotImplementedError, match="backward"):
        multilevel_roi_align([f.requires_grad_() for f in _nchw(_feats(rng))], rois, levels, STRIDES)
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
