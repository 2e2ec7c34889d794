"""The port's image operations (``basedet_tpu_torch/data/image_ops.py``)
against cv2, which the JAX package's data code calls and the card's machine
lacks. Exact where both sides compute the same integers (PNG, JPEG through
Pillow, BGR→HSV, filled rectangles); resize and warp within one grey level,
with the share of pixels that differ bounded (cv2 rounds its interpolation
weights to fixed point, the port samples in float32: 11-13% of resized
pixels and under 0.05% of warped ones differ, measured on smooth random
images at these sizes); HSV→BGR within one level of OpenCV's vector path
and the JAX package's ``augment_hsv`` round trip within two; the matrices
within 1e-12."""
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from basedet_tpu_torch.data import image_ops as io  # noqa: E402
from tests.torch_threads import torch_threads  # noqa: F401

RESIZE_SHARE = 0.15  # pixels one level off cv2.resize (measured 0.113-0.127)
WARP_SHARE = 0.002  # pixels one level off cv2.warpAffine (measured 0.0002)


def _smooth(rng, h, w):
    return cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3), np.uint8), (5, 5), 2)


def test_png_round_trips_with_cv2_exactly(tmp_path):
    rng = np.random.RandomState(0)
    noise, smooth = rng.randint(0, 256, (97, 131, 3), np.uint8), _smooth(rng, 64, 80)
    io.imwrite_png(str(tmp_path / "port.png"), noise)
    assert np.array_equal(cv2.imread(str(tmp_path / "port.png")), noise)
    io.imwrite_png(str(tmp_path / "grey.png"), smooth[..., 0])
    assert np.array_equal(cv2.imread(str(tmp_path / "grey.png")), np.repeat(smooth[..., :1], 3, axis=2))
    # cv2 writes with adaptive filters (Sub, Up, Average, Paeth), grey, and RGBA
    for name, img in (("noise", noise), ("smooth", smooth), ("grey", smooth[..., 1]),
                      ("bgra", np.concatenate([smooth, smooth[..., :1]], axis=2))):
        path = str(tmp_path / f"cv2_{name}.png")
        cv2.imwrite(path, img)
        assert np.array_equal(io.imread_bgr(path), cv2.imread(path)), name


def test_png_palette_and_one_bit_read_as_cv2_reads_them(tmp_path):
    from PIL import Image

    smooth = _smooth(np.random.RandomState(1), 48, 64)
    Image.fromarray(smooth[..., ::-1]).convert("P", palette=Image.ADAPTIVE).save(tmp_path / "p.png")
    Image.fromarray(smooth[..., 0]).convert("1").save(tmp_path / "b.png")
    for name in ("p.png", "b.png"):
        assert np.array_equal(io.imread_bgr(str(tmp_path / name)), cv2.imread(str(tmp_path / name))), name


def test_jpeg_through_pillow_equals_cv2(tmp_path):
    rng = np.random.RandomState(2)
    for name, img in (("noise", rng.randint(0, 256, (120, 160, 3), np.uint8)), ("smooth", _smooth(rng, 100, 90))):
        path = str(tmp_path / f"{name}.jpg")
        cv2.imwrite(path, img)
        assert np.array_equal(io.imread_bgr(path), cv2.imread(path)), name


def test_jpeg_without_pillow_raises_naming_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    for mod in [m for m in sys.modules if m == "PIL" or m.startswith("PIL.")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "PIL", None)  # import PIL now raises ImportError
    with pytest.raises(ImportError, match=r"x\.jpg: JPEG .* needs Pillow"):
        io.imread_bgr(path)


@pytest.mark.parametrize("src, dsize", [((160, 160), (107, 91)), ((120, 160), (128, 96)), ((64, 80), (150, 131)),
                                        ((128, 128), (64, 64))])
def test_resize_bilinear_within_one_level_of_cv2(src, dsize):
    img = _smooth(np.random.RandomState(3), *src)
    ref, out = cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR), io.resize_bilinear(img, dsize)
    diff = np.abs(ref.astype(int) - out)
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert diff.max() <= 1 and (diff > 0).mean() <= RESIZE_SHARE
    f = img.astype(np.float32)  # float images stay float, within float32 rounding
    np.testing.assert_allclose(io.resize_bilinear(f, dsize), cv2.resize(f, dsize), atol=1e-3)
    assert np.array_equal(io.resize_bilinear(img, src[::-1]), img)


@pytest.mark.parametrize("border", [0, 114])
def test_warp_affine_within_one_level_of_cv2(border):
    rng = np.random.RandomState(4)
    img = _smooth(rng, 160, 160)
    R = cv2.getRotationMatrix2D(angle=7.3, center=(0, 0), scale=0.83)
    M = np.ones((2, 3))
    M[0], M[1] = R[0] + 0.02 * R[1], R[1] + 0.03 * R[0]
    M[0, 2], M[1, 2] = 17.2, -11.7  # the output runs off the input: border taps
    ref = cv2.warpAffine(img, M, dsize=(96, 112), borderValue=(border,) * 3)
    out = io.warp_affine(img, M, (96, 112), border_value=border)
    diff = np.abs(ref.astype(int) - out)
    assert out.shape == ref.shape == (112, 96, 3)
    assert diff.max() <= 1 and (diff > 0).mean() <= WARP_SHARE
    assert (out == border).all(axis=2).any()  # some pixels see only the border


def test_hsv_conversions_match_cv2():
    """Every uint8 BGR colour to HSV bit for bit; every HSV value back within
    one level of OpenCV's vector path (float32 arithmetic, ~5e-5 of them
    differ) on rows 256 pixels wide, which that path covers whole."""
    grid = np.stack(np.meshgrid(*(np.arange(256),) * 3, indexing="ij"), -1).reshape(-1, 256, 3).astype(np.uint8)
    assert np.array_equal(io.bgr_to_hsv_u8(grid), cv2.cvtColor(grid, cv2.COLOR_BGR2HSV))
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij"),
                   -1).reshape(-1, 256, 3).astype(np.uint8)
    diff = np.abs(io.hsv_to_bgr_u8(hsv).astype(int) - cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-4


def test_augment_hsv_round_trip_within_two_levels_of_jax():
    """The JAX package's augment_hsv (cv2, global np.random) against the
    port's (DataRNG), same seed: the same gains, then the image within two
    grey levels."""
    from basedet_tpu.data.transforms.yolox_transform import augment_hsv as jax_augment_hsv
    from basedet_tpu_torch.data.transforms import DataRNG
    from basedet_tpu_torch.data.transforms.yolox_transform import augment_hsv

    img = _smooth(np.random.RandomState(5), 96, 128)
    for seed in range(6):
        np.random.seed(seed)
        ref = jax_augment_hsv(img.copy())
        out = augment_hsv(img.copy(), DataRNG(seed))
        assert np.abs(ref.astype(int) - out).max() <= 2, seed


def test_matrices_match_cv2():
    for angle, scale, center in ((7.3, 0.83, (0, 0)), (-10.0, 1.9, (12.5, -3.0)), (0.0, 1.0, (5, 5))):
        np.testing.assert_allclose(io.get_rotation_matrix_2d(center, angle, scale),
                                   cv2.getRotationMatrix2D(center, angle, scale), rtol=0, atol=1e-12)
    src = np.array([[250.3, 190.1], [250.3, -209.9], [-149.7, -209.9]], np.float32)
    dst = np.array([[256, 256], [256, 0], [0, 0]], np.float32)
    ref = cv2.getAffineTransform(src, dst)
    np.testing.assert_allclose(io.get_affine_transform(src, dst), ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(io.invert_affine_transform(ref), cv2.invertAffineTransform(ref), rtol=0, atol=1e-12)


def test_fill_rect_equals_cv2_rectangle():
    for pt1, pt2 in (((10, 5), (70, 30)), ((0, 0), (0, 0)), ((40, 45), (3, 2)), ((-5, -5), (8, 60))):
        ref, out = np.zeros((50, 60, 3), np.uint8), np.zeros((50, 60, 3), np.uint8)
        cv2.rectangle(ref, pt1, pt2, (40, 40, 230), -1)
        io.fill_rect(out, pt1, pt2, (40, 40, 230))
        assert np.array_equal(out, ref), (pt1, pt2)
