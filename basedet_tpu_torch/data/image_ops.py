"""The image operations of the host data pipeline, in numpy and CPU torch:
what the JAX package's data code asks of cv2, which the card's machine does
not have.

Images are BGR uint8 HWC, as cv2 gives them (the models' ``IMG_MEAN`` is in
BGR order). ``dsize`` is (w, h), as in cv2.

- ``imread_bgr`` reads PNG with its own reader (``zlib`` + numpy) and every
  other format (JPEG) through Pillow; without Pillow it raises, naming the
  file. ``imwrite_png`` writes PNG.
- ``resize_bilinear`` is ``cv2.resize(..., INTER_LINEAR)``: half-pixel
  centres, edge pixels repeated, no antialias. ``warp_affine`` is
  ``cv2.warpAffine`` with bilinear taps and a constant border. Both sample
  in float32 (the warp through torch's ``grid_sample``) where cv2 rounds its
  weights to fixed point, so a pixel may lie one grey level off cv2's.
- ``bgr_to_hsv_u8`` is ``cv2.cvtColor(COLOR_BGR2HSV)`` on uint8, bit for bit
  (OpenCV's fixed-point tables, H in [0, 180)); ``hsv_to_bgr_u8`` is
  ``COLOR_HSV2BGR`` as OpenCV's vector path computes it, in float32.
- ``get_rotation_matrix_2d``, ``get_affine_transform`` and
  ``invert_affine_transform`` are cv2's closed forms, in float64.
- ``fill_rect`` is ``cv2.rectangle`` with thickness -1.
"""
from __future__ import annotations

import math
import struct
import zlib
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel


# -- files -------------------------------------------------------------------------------------------

def imread_bgr(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 BGR, as ``cv2.imread(path,
    IMREAD_COLOR)`` does: grey is repeated into three channels, alpha dropped,
    16-bit samples cut to their high byte, and a JPEG's EXIF orientation
    applied."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        return _decode_png(path, data)
    return _decode_with_pillow(path)


def _decode_with_pillow(path: str) -> np.ndarray:
    try:
        from PIL import Image, ImageOps
    except ImportError:
        raise ImportError(f"{path}: JPEG (every format but PNG) needs Pillow, which is not "
                          f"installed") from None
    with Image.open(path) as im:
        rgb = np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
    return np.ascontiguousarray(rgb[..., ::-1])


def _png_chunks(path: str, data: bytes):
    pos = 8
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {tag!r}")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _decode_png(path: str, data: bytes) -> np.ndarray:
    header, palette, idat = None, None, []
    for tag, body in _png_chunks(path, data):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise NotImplementedError(f"{path}: interlaced PNG is not supported")
    if color not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16) or (depth < 8 and color not in (0, 3)):
        raise ValueError(f"{path}: PNG colour type {color} at bit depth {depth} is not valid")
    channels = _PNG_CHANNELS[color]
    row_bytes = (w * channels * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (row_bytes + 1):
        raise ValueError(f"{path}: PNG image data too short")
    rows = _unfilter(raw[:h * (row_bytes + 1)].reshape(h, row_bytes + 1), max(1, channels * depth // 8))

    if depth < 8:  # grey or palette indices, packed big-end first
        samples = np.unpackbits(rows, axis=1).reshape(h, -1, depth)[:, :w]
        values = (samples * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(-1).astype(np.uint8)
        if color == 0:  # scaled to 0-255, as libpng expands grey
            values = (values.astype(np.uint16) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        pixels = values[..., None]
    elif depth == 16:
        pixels = rows.reshape(h, w, channels, 2)[..., 0]
    else:
        pixels = rows.reshape(h, w, channels)

    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        rgb = palette[pixels[..., 0]]
    elif color in (0, 4):
        rgb = np.repeat(pixels[..., :1], 3, axis=2)
    else:
        rgb = pixels[..., :3]
    return np.ascontiguousarray(rgb[..., ::-1])


def _unfilter(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters (None, Sub, Up, Average, Paeth). Sub and Up
    are sums that numpy takes whole; Average and Paeth depend on the pixel to
    the left, so they go pixel by pixel."""
    h, n = filtered.shape[0], filtered.shape[1] - 1
    out = np.zeros((h + 1, n), np.uint8)  # row 0: the zero row above the image
    for r in range(h):
        kind, line, prev = filtered[r, 0], filtered[r, 1:], out[r]
        if kind == 0:
            out[r + 1] = line
        elif kind == 1:
            out[r + 1] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[r + 1] = line + prev
        elif kind in (3, 4):
            out[r + 1] = _unfilter_serial(kind, line, prev, bpp)
        else:
            raise ValueError(f"PNG filter type {kind} is not valid")
    return out[1:]


def _unfilter_serial(kind: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    cur = np.zeros(line.size + bpp, np.int32)  # bpp zeros to the left of the row
    line, up = line.astype(np.int32), np.concatenate([np.zeros(bpp, np.int32), prev.astype(np.int32)])
    for i in range(0, line.size, bpp):
        a, b, c = cur[i:i + bpp], up[i + bpp:i + 2 * bpp], up[i:i + bpp]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        cur[i + bpp:i + 2 * bpp] = (line[i:i + bpp] + pred) & 255
    return cur[bpp:].astype(np.uint8)


def imwrite_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """Write (H, W) grey or (H, W, 3) BGR uint8 as an 8-bit PNG (no filter,
    zlib ``level``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"{path}: imwrite_png takes (H, W) or (H, W, 3) uint8, not {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    color, samples = (0, img) if img.ndim == 2 else (2, img[..., ::-1])
    raw = np.zeros((h, 1 + samples[0].size), np.uint8)  # filter byte 0 on each row
    raw[:, 1:] = samples.reshape(h, -1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


# -- drawing ----------------------------------------------------------------------------------------

def fill_rect(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color: Sequence[float]) -> np.ndarray:
    """``cv2.rectangle(img, pt1, pt2, color, -1)``: fill the pixels from
    ``pt1`` to ``pt2`` (x, y), both corners included, clipped to the image;
    in place."""
    (x1, y1), (x2, y2) = pt1, pt2
    h, w = img.shape[:2]
    xa, xb = max(min(x1, x2), 0), min(max(x1, x2), w - 1)
    ya, yb = max(min(y1, y2), 0), min(max(y1, y2), h - 1)
    if xa <= xb and ya <= yb:
        img[ya:yb + 1, xa:xb + 1] = np.asarray(color, img.dtype)[:img.shape[2]] if img.ndim == 3 else color[0]
    return img


# -- geometry ---------------------------------------------------------------------------------------

def _taps(n_in: int, n_out: int):
    """The two source indices and float32 weights of each output position:
    its centre maps to (i + 0.5) * n_in / n_out - 0.5, clamped to the edge
    pixels."""
    src = np.clip((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5, 0, n_in - 1)
    i0 = np.floor(src).astype(np.intp)
    w1 = (src - i0).astype(np.float32)
    return i0, np.minimum(i0 + 1, n_in - 1), np.float32(1) - w1, w1


def resize_bilinear(img: np.ndarray, dsize: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, dsize, interpolation=INTER_LINEAR)``: each output
    pixel mixes its two nearest input pixels on each axis (half-pixel
    centres, edges repeated), rows then columns, in float32; uint8 results
    round to the nearest level. ``dsize`` is (w, h)."""
    w, h = int(dsize[0]), int(dsize[1])
    if (h, w) == img.shape[:2]:
        return img.copy()
    y0, y1, wy0, wy1 = _taps(img.shape[0], h)
    x0, x1, wx0, wx1 = _taps(img.shape[1], w)
    f = img.astype(np.float32, copy=False)
    per_row = (slice(None),) + (None,) * (img.ndim - 1)
    per_col = (None, slice(None)) + (None,) * (img.ndim - 2)
    rows = f[y0] * wy0[per_row] + f[y1] * wy1[per_row]
    out = rows[:, x0] * wx0[per_col] + rows[:, x1] * wx1[per_col]
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype, copy=False)


def invert_affine_transform(M: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform``, in float64; a singular M gives zeros."""
    M = np.asarray(M, np.float64)
    d = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = M[1, 1] * d, M[0, 0] * d, -M[0, 1] * d, -M[1, 0] * d
    b1 = -a11 * M[0, 2] - a12 * M[1, 2]
    b2 = -a21 * M[0, 2] - a22 * M[1, 2]
    return np.array([[a11, a12, b1], [a21, a22, b2]], np.float64)


def warp_affine(img: np.ndarray, M: np.ndarray, dsize: Tuple[int, int], border_value: float = 0.0) -> np.ndarray:
    """``cv2.warpAffine(img, M, dsize, borderValue=border_value)`` with
    bilinear taps: output pixel (x, y) samples the input at M⁻¹ (x, y, 1)
    (float64, then float32 grid coordinates), and a tap off the input reads
    ``border_value`` (the same in every channel). Sampling is linear, so the
    border is a zero border around ``img - border_value``. ``dsize`` is
    (w, h)."""
    w, h = int(dsize[0]), int(dsize[1])
    ih, iw = img.shape[:2]
    inv = invert_affine_transform(M)
    xs, ys = np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64)[:, None]
    sx = inv[0, 0] * xs + (inv[0, 1] * ys + inv[0, 2])
    sy = inv[1, 0] * xs + (inv[1, 1] * ys + inv[1, 2])
    # grid_sample's pixel centres (align_corners=False): x = ((g + 1) * iw - 1) / 2
    grid = np.stack([(2 * sx + 1) / iw - 1, (2 * sy + 1) / ih - 1], axis=-1).astype(np.float32)
    src = torch.from_numpy(np.ascontiguousarray(img)).to(torch.float32)
    src = (src[..., None] if img.ndim == 2 else src).permute(2, 0, 1)[None] - float(border_value)
    out = F.grid_sample(src, torch.from_numpy(grid)[None], mode="bilinear", padding_mode="zeros",
                        align_corners=False)[0].permute(1, 2, 0) + float(border_value)
    out = out[..., 0] if img.ndim == 2 else out
    if img.dtype == np.uint8:
        out = out.round().clamp_(0, 255).to(torch.uint8)
    return out.contiguous().numpy().astype(img.dtype, copy=False)


def get_rotation_matrix_2d(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: rotate by ``angle`` degrees
    (anticlockwise) about ``center`` and scale, as a (2, 3) float64 matrix."""
    a = angle * math.pi / 180
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getAffineTransform``: the (2, 3) float64 matrix taking the three
    ``src`` points to the three ``dst`` points, from cv2's 6x6 system solved
    by LU with partial pivoting."""
    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    a = np.zeros((6, 6), np.float64)
    b = np.zeros(6, np.float64)
    for i in range(3):
        a[2 * i, 0:2] = a[2 * i + 1, 3:5] = src[i]
        a[2 * i, 2] = a[2 * i + 1, 5] = 1.0
        b[2 * i:2 * i + 2] = dst[i]
    return np.linalg.solve(a, b).reshape(2, 3)


# -- colour -----------------------------------------------------------------------------------------

_HSV_SHIFT = 12
_SDIV = np.zeros(256, np.int32)
_HDIV180 = np.zeros(256, np.int32)
_SDIV[1:] = np.rint((255 << _HSV_SHIFT) / np.arange(1, 256, dtype=np.float64))
_HDIV180[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256, dtype=np.float64)))


def bgr_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_BGR2HSV)`` on uint8, bit for bit: V = max,
    S = 255 (V - min) / V and H = 30 · hue sector in [0, 180), each through
    OpenCV's 12-bit fixed-point reciprocal tables."""
    b, g, r = (img[..., i].astype(np.int32) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h += (h < 0) * 180
    out = np.empty(img.shape, np.uint8)
    out[..., 0], out[..., 1], out[..., 2] = h, s, v
    return out


_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])  # (b, g, r) picks


def hsv_to_bgr_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, COLOR_HSV2BGR)`` on uint8 (H in [0, 180)), as
    OpenCV's vector path computes it: float32 h · 6/180, s / 255 and v / 255,
    the hue sector's table, then each channel · 255 truncated. (OpenCV's
    scalar tail, the last width mod 32 pixels of a row on an AVX2 build,
    rounds instead: one level apart on a third of those pixels.)"""
    f = hsv.astype(np.float32)
    h = f[..., 0] * np.float32(6.0 / 180.0)
    s = f[..., 1] * np.float32(1.0 / 255.0)
    v = f[..., 2] * np.float32(1.0 / 255.0)
    pre = np.trunc(h)
    h = h - pre
    sector = (pre - np.trunc(pre * np.float32(1.0 / 6.0)) * np.float32(6.0)).astype(np.int64)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    return np.clip(np.trunc(bgr * np.float32(255.0)), 0, 255).astype(np.uint8)
