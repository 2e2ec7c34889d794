"""TensorBoard event files without TensorBoard: the port's stand-in for
``tensorboardX.SummaryWriter`` (``add_scalar``, ``add_image``, ``flush``,
``close``), which the JAX package's hooks use and a GPU machine need not
have.

An event file is a sequence of TFRecords, each

    uint64 length | uint32 masked CRC-32C of the length | data | uint32 masked CRC-32C of the data

(little-endian; CRC-32C is Castagnoli's polynomial, not ``zlib.crc32``; the
mask is ``((c >> 15) | (c << 17)) + 0xa282ead8`` mod 2^32), the data a
serialized ``Event`` protocol buffer:

    Event    wall_time 1 (double), step 2 (int64), file_version 3 (string), summary 5
    Summary  value 1 (repeated Value)
    Value    tag 1 (string), simple_value 2 (float), image 4 (Image)
    Image    height 1, width 2, colorspace 3 (int32), encoded_image_string 4 (PNG)

The first event carries ``file_version "brain.Event:2"``. The PNG is written
here too (``zlib``, chunk CRCs by ``zlib.crc32``). ``read_events`` parses a
file back, checking every CRC.
"""
from __future__ import annotations

import itertools
import os
import socket
import struct
import time
import zlib
from typing import Dict, List, Optional

import numpy as np


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protocol buffer encoding ----------------------------------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64 as two's complement, as protobuf does
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _event(step: int, wall_time: float, summary: Optional[bytes] = None, file_version: Optional[str] = None) -> bytes:
    out = _key(1, 1) + struct.pack("<d", wall_time) + _key(2, 0) + _varint(step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _value(tag: str, payload: bytes) -> bytes:
    return _bytes_field(1, _bytes_field(1, tag.encode()) + payload)


def encode_png(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB → PNG bytes, every row with filter 0, zlib
    level 6."""
    h, w, c = image.shape
    if c != 3:
        raise ValueError(f"an RGB image, not {c} channels")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), np.ascontiguousarray(image, np.uint8).reshape(h, w * c)], 1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


class SummaryWriter:
    """Writes ``events.out.tfevents.<time>.<host>.<pid>.<n>`` under
    ``log_dir`` (the suffix keeps two writers of one process and second
    apart, where tensorboardX's names would collide; TensorBoard reads every
    file whose name holds ``tfevents``)."""

    _count = itertools.count()

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}.{os.getpid()}."
                f"{next(self._count)}")
        self.path = os.path.join(log_dir, name)
        self._file = open(self.path, "wb")
        self._write(_event(0, time.time(), file_version="brain.Event:2"))

    def _write(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._file.write(header + struct.pack("<I", masked_crc(header)) + data + struct.pack("<I", masked_crc(data)))

    def add_scalar(self, tag: str, value, global_step: int = 0, walltime: Optional[float] = None) -> None:
        value = float(np.asarray(value, np.float64).reshape(()))
        self._write(_event(int(global_step), walltime or time.time(),
                           _value(tag, _key(2, 5) + struct.pack("<f", value))))

    def add_image(self, tag: str, image, global_step: int = 0, walltime: Optional[float] = None,
                  dataformats: str = "HWC") -> None:
        """An (H, W, 3) RGB image: uint8 as it is, any other dtype times 255
        (values in [0, 1]), as tensorboardX converts it."""
        if dataformats != "HWC":
            raise ValueError(f"dataformats {dataformats!r}: the writer takes HWC images")
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (img * 255.0).astype(np.uint8)
        h, w, c = img.shape
        image_pb = (_key(1, 0) + _varint(h) + _key(2, 0) + _varint(w) + _key(3, 0) + _varint(c)
                    + _bytes_field(4, encode_png(img)))
        self._write(_event(int(global_step), walltime or time.time(), _value(tag, _bytes_field(4, image_pb))))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()


# -- reading ---------------------------------------------------------------------

def _fields(data: bytes) -> List[tuple]:
    """(field, value) pairs of a serialized message: ints for varints, bytes
    for fixed and length-delimited fields."""
    out, i = [], 0
    while i < len(data):
        key, i = _read_varint(data, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(data, i)
        elif wire == 1:
            value, i = data[i:i + 8], i + 8
        elif wire == 5:
            value, i = data[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(data, i)
            value, i = data[i:i + n], i + n
        else:
            raise ValueError(f"wire type {wire} at byte {i}")
        out.append((field, value))
    return out


def _read_varint(data: bytes, i: int):
    n = shift = 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def read_events(path: str) -> List[Dict]:
    """Every event of an event file, each CRC checked (a mismatch raises):
    {"wall_time", "step", "file_version"?, "values": [{"tag",
    "simple_value"? | "image": {"height", "width", "colorspace", "png"}}]}."""
    with open(path, "rb") as f:
        raw = f.read()
    events, i = [], 0
    while i < len(raw):
        header = raw[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", raw[i + 8:i + 12])
        if crc != masked_crc(header):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        data = raw[i + 12:i + 12 + n]
        (crc,) = struct.unpack("<I", raw[i + 12 + n:i + 16 + n])
        if len(data) != n or crc != masked_crc(data):
            raise ValueError(f"{path}: bad data CRC at byte {i}")
        i += 16 + n
        event: Dict = {"values": []}
        for field, value in _fields(data):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", value)[0]
            elif field == 2:
                event["step"] = value - (1 << 64) if value >= 1 << 63 else value
            elif field == 3:
                event["file_version"] = value.decode()
            elif field == 5:
                for _, v in _fields(value):
                    entry = {}
                    for f2, x in _fields(v):
                        if f2 == 1:
                            entry["tag"] = x.decode()
                        elif f2 == 2:
                            entry["simple_value"] = struct.unpack("<f", x)[0]
                        elif f2 == 4:
                            img = dict(_fields(x))
                            entry["image"] = {"height": img.get(1, 0), "width": img.get(2, 0),
                                              "colorspace": img.get(3, 0), "png": img.get(4, b"")}
                    event["values"].append(entry)
        events.append(event)
    return events
