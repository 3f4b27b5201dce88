"""Dependency-free tfevents (TensorBoard) scalar writer and reader.

The port's own copy of the framework-free `raptor_tpu/utils/tfevents.py`: it
hand-encodes the two protos needed for scalars (Event / Summary) and the
TFRecord framing (length + masked CRC32C), with no tensorflow import.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven — required by the TFRecord framing
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b7 | 0x80])
        else:
            out += bytes([b7])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _f_int(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _f_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _encode_scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { tag=1, simple_value=2 }
    sv = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    # Summary { value=1 }
    summary = _f_bytes(1, sv)
    # Event { wall_time=1 (double), step=2 (int64), summary=5 }
    return _f_double(1, wall_time) + _f_int(2, step) + _f_bytes(5, summary)


def _encode_file_version(wall_time: float) -> bytes:
    # Event { wall_time=1, file_version=3 }
    return _f_double(1, wall_time) + _f_bytes(3, b"brain.Event:2")


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class SummaryWriter:
    """Append-only scalar tfevents writer.

    >>> w = SummaryWriter('runs/exp1')
    >>> w.scalar('loss', 0.1, step=10)
    >>> w.flush()
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.raptor{filename_suffix}"
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._f.write(_tfrecord(_encode_file_version(time.time())))

    def scalar(self, tag: str, value: float, step: int, wall_time: Optional[float] = None):
        ev = _encode_scalar_event(tag, value, step, wall_time or time.time())
        self._f.write(_tfrecord(ev))

    def scalars(self, values: dict, step: int):
        t = time.time()
        for tag, v in values.items():
            self.scalar(tag, float(v), step, t)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_scalars(path: str):
    """Parse a scalar tfevents file back into {tag: [(step, value), ...]}.

    Used by tests and by the baseline-comparison tooling (reads the shipped
    reference log too)."""
    out: dict = {}
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        payload = data[pos + 12 : pos + 12 + length]
        pos += 12 + length + 4
        step, wall, values = _parse_event(payload)
        for tag, v in values:
            out.setdefault(tag, []).append((step, v))
    return out


def _parse_event(buf: bytes):
    pos, step, wall, values = 0, 0, 0.0, []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            if num == 2:
                step = val
        elif wire == 1:
            (d,) = struct.unpack_from("<d", buf, pos)
            pos += 8
            if num == 1:
                wall = d
        elif wire == 5:
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            if num == 5:  # summary
                values.extend(_parse_summary(sub))
    return step, wall, values


def _parse_summary(buf: bytes):
    pos, out = 0, []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            if num == 1:
                out.append(_parse_value(sub))
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
    return out


def _parse_value(buf: bytes):
    pos, tag, val = 0, "", 0.0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            if num == 1:
                tag = buf[pos : pos + ln].decode()
            pos += ln
        elif wire == 5:
            (f,) = struct.unpack_from("<f", buf, pos)
            pos += 4
            if num == 2:
                val = f
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 1:
            pos += 8
    return tag, val


def _read_varint(buf: bytes, pos: int):
    result, shift = 0, 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
