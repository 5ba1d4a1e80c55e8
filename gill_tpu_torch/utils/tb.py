"""Pure-Python TensorBoard event writer and reader (no tensorflow).

A copy of gill_tpu/utils/tb.py (which imports no JAX; this package keeps
its own). The reference logs scalars and image grids through
torch.utils.tensorboard.SummaryWriter (reference main.py:299-303,653-720),
which needs the tensorboard package; this module writes the TensorBoard
event-file format directly:

  * TFRecord framing: u64-LE length, masked-CRC32C(length), payload,
    masked-CRC32C(payload) — TensorBoard's loader verifies the length CRC
    and stops at the first bad record, so the CRCs must be real CRC32C
    (Castagnoli), not zlib's CRC32.
  * Payload: a `tensorflow.Event` protobuf. Only three shapes are ever
    emitted (file_version header, scalar summary, image summary), so the
    protobuf encoding is hand-rolled varint/tag emission instead of a
    generated schema.
  * Images are PNG-encoded with zlib only (8-bit RGB, no filtering).

Interface-compatible with the subset of SummaryWriter the trainer uses:
add_scalar(tag, value, step), add_image(tag, chw_float01, step), flush(),
close().
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli, reflected, poly 0x82F63B78) + TFRecord masking
# ---------------------------------------------------------------------------

def _make_crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


def _crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    tbl = _CRC_TABLE
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf emission
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _pb_varint(field: int, n: int) -> bytes:
    return _tag(field, 0) + _varint(n)


def _pb_double(field: int, x: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", x)


def _pb_float(field: int, x: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(x))


def _event(wall_time: float, step: int | None = None, *,
           file_version: str | None = None,
           summary: bytes | None = None) -> bytes:
    # tensorflow.Event: 1=wall_time double, 2=step int64,
    # 3=file_version string, 5=summary Summary
    msg = _pb_double(1, wall_time)
    if step is not None:
        msg += _pb_varint(2, step)
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    if summary is not None:
        msg += _pb_bytes(5, summary)
    return msg


def _scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value: 1=tag string, 2=simple_value float
    val = _pb_bytes(1, tag.encode()) + _pb_float(2, value)
    return _pb_bytes(1, val)  # Summary: repeated Value value = 1


def _image_summary(tag: str, png: bytes, h: int, w: int) -> bytes:
    # Summary.Image: 1=height, 2=width, 3=colorspace (3 = RGB),
    # 4=encoded_image_string
    img = (_pb_varint(1, h) + _pb_varint(2, w) + _pb_varint(3, 3)
           + _pb_bytes(4, png))
    val = _pb_bytes(1, tag.encode()) + _pb_bytes(4, img)  # Value: 4=image
    return _pb_bytes(1, val)


# ---------------------------------------------------------------------------
# PNG encoding (stdlib zlib only)
# ---------------------------------------------------------------------------

def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png_rgb(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes. Filter type 0 (None) per scanline."""
    assert img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8, \
        (img.shape, img.dtype)
    h, w, _ = img.shape
    # prepend the per-scanline filter byte
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class SummaryWriter:
    """Drop-in for the SummaryWriter subset the trainer uses."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        fname = "events.out.tfevents.%010d.%s.%d" % (
            int(time.time()), socket.gethostname(), os.getpid())
        self._path = os.path.join(log_dir, fname)
        self._fh = open(self._path, "wb")
        self._lock = threading.Lock()
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        rec = (header + struct.pack("<I", _masked_crc(header)) + payload
               + struct.pack("<I", _masked_crc(payload)))
        with self._lock:
            self._fh.write(rec)

    def add_scalar(self, tag: str, value, step: int):
        self._write(_event(time.time(), int(step),
                           summary=_scalar_summary(tag, float(value))))

    def add_image(self, tag: str, img, step: int):
        """img: (3, H, W) float in [0, 1] or uint8 (the torch SummaryWriter
        CHW convention the trainer already emits), or (H, W, 3) likewise."""
        a = np.asarray(img)
        if a.ndim == 3 and a.shape[0] == 3 and a.shape[2] != 3:
            a = a.transpose(1, 2, 0)
        if a.dtype != np.uint8:
            a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        h, w = a.shape[:2]
        png = encode_png_rgb(np.ascontiguousarray(a))
        self._write(_event(time.time(), int(step),
                           summary=_image_summary(tag, png, h, w)))

    def flush(self):
        with self._lock:
            self._fh.flush()

    def close(self):
        with self._lock:
            if not self._fh.closed:
                self._fh.flush()
                self._fh.close()


# ---------------------------------------------------------------------------
# reader (for tests and offline inspection; parses what the writer emits)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _parse_fields(buf: bytes):
    """Yield (field_number, wire_type, value) for one protobuf message."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        else:  # pragma: no cover
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def read_events(path: str, *, verify_crc: bool = True):
    """Parse an event file -> list of dicts:
    {'step', 'wall_time', 'file_version'?, 'scalars': {tag: val},
     'images': {tag: png_bytes}}."""
    out = []
    with open(path, "rb") as fh:
        data = fh.read()
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (ln,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", data[i + 8:i + 12])
        if verify_crc and hcrc != _masked_crc(header):
            raise ValueError(f"bad length CRC at offset {i}")
        payload = data[i + 12:i + 12 + ln]
        (pcrc,) = struct.unpack("<I", data[i + 12 + ln:i + 16 + ln])
        if verify_crc and pcrc != _masked_crc(payload):
            raise ValueError(f"bad payload CRC at offset {i}")
        i += 16 + ln

        ev = {"scalars": {}, "images": {}}
        for field, wire, val in _parse_fields(payload):
            if field == 1 and wire == 1:
                ev["wall_time"] = struct.unpack("<d", val)[0]
            elif field == 2 and wire == 0:
                ev["step"] = val
            elif field == 3 and wire == 2:
                ev["file_version"] = val.decode()
            elif field == 5 and wire == 2:
                for f2, w2, v2 in _parse_fields(val):       # Summary.Value
                    if f2 != 1 or w2 != 2:
                        continue
                    tag = simple = image = None
                    for f3, w3, v3 in _parse_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode()
                        elif f3 == 2 and w3 == 5:
                            simple = struct.unpack("<f", v3)[0]
                        elif f3 == 4 and w3 == 2:
                            for f4, w4, v4 in _parse_fields(v3):
                                if f4 == 4 and w4 == 2:
                                    image = v4
                    if tag is not None and simple is not None:
                        ev["scalars"][tag] = simple
                    if tag is not None and image is not None:
                        ev["images"][tag] = image
        out.append(ev)
    return out
