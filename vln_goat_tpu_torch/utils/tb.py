"""Minimal TensorBoard event-file writer (no tensorflow/tensorboard dep;
a copy of vln_goat_tpu/utils/tb.py).

Both reference stacks log scalars through TensorBoard
(map_nav_src/r2r/main_nav.py:13 SummaryWriter;
pretrain_src/utils/logger.py:27-65 TensorboardLogger).  This module writes
the same on-disk format — TFRecord-framed `Event` protos with
`Summary.Value{tag, simple_value}` — so standard TensorBoard points at our
run directories unchanged, without pulling the tensorflow stack into the
image.  Wire format hand-encoded: Event{1: double wall_time, 2: int64
step, 3: string file_version | 5: Summary}; Summary{1: repeated
Value{1: string tag, 2: float simple_value}}; TFRecord framing =
len(u64 LE) + masked-crc32c(len) + payload + masked-crc32c(payload).
"""
import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; TFRecord masks it per the spec.

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = (c >> 8) ^ _CRC_TABLE[(c ^ b) & 0xFF]
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# proto wire helpers (field_number << 3 | wire_type)

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


def _tag_bytes(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _tag_double(field: int, v: float) -> bytes:
    return _varint(field << 3 | 1) + struct.pack("<d", v)


def _tag_float(field: int, v: float) -> bytes:
    return _varint(field << 3 | 5) + struct.pack("<f", v)


def _tag_varint(field: int, v: int) -> bytes:
    return _varint(field << 3 | 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    return _tag_double(1, wall_time) + _tag_varint(2, step) + body


class TensorBoardWriter:
    """SummaryWriter-shaped scalar logger (`add_scalar`, `flush`,
    `close`); one `events.out.tfevents.*` file per instance."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname().split(".")[0]
        path = os.path.join(
            log_dir,
            f"events.out.tfevents.{int(time.time())}.{host}"
            f"{filename_suffix}")
        self._f = open(path, "wb")
        self.path = path
        self._write(_event(time.time(), 0,
                           _tag_bytes(3, b"brain.Event:2")))
        self.flush()

    def _write(self, payload: bytes):
        hdr = struct.pack("<Q", len(payload))
        self._f.write(hdr + struct.pack("<I", _masked_crc(hdr))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None):
        val = _tag_bytes(1, tag.encode()) + _tag_float(2, float(value))
        summary = _tag_bytes(1, val)
        self._write(_event(wall_time if wall_time is not None
                           else time.time(), int(step),
                           _tag_bytes(5, summary)))

    def add_scalars(self, scalars: dict, step: int):
        for k, v in scalars.items():
            self.add_scalar(k, v, step)

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str):
    """Decode an events file back into [(wall_time, step, {tag: value})]
    (test/inspection aid; validates CRCs)."""
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (n,) = struct.unpack("<Q", hdr)
            (hc,) = struct.unpack("<I", f.read(4))
            assert hc == _masked_crc(hdr), "length crc mismatch"
            payload = f.read(n)
            (pc,) = struct.unpack("<I", f.read(4))
            assert pc == _masked_crc(payload), "payload crc mismatch"
            out.append(_decode_event(payload))
    return out


def _read_varint(buf: bytes, i: int):
    n = s = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << s
        if not b & 0x80:
            return n, i
        s += 7


def _decode_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = buf[i:i + 8]
            i += 8
        elif wt == 5:
            v = buf[i:i + 4]
            i += 4
        elif wt == 2:
            n, i = _read_varint(buf, i)
            v = buf[i:i + n]
            i += n
        else:  # pragma: no cover
            raise ValueError(f"wire type {wt}")
        yield field, wt, v


def _decode_event(buf: bytes):
    wall = step = 0
    scalars = {}
    for field, wt, v in _decode_fields(buf):
        if field == 1 and wt == 1:
            (wall,) = struct.unpack("<d", v)
        elif field == 2 and wt == 0:
            step = v
        elif field == 5 and wt == 2:
            for f2, _, v2 in _decode_fields(v):
                if f2 != 1:
                    continue
                tag, val = None, None
                for f3, wt3, v3 in _decode_fields(v2):
                    if f3 == 1 and wt3 == 2:
                        tag = v3.decode()
                    elif f3 == 2 and wt3 == 5:
                        (val,) = struct.unpack("<f", v3)
                if tag is not None and val is not None:
                    scalars[tag] = val
    return wall, step, scalars
