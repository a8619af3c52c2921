"""TensorBoard event-file writer, pure Python (the port's copy of
speech_recognition_tpu/utils/tb_events.py).

A copy of the JAX package's module, which imports no jax itself but
cannot be imported without running ``speech_recognition_tpu/__init__.py``
(which does). It writes training scalars in the ``events.out.tfevents.*``
format that TensorBoard loads (the reference's ``TensorBoard(log_dir=...)``
callback, train.py:64): TFRecord framing (length and masked CRC32C) around
hand-encoded ``Event``/``Summary`` protobufs for scalar summaries, so no
TensorFlow is needed. ``tests/test_torch_train_cli.py`` holds its bytes
equal to the JAX writer's.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterable, Optional, Tuple

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, as used by TFRecord framing.
# ---------------------------------------------------------------------------

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Minimal protobuf wire-format encoding for Event / Summary scalars.
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= 0xFFFFFFFFFFFFFFFF  # int64 two's complement
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int64_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def encode_scalar_event(step: int, wall_time: float,
                        scalars: Dict[str, float]) -> bytes:
    """Event{wall_time, step, summary{value{tag, simple_value}...}}."""
    summary = b"".join(
        _bytes_field(1, _bytes_field(1, tag.encode("utf-8"))
                     + _float_field(2, float(value)))
        for tag, value in scalars.items())
    return (_double_field(1, wall_time) + _int64_field(2, step)
            + _bytes_field(5, summary))


def encode_file_version(wall_time: float) -> bytes:
    """The conventional first record: Event{file_version='brain.Event:2'}."""
    return _double_field(1, wall_time) + _bytes_field(3, b"brain.Event:2")


def tfrecord_frame(data: bytes) -> bytes:
    """TFRecord: len u64 | masked_crc(len) u32 | data | masked_crc(data)."""
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header))
            + data + struct.pack("<I", masked_crc32c(data)))


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


class TBEventWriter:
    """Append-only scalar event writer for one log directory.

    Usage::

        w = TBEventWriter("artifacts/exp210/tb")
        w.add_scalars(step=100, {"loss": 0.71, "lr": 1e-3})
        w.close()
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "local"
        name = (f"events.out.tfevents.{int(time.time())}.{host}"
                f"{filename_suffix}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(encode_file_version(time.time()))

    def _write(self, event_bytes: bytes) -> None:
        self._f.write(tfrecord_frame(event_bytes))

    def add_scalars(self, step: int, scalars: Dict[str, float],
                    wall_time: Optional[float] = None) -> None:
        finite = {k: float(v) for k, v in scalars.items()
                  if v is not None}
        if not finite:
            return
        self._write(encode_scalar_event(
            step, wall_time if wall_time is not None else time.time(),
            finite))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalar_events(path: str) -> Iterable[Tuple[int, Dict[str, float]]]:
    """Decode scalar events back from an event file (for tests/tools;
    inverse of the writer, same minimal proto subset)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        record = data[pos + 12: pos + 12 + length]
        pos += 12 + length + 4
        step, scalars = 0, {}
        rpos = 0
        while rpos < len(record):
            tag_val, rpos = _decode_varint(record, rpos)
            field, wire = tag_val >> 3, tag_val & 7
            if wire == 1:
                rpos += 8
            elif wire == 0:
                val, rpos = _decode_varint(record, rpos)
                if field == 2:
                    step = val
            elif wire == 2:
                ln, rpos = _decode_varint(record, rpos)
                body = record[rpos: rpos + ln]
                rpos += ln
                if field == 5:
                    scalars.update(_decode_summary(body))
            elif wire == 5:
                rpos += 4
            else:
                break
        if scalars:
            yield step, scalars


def _decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _decode_summary(body: bytes) -> Dict[str, float]:
    scalars = {}
    pos = 0
    while pos < len(body):
        tag_val, pos = _decode_varint(body, pos)
        if tag_val >> 3 == 1 and tag_val & 7 == 2:
            ln, pos = _decode_varint(body, pos)
            value_msg = body[pos: pos + ln]
            pos += ln
            vpos, tag_name, simple = 0, None, None
            while vpos < len(value_msg):
                vtag, vpos = _decode_varint(value_msg, vpos)
                vfield, vwire = vtag >> 3, vtag & 7
                if vwire == 2:
                    ln2, vpos = _decode_varint(value_msg, vpos)
                    if vfield == 1:
                        tag_name = value_msg[vpos: vpos + ln2].decode("utf-8")
                    vpos += ln2
                elif vwire == 5:
                    if vfield == 2:
                        (simple,) = struct.unpack_from(
                            "<f", value_msg, vpos)
                    vpos += 4
                elif vwire == 0:
                    _, vpos = _decode_varint(value_msg, vpos)
                elif vwire == 1:
                    vpos += 8
            if tag_name is not None and simple is not None:
                scalars[tag_name] = simple
        else:
            break
    return scalars
