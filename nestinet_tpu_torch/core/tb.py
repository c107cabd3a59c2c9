"""Minimal TensorBoard scalar event writer.

Counterpart of `nestinet_tpu/core/tb.py`: the same file name, the same
TFRecord framing with a masked CRC-32C, and byte for byte the same
records.  The JAX package encodes its `Event` protobufs with
tensorboard's generated classes and turns into a no-op without them; this
writer encodes the few fields it needs by hand (`Event.wall_time`,
`.step`, `.file_version`, `.summary`; `Summary.Value.tag` and
`.simple_value`), so it needs no tensorboard and always writes.

File format: `events.out.tfevents.<wall_time>.<hostname>` containing
length-prefixed records `[len u64][masked crc32c(len) u32][payload]
[masked crc32c(payload) u32]`, the first record a file_version Event:
what `tensorboard --logdir` reads.
"""

from __future__ import annotations

import os
import socket
import struct
import time

import numpy as np

# ---- CRC-32C (Castagnoli), table-driven, as TFRecord framing requires ----
_CRC_TABLE: list[int] = []


def _crc_table() -> list[int]:
    if not _CRC_TABLE:
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---- protobuf wire format: the fields of Event and Summary used here ----
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # int64 is encoded as its two's complement
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _bytes_field(number: int, payload: bytes) -> bytes:
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def _float32(value: float) -> bytes:
    """A double rounded to float32, out-of-range values to +-inf, as the
    protobuf runtime stores a `float` field."""
    with np.errstate(over="ignore"):
        return np.asarray(value, dtype="<f4").tobytes()


def encode_event(wall_time: float, step: int = 0, *, file_version: str | None = None,
                 tag: str | None = None, simple_value: float | None = None) -> bytes:
    """A serialized `tensorboard.Event`: wall_time (field 1, double), step
    (2, int64), then file_version (3) or a summary (5) of one value with
    tag (1) and simple_value (2, float, in a oneof, so written even when
    0).  Fields in number order and proto3 defaults left out, as the
    protobuf runtime writes them."""
    out = b""
    if wall_time != 0.0:
        out += b"\x09" + struct.pack("<d", wall_time)
    if step != 0:
        out += b"\x10" + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if tag is not None:
        value = b""
        if tag:
            value += _bytes_field(1, tag.encode())
        value += b"\x15" + _float32(simple_value)
        out += _bytes_field(5, _bytes_field(1, value))
    return out


class EventWriter:
    """Append-only TB scalar writer for one log directory."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._file = open(os.path.join(logdir, name), "ab")
        self._write_record(encode_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._file.write(header)
        self._file.write(struct.pack("<I", _masked_crc(header)))
        self._file.write(payload)
        self._file.write(struct.pack("<I", _masked_crc(payload)))
        self._file.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        if self._file is None:
            raise ValueError("the event writer is closed")
        self._write_record(encode_event(time.time(), int(step), tag=tag,
                                        simple_value=float(value)))

    def scalars(self, prefix: str, values: dict, step: int) -> None:
        """One record per numeric value (bools and other types skipped),
        tagged `<prefix>/<key>`."""
        for k, v in values.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.scalar(f"{prefix}/{k}" if prefix else k, v, step)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


def read_events(path: str) -> list[bytes]:
    """The payloads of a tfevents file, each record's length and payload
    checked against its masked CRC-32C (raises ValueError on a mismatch or
    a truncated record)."""
    payloads = []
    with open(path, "rb") as f:
        while header := f.read(8):
            rest = f.read(4)
            if len(header) != 8 or len(rest) != 4:
                raise ValueError(f"{path}: truncated record header")
            if struct.unpack("<I", rest)[0] != _masked_crc(header):
                raise ValueError(f"{path}: header CRC mismatch")
            (length,) = struct.unpack("<Q", header)
            payload, crc = f.read(length), f.read(4)
            if len(payload) != length or len(crc) != 4:
                raise ValueError(f"{path}: truncated record")
            if struct.unpack("<I", crc)[0] != _masked_crc(payload):
                raise ValueError(f"{path}: payload CRC mismatch")
            payloads.append(payload)
    return payloads


def read_scalars(logdir: str) -> list[tuple[str, int, float]]:
    """(tag, step, value) of every scalar record of every event file in
    `logdir`, files in name order (the wall time of their creation)."""
    names = sorted(n for n in os.listdir(logdir) if n.startswith("events.out.tfevents."))
    out = []
    for name in names:
        for payload in read_events(os.path.join(logdir, name)):
            event = decode_event(payload)
            if "tag" in event:
                out.append((event["tag"], event["step"], event["simple_value"]))
    return out


def decode_event(payload: bytes) -> dict:
    """The fields `encode_event` writes, read back: {"wall_time", "step",
    "file_version"} or {..., "tag", "simple_value"}; other fields are
    skipped, a group (wire types 3 and 4) raises ValueError."""
    fields = _decode_message(payload)
    event = {"wall_time": struct.unpack("<d", fields.get(1, b"\0" * 8))[0],
             "step": fields.get(2, 0)}
    if 3 in fields:
        event["file_version"] = fields[3].decode()
    if 5 in fields:
        value = _decode_message(_decode_message(fields[5])[1])
        event["tag"] = value.get(1, b"").decode()
        event["simple_value"] = float(np.frombuffer(value[2], "<f4")[0])
    return event


def _decode_message(data: bytes) -> dict:
    """{field number: value} of a message of varint (step, a signed int64),
    64-bit, 32-bit and length-delimited fields, one each."""
    fields, i = {}, 0
    while i < len(data):
        key, i = _read_varint(data, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(data, i)
            fields[number] = v - (1 << 64) if v >= 1 << 63 else v
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            fields[number], i = data[i:i + n], i + n
        elif wire == 2:
            n, i = _read_varint(data, i)
            fields[number], i = data[i:i + n], i + n
        else:
            raise ValueError(f"unsupported wire type {wire} of field {number}")
        if i > len(data):
            raise ValueError("truncated message")
    return fields


def _read_varint(data: bytes, i: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if i >= len(data):
            raise ValueError("truncated varint")
        byte = data[i]
        i += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, i
