"""JSONL metric logging and its TensorBoard mirror.

Counterpart of the JAX package's `utils/logging.py`: every run writes a
JSONL event stream (step, losses, LRs, grad norms, throughput), and on
request mirrors its scalars into a TensorBoard event file.

The event file is written here in plain Python (`EventFileWriter`), since
neither TensorFlow nor `tensorboard` is needed to run the port: TFRecord
framing (u64 length, masked CRC-32C of the length, the data, masked
CRC-32C of the data) around hand-encoded `Event` protos, each scalar as
TF2's `tf.summary.scalar` writes it (a rank-0 DT_FLOAT tensor in
`tensor_content`, plugin "scalars").
"""

from __future__ import annotations

import itertools
import json
import os
import pathlib
import socket
import struct
import time
from typing import Any, Optional

import numpy as np


def _crc32c_table() -> tuple:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78) of `data`:
    TFRecord's checksum (zlib's CRC-32 is another polynomial)."""
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: the CRC rotated right by 15 bits plus
    0xa282ead8, mod 2^32."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    n = struct.pack("<Q", len(data))
    return (n + struct.pack("<I", masked_crc32c(n)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1               # an int64's two's complement
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _sub(field: int, payload: bytes) -> bytes:
    """A length-delimited proto field (wire type 2)."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, body: bytes) -> bytes:
    """Event{wall_time = 1 (double), step = 2 (int64; 0 is not written, as
    proto3 omits defaults), then `body`}."""
    head = b"\x09" + struct.pack("<d", wall_time)
    return head + (b"\x10" + _varint(step) if step else b"") + body


# SummaryMetadata{plugin_data = 1 {plugin_name = 1: "scalars"}}
_SCALARS = _sub(1, _sub(1, b"scalars"))


def _scalar_event(tag: str, value: float, step: int,
                  wall_time: float) -> bytes:
    """Event{summary = 5 {value = 1 {tag = 1, tensor = 8 {dtype = 1:
    DT_FLOAT, tensor_shape = 2: rank 0, tensor_content = 4: the float32,
    which is inf beyond its range}, metadata = 9}}}."""
    with np.errstate(over="ignore"):
        f32 = np.asarray(value, "<f4").tobytes()
    tensor = b"\x08\x01" + _sub(2, b"") + _sub(4, f32)
    value_msg = _sub(1, tag.encode()) + _sub(8, tensor) + _sub(9, _SCALARS)
    return _event(wall_time, step, _sub(5, _sub(1, value_msg)))


_FILES = itertools.count()           # the last field of each file's name


class EventFileWriter:
    """A TensorBoard event file `events.out.tfevents.<unix time>.<host>.
    <pid>.<n>.v2` under `logdir`: a first event with file_version
    "brain.Event:2", then one event per scalar. Each record is flushed as
    it is written."""

    def __init__(self, logdir: str | pathlib.Path):
        logdir = pathlib.Path(logdir)
        logdir.mkdir(parents=True, exist_ok=True)
        now = int(time.time())
        self.path = logdir / (f"events.out.tfevents.{now}."
                              f"{socket.gethostname()}.{os.getpid()}."
                              f"{next(_FILES)}.v2")
        self._f = self.path.open("wb")
        self._write(_event(float(now), 0, _sub(3, b"brain.Event:2")))

    def _write(self, event: bytes) -> None:
        self._f.write(tfrecord(event))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_scalar_event(tag, value, step, time.time()))

    def close(self) -> None:
        self._f.close()


class MetricLogger:
    """Append-only JSONL event log; stdout echo optional.

    `tensorboard`: optional event-file directory. Every numeric field of
    a record that carries a `step` or `epoch` is mirrored as the scalar
    `<event>/<field>` at that step; other fields, and records without a
    step, stay in the JSONL only, which is the source of truth either
    way."""

    def __init__(self, path: Optional[str | pathlib.Path] = None,
                 echo: bool = False,
                 tensorboard: Optional[str | pathlib.Path] = None):
        self.path = pathlib.Path(path) if path else None
        self.echo = echo
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = self.path.open("a")
        else:
            self._f = None
        self._tb = (EventFileWriter(tensorboard) if tensorboard is not None
                    else None)

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        line = json.dumps(rec, default=float)
        if self._f:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line)
        if self._tb is not None:
            step = fields.get("step", fields.get("epoch"))
            if step is not None:
                for k, v in fields.items():
                    if k in ("step", "epoch"):
                        continue
                    try:
                        value = float(v)
                    except (TypeError, ValueError):
                        continue        # non-scalar field (str, array, ...)
                    self._tb.add_scalar(f"{event}/{k}", value, int(step))

    def close(self) -> None:
        if self._f:
            self._f.close()
        if self._tb is not None:
            self._tb.close()

