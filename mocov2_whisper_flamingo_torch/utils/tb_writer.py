"""Minimal TensorBoard event writer (no deps).

Capability parity with the reference's ``TensorBoardLogger`` scalar streams
(reference: train.py:304-308 writes train/val losses, WER, LR, and gate
values under logs/avsr_logs/version_N). Writes standard tfevents files —
hand-encoded protobuf records with masked CRC32C framing — readable by the
stock TensorBoard ``EventAccumulator`` (which ``tools/monitor.py`` uses to
read them back).
"""

from __future__ import annotations

import os
import struct
import time


# -- CRC32C (Castagnoli), table-driven ----------------------------------------

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
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# -- Protobuf wire encoding (only what tfevents needs) --------------------------


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


def _field_double(num: int, value: float) -> bytes:
    return bytes([(num << 3) | 1]) + struct.pack("<d", value)


def _field_float(num: int, value: float) -> bytes:
    return bytes([(num << 3) | 5]) + struct.pack("<f", value)


def _field_varint(num: int, value: int) -> bytes:
    return bytes([(num << 3) | 0]) + _varint(value)


def _field_bytes(num: int, data: bytes) -> bytes:
    return bytes([(num << 3) | 2]) + _varint(len(data)) + data


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    # Summary.Value { tag = 1, simple_value = 2 }
    val = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, val)  # Summary { repeated Value value = 1 }
    # Event { wall_time = 1, step = 2, summary = 5 }
    return _field_double(1, wall_time) + _field_varint(2, step) + _field_bytes(5, summary)


def _file_version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


class SummaryWriter:
    """Drop-in minimal scalar writer: ``add_scalar(tag, value, step)``."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = f"events.out.tfevents.{int(time.time())}.{os.uname().nodename}.{os.getpid()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "wb")
        self._write_record(_file_version_event(time.time()))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
