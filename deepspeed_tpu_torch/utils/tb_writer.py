"""Minimal TensorBoard event-file writer (no tensorboard/tensorflow dep).

Port of deepspeed_tpu/utils/tb_writer.py (pure Python, byte for byte the
same records). The reference logs scalars through tensorboardX (reference
engine.py:157-158, 888-899, 1039-1091). This writes the same on-disk
format natively: a TFRecord stream of protobuf ``Event`` messages with
masked-CRC32C framing, readable by stock TensorBoard.

Wire format (both fixed, stable since TF 1.x):
  record  = uint64 len (LE) | masked_crc32c(len) | data | masked_crc32c(data)
  Event   = { double wall_time = 1; int64 step = 2;
              string file_version = 3; Summary summary = 5; }
  Summary = { repeated Value value = 1 }  with
  Value   = { string tag = 1; float simple_value = 2; }
"""
import os
import socket
import struct
import time

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; TFRecord uses the masked variant
# ---------------------------------------------------------------------------
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# tiny protobuf encoder (just the fields Event/Summary need)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _summary_value(tag: str, value: float) -> bytes:
    return _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_float(2, float(value)))


def _event(step: int, summary: bytes = b"", file_version: str = None) -> bytes:
    msg = _pb_double(1, time.time())
    if file_version is not None:
        msg += _pb_bytes(3, file_version.encode())
    else:
        msg += _pb_int64(2, int(step))
        msg += _pb_bytes(5, summary)
    return msg


class SummaryWriter:
    """tensorboardX-shaped scalar writer producing real TB event files."""

    def __init__(self, log_dir: str, job_name: str = None):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}"
                 + (f".{job_name}" if job_name else ""))
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_event(0, file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, global_step: int = 0):
        self._write_record(_event(global_step, _summary_value(tag, value)))

    def add_scalars(self, scalars: dict, global_step: int = 0):
        summary = b"".join(_summary_value(t, v) for t, v in scalars.items())
        self._write_record(_event(global_step, summary))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# reader: the records back, CRCs checked (what a run's own checks read)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(msg: bytes):
    """(field, wire type, value) of each field of one protobuf message."""
    i = 0
    while i < len(msg):
        key, i = _read_varint(msg, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(msg, i)
        elif wire == 1:
            v, i = msg[i:i + 8], i + 8
        elif wire == 5:
            v, i = msg[i:i + 4], i + 4
        elif wire == 2:
            n, i = _read_varint(msg, i)
            v, i = msg[i:i + n], i + n
        else:
            raise ValueError(f"protobuf wire type {wire} is not written here")
        yield field, wire, v


def read_events(path):
    """Every record of an event file: ``[{"wall_time", "step",
    "file_version" or "scalars": {tag: value}}]``. Raises ValueError on a
    record whose length or data CRC does not match."""
    with open(path, "rb") as f:
        data = f.read()
    out, i = [], 0
    while i < len(data):
        hdr = data[i:i + 8]
        (crc_h,) = struct.unpack("<I", data[i + 8:i + 12])
        if len(hdr) < 8 or crc_h != _masked_crc(hdr):
            raise ValueError(f"{path}: bad length CRC at byte {i}")
        (n,) = struct.unpack("<Q", hdr)
        body = data[i + 12:i + 12 + n]
        (crc_d,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if len(body) < n or crc_d != _masked_crc(body):
            raise ValueError(f"{path}: bad data CRC at byte {i}")
        i += 16 + n
        event = {"step": 0}
        for field, _, v in _fields(body):
            if field == 1:
                event["wall_time"] = struct.unpack("<d", v)[0]
            elif field == 2:
                event["step"] = v
            elif field == 3:
                event["file_version"] = v.decode()
            elif field == 5:
                scalars = event.setdefault("scalars", {})
                for _, _, value in _fields(v):
                    tag = val = None
                    for f2, _, v2 in _fields(value):
                        if f2 == 1:
                            tag = v2.decode()
                        elif f2 == 2:
                            val = struct.unpack("<f", v2)[0]
                    scalars[tag] = val
        out.append(event)
    return out
