"""Native TensorBoard event-file writer and process supervisor.

The port's own copy of ``hilo_mpc_tpu/utils/tb_events.py`` (the port
imports nothing of the JAX package); it needs neither torch's nor
TensorFlow's TensorBoard plumbing:

* ``EventFileWriter`` emits standard ``events.out.tfevents.*`` files —
  TFRecord framing (length + masked CRC32C) around hand-encoded
  ``tensorflow.Event`` protobuf messages. Only scalar summaries are
  needed for training-curve logging, so only those are implemented.
  Any stock TensorBoard (or tensorboard.backend event loaders) reads
  the output; torch/TF are NOT required to write it.
* ``TensorBoardSupervisor`` launches an installed ``tensorboard``
  binary against a logdir in a child process and optionally opens a
  browser — the reference's supervisor behavior, gated with a clear
  error when tensorboard is absent.

Wire-format notes (stable public formats, not private APIs):
 - TFRecord: u64-LE length, u32-LE masked-crc32c(length bytes),
   payload, u32-LE masked-crc32c(payload); mask(c) = ((c>>15 | c<<17)
   + 0xa282ead8) mod 2^32, CRC32C = Castagnoli (poly 0x82F63B78,
   reflected).
 - Event proto: field 1 wall_time (double), 2 step (int64),
   3 file_version (string), 5 summary (message). Summary: repeated
   field 1 Value; Value: field 1 tag (string), 2 simple_value (float).
"""
from __future__ import annotations

import os
import shutil
import socket
import struct
import subprocess
import time
from typing import Optional

__all__ = ["EventFileWriter", "TensorBoardSupervisor", "crc32c", "masked_crc"]


# -- CRC32C (Castagnoli), table-driven ----------------------------------------
def _make_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return ((c >> 15) | ((c << 17) & 0xFFFFFFFF)) + 0xA282EAD8 & 0xFFFFFFFF


# -- minimal protobuf wire encoding --------------------------------------------
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


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    if v < 0:  # int64 two's complement (10-byte varint)
        v += 1 << 64
    return _key(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _f_bytes(1, tag.encode("utf-8")) + _f_float(2, float(value))
    summary = _f_bytes(1, val)
    return (_f_double(1, wall_time) + _f_varint(2, int(step))
            + _f_bytes(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _f_double(1, wall_time) + _f_bytes(3, b"brain.Event:2")


class EventFileWriter:
    """Write TensorBoard scalar events without torch/TF.

    Drop-in for the subset of ``SummaryWriter`` the framework uses:
    ``add_scalar(tag, value, step)``, ``flush()``, ``close()``.
    """

    def __init__(self, log_dir: str = "./runs", filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        host = socket.gethostname() or "host"
        name = f"events.out.tfevents.{int(time.time())}.{host}.{os.getpid()}"
        self.path = os.path.join(log_dir, name + filename_suffix)
        self._fh = open(self.path, "wb")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int = 0,
                   wall_time: Optional[float] = None) -> None:
        if self._fh.closed:
            raise ValueError("writer is closed")
        self._write_record(
            _scalar_event(tag, value, step,
                          time.time() if wall_time is None else wall_time))

    def flush(self) -> None:
        if not self._fh.closed:
            self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TensorBoardSupervisor:
    """Run TensorBoard against a logdir in a child process.

    Mirrors the reference's ``_TensorBoardSupervisor`` (a
    multiprocessing wrapper launching the tensorboard server and a
    browser, plugins/tensorboard/wrapper.py:29-214). Gated: raises a
    clear RuntimeError when no ``tensorboard`` executable is on PATH
    instead of silently no-opping.
    """

    def __init__(self, log_dir: str, port: int = 6006,
                 open_browser: bool = False):
        self.log_dir = log_dir
        self.port = port
        self.open_browser = open_browser
        self._proc: Optional[subprocess.Popen] = None

    @property
    def url(self) -> str:
        return f"http://localhost:{self.port}/"

    def start(self) -> "TensorBoardSupervisor":
        exe = shutil.which("tensorboard")
        if exe is None:
            raise RuntimeError(
                "no `tensorboard` executable on PATH — install tensorboard "
                "to supervise a server (event files are written natively "
                "and can be viewed on any machine with tensorboard)")
        self._proc = subprocess.Popen(
            [exe, "--logdir", self.log_dir, "--port", str(self.port)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        if self.open_browser:  # pragma: no cover - needs a display
            import webbrowser
            webbrowser.open(self.url)
        return self

    def running(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def stop(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                self._proc.kill()
                self._proc.wait()
            self._proc = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
