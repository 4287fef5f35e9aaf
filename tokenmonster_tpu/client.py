"""Subprocess client for the wire-protocol server.

Mirrors the reference binding's architecture (python/tokenmonster.py
``_communicate`` :1036-1092): a shared server subprocess owns the
vocabularies; multiple client processes talk the 12-byte-header protocol
over stdin/stdout pipes.  Used by ``load_multiprocess_safe``.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import threading

import numpy as np


class ServerProcess:
    """Owns a server subprocess and multiplexes requests."""

    def __init__(self):
        # the server uses only the host Vocab and never imports JAX, so it
        # holds no device memory beside the caller's own process
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "tokenmonster_tpu.cli", "server"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
                + os.environ.get("PYTHONPATH", "").split(os.pathsep))},
        )
        self._lock = threading.Lock()
        version = struct.unpack_from("<I", self.communicate(0, 0, b""), 1)[0]
        from .server import VERSION
        if version != VERSION:
            raise RuntimeError(f"server version mismatch: {version}")

    def communicate(self, job: int, vid: int, payload: bytes) -> bytes:
        """Send one request; returns the raw 9-byte header + body."""
        with self._lock:
            header = bytes([job]) + struct.pack("<I", vid) + \
                len(payload).to_bytes(7, "little")
            self._proc.stdin.write(header + payload)
            self._proc.stdin.flush()
            resp = self._proc.stdout.read(9)
            if len(resp) < 9:
                raise RuntimeError("server closed")
            status = resp[0]
            if status == 0:  # HEADER_IS_LENGTH
                length = struct.unpack_from("<Q", resp, 1)[0]
                return resp + self._proc.stdout.read(length)
            return resp

    def close(self):
        if self._proc.poll() is None:
            self._proc.stdin.close()
            self._proc.wait(timeout=5)


class RemoteVocab:
    """Vocabulary living in a server subprocess (multiprocess-safe)."""

    def __init__(self, path, server: ServerProcess | None = None):
        self._server = server or ServerProcess()
        fname = str(path).encode()
        resp = self._server.communicate(10, 0, bytes([len(fname)]) + fname)
        if resp[0] != 1:
            raise FileNotFoundError(f"server could not load {path}")
        self.id = struct.unpack_from("<I", resp, 1)[0]
        # fetch size via detailed listing header
        resp = self._server.communicate(15, self.id, b"")
        self.vocab_size = struct.unpack_from("<I", resp, 9)[0]
        self.encoding_length = 2 if self.vocab_size <= 65536 else 4

    def __len__(self):
        return self.vocab_size

    def tokenize(self, text):
        if isinstance(text, str):
            text = text.encode("utf-8")
        payload = struct.pack("<I", 1) + struct.pack("<Q", len(text)) + text
        resp = self._server.communicate(1, self.id, payload)
        blen = struct.unpack_from("<Q", resp, 13)[0]
        ser = resp[21:21 + blen]
        dt = "<u2" if self.encoding_length == 2 else "<u4"
        return np.frombuffer(ser, dt)

    def decode(self, tokens) -> str:
        arr = np.asarray(tokens, np.uint32)
        dt = "<u2" if self.encoding_length == 2 else "<u4"
        ser = arr.astype(dt).tobytes()
        payload = struct.pack("<I", 1) + struct.pack("<Q", len(ser)) + ser
        resp = self._server.communicate(self.encoding_length, self.id, payload)
        blen = struct.unpack_from("<Q", resp, 13)[0]
        return resp[21:21 + blen].decode("utf-8", errors="replace")

    def unload(self):
        self._server.communicate(11, self.id, b"")
