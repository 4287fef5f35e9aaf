#!/usr/bin/env python
"""Rebuild .tmp/real_corpus.bin — the real-text bench corpus.

bench.py's real-text row (device_bps_realtext + FNV certificate)
reads the first 4 MB of this file; tests/test_capcode_native.py's
real-corpus parity test reads 1 MB of the capcoded form.  The corpus is
real English prose + source code assembled deterministically from files
already on the rig (the reference repo's docs/sources and the Python
standard library), so any machine with this repo can regenerate a
byte-identical file:

    python tools/measure/build_real_corpus.py

Determinism: files are concatenated in sorted-path order with a one-line
header per file; the stdlib portion pins os.__file__'s directory (the
running interpreter's stdlib) — corpus bytes therefore depend on the
Python version, which is fine: the bench certifies device-vs-native FNV
equality ON THE SAME RUN's corpus, not against a stored checksum.
"""
import os
import sys

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   os.pardir, os.pardir, ".tmp", "real_corpus.bin")
CAP = 20 * 1024 * 1024
EXTS = (".md", ".go", ".py", ".js", ".cpp", ".hpp", ".yaml", ".txt",
        ".json")


def gather(root, exts, cap):
    chunks, total = [], 0
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for f in sorted(filenames):
            if f.endswith(exts):
                paths.append(os.path.join(dirpath, f))
    for p in sorted(paths):
        try:
            with open(p, "rb") as fh:
                data = fh.read()
        except OSError:
            continue
        if not data or b"\x00" in data[:4096]:
            continue
        rel = os.path.relpath(p, root)
        chunks.append(b"\n# == %s ==\n" % rel.encode() + data)
        total += len(chunks[-1])
        if total >= cap:
            break
    return b"".join(chunks)[:cap]


def main():
    parts = []
    ref = "/root/reference"
    if os.path.isdir(ref):
        parts.append(gather(ref, EXTS, CAP // 2))
    stdlib = os.path.dirname(os.__file__)
    parts.append(gather(stdlib, (".py",), CAP - sum(map(len, parts))))
    data = b"".join(parts)[:CAP]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "wb") as fh:
        fh.write(data)
    print(f"wrote {len(data)} bytes to {os.path.normpath(OUT)}")


if __name__ == "__main__":
    sys.exit(main())
