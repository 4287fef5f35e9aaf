"""UTF-16 charset runtime parity: host oracle, device path, native C++.

The reference training tools exit on UTF-16 (getalltokens.go:1726-1737) but
the runtime supports UTF-16 vocabularies (lilbufOffset=2 arithmetic,
go/tokenmonster.go:1031-1036); all three of our runtimes do too.
"""

import numpy as np

from tokenmonster_tpu.core.vocab import Vocab


def u16(s: str) -> bytes:
    return s.encode("utf-16-le")


def test_utf16_vocab_roundtrip():
    toks = [u16(t) for t in ["hello", " hello", "world", " world", "he",
                             " the", "the", "lo wo"]]
    singles = [u16(c) for c in "abcdefghijklmnopqrstuvwxyz .!"]
    v = Vocab()
    v._generate(tokens=toks + singles, charset=2, normalize_string="none",
                using_capcode=0, level=5, reset_token_ids=True)
    assert v.charset == 2
    text = u16("the quick hello world!")
    from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
    ids, missing = host_tokenize(v, text)
    assert missing == 0
    assert v.decode(ids) == text
    # streaming decoder buffers incomplete UTF-16 code units
    d = v.new_decoder()
    out = b"".join(d.decode(np.asarray([t], np.uint32)) for t in ids)
    out += d.flush()
    assert out == text


def test_utf16_device_path_parity():
    """The device path handles charset 2 (lilbufOffset=2 arithmetic,
    go/tokenmonster.go:1031-1036, :1093): ids match the host oracle."""
    import random

    from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
    from tokenmonster_tpu.ops.scan import DeviceTokenizer

    toks = [u16(t) for t in ["hello", " hello", "world", " world", "he",
                             " the", "the", "lo wo", " wor", " w", "quick",
                             " qui", "wor", "ld", " worldly", "ly"]]
    singles = [u16(c) for c in "abcdefghijklmnopqrstuvwxyz .!"]
    v = Vocab()
    v._generate(tokens=toks + singles, charset=2, normalize_string="none",
                using_capcode=0, level=5, reset_token_ids=True)
    tk = DeviceTokenizer(v, chunk=256)
    rnd = random.Random(11)
    words = ["the", "quick", "hello", "world", "he", "lo", "worldly", "ld",
             "a", "zz"]
    for _ in range(2):
        text = u16(" ".join(rnd.choices(words, k=120)) + "!")
        want, wm = host_tokenize(v, text)
        got, gm = tk.tokenize(text)
        assert gm == wm
        np.testing.assert_array_equal(np.asarray(want), got)


def test_utf16_native_parity():
    """The native C++ tokenizer handles charset 2 (lil_off=2 path,
    native/tm_native.cpp): ids match the host oracle."""
    import random

    import pytest

    from tokenmonster_tpu import native
    from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize

    if native.get_lib() is None:
        pytest.skip("native library unavailable")

    toks = [u16(t) for t in ["hello", " hello", "world", " world", "he",
                             " the", "the", "lo wo", " wor", " w", "quick",
                             " qui", "wor", "ld", " worldly", "ly"]]
    singles = [u16(c) for c in "abcdefghijklmnopqrstuvwxyz .!"]
    v = Vocab()
    v._generate(tokens=toks + singles, charset=2, normalize_string="none",
                using_capcode=0, level=5, reset_token_ids=True)
    nv = native.NativeVocab(v)
    rnd = random.Random(23)
    words = ["the", "quick", "hello", "world", "he", "lo", "worldly", "ld",
             "a", "zz"]
    for _ in range(4):
        text = u16(" ".join(rnd.choices(words, k=250)) + "!")
        want, wm = host_tokenize(v, text)
        got, gm = nv.tokenize(text)
        assert gm == wm
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    # multithreaded path too
    text = u16(" ".join(rnd.choices(words, k=4000)))
    want, wm = host_tokenize(v, text)
    got, gm = nv.tokenize(text, threads=3)
    assert gm == wm
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
