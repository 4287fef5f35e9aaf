"""Native C++ host runtime vs Python oracle: exact parity."""

import numpy as np
import pytest

from tokenmonster_tpu.core import capcode as cc
from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode
from tokenmonster_tpu import native

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="no C++ toolchain")

TEXTS = [
    b"The quick brown fox jumps over the lazy dog. HELLO World! 123",
    b"int main() { return 0; } // code\n#include <stdio.h>",
    "Ünïcödé ÀÉÎÕÜ — “quotes” and 你好世界 🎉".encode("utf-8"),
    b"",
    b"x" * 500,
    bytes(range(256)),
]


def test_native_capcode_parity():
    for raw in TEXTS:
        want = cc.encode(raw)
        got = native.native_capcode_encode(raw)
        assert got == want, f"capcode encode mismatch on {raw[:40]!r}"
        state = np.zeros(4, np.uint8)
        dec = native.native_capcode_decode(want, state)
        assert dec == cc.decode(want)
        # no-capcode variant
        want1 = cc.no_capcode_encode(raw)
        got1 = native.native_nocapcode_encode(raw)
        assert got1 == want1
        state = np.zeros(4, np.uint8)
        assert native.native_nocapcode_decode(want1, state) == cc.no_capcode_decode(want1)


def test_native_capcode_streaming():
    data = "The QUICK Brown FoX and O'Brien's 42nd try".encode()
    encoded = cc.encode(data)
    for cut in range(0, len(encoded) + 1, 3):
        state = np.zeros(4, np.uint8)
        out = (native.native_capcode_decode(encoded[:cut], state)
               + native.native_capcode_decode(encoded[cut:], state))
        assert out == data, f"cut={cut}"


@pytest.fixture(scope="module")
def small_vocab():
    v1 = Vocab()
    v1._generate(tokens=[b" hello", b" world", b"hello", b"hell", b"he",
                         b" he", b" the", b"the", b" quick", b"quick",
                         b" brown", b" fox", b" jump", b"jumps", b" over",
                         b" lazy", b" dog", b"ing", b"er", b"s ", b"e ",
                         b"  ", b"\n"],
                 charset=1, normalize_string="none", using_capcode=2,
                 level=5, reserve=8, reset_token_ids=True)
    return v1


@pytest.mark.parametrize("which", ["small", "realtext32k",
                                   "realtext32k_cc0"])
def test_native_tokenize_parity(which, request):
    vocab = request.getfixturevalue(
        {"small": "small_vocab", "realtext32k": "realtext_vocab",
         "realtext32k_cc0": "realtext_cc0_vocab"}[which])
    rng = np.random.default_rng(3)
    rand = rng.integers(0, 256, size=2000, dtype=np.uint8).tobytes()
    samples = TEXTS + [rand, (TEXTS[0] + TEXTS[1]) * 20]
    nv = native.NativeVocab(vocab)
    for raw in samples:
        data = normalize_and_capcode(raw, vocab.using_capcode,
                                     vocab.normalizer)
        want_ids, want_missing = host_tokenize(vocab, data)
        got_ids, got_missing = nv.tokenize(data)
        assert got_missing == want_missing
        np.testing.assert_array_equal(got_ids, np.asarray(want_ids))


def test_native_sorted_windows_parity():
    """tm_sorted_windows == the numpy lexsort engine (grouping + LCP), with
    position-stable order inside equal-window groups."""
    rng = np.random.default_rng(0)
    cases = [
        rng.integers(0, 256, 5000, dtype=np.uint8),
        rng.integers(97, 101, 5000, dtype=np.uint8),
        np.frombuffer(b"the cat sat on the mat " * 300, np.uint8),
        np.zeros(2000, np.uint8),
    ]
    width = 41
    for data in cases:
        n = len(data) - width
        built = native.native_sorted_windows(data, n, width)
        if built is None:
            return  # no compiler: numpy path is the engine
        order, fd = built
        windows = np.lib.stride_tricks.sliding_window_view(data, width)[:n]
        sw_nat = windows[order]
        n_words = -(-width // 8)
        padded = np.zeros(n + n_words * 8, np.uint8)
        padded[:n + width] = data[:n + width]
        wide = np.lib.stride_tricks.sliding_window_view(
            padded, n_words * 8)[:n]
        words = np.ascontiguousarray(wide).view(">u8").reshape(n, n_words)
        ref_order = np.lexsort(
            tuple(words[:, i] for i in range(n_words - 1, -1, -1)))
        sw_ref = np.ascontiguousarray(windows[ref_order])
        neq = sw_ref[1:] != sw_ref[:-1]
        ref_fd = np.where(neq.any(axis=1), neq.argmax(axis=1), width)
        np.testing.assert_array_equal(sw_nat, sw_ref)
        np.testing.assert_array_equal(fd, ref_fd)
        grp_start = np.concatenate([[True], fd < width])
        gid = np.cumsum(grp_start) - 1
        for g in range(int(gid[-1]) + 1):
            seg = order[gid == g].astype(np.int64)
            assert np.all(np.diff(seg) > 0)
