"""Device (phase-1 + phase-2 + stitch) tokenizer vs host oracle: exact parity."""

import numpy as np
import pytest

from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
from tokenmonster_tpu.core.vocab import Vocab
from tokenmonster_tpu.ops.scan import DeviceTokenizer

ENGLISH = (
    b"The quick brown fox jumps over the lazy dog. Pack my box with five "
    b"dozen liquor jugs. How vexingly quick daft zebras jump! The five "
    b"boxing wizards jump quickly. Sphinx of black quartz, judge my vow. "
    b"int main() { printf(\"hello world\\n\"); return 0; } // C code\n"
    b"def f(x):\n    return x * 2  # python\n"
)


@pytest.fixture(scope="module")
def capcode_vocab():
    v = Vocab()
    v._generate(
        tokens=[b" hello", b" world", b"hello", b"hell", b"he", b" he",
                b" the", b"the", b" quick", b"quick", b" brown", b" fox",
                b" jump", b"jumps", b" over", b" lazy", b" dog", b"ing",
                b" box", b" liquor", b" five", b" judge", b" my", b" vow",
                b"er", b" ju", b"mp", b" zebras", b"s ", b"e ", b"d ",
                b" return", b"return", b" int", b"int", b" main", b"main",
                b"() {", b"; }", b" printf", b"(\"", b"\\n\"); ", b" x",
                b" def", b" f(x):", b"    ", b" * 2", b" #", b" python",
                b"  ", b"   ", b"    ", b"\n"],
        charset=1, normalize_string="none", using_capcode=2,
        level=5, reserve=8, reset_token_ids=True)
    return v


def _assert_parity(vocab, data, chunk):
    want_ids, want_missing = host_tokenize(vocab, data)
    tk = DeviceTokenizer(vocab, chunk=chunk)
    got_ids, got_missing = tk.tokenize(data)
    assert got_missing == want_missing, (
        f"missing mismatch: {got_missing} vs {want_missing}")
    np.testing.assert_array_equal(np.asarray(got_ids), np.asarray(want_ids))


def test_capcode_vocab_parity(capcode_vocab):
    from tokenmonster_tpu.core.vocab import normalize_and_capcode
    raw = ENGLISH * 4
    data = normalize_and_capcode(raw, 2, capcode_vocab.normalizer)
    for chunk in (64, 256, 2048):
        _assert_parity(capcode_vocab, data, chunk)


def test_capcode_vocab_parity_random(capcode_vocab):
    rng = np.random.default_rng(7)
    # mixed random printable + binary
    printable = rng.integers(32, 127, size=3000, dtype=np.uint8).tobytes()
    binary = rng.integers(0, 256, size=1000, dtype=np.uint8).tobytes()
    data = printable + binary + ENGLISH
    # tokenize raw (no capcode applied: exercises missing/unk paths too)
    for chunk in (128, 1024):
        _assert_parity(capcode_vocab, data, chunk)


def test_realtext_parity(realtext_any):
    """The in-repo 32k vocabulary (capcode 2, and regenerated at capcode
    0): normalized English/code text at two chunk widths."""
    data = realtext_any.normalize(ENGLISH * 8)
    for chunk in (256, 4096):
        _assert_parity(realtext_any, data, chunk)


def test_realtext_parity_unicode(realtext_any):
    data = realtext_any.normalize(
        ("Ünïcödé everywhere: 你好世界 — em-dash, “curly quotes”, "
         "emoji 🎉🎊, tabs\tand\nnewlines. " * 6).encode("utf-8"))
    _assert_parity(realtext_any, data, 512)
