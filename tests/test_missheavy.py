"""Miss-heavy corpora through the compiled device path (VERDICT r4 #7).

A missing byte WITHOUT an unk token emits nothing, so the device stitch
must handle records with no output slot.  These tests drive binary bytes
against a letters-only vocabulary (no unk) end-to-end and assert exact
ids, plus the unk variant."""

import numpy as np
import pytest

from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
from tokenmonster_tpu.core.vocab import Vocab

LETTER_TOKENS = [b"the", b" the", b"and", b" and", b"ing", b"er", b"a",
                 b"e", b"i", b"o", b"t", b"n", b"s", b"h", b" ", b"qu",
                 b" of", b"tion", b"ed ", b"ly"]


def _vocab(unk: bool) -> Vocab:
    v = Vocab()
    v._generate(tokens=list(LETTER_TOKENS), charset=0,
                normalize_string="none", using_capcode=0, level=5,
                reset_token_ids=True)
    if unk:
        v.enable_unk_token()
    return v


def _binary_corpus(n=40000, seed=7):
    rng = np.random.default_rng(seed)
    # ~half real-ish text, half arbitrary binary — plenty of missing bytes
    text = (b"the thing and the other thing er a qu of " * 400)[:n // 2]
    blob = rng.integers(0, 256, n - len(text)).astype(np.uint8).tobytes()
    chunks = []
    for i in range(0, len(text), 512):
        chunks.append(text[i:i + 512])
        chunks.append(blob[i:i + 512])
    return b"".join(chunks)[:n]


@pytest.mark.parametrize("unk", [False, True])
def test_missheavy_device_parity(unk):
    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    v = _vocab(unk)
    data = _binary_corpus()
    tk = DeviceTokenizer(v, chunk=2048)
    want_ids, want_missing = host_tokenize(v, data)
    got_ids, got_missing = tk.tokenize(data)
    assert got_missing == want_missing
    assert want_missing > 1000  # genuinely miss-heavy
    np.testing.assert_array_equal(np.asarray(got_ids),
                                  np.asarray(want_ids))


def test_missheavy_fast_window_overflow_retries_full():
    """Dense/miss-heavy data (~1 byte per record) overflows the fast
    record window; tokenize_staged must retry on the full-window variant
    and still produce exact ids on device (the device stitch handles
    non-emitting records)."""
    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    v = _vocab(False)
    data = _binary_corpus()
    tk = DeviceTokenizer(v, chunk=2048)
    res = tk.tokenize_staged(tk.stage(data))
    assert res is not None and tk.last_mode == "full"
    want_ids, want_missing = host_tokenize(v, data)
    assert res[1] == want_missing
    np.testing.assert_array_equal(np.asarray(res[0]),
                                  np.asarray(want_ids))
