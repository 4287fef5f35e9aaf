"""Randomised cross-implementation fuzz: oracle vs native vs device path."""

import numpy as np
import pytest

import tokenmonster_tpu.core.vocab as vocab_mod
from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode
from tokenmonster_tpu import native

WORDS = [b"the", b"cat", b"dog", b"run", b"ing", b"er", b"s", b"and",
         b"to", b"of", b"a", b"in", b"x", b"y", b"12", b"3", b".", b",",
         b"\n", b"-", b"'"]


def _random_vocab(rng, capcode):
    n_tok = rng.integers(10, 60)
    toks = set()
    while len(toks) < n_tok:
        k = rng.integers(1, 4)
        t = b"".join(WORDS[rng.integers(0, len(WORDS))] for _ in range(k))
        if rng.random() < 0.5:
            t = b" " + t
        toks.add(t[:40])
    v = Vocab()
    v._generate(tokens=sorted(toks), charset=1, normalize_string="none",
                using_capcode=capcode, level=5, reserve=8,
                reset_token_ids=True)
    return v


def _random_text(rng, n):
    parts = []
    size = 0
    while size < n:
        r = rng.random()
        if r < 0.75:
            w = WORDS[rng.integers(0, len(WORDS))]
            if rng.random() < 0.3:
                w = w.decode().capitalize().encode()
            parts.append(w)
            parts.append(b" " if rng.random() < 0.7 else b"")
        else:
            parts.append(bytes([rng.integers(0, 256)]))
        size += len(parts[-2] if len(parts) > 1 else parts[-1]) + 1
    return b"".join(parts)[:n]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("capcode", [0, 2])
def test_fuzz_oracle_native_device(seed, capcode):
    rng = np.random.default_rng(seed * 10 + capcode)
    v = _random_vocab(rng, capcode)
    text = _random_text(rng, 1600)
    data = normalize_and_capcode(text, capcode, v.normalizer)

    want_ids, want_missing = host_tokenize(v, data)

    if native.get_lib() is not None:
        nv = native.NativeVocab(v)
        got_ids, got_missing = nv.tokenize(data, threads=1)
        np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
        assert got_missing == want_missing
        got_ids2, got_missing2 = nv.tokenize(data + data * 8, threads=2)
        w2, m2 = host_tokenize(v, data + data * 8)
        np.testing.assert_array_equal(got_ids2, np.asarray(w2))

    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    tk = DeviceTokenizer(v, chunk=256)
    t_ids, t_missing = tk.tokenize(data)
    np.testing.assert_array_equal(np.asarray(t_ids), np.asarray(want_ids))
    assert t_missing == want_missing
