"""Phase-1 match table (AC DFA) vs host dictionary oracle."""

import numpy as np
import pytest

from tokenmonster_tpu.core.vocab import Vocab
from tokenmonster_tpu.ops.automaton import build_match_automata
from tokenmonster_tpu.ops.match import (
    compute_match_table, reference_match_table, reference_space_match_table,
)


@pytest.fixture(scope="module")
def small_vocab():
    v = Vocab()
    v._generate(tokens=[b" hello", b" world", b"hello", b"hell", b"he",
                        b" he", b"lo w", b"o wor", b"ld", b" the", b"the",
                        b"ing", b" a", b"abcdefghijklmnopqrstuvwxyz0123456789",
                        b"\x00\x01", b"  ", b"   "],
                charset=1, normalize_string="none", using_capcode=2,
                level=5, reserve=8, reset_token_ids=True)
    return v


def test_match_table_vs_oracle(small_vocab):
    rng = np.random.default_rng(42)
    text = (b"hello world the thing  a hello   abcdefghijklmnopqrstuvwxyz0123456789"
            b" \x00\x01\x02 hellhello worhello")
    data = np.frombuffer(text, np.uint8)
    main, space = build_match_automata(small_vocab)
    got = compute_match_table(main, data, chunk=16)
    want = reference_match_table(small_vocab, data)
    np.testing.assert_array_equal(got, want)

    gotb = compute_match_table(space, data, chunk=16)
    wantb = reference_space_match_table(small_vocab, data)
    np.testing.assert_array_equal(gotb, wantb)

    # random bytes, multiple chunk sizes
    rand = rng.integers(0, 256, size=1000, dtype=np.uint8)
    want_r = reference_match_table(small_vocab, rand)
    for chunk in (8, 64, 256, 2048):
        got_r = compute_match_table(main, rand, chunk=chunk)
        np.testing.assert_array_equal(got_r, want_r)


def test_match_table_realtext(realtext_any):
    v = realtext_any
    text = (b"The quick brown fox jumps over the lazy dog. "
            b"Programming languages: Python, C++, Go; \xe4\xbd\xa0\xe5\xa5\xbd"
            b" int main() { return 0; } // comment\n#include <stdio.h>\n") * 3
    data = np.frombuffer(v.normalize(text), np.uint8)
    main, space = build_match_automata(v)
    got = compute_match_table(main, data, chunk=128)
    want = reference_match_table(v, data)
    np.testing.assert_array_equal(got, want)
    if space is not None:
        gotb = compute_match_table(space, data, chunk=128)
        wantb = reference_space_match_table(v, data)
        np.testing.assert_array_equal(gotb, wantb)
