"""Decision-equivalence of the device trainer backend (VERDICT r1 weak #2/#3):
the exact strip scorer must produce bit-identical score vectors, token
counts and missing-byte sets to the native contiguous scorer on arbitrary
(unaligned) strips — and a seeded training run must therefore make
identical deletions under either backend."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode  # noqa: E402
from tokenmonster_tpu.train.trainvocab import CandidateScorer  # noqa: E402


@pytest.fixture(scope="module")
def vocab():
    v = Vocab()
    v._generate(tokens=[b" the", b"the", b" quick", b" brown", b" fox",
                        b" jump", b"jumps", b" over", b" lazy", b" dog",
                        b"ing", b"er", b" hello", b"hello", b" world",
                        b" of", b" and", b" to", b"s ", b"e ", b"  ",
                        b"\n", b" a", b"a", b"o", b"t"],
                charset=1, normalize_string="none", using_capcode=2,
                level=5, reserve=8, reset_token_ids=True)
    return v


@pytest.fixture(scope="module")
def strips(vocab):
    seed = (b"The quick brown fox jumps over the lazy dog and the world. "
            b"Hello world of jumping dogs; lazy foxes doze over the hills. "
            b"A jolt of quick thinking turns the tide: hello, brown fox! ")
    corpus = normalize_and_capcode(seed * 120, 2, vocab.normalizer)
    # odd, unaligned strip lengths incl. one with unmatched (binary) bytes
    cuts = [0, 1371, 1371 + 2999, 1371 + 2999 + 777, 1371 + 2999 + 777 + 4093]
    out = [bytes(corpus[cuts[i]:cuts[i + 1]]) for i in range(len(cuts) - 1)]
    out.append(bytes(corpus[cuts[-1]:cuts[-1] + 3001]) + b"\xf7\xfe\xff"
               + bytes(corpus[:500]))
    return out


def _score(vocab, strips, backend):
    sc = CandidateScorer(vocab.charset, vocab.using_capcode,
                         vocab.normalizer.flag, backend=backend)
    sc.set_specials([])
    return sc.score(vocab, strips)


def test_exact_scorer_matches_native(vocab, strips):
    from tokenmonster_tpu import native
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    s_n, t_n, m_n = _score(vocab, strips, "native")
    s_t, t_t, m_t = _score(vocab, strips, "device")
    np.testing.assert_array_equal(np.asarray(s_n), np.asarray(s_t))
    assert t_n == t_t
    assert m_n == m_t and len(m_t) > 0  # the binary strip must report bytes


@pytest.mark.slow
def test_train_decisions_equivalent(vocab, tmp_path):
    """Same seed + different backend => identical trained vocabulary."""
    from tokenmonster_tpu import native
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    from tokenmonster_tpu.train.getalltokens import (
        get_all_tokens, save_tokens_file)
    from tokenmonster_tpu.train.trainvocab import TrainConfig, train_vocab
    from tokenmonster_tpu.train.getalltokens import load_tokens_file

    seed = (b"The quick brown fox jumps over the lazy dog. The dog sleeps "
            b"while the fox runs through the forest; every morning the sun "
            b"rises over the mountains and the birds sing their songs. ")
    corpus = seed * 40
    counter, char_table, header = get_all_tokens(
        corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
        min_occur_total=10, min_occur_singles=1, chunk_size=1 << 20,
        micro_chunks=1, add_extra_tokens=False)
    tok_path = tmp_path / "all.tok"
    save_tokens_file(tok_path, counter, char_table, header)

    outs = {}
    for backend in ("native", "device"):
        results = tmp_path / f"results_{backend}"
        cfg = TrainConfig(vocab_size=120, workers=2, fast=True, seed=7,
                          keep_trying=5, backend=backend)
        best = train_vocab(corpus, tok_path, results, cfg)
        assert best is not None
        outs[backend] = sorted(load_tokens_file(best)["tokens"])
    assert outs["native"] == outs["device"]
