"""The trainer's device backend (CandidateScorer.score -> the exact strip
scorer) scores successive candidates bit-identically to the native
contiguous scorer, compiling once per geometry for the whole training run:
candidate tables are padded to shared buckets."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode  # noqa: E402
from tokenmonster_tpu.train.trainvocab import CandidateScorer  # noqa: E402

POOL = [b" the", b"the", b" quick", b" brown", b" fox", b" jump",
        b"jumps", b" over", b" lazy", b" dog", b"ing", b"er", b" hello",
        b"hello", b" world", b" of", b" and", b" to", b"s ", b"e ",
        b"  ", b"\n", b" a"]
SINGLES = [bytes([c]) for c in b"abcdefghijklmnoqrstuvwxzDWC. ;:!,"]


@pytest.fixture(scope="module")
def pool_vocab():
    v = Vocab()
    v._generate(tokens=POOL + SINGLES, charset=1, normalize_string="none",
                using_capcode=2, level=5, reserve=8, reset_token_ids=True)
    return v


@pytest.fixture(scope="module")
def strips(pool_vocab):
    seed = (b"The quick brown fox jumps over the lazy dog and the world. "
            b"Hello world of jumping dogs; lazy foxes doze over the hills. ")
    corpus = normalize_and_capcode(seed * 120, 2, pool_vocab.normalizer)
    cuts = [0, 1371, 1371 + 2999, 1371 + 2999 + 4093]
    out = [bytes(corpus[cuts[i]:cuts[i + 1]]) for i in range(len(cuts) - 1)]
    out.append(bytes(corpus[cuts[-1]:cuts[-1] + 2001]) + b"\xf7\xfe"
               + bytes(corpus[:400]))
    return out


def test_pallas_scorer_matches_native(pool_vocab, strips):
    from tokenmonster_tpu import native
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    sc = CandidateScorer(1, 2, pool_vocab.normalizer.flag,
                         backend="device")
    sc.set_specials([])

    nsc = CandidateScorer(1, 2, pool_vocab.normalizer.flag,
                          backend="native")
    nsc.set_specials([])

    # several candidates: full pool, then subsets with tokens deleted
    drop_sets = [[], [b" quick", b"the", b" hello"],
                 [b" the", b"ing", b"er", b" of", b" to", b"  "]]
    for drops in drop_sets:
        cand_tokens = [t for t in POOL if t not in drops] + SINGLES
        cand = sc.build(cand_tokens)
        s_t, t_t, m_t = sc.score(cand, strips)
        s_n, t_n, m_n = nsc.score(cand, strips)
        np.testing.assert_array_equal(np.asarray(s_t), np.asarray(s_n))
        assert t_t == t_n, drops
        assert m_t == m_n, drops
    # every score() above reused one compiled step
    assert sc.device_compiles == 1
