"""Native metadata builder vs pure-Python oracle: exact agreement."""

import numpy as np
import pytest

import tokenmonster_tpu.core.vocab as vocab_mod
from tokenmonster_tpu.core.vocab import Vocab
from tokenmonster_tpu import native

pytestmark = pytest.mark.skipif(native.get_lib() is None,
                                reason="no C++ toolchain")


def _build(tokens, capcode, force_python, specials=()):
    old = vocab_mod._FORCE_PYTHON_META
    vocab_mod._FORCE_PYTHON_META = force_python
    try:
        v = Vocab()
        v._generate(tokens=tokens, special_tokens_encoded=list(specials),
                    charset=1, normalize_string="none",
                    using_capcode=capcode, level=5, reserve=8,
                    reset_token_ids=True)
    finally:
        vocab_mod._FORCE_PYTHON_META = old
    return v


TOKENS = [b" hello", b" world", b"hello", b"hell", b"he", b" he", b" the",
          b"the", b" quick", b"ing", b"er", b"s ", b"e ", b"  ", b"\n",
          b" 123", b"123", b"12", b" don't", b"don't", b"'s", b" it's",
          b"a-b", b" a-b", b"x_y", b" (a)", b"(a)", b"\xc3\xa9t\xc3\xa9",
          b" \xc3\xa9t\xc3\xa9", b"D hi", b"hi", b" hi",
          b"C to", b"W up", b"upD ", b"...", b" , ", b"\r\n"]


@pytest.mark.parametrize("capcode", [0, 1, 2])
def test_meta_parity(capcode):
    va = _build(TOKENS, capcode, force_python=False,
                specials=[b"<pad>", b"<eos>"])
    vb = _build(TOKENS, capcode, force_python=True,
                specials=[b"<pad>", b"<eos>"])
    assert va.tokens == vb.tokens
    np.testing.assert_array_equal(va.flag, vb.flag)
    np.testing.assert_array_equal(va.nwords, vb.nwords)
    np.testing.assert_array_equal(va.index1, vb.index1)
    np.testing.assert_array_equal(va.index2, vb.index2)
    np.testing.assert_array_equal(va.len1, vb.len1)
    np.testing.assert_array_equal(va.len2, vb.len2)
    np.testing.assert_array_equal(va.id1, vb.id1)
    np.testing.assert_array_equal(va.id2, vb.id2)
    np.testing.assert_array_equal(va.begin_byte, vb.begin_byte)


@pytest.mark.parametrize("capcode", [0, 2])
def test_meta_parity_realtext_sample(realtext_vocab, capcode):
    """Every 17th token of the in-repo 32k vocabulary: native and Python
    metadata builders agree exactly."""
    toks = [bytes(t) for i, t in enumerate(realtext_vocab.tokens)
            if i % 17 == 0 and 0 < len(t) <= 40][:1500]
    va = _build(toks, capcode, force_python=False)
    vb = _build(toks, capcode, force_python=True)
    np.testing.assert_array_equal(va.flag, vb.flag)
    np.testing.assert_array_equal(va.nwords, vb.nwords)
    np.testing.assert_array_equal(va.index1, vb.index1)
    np.testing.assert_array_equal(va.index2, vb.index2)
    np.testing.assert_array_equal(va.len1, vb.len1)
    np.testing.assert_array_equal(va.len2, vb.len2)
    np.testing.assert_array_equal(va.begin_byte, vb.begin_byte)
