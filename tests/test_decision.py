"""Decision-table engine (ops/decision.py): direct chain-follow parity.

Validates the (2, P) decision tables against the host oracle tokenizer by
following the chain from (0, 0) on the host — no lanes, no stitcher — so a
table bug cannot hide behind stitching.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode
from tokenmonster_tpu.ops.decision import chain_follow_host, decision_tables
from tokenmonster_tpu.ops.match import compute_match_table
from tokenmonster_tpu.ops.scan import DeviceVocab

from test_scan_parity import ENGLISH, capcode_vocab  # noqa: F401


def _tables(vocab, data, extra=0):
    import tokenmonster_tpu.ops.match as match
    from tokenmonster_tpu.ops.automaton import build_match_automata

    dv = DeviceVocab.build(vocab)
    n = len(data)
    # ``extra`` zero bytes past n: the padded dispatch buffer layout
    arr = np.frombuffer(bytes(data) + bytes(extra), np.uint8)
    main, space = build_match_automata(vocab)
    m = compute_match_table(main, arr)
    pad = np.zeros(64, np.uint32)
    m_tab = jnp.asarray(np.concatenate([m, pad]))
    if space is not None and dv.has_delete:
        mb = compute_match_table(space, arr)
        # space-automaton matches at p correspond to " "+data[p:]
        mb_tab = jnp.asarray(np.concatenate([mb, pad]))
        has_delete = True
    else:
        mb_tab = m_tab
        has_delete = False
    bb = jnp.asarray(np.concatenate([
        vocab.begin_byte.astype(np.int32)[arr],
        np.full(64, int(vocab.begin_byte[0]), np.int32)]))
    ctl, tok = decision_tables(
        m_tab, mb_tab, bb, dv.p1, dv.index1, dv.index2, dv.ids,
        n, has_delete, dv.has_unk, dv.unk_token & 0xFFFFFF,
        lil_off=dv.lil_off)
    return ctl, tok, dv


def _assert_chain_parity(vocab, data, extra=0):
    ctl, tok, dv = _tables(vocab, data, extra=extra)
    got_ids, got_missing = chain_follow_host(
        ctl, tok, len(data), dv.delete_token & 0xFFFFFF)
    want_ids, want_missing = host_tokenize(vocab, data)
    assert got_missing == want_missing
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))


def test_decision_chain_capcode(capcode_vocab):  # noqa: F811
    data = normalize_and_capcode(ENGLISH * 2, 2, capcode_vocab.normalizer)
    _assert_chain_parity(capcode_vocab, data)


def test_decision_chain_random(capcode_vocab):  # noqa: F811
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, size=2000, dtype=np.uint8).tobytes() + ENGLISH
    _assert_chain_parity(capcode_vocab, data)


def test_decision_chain_dense_capcode(capcode_vocab):  # noqa: F811
    """Decision tables over a padded buffer (the dispatch layout, where
    the tables run past the n valid bytes) are identical on [0, n) to the
    exact-size tables, and their chain matches the oracle."""
    data = normalize_and_capcode(ENGLISH * 2, 2, capcode_vocab.normalizer)
    n = len(data)
    _assert_chain_parity(capcode_vocab, data, extra=777)
    a, ta, _ = _tables(capcode_vocab, data)
    b, tb, _ = _tables(capcode_vocab, data, extra=777)
    np.testing.assert_array_equal(np.asarray(a)[:, :n],
                                  np.asarray(b)[:, :n])
    # token words may differ only where ctl has no emission
    emit = (np.asarray(a)[:, :n] & (1 << 7)) != 0
    np.testing.assert_array_equal(np.asarray(ta)[:, :n][emit],
                                  np.asarray(tb)[:, :n][emit])
