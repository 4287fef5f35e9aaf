"""Distributed trainer scoring: multi-device psum == single-device scores.

This is the multi-host correctness contract from SURVEY §5: the psum'd
score vector over an N-device mesh must equal the single-device result
bit-exactly (integer scores, order-independent reduction).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode  # noqa: E402
from tokenmonster_tpu.parallel.score import (  # noqa: E402
    device_tables_for_scoring, make_distributed_score_step)


@pytest.fixture(scope="module")
def setup():
    v = Vocab()
    v._generate(tokens=[b" the", b"the", b" quick", b" brown", b" fox",
                        b" jump", b"jumps", b" over", b" lazy", b" dog",
                        b"ing", b"er", b" hello", b"hello", b" world",
                        b"s ", b"e ", b"  ", b"\n"],
                charset=1, normalize_string="none", using_capcode=2,
                level=5, reserve=8, reset_token_ids=True)
    seed = (b"The quick brown fox jumps over the lazy dog. Hello world! "
            b"Jumping dogs dodge lazy foxes while the world says hello. ")
    corpus = normalize_and_capcode(seed * 512, 2, v.normalizer)
    return v, corpus


def _run(v, corpus, n_devices, chunk=512, lanes_mult=4):
    devices = np.array(jax.devices()[:n_devices])
    mesh = Mesh(devices, ("data",))
    dv, tables = device_tables_for_scoring(v)
    n_ids = len(v.reverse)
    step = make_distributed_score_step(
        mesh, chunk, dv.space_dfa is not None, dv.delete_token, n_ids)
    per_dev = chunk * lanes_mult * (8 // n_devices)
    total = per_dev * n_devices
    arr = np.zeros(total, np.uint8)
    body = np.frombuffer(corpus[:total], np.uint8)
    arr[:len(body)] = body
    import jax.numpy as jnp
    text = jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("data")))
    rep = NamedSharding(mesh, P())
    tabs = tuple(jax.device_put(t, rep) for t in tables)
    scores, n_tok, n_miss = step(text, *tabs)
    return np.asarray(scores), int(n_tok), int(n_miss), total


def test_psum_equals_single_device(setup):
    v, corpus = setup
    assert len(jax.devices()) >= 8, "test requires the virtual 8-device mesh"
    s1, t1, m1, total = _run(v, corpus, 1)
    s8, t8, m8, total8 = _run(v, corpus, 8)
    assert total == total8
    np.testing.assert_array_equal(s1, s8)
    assert t1 == t8 and m1 == m8
    # conservation: chars covered + missing + delete-marker credits
    delete_credits = s1[v.delete_token] if v.delete_token < len(s1) else 0
    # each delete use contributes +1 score without consuming a byte
    assert s1.sum() + m1 >= total
    assert s1.sum() - delete_credits + m1 <= total


def test_scores_match_native_backend(setup):
    """Device strip-mode scoring == native scoring when strips == lanes."""
    from tokenmonster_tpu import native
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    v, corpus = setup
    chunk = 512
    s_dev, t_dev, m_dev, total = _run(v, corpus, 1, chunk=chunk)
    nv = native.NativeVocab(v)
    scores = np.zeros(len(v.reverse) + 1, np.int64)
    n_tok = 0
    data = corpus[:total] + b"\x00" * max(0, total - len(corpus))
    for i in range(0, total, chunk):
        nt, miss = nv.tokenize_score(data[i:i + chunk], scores)
        n_tok += nt
    np.testing.assert_array_equal(s_dev, scores[:len(v.reverse)])
    assert t_dev == n_tok
