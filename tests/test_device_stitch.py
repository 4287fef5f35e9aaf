"""Device-side stitch/compaction (ops/stitch.py) vs host oracle and the
legacy host stitcher — including multi-dispatch bridge chaining."""

import numpy as np
import pytest

from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
from tokenmonster_tpu.core.vocab import Vocab, normalize_and_capcode
from tokenmonster_tpu.ops import scan as scan_mod
from tokenmonster_tpu.ops.scan import DeviceTokenizer

ENGLISH = (
    b"The quick brown fox jumps over the lazy dog. Pack my box with five "
    b"dozen liquor jugs. How vexingly quick daft zebras jump! "
    b"def f(x):\n    return x * 2  # python\n"
)


@pytest.fixture(scope="module")
def vocab():
    v = Vocab()
    v._generate(
        tokens=[b" hello", b" world", b"hello", b"hell", b"he", b" he",
                b" the", b"the", b" quick", b"quick", b" brown", b" fox",
                b" jump", b"jumps", b" over", b" lazy", b" dog", b"ing",
                b" box", b" liquor", b" five", b"er", b" ju", b"mp",
                b"s ", b"e ", b"d ", b" return", b"return", b" x",
                b" def", b" f(x):", b"    ", b" * 2", b" #", b" python",
                b"  ", b"\n"],
        charset=1, normalize_string="none", using_capcode=2,
        level=5, reserve=8, reset_token_ids=True)
    return v


def test_multidispatch_bridge_chaining(vocab, monkeypatch):
    """Force many chained dispatches (small MAX_LANES) and check exact
    parity: the bridge-lane skip scalar must flow correctly between
    dispatches."""
    monkeypatch.setattr(scan_mod, "MAX_LANES", 8)
    data = normalize_and_capcode(ENGLISH * 40, 2, vocab.normalizer)
    want_ids, want_missing = host_tokenize(vocab, data)
    tk = DeviceTokenizer(vocab, chunk=64)
    L, plan = tk._plan(len(data))
    assert len(plan) > 3, "test should exercise multiple dispatches"
    got = tk.tokenize_staged(tk.stage(data))
    assert got is not None, "device stitch unexpectedly failed to sync"
    ids, missing = got
    assert missing == want_missing
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want_ids))


def test_device_matches_hoststitch(vocab):
    """Device-stitched ids == legacy host-stitched ids == oracle."""
    data = normalize_and_capcode(ENGLISH * 6, 2, vocab.normalizer)
    tk = DeviceTokenizer(vocab, chunk=128)
    dev = tk.tokenize_staged(tk.stage(data))
    host = tk._tokenize_hoststitch(data)
    want = host_tokenize(vocab, data)
    assert dev is not None
    np.testing.assert_array_equal(np.asarray(dev[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(host[0]), np.asarray(want[0]))
    assert dev[1] == want[1] == host[1]


def test_missing_bytes_and_unk(vocab):
    """Binary junk (missing bytes) flows through the device stitch."""
    rng = np.random.default_rng(3)
    data = (ENGLISH + rng.integers(128, 256, 400, dtype=np.uint8).tobytes()
            + ENGLISH)
    want_ids, want_missing = host_tokenize(vocab, data)
    tk = DeviceTokenizer(vocab, chunk=64)
    ids, missing = tk.tokenize(data)
    assert missing == want_missing
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want_ids))


@pytest.mark.parametrize("k", [16, 31])
def test_junction_sync_late_in_right_lane(k):
    """The right lane first shares a state with the left lane at its record
    k: the default probe finds it and splices exactly; a 16-record probe
    misses it and reports sync_ok False."""
    import jax.numpy as jnp
    from tokenmonster_tpu.ops.stitch import device_stitch, stitched_keep

    left = np.arange(2, 402, 2)                       # 200 records, fd 0
    right = np.concatenate([201 + 2 * np.arange(k),   # k states left lacks
                            np.arange(202 + 2 * k, 502, 2)])
    pos = np.zeros((256, 2), np.uint32)
    pos[:len(left), 0] = left
    pos[:len(right), 1] = right
    recs = jnp.asarray(np.where(pos > 0, (pos << 4) | scan_mod._REC_TOK, 0)
                       .astype(np.uint32))
    toks = jnp.asarray(pos)
    out, count, missing, _next, sync_ok = device_stitch(
        recs, toks, 0, 1, True, delete_token=0, out_cap=512)
    assert bool(sync_ok) and int(missing) == 0
    np.testing.assert_array_equal(np.asarray(out)[:int(count)],
                                  np.arange(2, 502, 2))
    assert not bool(stitched_keep(recs, 0, 1, True, probe=16)[3])


def test_tiny_and_empty(vocab):
    tk = DeviceTokenizer(vocab, chunk=64)
    ids, missing = tk.tokenize(b"")
    assert len(ids) == 0 and missing == 0
    data = b" hello"
    want_ids, want_missing = host_tokenize(vocab, data)
    ids, missing = tk.tokenize(data)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want_ids))
    assert missing == want_missing
