"""End-to-end device engine (DeviceTokenizer): match automata + decision
tables + lane follow + device stitch, byte-exact vs the host oracle.  The
engine is the same plain XLA program on every platform."""

import numpy as np
import pytest

from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
from tokenmonster_tpu.core.vocab import Vocab


@pytest.fixture(scope="module")
def plain_vocab():
    v = Vocab()
    v._generate(
        tokens=[b" the", b"the", b" quick", b"quick", b" brown", b" fox",
                b"he", b"er", b"e", b"t", b" ", b"o", b"x", b" jumps",
                b" over", b" lazy", b" dog", b"s", b"ing", b"\n", b".",
                b"q", b"u", b"i", b"c", b"k", b"b", b"r", b"w", b"n"],
        charset=1, normalize_string="none", using_capcode=0,
        level=5, reserve=8, reset_token_ids=True)
    return v


def _primitives(jaxpr, out=None):
    """Every primitive name in a closed jaxpr, nested jaxprs included."""
    out = set() if out is None else out
    for eqn in jaxpr.eqns:
        out.add(eqn.primitive.name)
        for p in eqn.params.values():
            subs = p if isinstance(p, (list, tuple)) else [p]
            for sub in subs:
                inner = getattr(sub, "jaxpr", None)
                if inner is not None and hasattr(inner, "eqns"):
                    _primitives(inner, out)
                elif hasattr(sub, "eqns"):
                    _primitives(sub, out)
    return out


def _dispatch_primitives(tk, data):
    import jax
    import jax.numpy as jnp
    n, lanes, bufs = tk.stage(data)
    buf, n_slice, last_lane = bufs[0]
    fn = tk._fused_stitch_fn(lanes)
    closed = jax.make_jaxpr(fn)(buf, jnp.int32(n_slice), jnp.int32(0),
                                jnp.int32(last_lane), jnp.bool_(True),
                                *tk.tables())
    return _primitives(closed.jaxpr)


def test_engine_selection(plain_vocab):
    """One engine: the dispatch is plain XLA (automaton scan, decision
    gathers, follow while-loop) with no kernel call of any kind."""
    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    tk = DeviceTokenizer(plain_vocab, chunk=512)
    prims = _dispatch_primitives(tk, b"the quick brown fox. " * 40)
    assert {"scan", "while", "gather"} <= prims, prims
    assert not any("pallas" in p or "custom_call" in p or "ffi" in p
                   for p in prims), prims


def test_engine_is_never_pallas_on_any_platform(plain_vocab, monkeypatch):
    """Reporting a GPU platform changes nothing in the traced program: the
    engine is not chosen from the backend."""
    import jax

    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    data = b"the quick brown fox jumps. " * 30
    want = _dispatch_primitives(DeviceTokenizer(plain_vocab, chunk=512),
                                data)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = _dispatch_primitives(DeviceTokenizer(plain_vocab, chunk=512),
                               data)
    assert got == want
    assert "pallas_call" not in got


def test_device_engine_small_lanes(plain_vocab):
    """A dispatch narrower than the full 512 lanes."""
    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    tk = DeviceTokenizer(plain_vocab, chunk=512)
    data = (b"the quick brown fox jumps over the lazy dog. " * 150)
    ids, miss = tk.tokenize(data)
    want, wmiss = host_tokenize(plain_vocab, data)
    np.testing.assert_array_equal(ids, np.asarray(want))
    assert miss == wmiss
    assert tk.last_mode == "fast"


def test_capcode_vocab_parity():
    """Delete-token vocabulary through the full device pipeline, byte-exact
    incl. delete-token emissions (go/tokenmonster.go:1088-1108)."""
    from tokenmonster_tpu.core.vocab import normalize_and_capcode
    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    from test_scan_parity import ENGLISH, capcode_vocab
    v = capcode_vocab.__wrapped__()
    data = normalize_and_capcode(ENGLISH * 2, 2, v.normalizer)
    want, wmiss = host_tokenize(v, data)
    # the case must actually exercise the forward-delete branch
    assert int((np.asarray(want) == v.delete_token).sum()) > 0
    tk = DeviceTokenizer(v, chunk=512)
    ids, miss = tk.tokenize(data)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want))
    assert miss == wmiss


def test_utf16_delete_vocab_parity():
    """UTF-16 charset (lilbufOffset=2, go/tokenmonster.go:1031-1036) with a
    delete token through the device engine, incl. delete emissions."""
    import random

    from tokenmonster_tpu.ops.scan import DeviceTokenizer

    def u16(s):
        return s.encode("utf-16-le")

    toks = [u16(t) for t in ["jump", " jump", "ser", " ser", "er", " er",
                             "s", "ing", " box", "boxing", " vow", " jumps",
                             " judge", "judgeing", " inger", " serve",
                             "rve", " in", "ge", " ge", "box", "vow",
                             " vowing"]]
    singles = [u16(c) for c in "abcdefghijklmnopqrstuvwxyz ."]
    v = Vocab()
    v._generate(tokens=toks + singles + [b"\x7f"], charset=2,
                normalize_string="none", using_capcode=1, level=5,
                reset_token_ids=True)
    assert v.delete_token != 0xFFFFFF
    rnd = random.Random(5)
    words = ["jump", "ser", "er", "s", "ing", "box", "vow", "judge", "ge",
             "in", "rve", "serve", "inger"]
    parts = []
    for _ in range(80):
        parts.append(rnd.choice(words))
        if rnd.random() < 0.5:
            parts.append(" ")
    data = u16("".join(parts)) * 6
    want, wmiss = host_tokenize(v, data)
    assert int((np.asarray(want) == v.delete_token).sum()) > 0
    tk = DeviceTokenizer(v, chunk=256)
    ids, miss = tk.tokenize(data)
    np.testing.assert_array_equal(np.asarray(ids), np.asarray(want))
    assert miss == wmiss


def test_record_window_overflow_falls_back(plain_vocab):
    """Streams denser than the fast record window (~1 byte/token) must
    fail sync_ok there and retry on the full window, still exact."""
    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    tk = DeviceTokenizer(plain_vocab, chunk=2048)
    # single letters separated by unmatched bytes -> ~1 record per 1-2 bytes
    data = (b"q\x01u\x02i\x03c\x04k\x05" * 800)[:3000]
    ids, miss = tk.tokenize(data)
    want, wmiss = host_tokenize(plain_vocab, data)
    np.testing.assert_array_equal(ids, np.asarray(want))
    assert miss == wmiss
    assert tk.last_mode in ("full", "hoststitch", "oracle")
