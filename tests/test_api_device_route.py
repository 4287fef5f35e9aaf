"""api.Vocab routes large inputs through the device tokenizer: forced
device-backend tokenize must equal the native/host path exactly, the route
of each call is recorded, and an accelerator that fails to build the device
tokenizer raises instead of dropping silently to the host."""

import os

import numpy as np
import pytest

from tokenmonster_tpu import api
from tokenmonster_tpu.core.vocab import Vocab as _CoreVocab


@pytest.fixture()
def vocab(tmp_path):
    v = _CoreVocab()
    v._generate(tokens=[b" the", b"the", b" quick", b" brown", b" fox",
                        b" jump", b"jumps", b" over", b" lazy", b" dog",
                        b"ing", b"er", b" hello", b"hello", b" world",
                        b"s ", b"e ", b"  ", b"\n", b"a", b"o", b"t", b" "],
                charset=1, normalize_string="none", using_capcode=2,
                level=5, reserve=8, reset_token_ids=True)
    p = tmp_path / "t.vocab"
    v.save(p)
    return api.Vocab(str(p))


def test_device_route_parity(vocab, monkeypatch):
    text = ("The quick brown fox jumps over the lazy dog. Hello world! "
            * 40)
    monkeypatch.setenv("TM_API_BACKEND", "device")
    monkeypatch.setattr(api.Vocab, "DEVICE_THRESHOLD", 256)
    want = vocab._tokenize_one(text[:64])  # native path (below threshold)
    assert vocab.last_route in ("native", "host")
    got_full = vocab.tokenize(text)
    assert vocab._device, "device tokenizer should have been built (forced)"
    assert vocab.last_route == "device"
    # host/native reference on the full text with threshold disabled
    monkeypatch.setattr(api.Vocab, "DEVICE_THRESHOLD", 1 << 40)
    ref_full = vocab.tokenize(text)
    assert vocab.last_route in ("native", "host")
    np.testing.assert_array_equal(np.asarray(got_full),
                                  np.asarray(ref_full))
    assert want.dtype == got_full.dtype


def test_measured_rate_routing_excludes_compile_and_reprobes():
    """The route probe must not count one-time compilation (it would lock
    the device path out), and the losing path must be re-probed
    periodically."""
    import tokenmonster_tpu as tm

    v = tm.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "realtext-1024-fast.vocab"))
    # drive _pick_route directly with synthetic rates
    v._route_rates = {"native": None, "device": None}
    v._route_calls = 0
    assert v._pick_route() == "device"       # unprobed -> probe device first
    v._route_rates["device"] = 5e6
    assert v._pick_route() == "native"       # then probe native
    v._route_rates["native"] = 40e6
    for _ in range(v._REPROBE_EVERY - 3):
        assert v._pick_route() == "native"   # native wins steady-state
    # the reprobe tick clears the loser and routes it once
    routes = [v._pick_route() for _ in range(4)]
    assert "device" in routes, routes
    # warm tracking: no chain geometry is warm yet, so the first device
    # call for any input size is never timed
    assert v._device_warm_geoms == set()


def test_device_build_failure_raises_on_accelerator(vocab, monkeypatch):
    """On a non-CPU platform a failed device build propagates: no silent
    fallback to the host paths."""
    from tokenmonster_tpu.ops import scan

    def broken(self, *a, **k):
        raise RuntimeError("device build failed")

    monkeypatch.setattr(scan.DeviceTokenizer, "__init__", broken)
    monkeypatch.setattr(api.Vocab, "_platform", staticmethod(lambda: "gpu"))
    monkeypatch.setattr(api.Vocab, "DEVICE_THRESHOLD", 256)
    with pytest.raises(RuntimeError, match="device build failed"):
        vocab.tokenize("The quick brown fox jumps over the lazy dog. " * 20)


def test_cpu_platform_stays_on_host(vocab, monkeypatch):
    """On the CPU platform (and no TM_API_BACKEND=device) large inputs are
    served by the native tokenizer; no device tokenizer is built."""
    from tokenmonster_tpu.ops import scan

    def unexpected(self, *a, **k):
        raise AssertionError("device tokenizer built on the CPU platform")

    monkeypatch.delenv("TM_API_BACKEND", raising=False)
    monkeypatch.setattr(scan.DeviceTokenizer, "__init__", unexpected)
    monkeypatch.setattr(api.Vocab, "_platform", staticmethod(lambda: "cpu"))
    monkeypatch.setattr(api.Vocab, "DEVICE_THRESHOLD", 256)
    ids = vocab.tokenize("The quick brown fox jumps over the lazy dog. " * 20)
    assert len(ids) > 0 and vocab.last_route in ("native", "host")


def test_no_jax_install_stays_on_host(vocab, monkeypatch):
    """Without JAX there is no accelerator: a large input is served on the
    host, not by an ImportError."""
    import sys

    monkeypatch.delenv("TM_API_BACKEND", raising=False)
    monkeypatch.setitem(sys.modules, "jax", None)   # import jax -> ImportError
    monkeypatch.setattr(api.Vocab, "DEVICE_THRESHOLD", 256)
    assert api.Vocab._platform() == "cpu"
    ids = vocab.tokenize("The quick brown fox jumps over the lazy dog. " * 20)
    assert len(ids) > 0 and vocab.last_route in ("native", "host")
