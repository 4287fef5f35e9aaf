"""chip_smoke.py's phases, run through their functions on the CPU at tiny
sizes against the native tokenizer, plus its refusal to run without a GPU.
The `gpu`-marked test runs the whole script on a card and skips here."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from tokenmonster_tpu import api, native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def device_api(monkeypatch):
    """The API forced onto the device tokenizer (the CPU backend here) with
    a threshold small enough for tiny inputs."""
    monkeypatch.setenv("TM_API_BACKEND", "device")
    monkeypatch.setattr(api.Vocab, "DEVICE_THRESHOLD", 40_000)
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")


def test_corpus_is_seeded_and_mixed(realtext_vocab):
    a = chip_smoke.make_corpus(realtext_vocab, 60_000, seed=3)
    b = chip_smoke.make_corpus(realtext_vocab, 60_000, seed=3)
    c = chip_smoke.make_corpus(realtext_vocab, 60_000, seed=4)
    assert a == b and a != c
    assert 55_000 <= len(a) <= 60_000
    text = a.decode("utf-8")
    assert any(ch.isupper() for ch in text)
    assert any(ord(ch) > 127 for ch in text)
    assert any(ch.isdigit() for ch in text)
    # no short seed repeated: the first 2 KiB does not recur
    assert a.count(a[:2048]) == 1


def test_tokenize_phase_realtext(device_api, realtext_vocab):
    v = api.Vocab.__new__(api.Vocab)
    v._init_core(realtext_vocab)
    lines = []
    facts = chip_smoke.tokenize_phase(
        "rt", v, [20_000, 90_000], seed=5,
        nv=native.NativeVocab(realtext_vocab), log=lines.append)
    assert [c[1] for c in facts["calls"]] == [1, 1]
    assert any("direct" in ln for ln in lines)
    assert any("host oracle ids exactly" in ln for ln in lines)
    assert any(" api: " in ln for ln in lines)
    assert v.last_route == "device"
    assert facts["device_MBps"] > 0


def test_tokenize_phase_capcode0(device_api, realtext_cc0_vocab):
    assert realtext_cc0_vocab.delete_token == 0xFFFFFF
    v = api.Vocab.__new__(api.Vocab)
    v._init_core(realtext_cc0_vocab)
    facts = chip_smoke.tokenize_phase(
        "cc0", v, [50_000], seed=6,
        nv=native.NativeVocab(realtext_cc0_vocab), log=lambda s: None)
    assert v.last_route == "device" and len(facts["calls"]) == 1


def test_check_tokenize_catches_a_wrong_id(device_api, realtext_vocab):
    """The comparison is exact: one changed id fails the phase."""
    class OffByOne:
        def __init__(self, nv):
            self.nv = nv

        def tokenize(self, data):
            ids, missing = self.nv.tokenize(data)
            ids = np.array(ids, copy=True)
            ids[len(ids) // 2] ^= 1
            return ids, missing

    v = api.Vocab.__new__(api.Vocab)
    v._init_core(realtext_vocab)
    text = chip_smoke.make_corpus(realtext_vocab, 50_000, seed=8)
    with pytest.raises(AssertionError, match="ids differ"):
        chip_smoke.check_tokenize(
            v, text, OffByOne(native.NativeVocab(realtext_vocab)), False)


def test_trainer_phase_backends_agree(tmp_path):
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    lines = []
    rounds = chip_smoke.trainer_phase(150_000, 3000, 2, seed=7,
                                      workdir=str(tmp_path),
                                      log=lines.append)
    assert set(rounds) == {"device", "native"}
    assert len(rounds["device"]) == 2 and len(rounds["native"]) == 2
    assert sum("identical on both backends" in ln for ln in lines) == 2
    assert any(ln.startswith("[trainer] device backend:")
               and ln.endswith(", 0 on the native fallback") for ln in lines)
    assert logging.getLogger("tokenmonster_tpu.trainvocab").handlers == []


def test_four_card_phase_on_virtual_devices():
    import jax
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    devs = jax.devices()
    assert len(devs) >= 4, "conftest provides 8 virtual CPU devices"
    lines = []
    chip_smoke.four_card_phase(devs[:4], n_strips=8, strip_bytes=6_000,
                               seed=9, log=lines.append)
    assert "exactly" in lines[-1]
    assert all("0 on the native fallback" in ln for ln in lines[:2])


def test_four_card_phase_fails_on_scorer_fallback(monkeypatch):
    """A strip group that the device could not stitch is scored natively
    (still exact); the scorer counts it and the phase refuses to pass."""
    import jax
    from tokenmonster_tpu.parallel import score
    if native.get_lib() is None:
        pytest.skip("no C++ toolchain")
    real = score.make_exact_score_step

    def no_sync(*a, **k):
        step = real(*a, **k)
        return lambda *args: (*step(*args)[:3], False)

    monkeypatch.setattr(score, "make_exact_score_step", no_sync)
    with pytest.raises(AssertionError, match="on the native fallback"):
        chip_smoke.four_card_phase(jax.devices()[:2], n_strips=4,
                                   strip_bytes=3_000, seed=9,
                                   log=lambda s: None)


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_card):
    """The whole script on the card, in a child process that owns it."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_PLATFORM_NAME", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().splitlines()[-1].startswith('{"ok": true')
