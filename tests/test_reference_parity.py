"""External conformance anchors: golden ids produced by the UNMODIFIED
reference C++ runtime (tokenmonster-cpp/src/tokenmonster.cpp), generated by
tools/refgen and committed in tests/fixtures/reference_ids.json.

These are the only expected values in the tree that did NOT originate from
this repo's own code — a correlated oracle+kernel bug cannot pass them.
Covers the gpt2-50k import (capcode 0) and a capcode-2 vocabulary with
forward-delete branches (reference loop driven on pre-capcoded bytes; see
the fixture provenance note).
"""

import json
import os

import numpy as np
import pytest

from tokenmonster_tpu.core.vocab import Vocab

from test_scan_parity import capcode_vocab  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures",
                        "reference_ids.json")
GPT2_JSON = "/root/reference/yaml_guide/gpt2.json"


def _load():
    with open(FIXTURES) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def gpt2_vocab():
    if not os.path.exists(GPT2_JSON):
        pytest.skip("reference gpt2.json unavailable")
    from tokenmonster_tpu.train.imports import import_gpt2_json
    return import_gpt2_json(GPT2_JSON)


@pytest.fixture(params=["gpt2", "capcode2_synth"])
def fixture_vocab(request, capcode_vocab):  # noqa: F811
    """(fixture vocabulary name, Vocab): the gpt2 cases need the reference
    checkout's gpt2.json and skip without it."""
    if request.param == "gpt2":
        return "gpt2", request.getfixturevalue("gpt2_vocab")
    return "capcode2_synth", capcode_vocab


def _cases(name):
    cases = [c for c in _load()["fixtures"] if c["vocab"] == name]
    assert cases, name
    return cases


def test_reference_ids_exist():
    meta = _load()
    assert len(meta["fixtures"]) >= 7
    # the capcode-2 cases must exercise the forward-delete branch
    cc2 = [c for c in meta["fixtures"] if c["vocab"] == "capcode2_synth"]
    assert cc2, "capcode-2 anchor cases missing"


def test_host_oracle_matches_reference(fixture_vocab):
    from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
    name, v = fixture_vocab
    for case in _cases(name):
        data = bytes.fromhex(case["input_hex"])
        # fixtures carry pre-normalized+capcoded bytes: drive the loop direct
        ids, missing = host_tokenize(v, data)
        assert missing == case["missing"], case["name"]
        np.testing.assert_array_equal(
            np.asarray(ids), np.asarray(case["ids"], np.uint32),
            err_msg=f"{case['vocab']}/{case['name']}")


def test_native_matches_reference(fixture_vocab):
    from tokenmonster_tpu import native
    if native.get_lib() is None:
        pytest.skip("native lib unavailable")
    name, v = fixture_vocab
    nv = native.NativeVocab(v)
    for case in _cases(name):
        data = bytes.fromhex(case["input_hex"])
        # NativeVocab.tokenize expects pre-normalized+capcoded bytes, which
        # is exactly what the fixtures carry
        ids, missing = nv.tokenize(data)
        assert missing == case["missing"], case["name"]
        np.testing.assert_array_equal(
            np.asarray(ids), np.asarray(case["ids"], np.uint32),
            err_msg=f"{case['vocab']}/{case['name']}")


def test_pallas_engine_matches_reference(capcode_vocab):  # noqa: F811
    """The full device engine (automaton match + both fd decision rows +
    follow + device stitch) reproduces the reference ids for the capcode-2
    forward-delete fixtures — the vocab class every TokenMonster-trained
    vocabulary belongs to."""
    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    tk = DeviceTokenizer(capcode_vocab, chunk=512)
    for case in _load()["fixtures"]:
        if case["vocab"] != "capcode2_synth":
            continue
        data = bytes.fromhex(case["input_hex"])
        ids, missing = tk.tokenize(data)
        assert missing == case["missing"], case["name"]
        np.testing.assert_array_equal(
            np.asarray(ids), np.asarray(case["ids"], np.uint32),
            err_msg=f"{case['vocab']}/{case['name']}")


def test_decision_engine_matches_reference(fixture_vocab):
    """The decision-table engine (chain-followed on host, no stitcher)
    reproduces the reference ids for every fixture."""
    from tokenmonster_tpu.ops.decision import chain_follow_host
    from test_decision import _tables
    name, v = fixture_vocab
    for case in _cases(name):
        if case["vocab"] == "gpt2" and case["name"] != "seed_text":
            continue  # one gpt2 case suffices: table build is ~1 min on CPU
        data = bytes.fromhex(case["input_hex"])
        ctl, tok, dv = _tables(v, data)
        ids, missing = chain_follow_host(ctl, tok, len(data),
                                         dv.delete_token & 0xFFFFFF)
        assert missing == case["missing"], case["name"]
        np.testing.assert_array_equal(
            ids, np.asarray(case["ids"], np.uint32),
            err_msg=f"{case['vocab']}/{case['name']}")
