#!/usr/bin/env python
"""Benchmark: tokenize bytes/sec/chip vs the reference headline number.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "bytes/sec", "vs_baseline": N, ...}

Baseline: the reference C++ runtime's encode+tokenize headline, 33.1 MB/s
single-core with a 32000-token vocabulary (tokenmonster-cpp/README.md:70;
BASELINE.md).  We measure on a 50k GPT-2-imported vocabulary over a
deterministic synthetic English/code corpus, reporting the best end-to-end
tokenize path:
  - device: fused match + decision + follow + stitch dispatches (exact ids)
  - native: C++ host tokenizer (single core, exact ids)

One process; the device measurement needs a GPU and stops without one.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

SEED_TEXT = (
    b"The quick brown fox jumps over the lazy dog. Pack my box with five "
    b"dozen liquor jugs; amazingly few discotheques provide jukeboxes! "
    b"In 2024, researchers trained a 7B-parameter language model on 2.4T "
    b"tokens of web text, costing $1.2M in compute. "
    b"def tokenize(text):\n    return [vocab[t] for t in split(text)]\n"
    b"for (int i = 0; i < n; ++i) { sum += scores[ids[i]]; }\n"
    b"SELECT id, score FROM tokens WHERE length > 4 ORDER BY score DESC;\n"
    b"Die Wuerde des Menschen ist unantastbar. Liberte, egalite, "
    b"fraternite. La vida es sueno, y los suenos, suenos son.\n")

MB = 1024 * 1024
CORPUS_MB = 4
BASELINE_BPS = 33.1e6  # tokenmonster-cpp/README.md:70 (encode+tokenize)
TARGET_BPS = 1e9       # BASELINE.md framework target: 1 GB/s per device


def build_vocab():
    from tokenmonster_tpu.train.imports import import_gpt2_json
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".tmp", "gpt2_bench.vocab")
    from tokenmonster_tpu.core.vocab import Vocab
    if os.path.exists(cache):
        return Vocab.load(cache)
    v = import_gpt2_json("/root/reference/yaml_guide/gpt2.json")
    try:
        os.makedirs(os.path.dirname(cache), exist_ok=True)
        v.save(cache)
    except OSError:
        pass
    return v


def build_capcode_vocab():
    """Production-shape capcode-2 vocabulary: the gpt2 token set re-generated
    at capcode level 2, which defines a delete token (the "D" marker single-
    byte token, go/tokenmonster.go:3475-3478) and ~20k space-prefixed
    entries — the vocabulary class every TokenMonster-trained vocab belongs
    to, exercising the forward-delete device path."""
    cache = os.path.join(_HERE, ".tmp", "gpt2_cc2_bench.vocab")
    from tokenmonster_tpu.core.vocab import Vocab
    if os.path.exists(cache):
        return Vocab.load(cache)
    v0 = build_vocab()
    v = Vocab()
    v._generate(tokens=list(v0.tokens), charset=1, normalize_string="none",
                using_capcode=2, level=5, reset_token_ids=True)
    try:
        v.save(cache)
    except OSError:
        pass
    return v


def fnv1a64(ids) -> int:
    """FNV-1a over the little-endian u32 id stream (pure-Python
    byte loop: ~0.7 s/M ids — acceptable at bench sizes)."""
    h = 0xCBF29CE484222325
    for b in np.asarray(ids, np.uint32).astype("<u4").tobytes():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _device_measure(vocab, corpus):
    """Measure the device path in this process; returns a dict.

      device_bps — device-resident sustained throughput: input staged on
        the device, chained dispatches, dense ids left on device, completion
        by block_until_ready.
      device_e2e_bps — full tokenize() including transfers.
    Per-phase wall-clock marks are reported in the details.
    """
    import jax

    from tokenmonster_tpu.core.vocab import normalize_and_capcode
    from tokenmonster_tpu.ops.scan import DeviceTokenizer
    t_start = time.time()
    out = {}

    def mark(key):
        out[key] = round((time.time() - t_start) * 1000)

    def sustained(tk, staged, full, reps):
        jax.block_until_ready(tk._run_staged(staged, full))
        best = None
        for _loop in range(2):
            t0 = time.time()
            for _ in range(reps):
                outs = tk._run_staged(staged, full)
            jax.block_until_ready(outs)
            d = (time.time() - t0) / reps
            best = d if best is None else min(best, d)
        return best

    tk = DeviceTokenizer(vocab, chunk=2048)
    mark("t_tables_ms")  # automaton table build + device upload
    staged = tk.stage(corpus)
    res = tk.tokenize_staged(staged)  # warm: exactness certificate run
    mark("t_warm_ms")
    assert res is not None, "device stitch failed to sync"
    ids_t, _missing = res
    out["device_n_tokens"] = int(len(ids_t))
    out["device_ids_fnv"] = str(fnv1a64(ids_t))
    mark("t_fnv_ms")

    # capcode-2 (forward-delete) vocabulary: the vocabulary class every
    # TokenMonster-trained vocab belongs to; certified before throughput
    vc = build_capcode_vocab()
    data_cc = normalize_and_capcode(corpus, 2, vc.normalizer)
    tkc = DeviceTokenizer(vc, chunk=2048)
    mark("t_cc_tables_ms")
    staged_c = tkc.stage(data_cc)
    res_c = tkc.tokenize_staged(staged_c)   # warm + exactness
    mark("t_cc_warm_ms")
    assert res_c is not None, "capcode device stitch failed to sync"
    out["capcode_n_tokens"] = int(len(res_c[0]))
    out["device_capcode_ids_fnv"] = str(fnv1a64(res_c[0]))
    out["capcode_corpus_bytes"] = len(data_cc)

    dt = sustained(tk, staged, tk.last_mode == "full", 10)
    out["device_bps"] = round(len(corpus) / dt)
    mark("t_device_bench_ms")

    best_dt = None
    for _ in range(2):
        t0 = time.time()
        res = tk.tokenize_staged(tk.stage(corpus))
        dt = time.time() - t0
        if res is not None and (best_dt is None or dt < best_dt):
            best_dt = dt
    out["device_e2e_bps"] = round(len(corpus) / best_dt)
    out["device"] = str(jax.devices()[0])

    dt = sustained(tkc, staged_c, tkc.last_mode == "full", 6)
    out["device_bps_capcode"] = round(len(data_cc) / dt)
    mark("t_cc_bench_ms")

    # real-text row: exactness over real corpus bytes when available
    rt_path = os.path.join(_HERE, ".tmp", "real_corpus.bin")
    if not os.path.exists(rt_path):
        subprocess.run(
            [sys.executable,
             os.path.join(_HERE, "tools", "measure", "build_real_corpus.py")],
            check=True, timeout=120, stdout=subprocess.DEVNULL)
    with open(rt_path, "rb") as f:
        real = f.read(CORPUS_MB * MB)
    real = vocab.normalizer.normalize(real)
    staged_r = tk.stage(real)
    res_r = tk.tokenize_staged(staged_r)
    assert res_r is not None, "real-text device stitch failed to sync"
    out["device_realtext_ids_fnv"] = str(fnv1a64(res_r[0]))
    out["realtext_n_tokens"] = int(len(res_r[0]))
    out["realtext_bytes"] = len(real)
    out["realtext_window"] = tk.last_mode
    dt = sustained(tk, staged_r, tk.last_mode == "full", 6)
    out["device_bps_realtext"] = round(len(real) / dt)
    mark("t_rt_bench_ms")
    return out


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU found (JAX platform "
                         f"{dev.platform!r})")
    from tokenmonster_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()

    corpus = (SEED_TEXT * (CORPUS_MB * MB // len(SEED_TEXT) + 1))[:CORPUS_MB * MB]
    vocab = build_vocab()

    details = {"card": card, "device_kind": dev.device_kind,
               "device_count": len(jax.devices())}
    n_tokens = None

    # --- native C++ path (best-of-N to damp noisy-neighbour variance) ---
    native_bps = 0.0
    ids = None
    try:
        from tokenmonster_tpu import native
        nv = native.NativeVocab(vocab)
        ids, missing = nv.tokenize(corpus)  # warm
        best_dt = None
        for threads in (1, 2):
            for _ in range(4):
                t0 = time.time()
                ids, missing = nv.tokenize(corpus, threads=threads)
                dt = time.time() - t0
                if best_dt is None or dt < best_dt:
                    best_dt = dt
                    details["native_threads"] = threads
        native_bps = len(corpus) / best_dt
        n_tokens = int(len(ids))
        details["native_cxx_bps"] = round(native_bps)
    except Exception as e:  # pragma: no cover
        details["native_error"] = str(e)[:120]

    # --- device path (fused dispatches + device stitch, exact ids) ---
    dev_out = _device_measure(vocab, corpus)
    device_bps = max(float(dev_out["device_bps"]),
                     float(dev_out["device_e2e_bps"]))
    if n_tokens is not None:
        assert dev_out["device_n_tokens"] == n_tokens, \
            "device/native token mismatch"
    if ids is not None:
        # exactness certificate: the device id stream must checksum-match
        # the native tokenizer's
        match = dev_out["device_ids_fnv"] == str(fnv1a64(ids))
        details["ids_fnv_match"] = match
        assert match, "device/native id stream checksum mismatch"
    details.update(dev_out)

    # --- real-text row: native side + FNV certificate ---
    if details.get("device_realtext_ids_fnv"):
        try:
            from tokenmonster_tpu import native
            rt_path = os.path.join(_HERE, ".tmp", "real_corpus.bin")
            with open(rt_path, "rb") as f:
                real = f.read(CORPUS_MB * MB)   # same prefix as above
            real = vocab.normalizer.normalize(real)
            assert len(real) == details["realtext_bytes"]
            nv = native.NativeVocab(vocab)
            ids_r, _m = nv.tokenize(real)
            best_dt = None
            for _ in range(3):
                t0 = time.time()
                ids_r, _m = nv.tokenize(real, threads=1)
                dt = time.time() - t0
                best_dt = dt if best_dt is None else min(best_dt, dt)
            details["native_cxx_realtext_bps"] = round(len(real) / best_dt)
            match = (details["device_realtext_ids_fnv"]
                     == str(fnv1a64(ids_r)))
            details["ids_fnv_match_realtext"] = match
            assert match, "realtext device/native id stream checksum mismatch"
        except Exception as e:  # pragma: no cover
            details["realtext_native_error"] = str(e)[:120]

    # --- capcode-2 vocabulary: native side of the comparison ---
    if details.get("device_capcode_ids_fnv"):
        try:
            from tokenmonster_tpu import native
            from tokenmonster_tpu.core.vocab import normalize_and_capcode
            vc = build_capcode_vocab()
            data_cc = normalize_and_capcode(corpus, 2, vc.normalizer)
            nvc = native.NativeVocab(vc)
            ids_c, _m = nvc.tokenize(data_cc)   # warm
            best_dt = None
            for _ in range(4):
                t0 = time.time()
                ids_c, _m = nvc.tokenize(data_cc, threads=1)
                dt = time.time() - t0
                best_dt = dt if best_dt is None else min(best_dt, dt)
            details["native_cxx_capcode_bps"] = round(len(data_cc) / best_dt)
            match = (details.get("device_capcode_ids_fnv")
                     == str(fnv1a64(ids_c)))
            details["ids_fnv_match_capcode"] = match
            assert details.get("capcode_n_tokens") in (None, len(ids_c))
            assert match, "capcode device/native id stream checksum mismatch"
        except Exception as e:  # pragma: no cover
            details["capcode_native_error"] = str(e)[:120]

    # --- auxiliary reference-table metrics (tokenmonster-cpp/README.md:62-71:
    # the reference benches tokenize / decode / round-trip separately) ---
    try:
        t0 = time.time()
        norm = vocab.normalizer.normalize(corpus)
        details["normalize_bps"] = round(len(corpus) / (time.time() - t0))
        if native_bps == 0.0:
            # native path failed: obtain ids from the host oracle so the
            # decode/serialize metrics still report
            ids, _m = vocab.tokenize(corpus)
        ids_a = np.asarray(ids)
        decoded = vocab.decode(ids_a)  # warm the blob cache
        best_dt = None
        for _ in range(3):
            t0 = time.time()
            decoded = vocab.decode(ids_a)
            dt = time.time() - t0
            if best_dt is None or dt < best_dt:
                best_dt = dt
        details["decode_bps"] = round(len(decoded) / best_dt)
        assert decoded == norm[:len(decoded)] or decoded == norm, \
            "decode round-trip mismatch"
        # serialized round-trip (16/24/32-bit auto width)
        t0 = time.time()
        ser, enc_len, _m = vocab.tokenize_to_serialized(corpus)
        deser = vocab.deserialize(ser, enc_len)
        details["serialize_roundtrip_bps"] = round(
            len(corpus) / (time.time() - t0))
        assert np.array_equal(np.asarray(deser), ids_a)
    except Exception as e:  # pragma: no cover
        details["aux_error"] = str(e)[:120]

    # Headline = the best path, but labeled by what was actually measured:
    # the device path only claims "per device" once it beats the host C++
    # tokenizer (never report a CPU number as a device number).
    device = float(details.get("device_bps", 0))
    if device >= native_bps:
        value = device
        metric = ("tokenize bytes/sec per device (device path, gpt2-50k, "
                  "exact ids)")
    else:
        value = max(device_bps, native_bps)
        metric = ("tokenize bytes/sec (best path = host C++ single-core, "
                  "gpt2-50k, exact ids)")
    details["corpus_bytes"] = len(corpus)
    details["vs_target_1gbps"] = round(device / TARGET_BPS, 4)
    if n_tokens:
        details["chars_per_token"] = round(len(corpus) / n_tokens, 3)
    result = {
        "metric": metric,
        "value": round(value),
        "unit": "bytes/sec",
        "vs_baseline": round(value / BASELINE_BPS, 3),
        "details": details,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
