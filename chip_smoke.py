#!/usr/bin/env python
"""Smoke test of the tokenizer and the trainer on one NVIDIA GPU.

    python chip_smoke.py               # one GPU: tokenize + trainer phases
    python chip_smoke.py --four-cards  # only the trainer's scorer, 4 GPUs

Drives the main paths through the entry points a user calls, at the width
of the largest vocabulary the repository ships
(examples/realtext-32000-fast.vocab: capcode 2, delete token, 40,767
entries), and checks every result exactly against the native C++
tokenizer:

  1. device and card: a GPU is required (never falls back to the CPU);
  2. bulk tokenize, realtext-32000 (two forward-delete rows), at ~512 KiB
     (device tokenizer called directly), ~4 MiB (one chained dispatch) and
     >= 32 MiB (the per-dispatch loop), through ``tokenmonster_tpu.load``,
     plus a 16 KiB slice against the sequential host oracle;
  3. bulk tokenize, the same token set regenerated at capcode 0 (no delete
     token, single-row path), at ~4 MiB;
  4. trainer: getalltokens on a seeded corpus, then 3 rounds of
     ``train_vocab`` on the device backend and on the native backend, which
     must delete the same tokens every round;
  5. timing lines: device MB/s, set-up time, peak device memory.

Each phase prints one line; any failure exits non-zero.  The last line of
standard output is one JSON object naming the device.  Everything runs in
this one process, so one process holds the card.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
VOCAB_32K = os.path.join(HERE, "examples", "realtext-32000-fast.vocab")
MiB = 1 << 20


def require_gpu():
    """Phase 1: the first JAX device must be a GPU; returns jax."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU found (JAX platform "
                         f"{dev.platform!r}); refusing to run on the CPU")
    return jax


def card_line() -> str:
    """`nvidia-smi` name and power limit, read in a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def build_native():
    """Build (or find) the native C++ library from the committed source;
    a failed build stops the run with the compiler's message."""
    from tokenmonster_tpu import native
    try:
        native._build_lib()
    except (OSError, subprocess.CalledProcessError) as e:
        err = getattr(e, "stderr", b"") or b""
        raise SystemExit(f"chip_smoke: cannot build the native library: {e}"
                         f"\n{err.decode(errors='replace')[-2000:]}")
    if native.get_lib() is None:
        raise SystemExit("chip_smoke: native library built but not loadable")
    return native


def fnv1a64(ids) -> int:
    """FNV-1a over the little-endian u32 id stream."""
    h = 0xCBF29CE484222325
    for b in np.asarray(ids, np.uint32).astype("<u4").tobytes():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


# ---- seeded corpus -------------------------------------------------------

# multi-byte characters whose NFD bytes the realtext vocabulary covers, so
# that every byte is tokenized and decode must give back the text
_UTF8_WORDS = ["café", "naïve", "Zürich", "Köln", "à la carte", "crème",
               "résumé", "über", "—", " — ", "─────", "│", "═══", "╔═╕",
               "あいう", "、", "。", "〔〕"]
_PUNCT = ["...", "!!!", "???", "---", "***", "====", "  ", "    ", "\t",
          "\n\n", ";;", "::", "()", "[]", "{}", "<>", "//", "##", "!?",
          "\"'", "''", "..", ",", ".", "!", "?", "\n"]


def _code_lines(rng, words, n):
    idents = [w.strip().lower() or "x" for w in rng.choice(words, 2000)]
    idents = ["".join(c if c.isalnum() else "_" for c in w) for w in idents]
    out = []
    for _ in range(n):
        a, b, c = rng.choice(idents, 3)
        k = int(rng.integers(0, 100000))
        form = int(rng.integers(0, 6))
        if form == 0:
            out.append(f"def {a}({b}, {c}=None):\n")
        elif form == 1:
            out.append(f"    return {a}[{k}] + {b}.{c}({k % 97})\n")
        elif form == 2:
            out.append(f"for (int i = 0; i < {k}; ++i) {{ {a} += {b}[i]; }}\n")
        elif form == 3:
            out.append(f'{a} = {{"{b}": {k}, "{c}": [{k % 13}, {k % 7}]}}\n')
        elif form == 4:
            out.append(f"SELECT {a}, {b} FROM {c} WHERE id > {k};\n")
        else:
            out.append(f"    if {a} is not None and {b} != 0x{k:x}:\n")
    return out


def _numbers(rng, n):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 10 ** 7))
        form = int(rng.integers(0, 5))
        out.append([f" {k}", f" {k / 100:.2f}", f" {k % 28 + 1:02d}/"
                    f"{k % 12 + 1:02d}/{1900 + k % 130}", f" 0x{k:06X}",
                    f" {k:,}"][form])
    return out


def make_corpus(core, n_bytes: int, seed: int) -> bytes:
    """Seeded text of about ``n_bytes``: prose drawn with Zipf weights from
    the vocabulary's own decoded tokens in mixed case, code lines, numbers,
    punctuation runs and multi-byte UTF-8, drawn from large pools (no short
    seed is repeated)."""
    rng = np.random.default_rng(seed)
    words = []
    for t in core.tokens:
        if len(t) < 2:
            continue
        try:
            w = core.denormalize(bytes(t)).decode("utf-8")
        except UnicodeDecodeError:
            continue
        if w.strip():
            words.append(w)
    words = sorted(set(words))
    rng.shuffle(words)
    zipf = 1.0 / np.arange(1, len(words) + 1) ** 1.07
    zipf /= zipf.sum()
    cases = [(0.80, str), (0.15, str.capitalize), (0.05, str.upper)]
    pools, weights = [], []
    for share, f in cases:
        pools += [f(w) for w in words]
        weights.append(0.82 * share * zipf)
    extra = [(0.06, _code_lines(rng, words, 6000)),
             (0.05, _numbers(rng, 6000)),
             (0.04, _PUNCT),
             (0.03, _UTF8_WORDS)]
    for share, pool in extra:
        pools += pool
        weights.append(np.full(len(pool), share / len(pool)))
    p = np.concatenate(weights)
    p /= p.sum()
    enc = np.array([s.encode("utf-8") for s in pools], dtype=object)
    lens = np.array([len(b) for b in enc])
    draws = int(n_bytes / float((p * lens).sum()) * 1.05) + 16
    out = b"".join(enc[rng.choice(len(enc), size=draws, p=p)].tolist())
    cut = out.rfind(b" ", 0, n_bytes)
    return out[:cut if cut > 0 else n_bytes]


def regenerate_capcode0(core):
    """The same token set as a capcode-0 vocabulary (no delete token, one
    decision row), plus all 256 single bytes so that mixed-case text is
    covered without capcode markers."""
    from tokenmonster_tpu.core.vocab import Vocab
    v = Vocab()
    v._generate(tokens=list(core.tokens) + [bytes([i]) for i in range(256)],
                charset=1, normalize_string="none", using_capcode=0,
                level=5, reset_token_ids=True)
    return v


# ---- phases ---------------------------------------------------------------

def check_tokenize(api_vocab, text: bytes, nv, direct: bool):
    """Tokenize ``text`` through the API (or, below the API's device
    threshold, the device tokenizer directly) and compare with the native
    tokenizer exactly; decode must give back the normalized text.  Returns
    (n_tokens, fnv, seconds, device window mode)."""
    core = api_vocab.core
    normalized = core.normalize(text)
    tk = api_vocab._device_tokenizer()
    if tk is None:
        raise AssertionError("no device tokenizer was built")
    t0 = time.perf_counter()
    if direct:
        ids, missing = tk.tokenize(normalized)
    else:
        ids = api_vocab.tokenize(text)
        if api_vocab.last_route != "device":
            raise AssertionError(
                f"{len(text)} bytes were served by {api_vocab.last_route!r}, "
                f"not the device")
        missing = None
    dt = time.perf_counter() - t0
    if tk.last_mode not in ("fast", "full"):
        raise AssertionError(f"device stitch fell back ({tk.last_mode})")
    want, want_missing = nv.tokenize(normalized)
    ids = np.asarray(ids, np.uint32)
    want = np.asarray(want, np.uint32)
    if missing is not None and missing != want_missing:
        raise AssertionError(f"missing {missing} != native {want_missing}")
    if len(ids) != len(want) or not np.array_equal(ids, want):
        bad = int(np.argmax(ids[:len(want)] != want[:len(ids)])) \
            if min(len(ids), len(want)) else 0
        raise AssertionError(f"ids differ from native: {len(ids)} vs "
                             f"{len(want)} tokens, first mismatch at {bad}")
    fnv = fnv1a64(ids)
    if fnv != fnv1a64(want):
        raise AssertionError("FNV of the id streams differs")
    if want_missing:
        raise AssertionError(f"{want_missing} bytes have no token")
    if core.decode(ids) != core.denormalize(normalized):
        raise AssertionError("decode does not give back the normalized text")
    return len(ids), fnv, dt, tk.last_mode


def check_oracle_slice(api_vocab, text: bytes, n_bytes: int = 16384):
    """A short slice of the normalized text through the device tokenizer
    and the sequential host oracle (core/tokenizer.py): ids and missing
    count must agree exactly."""
    from tokenmonster_tpu.core.tokenizer import tokenize as host_tokenize
    sl = api_vocab.core.normalize(text)[:n_bytes]
    ids, missing = api_vocab._device_tokenizer().tokenize(sl)
    want, want_missing = host_tokenize(api_vocab.core, sl)
    if missing != want_missing or not np.array_equal(
            np.asarray(ids, np.uint32), np.asarray(want, np.uint32)):
        raise AssertionError("device ids differ from the host oracle")
    return len(sl), len(want)


def device_rate(tk, normalized: bytes, reps: int = 3) -> float:
    """Device-resident MB/s: staged input, dispatch chain, results left on
    the device, completion by block_until_ready (best of ``reps``)."""
    import jax
    staged = tk.stage(normalized)
    jax.block_until_ready(tk._run_staged(staged, tk.last_mode == "full"))
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(tk._run_staged(staged,
                                             tk.last_mode == "full"))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return len(normalized) / best / 1e6


def tokenize_phase(name, api_vocab, sizes, seed, nv, log=print):
    """Tokenize seeded corpora of ``sizes`` bytes (a size below the API's
    device threshold is sent to the device tokenizer directly) and check
    each against native.  Returns the timing facts for the summary."""
    core = api_vocab.core
    t0 = time.perf_counter()
    api_vocab._device_tokenizer()
    setup = time.perf_counter() - t0
    log(f"[{name}] device tables built in {setup:.2f} s "
        f"({len(core.tokens)} entries, capcode {core.using_capcode}, "
        f"delete token {'yes' if core.delete_token != 0xFFFFFF else 'no'})")
    facts = {"tables_s": setup, "calls": []}
    last = None
    for i, size in enumerate(sizes):
        text = make_corpus(core, size, seed + i)
        direct = len(core.normalize(text)) < api_vocab.DEVICE_THRESHOLD
        n_tok, fnv, dt, mode = check_tokenize(api_vocab, text, nv,
                                                       direct)
        tk = api_vocab._device_tokenizer()
        k = len(tk._plan(len(core.normalize(text)))[1])
        log(f"[{name}] {len(text)} bytes, {k} dispatch(es), "
            f"{'direct' if direct else 'api'}: {n_tok} ids == native "
            f"exactly (fnv {fnv:016x}, decode == text, window {mode}), "
            f"first call {dt:.2f} s, no host fallback")
        facts["calls"].append((len(text), k, dt))
        last = core.normalize(text)
        if i == 0:
            n_sl, n_ids = check_oracle_slice(api_vocab, text)
            log(f"[{name}] {n_sl}-byte slice: {n_ids} ids == host oracle "
                f"ids exactly")
    facts["device_MBps"] = device_rate(api_vocab._device_tokenizer(), last)
    log(f"[{name}] device-resident rate {facts['device_MBps']:.2f} MB/s "
        f"on {len(last)} bytes (block_until_ready, best of 3)")
    return facts


class _RoundLog(logging.Handler):
    """Collects the trainer's per-round deletion lines and the device
    scorer's running (groups on the device, groups on the fallback)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.rounds = []
        self.device = (0, 0)

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("round "):
            self.rounds.append((record.created, msg.split(";")[0]))
        elif msg.startswith("device scorer:"):
            self.device = tuple(record.args)


def trainer_phase(corpus_bytes: int, vocab_size: int, rounds: int, seed: int,
                  workdir: str, log=print):
    """getalltokens on a seeded corpus, then ``rounds`` rounds of training
    on the device and on the native backend; the deletions must agree
    round by round.  Returns {backend: seconds per round}."""
    from tokenmonster_tpu.core.vocab import Vocab
    from tokenmonster_tpu.train.getalltokens import (get_all_tokens,
                                                     save_tokens_file)
    from tokenmonster_tpu.train.trainvocab import TrainConfig, train_vocab
    core = Vocab.load(VOCAB_32K)
    corpus = make_corpus(core, corpus_bytes, seed)
    t0 = time.perf_counter()
    counter, char_table, header = get_all_tokens(
        corpus, "balanced", charset=1, normalization="nfd", using_capcode=2,
        add_extra_tokens=False)
    tok_path = os.path.join(workdir, "all.tok")
    save_tokens_file(tok_path, counter, char_table, header)
    log(f"[trainer] getalltokens: {len(corpus)} bytes -> {len(counter)} "
        f"candidate tokens in {time.perf_counter() - t0:.2f} s")
    tlog = logging.getLogger("tokenmonster_tpu.trainvocab")
    handler = _RoundLog()
    tlog.addHandler(handler)
    old_level = tlog.level
    tlog.setLevel(logging.INFO)
    per_round, lines = {}, {}
    try:
        for backend in ("device", "native"):
            handler.rounds = []
            cfg = TrainConfig(vocab_size=vocab_size, seed=seed,
                              max_rounds=rounds, backend=backend)
            t_start = time.time()
            train_vocab(corpus, tok_path,
                        os.path.join(workdir, f"results_{backend}"), cfg)
            stamps = [t_start] + [t for t, _m in handler.rounds]
            per_round[backend] = np.diff(stamps).tolist()
            lines[backend] = [m for _t, m in handler.rounds]
            log(f"[trainer] {backend}: {len(lines[backend])} rounds, "
                f"s/round " + ", ".join(f"{s:.2f}" for s in
                                        per_round[backend]))
    finally:
        tlog.removeHandler(handler)
        tlog.setLevel(old_level)
    groups, fell_back = handler.device
    if groups == 0 or fell_back:
        raise AssertionError(f"device backend scored {groups} strip groups "
                             f"on the device and {fell_back} on the native "
                             f"fallback")
    log(f"[trainer] device backend: {groups} strip groups scored on the "
        f"device, 0 on the native fallback")
    if len(lines["device"]) != rounds:
        raise AssertionError(f"device backend ran {len(lines['device'])} "
                             f"pruning rounds, not {rounds}")
    if lines["device"] != lines["native"]:
        raise AssertionError(f"deletions differ: device {lines['device']} "
                             f"vs native {lines['native']}")
    for m in lines["device"]:
        log(f"[trainer] {m}: identical on both backends")
    return per_round


def four_card_phase(devices, n_strips: int, strip_bytes: int, seed: int,
                    log=print):
    """The trainer's exact scorer over a 1-D mesh of ``devices`` (psum
    across them), compared exactly with the same strips scored on the first
    device alone and by the native scorer."""
    from tokenmonster_tpu.core.vocab import Vocab
    from tokenmonster_tpu.train.trainvocab import CandidateScorer
    core = Vocab.load(VOCAB_32K)
    text = core.normalize(make_corpus(core, n_strips * strip_bytes, seed))
    step = len(text) // n_strips
    strips = [text[i * step:(i + 1) * step + 17 * i]
              for i in range(n_strips)]
    results = {}
    for name, backend, devs in (("mesh", "device", list(devices)),
                                ("one card", "device", list(devices[:1])),
                                ("native", "native", None)):
        sc = CandidateScorer(core.charset, core.using_capcode,
                             core.normalizer.flag, backend=backend,
                             devices=devs)
        t0 = time.perf_counter()
        scores, n_tok, missing = sc.score(core, strips)
        results[name] = (np.asarray(scores, np.int64), n_tok, missing)
        where = ""
        if backend == "device":
            if sc.device_groups == 0 or sc.device_fallbacks:
                raise AssertionError(
                    f"{name}: {sc.device_groups} strip groups on the device, "
                    f"{sc.device_fallbacks} on the native fallback")
            where = (f", {sc.device_groups} strip groups on the device, "
                     f"0 on the native fallback")
        log(f"[four-cards] {name}: {n_tok} tokens, {len(missing)} missing "
            f"byte values, {time.perf_counter() - t0:.2f} s{where}")
    ref = results["native"]
    for name in ("mesh", "one card"):
        s, n_tok, missing = results[name]
        if not (np.array_equal(s, ref[0]) and n_tok == ref[1]
                and missing == ref[2]):
            raise AssertionError(f"{name} scores differ from native")
    log(f"[four-cards] {len(devices)}-device psum scores == one-card scores "
        f"== native scores, exactly ({len(strips)} strips, "
        f"{sum(map(len, strips))} bytes)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the trainer scorer across 4 GPUs")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)

    jax = require_gpu()
    sys.path.insert(0, HERE)
    from tokenmonster_tpu.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    devs = jax.devices()
    card = card_line()
    print(f"[device] platform gpu, kind {devs[0].device_kind}, "
          f"{len(devs)} device(s); card: {card}; compile cache {cache_dir}",
          flush=True)
    native = build_native()

    if args.four_cards:
        if len(devs) < 4:
            raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, "
                             f"found {len(devs)}")
        four_card_phase(devs[:4], n_strips=16, strip_bytes=256 * 1024,
                        seed=args.seed)
        count = 4
    else:
        import tokenmonster_tpu
        from tokenmonster_tpu.api import Vocab as ApiVocab
        t0 = time.perf_counter()
        v32 = tokenmonster_tpu.load(VOCAB_32K)
        nv32 = native.NativeVocab(v32.core)
        f32 = tokenize_phase("realtext-32000", v32,
                             [512 * 1024, 4 * MiB, 32 * MiB], args.seed,
                             nv32)
        v0 = ApiVocab.__new__(ApiVocab)
        v0._init_core(regenerate_capcode0(v32.core))
        f0 = tokenize_phase("realtext-32000 capcode-0", v0, [4 * MiB],
                            args.seed + 10, native.NativeVocab(v0.core))
        with tempfile.TemporaryDirectory() as work:
            rounds = trainer_phase(4 * MiB, 32000, 3, args.seed, work)
        peak = devs[0].memory_stats().get("peak_bytes_in_use", 0)
        print(f"[timing] card {card}; realtext-32000 device "
              f"{f32['device_MBps']:.2f} MB/s, capcode-0 device "
              f"{f0['device_MBps']:.2f} MB/s", flush=True)
        print(f"[timing] card {card}; set-up: tables "
              f"{f32['tables_s']:.2f} s / {f0['tables_s']:.2f} s, first "
              f"calls (bytes, dispatches, s) {f32['calls']} / "
              f"{f0['calls']}; trainer s/round {rounds}; whole run "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        print(f"[timing] card {card}; peak_bytes_in_use {peak}", flush=True)
        count = len(devs)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
