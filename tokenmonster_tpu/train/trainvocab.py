"""Vocabulary distillation trainer: the trainvocab pipeline.

Faithful port of training/trainvocab.go (master loop :1831-2293, worker
:505-1345): repeatedly tokenize the corpus with random candidate
vocabularies, vote the worst-scoring tokens for deletion with the reference
prune schedule, track phases (midway / 2x-vocab / final), save best-1%
checkpoint files, resurrect tokens from the 2x snapshot, and stop after
``keep_trying`` rounds with no new best.

Scoring backends:
  - "native": C++ host tokenizer scoring pass (tm_tokenize_score), threads.
  - "device": the exact strip scorer, data-parallel over every device
              with psum'd score vectors (parallel/score.py).

The asynchronous Go worker pool is realised as streamed rounds over a
ThreadPoolExecutor: worker threads keep scoring later candidates while the
master consumes earlier results in submission order, so pruning overlaps
candidate scoring; the algorithm's decisions are sequenced identically to
the reference's select loop.
"""

from __future__ import annotations

import json
import logging
import os
import random
from dataclasses import dataclass, field

import numpy as np

from ..core import capcode as cc
from ..core.normalize import Normalizer
from ..core.vocab import Vocab, normalize_and_capcode
from ..utils.runes import decode_utf8
from .getalltokens import load_tokens_file, save_tokens_with_scores

log = logging.getLogger("tokenmonster_tpu.trainvocab")

MAXINT = 1 << 62


@dataclass
class TrainConfig:
    vocab_size: int = 0
    workers: int = 2
    percentage: int = 15
    midway_target: int = 0
    keep_trying: int = 1000
    strips: int = 100
    fast: bool = False
    include_256_bytes: bool = False
    include_128_bytes: bool = False
    include_utf8_bytes: bool = False
    include_ascii_bytes: bool = False
    include_extended_bytes: bool = False
    include_missing_bytes: bool = False
    exclude_other_bytes: bool = False
    special_tokens: list = field(default_factory=list)
    backend: str = "native"
    seed: int | None = None
    max_rounds: int | None = None   # extension: bound total rounds (tests)


class CandidateScorer:
    """Builds a per-candidate index and scores the corpus with it."""

    def __init__(self, charset, using_capcode, norm_flag, backend="native",
                 devices=None):
        """``devices``: the devices the "device" backend scores across
        (default: all of them; a subset is a test seam for comparing mesh
        sizes)."""
        self.charset = charset
        self.using_capcode = using_capcode
        self.norm_flag = norm_flag
        self.backend = backend
        self.devices = devices
        # strip groups the device scored, and groups that found no junction
        # sync and were scored by the native fallback instead
        self.device_groups = 0
        self.device_fallbacks = 0
        # jitted exact-score steps cached per geometry: candidate tables are
        # padded to pow2 buckets (pad_tables_for_scoring), so a 50-round
        # training run compiles exactly once per (chunk, lanes, dispatches,
        # ids-cap, delete-config) — rebuilding the closure each score() call
        # would re-trace and re-compile the whole pipeline every round.
        self._device_steps: dict = {}
        self.device_compiles = 0
        import threading
        self._step_lock = threading.Lock()  # threaded rounds share the
                                            # jitted-step caches

    def build(self, token_list):
        """token_list: singles + tokens + specials (pre-encoded bytes)."""
        v = Vocab()
        specials = [t for t in token_list if t in self._special_set]
        regular = [t for t in token_list if t not in self._special_set]
        v._generate(tokens=regular,
                    special_tokens_encoded=specials,
                    charset=self.charset, normalize_string="",
                    using_capcode=self.using_capcode, level=5, reserve=0,
                    reset_token_ids=True)
        v.normalizer = Normalizer(self.norm_flag)
        return v

    _special_set: set = frozenset()

    def set_specials(self, specials):
        self._special_set = frozenset(specials)

    def score(self, cand: Vocab, datasets: list[bytes]):
        """Returns (scores int64[max_id], tokens_in_text, missing_list)."""
        n_ids = len(cand.reverse)
        scores = np.zeros(n_ids + 1, np.int64)
        tokens_in_text = 0
        missing_bytes = set()
        if self.backend == "native":
            from .. import native
            nv = native.NativeVocab(cand)
            mask = np.zeros(256, np.uint8)
            for data in datasets:
                nt, _miss = nv.tokenize_score(data, scores, mask)
                tokens_in_text += nt
            missing_bytes |= {int(b) for b in np.nonzero(mask)[0]}
        elif self.backend == "device":
            n_tok, dev_missing = self._score_device(cand, datasets, scores)
            tokens_in_text += n_tok
            missing_bytes |= dev_missing
        else:
            raise ValueError(f"unknown backend {self.backend}")
        return scores[:n_ids], tokens_in_text, missing_bytes

    def _find_missing(self, cand, data):
        missing = set()
        for b in set(data):
            if bytes([b]) not in cand.dictionary.index:
                missing.add(b)
        return missing

    def _score_device(self, cand, datasets, scores):
        """Exact (decision-equivalent) distributed scoring: whole strips
        data-parallel over the mesh, chunk-parallel + device-stitched within
        a strip — byte-exact vs the native contiguous tokenizer, so both
        backends vote identical deletions.  Returns (n_tokens, missing)."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from ..parallel.score import (
            _pow2, exact_score_geometry, make_exact_score_step,
            pad_tables_for_scoring)
        devices = np.array(self.devices or jax.devices())
        mesh = Mesh(devices, ("data",))
        n_ids = len(cand.reverse)
        n_ids_cap = _pow2(max(n_ids, 256))
        dv, tables = pad_tables_for_scoring(cand, ids_bucket=n_ids_cap)
        chunk = 2048
        max_len = max((len(d) for d in datasets), default=1)
        lanes, dispatches, buf_len = exact_score_geometry(
            _pow2(max(max_len, chunk)), chunk)
        key = (chunk, lanes, dispatches, n_ids_cap,
               dv.space_dfa is not None, dv.delete_token & 0xFFFFFF,
               dv.lil_off, len(devices))
        with self._step_lock:
            step = self._device_steps.get(key)
            if step is None:
                step = make_exact_score_step(
                    mesh, chunk, lanes, dispatches, n_ids_cap,
                    dv.space_dfa is not None, dv.delete_token & 0xFFFFFF,
                    lil_off=dv.lil_off)
                self._device_steps[key] = step
                self.device_compiles += 1
        rep = NamedSharding(mesh, P())
        tables_dev = tuple(jax.device_put(t, rep) for t in tables)
        n_dev = len(devices)
        total_tokens = 0
        on_device = fell_back = 0
        miss_mask = np.zeros(256, np.int64)
        for g in range(0, len(datasets), n_dev):
            group = datasets[g:g + n_dev]
            text = np.zeros((n_dev, buf_len), np.uint8)
            ns = np.zeros(n_dev, np.int32)
            for i, d in enumerate(group):
                a = np.frombuffer(d, np.uint8)
                text[i, :len(a)] = a
                ns[i] = len(a)
            s, n_tok, mm, sync_ok = step(
                jax.device_put(jnp.asarray(text),
                               NamedSharding(mesh, P("data", None))),
                jax.device_put(jnp.asarray(ns),
                               NamedSharding(mesh, P("data"))),
                *tables_dev)
            if not bool(sync_ok):
                # pathological junction: exact native fallback for this
                # group, counted so that callers can see the device missed it
                fell_back += 1
                from .. import native
                nv = native.NativeVocab(cand)
                mask = np.zeros(256, np.uint8)
                for d in group:
                    nt, _n_miss = nv.tokenize_score(d, scores, mask)
                    total_tokens += nt
                miss_mask += mask.astype(np.int64)
                continue
            on_device += 1
            scores[:n_ids] += np.asarray(s, np.int64)[:n_ids]
            total_tokens += int(n_tok)
            miss_mask += np.asarray(mm, np.int64)
        with self._step_lock:
            self.device_groups += on_device
            self.device_fallbacks += fell_back
        missing = {int(b) for b in np.nonzero(miss_mask)[0]}
        return total_tokens, missing


def _worker_divider(remaining, vocab_size, midway_target, fast):
    """trainvocab.go:1192-1249."""
    if fast:
        table = [(vocab_size + vocab_size // 4, 200),
                 (vocab_size + vocab_size // 2, 150),
                 (vocab_size * 2, 100),
                 (midway_target // 6, 100), (midway_target // 4, 100),
                 (midway_target // 2, 100), (midway_target, 50),
                 (midway_target * 3 // 2, 40), (midway_target * 2, 30),
                 (midway_target * 4, 20), (midway_target * 10, 10)]
        default = 10
    else:
        table = [(vocab_size + vocab_size // 4, 2000),
                 (vocab_size + vocab_size // 2, 1500),
                 (vocab_size * 2, 1000),
                 (midway_target // 6, 400), (midway_target // 4, 300),
                 (midway_target // 2, 200), (midway_target, 150),
                 (midway_target * 3 // 2, 100), (midway_target * 2, 80),
                 (midway_target * 4, 40), (midway_target * 10, 20)]
        default = 10
    if remaining == 0:
        return 10
    for bound, div in table:
        if remaining < bound:
            return div
    return default


def _final_phase_cap(temp, in_top_percent, fast, zero_removed):
    """trainvocab.go:1908-1947."""
    for bound, v in ((25, 2), (50, 3), (100, 4), (200, 5), (300, 6),
                     (400, 8), (500, 10), (750, 15), (1000, 20), (2000, 30),
                     (2500, 40), (3000, 50)):
        if temp < bound:
            cap = v
            break
    else:
        cap = 100
    if in_top_percent:
        cap += 4
    if fast:
        cap *= 2
    return cap + zero_removed


def _fnv_vocab_hash(sorted_tokens):
    """trainvocab.go:2265-2279 (modified FNV-1a over the sorted vocab)."""
    h = 14695981039346656037
    mask = (1 << 64) - 1
    for key in sorted_tokens:
        for c in key:
            h = ((h ^ (c + 11)) * 1099511628211) & mask
        h = ((h ^ 11400714819323198485) * 1099511628211) & mask
    return h


def _select_deletions(cand: Vocab, scores, vocab_size, remaining_plus,
                      midway_target, fast, special_set, work_type):
    """Worker deletion-vote selection (trainvocab.go:1180-1320).

    scores: int64[max_id]; returns list of token bytes (worst first), or for
    work_type 1 the best tokens (best first)."""
    id_to_token = cand.reverse
    ids = [i for i, t in enumerate(id_to_token) if t is not None]
    order = sorted(ids, key=lambda i: (scores[i], i))
    if work_type == 1:
        result = []
        for i in reversed(order):
            t = id_to_token[i]
            if len(t) <= 1 or t in special_set:
                continue
            result.append(t)
        return result

    divider = _worker_divider(remaining_plus, vocab_size, midway_target, fast)
    length = max(2, min(vocab_size // divider, vocab_size - 1))
    result = []
    k = 0
    for i in order:
        if len(result) >= length:
            break
        k += 1
        t = id_to_token[i]
        if len(t) == 1 or t in special_set:
            continue
        result.append(t)
    # append all remaining zero-score tokens (trainvocab.go:1277-1295)
    for i in order[k:]:
        if scores[i] > 0:
            break
        t = id_to_token[i]
        if len(t) == 1 or t in special_set:
            continue
        result.append(t)
    return result


def train_vocab(dataset: bytes, dictionary_path, results_dir,
                config: TrainConfig):
    """Run the distillation training loop.  Returns the best .tok path."""
    cfg = config
    rng = random.Random(cfg.seed)
    os.makedirs(results_dir, exist_ok=True)

    # Resume support (trainvocab.go:1395-1411, 1609-1642): a directory input
    # resumes from its latest checkpoint.  Token counts shrink monotonically
    # during pruning, so "latest" = the file with the *smallest* numeric
    # suffix (lexicographic order is wrong: interval_995 sorts after
    # interval_1002).  The token list is loaded from that checkpoint, while
    # doublevocab_*/finalrun_* — like the reference — additionally restore
    # the 2x-vocab resurrection snapshot and the final-run filename rather
    # than replacing newer interval_ progress.
    resume_double_path = None
    resume_finalrun_path = None
    if os.path.isdir(dictionary_path):
        def _suffix(name, prefix):
            try:
                return int(name[len(prefix):-len(".tok")])
            except ValueError:
                return None

        def _best(prefix):
            hits = []
            for n in os.listdir(dictionary_path):
                if n.startswith(prefix) and n.endswith(".tok"):
                    s = _suffix(n, prefix)
                    if s is not None:
                        hits.append((s, n))
            if not hits:
                return None
            return os.path.join(dictionary_path, min(hits)[1])

        resume_double_path = _best("doublevocab_")
        resume_finalrun_path = _best("finalrun_")
        best_ckpt = (_best("interval_") or resume_finalrun_path
                     or resume_double_path)
        if best_ckpt is None:
            raise FileNotFoundError(
                f"no interval_/finalrun_/doublevocab_ .tok in "
                f"{dictionary_path}")
        dictionary_path = best_ckpt
        log.info("resuming from checkpoint %s", dictionary_path)

    dic = load_tokens_file(dictionary_path)
    using_capcode = dic["using_capcode"]
    charset = dic["charset"]
    norm_flag = dic["norm_flag"]
    level = dic["level"]
    tokens = list(dic["tokens"])
    if dic.get("specials"):
        cfg.special_tokens = list(cfg.special_tokens) + list(dic["specials"])

    vocab_size = cfg.vocab_size
    if vocab_size <= 0:
        raise ValueError("vocab_size required")
    midway_target = cfg.midway_target
    keep_trying = cfg.keep_trying
    if cfg.fast:
        midway_target = midway_target or (vocab_size * 2 + vocab_size // 4)
        keep_trying = 275 if keep_trying == 1000 else keep_trying
    midway_target = midway_target or vocab_size * 6

    # normalize corpus once (trainvocab.go:1657-1665)
    normalizer = Normalizer(norm_flag)
    filedata = normalize_and_capcode(bytes(dataset), using_capcode, normalizer)
    data_len = len(filedata)

    # strips (trainvocab.go:1668-1695)
    strips = 20 if data_len < 10 * 1024 * 1024 else cfg.strips
    bytes_per_worker = data_len * cfg.percentage // 100
    bytes_per_strip = bytes_per_worker // max(1, strips)
    bytes_per_strip += 4 - (bytes_per_strip % 4)
    offset = data_len // max(1, strips)
    worker_strips = []
    if offset + bytes_per_strip > data_len or cfg.percentage >= 100 or data_len < 24000:
        worker_strips = [[filedata] for _ in range(cfg.workers)]
    else:
        for _w in range(cfg.workers):
            frm = rng.randrange(max(1, offset))
            ws = []
            for _s in range(strips):
                if frm + bytes_per_strip > data_len:
                    frm = (frm + bytes_per_strip) - data_len
                ws.append(filedata[frm:frm + bytes_per_strip])
                frm += offset
            worker_strips.append(ws)

    # specials handling (trainvocab.go:1737-1749)
    special_tokens = []
    for sp in cfg.special_tokens:
        sp = bytes(sp)
        spn = normalize_and_capcode(sp, using_capcode, normalizer)
        special_tokens.append(spn)
    special_set = set(special_tokens)
    tokens = [t for t in tokens
              if not any(sp in t for sp in special_tokens)]

    # separate singles; strip "D " prefixes (trainvocab.go:1751-1790)
    include_bytes = [False] * 256
    from ..core.vocab import (_gen_128, _gen_256, _gen_ascii, _gen_extended,
                              _gen_utf8)
    if cfg.include_256_bytes:
        _gen_256(include_bytes, using_capcode)
    if cfg.include_128_bytes:
        _gen_128(include_bytes, using_capcode)
    if cfg.include_utf8_bytes:
        _gen_utf8(include_bytes, using_capcode)
    if cfg.include_ascii_bytes:
        _gen_ascii(include_bytes, using_capcode)
    if cfg.include_extended_bytes:
        _gen_extended(include_bytes, using_capcode, normalizer)
    unique = set()
    from ..core.tokenmeta import is_alphanum_tm
    for tok in tokens:
        if len(tok) == 0:
            continue
        if len(tok) == 1:
            if not cfg.exclude_other_bytes:
                include_bytes[tok[0]] = True
            continue
        if len(tok) >= 2 and tok[1] == 0x20:
            if ((tok[0] == cc.DELETE_TOKEN and using_capcode == 2)
                    or (using_capcode == 1
                        and tok[0] == cc.NO_CAPCODE_DELETE_TOKEN)):
                if len(tok) > 2:
                    r, _n = decode_utf8(tok, 2)
                    if is_alphanum_tm(r, using_capcode):
                        tok = tok[2:]
        if len(tok) > 1:
            unique.add(tok)
    tokens = sorted(unique, key=lambda t: (len(t), t))
    if using_capcode == 2:
        for b in (cc.DELETE_TOKEN, cc.CHARACTER_TOKEN, cc.WORD_TOKEN):
            include_bytes[b] = True
    elif using_capcode == 1:
        include_bytes[cc.NO_CAPCODE_DELETE_TOKEN] = True
    single_chars = [bytes([i]) for i in range(256) if include_bytes[i]]

    vocab_diff = len(single_chars) + len(special_tokens)
    vocab_size_effective = vocab_size - vocab_diff
    if vocab_size_effective <= 0:
        raise ValueError("vocab size too small for singles + specials")

    scorer = CandidateScorer(charset, using_capcode, norm_flag, cfg.backend)
    scorer.set_specials(special_set)

    header = {"using_capcode": using_capcode, "charset": charset,
              "norm_flag": norm_flag, "level": level}

    # ---- master state ----
    remaining = len(tokens)
    reached_midway = remaining <= midway_target
    within_vocab_x2 = remaining <= vocab_size * 2
    reached_vocab = False
    best = MAXINT
    best1percent = MAXINT
    no_new_best = 0
    zero_removed = 0
    dicts_within_1pct: list[tuple[int, str]] = []
    unique_file_number = 0
    vocabs_tried = set()
    double_tokens: list[bytes] = []
    double1: list[bytes] = []
    double2: list[bytes] = []
    counter_multi_deletes: dict[bytes, int] = {}
    final_run_filename = None
    # restore checkpoint side-state (reference trainvocab.go:1617-1637:
    # doublevocab_ refills doubletokens, finalrun_ restores the final-run
    # filename — without replacing the interval_ dictionary loaded above)
    if resume_double_path is not None:
        double_tokens = [t for t in load_tokens_file(
            resume_double_path)["tokens"] if len(t) > 1]
        within_vocab_x2 = True
    if resume_finalrun_path is not None:
        final_run_filename = resume_finalrun_path
        reached_vocab = True
    interval10 = 0
    last_interval = None
    justreset = False
    add_tokens_flag = False
    round_no = 0
    worker_cycle = 0

    def save_checkpoint(name, toks, scores=None):
        """Write a resumable checkpoint.  The reference saves the master
        token list together with specials and single-byte tokens
        (trainvocab.go:2173, 2005, 2082) so that resuming from the file
        reconstructs the full candidate state — the loader folds dictionary
        singles back into include_bytes."""
        path = os.path.join(results_dir, name)
        full = (list(toks) if scores is not None
                else list(toks) + list(special_tokens) + single_chars)
        save_tokens_with_scores(path, header, full, scores,
                                special_tokens if scores is not None else None)
        return path

    log.info("training: %d candidate tokens -> vocab %d (effective %d)",
             remaining, vocab_size, vocab_size_effective)

    while True:
        round_no += 1
        if cfg.max_rounds is not None and round_no > cfg.max_rounds:
            log.info("max_rounds reached")
            break

        # --- build candidate vocabularies (master :2217-2290) ---
        jobs = []
        shuffles = 0
        no_more_vocabs = False
        while not jobs:
            if shuffles == 5000 or (shuffles > 0
                                    and remaining <= vocab_size_effective):
                if justreset:
                    log.info("all near vocabularies have been tested")
                    no_more_vocabs = None  # terminal
                    break
                no_more_vocabs = True
                break
            rng.shuffle(tokens)
            shuffles += 1
            i = 0
            for _ in range(10):
                to = i + vocab_size_effective
                if to > len(tokens):
                    break
                cand_tokens = (single_chars + tokens[i:to] + special_tokens)
                i = to
                key = sorted(cand_tokens, key=lambda t: (len(t), t))
                h = _fnv_vocab_hash(key) if within_vocab_x2 else None
                if h is not None and h in vocabs_tried:
                    continue
                if h is not None:
                    vocabs_tried.add(h)
                jobs.append((cand_tokens, 0))
                if len(jobs) >= cfg.workers:
                    break
        if no_more_vocabs is None:
            break

        # workType 1 jobs (master :2183-2215)
        if add_tokens_flag:
            add_tokens_flag = False
            if len(double_tokens) >= vocab_size_effective:
                rng.shuffle(double_tokens)
                half1 = double_tokens[:vocab_size_effective]
                to2 = vocab_size_effective * 2
                half2 = double_tokens[vocab_size_effective:to2]
                if len(double_tokens) < to2:
                    half2 = half2 + double_tokens[:to2 - len(double_tokens)]
                jobs.append((single_chars + half1 + special_tokens, 1))
                jobs.append((single_chars + half2 + special_tokens, 1))

        # --- score the candidates (the worker pool) ---
        # Candidates are evaluated thread-parallel (the C++ scorer releases
        # the GIL), results processed in submission order so every master
        # decision is deterministic.
        tokens_to_remove: dict[bytes, int] = {}
        has_tokens_to_remove = False

        def _evaluate(job):
            cand_tokens, work_type = job[0], job[1]
            widx = job[2]
            cand = scorer.build(cand_tokens)
            # the full dataset is used after midway for normal scoring jobs
            # (trainvocab.go:916-922; workType-1 jobs always use strips)
            use_full = (reached_midway and work_type == 0)
            datasets = [filedata] if use_full else worker_strips[widx]
            return cand, use_full, scorer.score(cand, datasets)

        jobs_w = []
        for cand_tokens, work_type in jobs:
            jobs_w.append((cand_tokens, work_type,
                           worker_cycle % max(1, len(worker_strips))))
            worker_cycle += 1
        # Asynchronous rounds (VERDICT r3 #4, trainvocab.go:1831-2293):
        # worker threads keep scoring later candidates WHILE the master
        # consumes earlier results (the streamed map below yields in
        # submission order, so master decisions stay deterministic).  For
        # the device backend two threads pipeline candidate build + table
        # upload (host) against device scoring.
        from concurrent.futures import ThreadPoolExecutor
        _pool = None
        if len(jobs_w) > 1:
            workers_n = (min(4, len(jobs_w)) if cfg.backend == "native"
                         else 2)
            _pool = ThreadPoolExecutor(max_workers=workers_n)
            evaluated = _pool.map(_evaluate, jobs_w)
        else:
            evaluated = (_evaluate(j) for j in jobs_w)

        for (cand_tokens, work_type, _w), (cand, use_full, score_result) \
                in zip(jobs_w, evaluated):
            scores, tokens_in_text, missing = score_result
            remaining_plus = 0 if reached_vocab else remaining + vocab_diff
            votes = _select_deletions(
                cand, scores, vocab_size, remaining_plus, midway_target,
                cfg.fast, special_set, work_type)

            if work_type == 1:
                if not double1:
                    double1 = votes
                else:
                    double2 = votes
                continue

            if cfg.include_missing_bytes and missing:
                for b in missing:
                    if bytes([b]) not in single_chars:
                        single_chars.append(bytes([b]))
                single_chars.sort()
                vocab_diff = len(single_chars) + len(special_tokens)
                vocab_size_effective = vocab_size - vocab_diff

            # best tracking (master :1859-1886)
            if within_vocab_x2 and use_full:
                if tokens_in_text < best:
                    best = tokens_in_text
                    best1percent = best + best // 100
                    no_new_best = 0
                    log.info("new best score %d", best)
                    dicts_within_1pct = [
                        (t, f) for (t, f) in dicts_within_1pct
                        if t <= best1percent or not _try_remove(f)]
                else:
                    no_new_best += 1
                if tokens_in_text < best1percent:
                    fname = os.path.join(
                        results_dir,
                        f"{tokens_in_text}_{unique_file_number}.tok")
                    unique_file_number += 1
                    # tokens the candidate build dropped (e.g. beyond the
                    # 40-byte key cap) have no dictionary entry: score 0
                    saved_tokens = sorted(set(cand_tokens),
                                          key=lambda t: (len(t), t))
                    didx = cand.dictionary.index
                    score_arr = [
                        (float(scores[cand.id[didx[t]]]) / max(1, data_len))
                        if t in didx else 0.0
                        for t in saved_tokens]
                    save_tokens_with_scores(
                        fname, header, saved_tokens, score_arr,
                        special_tokens)
                    dicts_within_1pct.append((tokens_in_text, fname))

            if reached_vocab:
                if no_new_best >= keep_trying:
                    log.info("finished: no new best in %d runs", no_new_best)
                    if _pool is not None:
                        # stop remaining queued candidates before the final
                        # scoring pass (they'd contend for the device and
                        # keep the process alive after the decision to stop)
                        _pool.shutdown(wait=False, cancel_futures=True)
                    return _finish(dicts_within_1pct, best, best1percent,
                                   data_len)
                if best != tokens_in_text and votes:
                    temp = remaining - vocab_size_effective
                    cap = _final_phase_cap(temp, tokens_in_text > best1percent,
                                           cfg.fast, zero_removed)
                    cap = min(cap, len(votes))
                    for t in votes[:cap]:
                        tokens_to_remove[t] = tokens_to_remove.get(t, 0) + 1
                        counter_multi_deletes[t] = (
                            counter_multi_deletes.get(t, 0)
                            + (remaining - vocab_size_effective))
                    has_tokens_to_remove = True
            else:
                if best != tokens_in_text:
                    for t in votes:
                        tokens_to_remove[t] = tokens_to_remove.get(t, 0) + 1
                    has_tokens_to_remove = True

        if _pool is not None:
            _pool.shutdown()
        if cfg.backend == "device":
            log.info("device scorer: %d strip groups on the device, %d on "
                     "the native fallback", scorer.device_groups,
                     scorer.device_fallbacks)

        # --- prune (master default branch :1962-2177) ---
        if has_tokens_to_remove or remaining < vocab_size_effective or no_more_vocabs:
            before = len(tokens)
            deleted = [t for t in tokens if t in tokens_to_remove]
            tokens = [t for t in tokens if t not in tokens_to_remove]
            removed = before - len(tokens)
            zero_removed = zero_removed + 1 if removed == 0 else 0
            remaining = len(tokens)
            # the FNV of the deleted set lets two runs (or backends) be
            # compared round by round
            log.info("round %d: deleted %d (fnv %016x); remaining %d%s",
                     round_no, removed,
                     _fnv_vocab_hash(sorted(deleted)),
                     remaining + vocab_diff,
                     " [final]" if reached_vocab else
                     (" [x2]" if within_vocab_x2 else
                      (" [midway]" if reached_midway else "")))
            if remaining <= midway_target and not reached_midway:
                save_checkpoint(f"midwaypoint_{remaining + vocab_diff}.tok",
                                tokens)
                reached_midway = True
            if remaining <= vocab_size * 2 and not within_vocab_x2:
                save_checkpoint(f"doublevocab_{remaining + vocab_diff}.tok",
                                tokens)
                double_tokens = list(tokens)
                within_vocab_x2 = True
                add_tokens_flag = True
            justreset = False
            if remaining < vocab_size_effective or no_more_vocabs:
                # final-phase reset (master :2018-2160)
                unique_final: set[bytes] = set()
                if final_run_filename:  # subsequent resets
                    prev = load_tokens_file(final_run_filename)
                    for b in prev["tokens"]:
                        if len(b) > 1 and b not in special_set:
                            if counter_multi_deletes.get(b, 0) < 4000:
                                unique_final.add(b)
                    unique_final.update(tokens)
                else:
                    for t_count, fname in dicts_within_1pct:
                        if t_count < best1percent:
                            d = load_tokens_file(fname)
                            for b in d["tokens"]:
                                if len(b) > 1 and b not in special_set:
                                    unique_final.add(b)
                    no_new_best = 0
                    tokens = sorted(unique_final, key=lambda t: (len(t), t))
                    final_run_filename = save_checkpoint(
                        f"finalrun_{len(tokens) + vocab_diff}.tok", tokens)
                # resurrection from the 2x snapshot (master :2161-2155)
                n_res = max(0, (len(unique_final) - vocab_size_effective) // 3)
                added = 0
                for src_list in (double1, double2):
                    added = 0
                    for b in src_list:
                        if (len(b) > 1 and b not in special_set
                                and b not in unique_final
                                and counter_multi_deletes.get(b, 0) < 1000):
                            unique_final.add(b)
                            added += 1
                            if added >= n_res:
                                break
                double1, double2 = [], []
                add_tokens_flag = True
                tokens = sorted(unique_final, key=lambda t: (len(t), t))
                reached_vocab = True
                justreset = True
                remaining = len(tokens)
                log.info("determining best combination of %d tokens",
                         remaining + vocab_diff)
            if (not reached_vocab
                    and remaining > vocab_size_effective
                    + vocab_size_effective // 50):
                interval10 += 1
                if interval10 == 10:
                    if last_interval:
                        _try_remove(last_interval)
                    last_interval = save_checkpoint(
                        f"interval_{remaining + vocab_diff}.tok", tokens)
                    interval10 = 0

    return _finish(dicts_within_1pct, best, best1percent, data_len)


def _try_remove(path):
    try:
        os.remove(path)
    except OSError:
        pass
    return True


def _finish(dicts_within_1pct, best, best1percent, data_len):
    best_path = None
    for t, f in dicts_within_1pct:
        if t > best1percent:
            _try_remove(f)
        elif t == best:
            best_path = f
    if best != MAXINT and best > 0:
        log.info("best tokenized %d bytes with %d tokens (%.3f chr/tok)",
                 data_len, best, data_len / best)
    return best_path
