"""Phase 2 of device tokenization: the chunk-parallel ungreedy automaton.

The reference's tokenize loop (go/tokenmonster.go:1048-1277) is sequential:
each iteration consumes the carried longest match, evaluates up to 6 branches
and emits 1-2 tokens.  The key restructuring insight: at every emission point
the automaton state is exactly ``(position, forwardDelete)`` — the carried
match is a pure function of that pair via the precomputed tables
M (ops/match.py) and Mb (space-prefixed variant).  That makes speculative
chunk starts reconcilable: every lane scans from its chunk start with
state (start, 0), continues ``OVERLAP_SCAN`` bytes into the next chunk, and
the host stitcher finds the first emission state shared by neighbouring
lanes.  From that sync point on, the speculative stream provably equals the
sequential one, so the final output is byte-exact vs. the oracle
(core/tokenizer.py).  If a junction never syncs (pathological data), the
stitcher falls back to the host oracle for that junction only.

Score formula and tie-break order are the exact ints of
go/tokenmonster.go:1075-1084 / :1217-1262.
"""

from __future__ import annotations


from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..core.tokenmeta import DOES_NOT_EXIST
from .automaton import build_match_automata


NEG = -1000000
OVERLAP_SCAN = 128  # bytes a lane scans past its chunk end to find sync

# record packing: pos(bits 4..31) | fd(0) | has_tok(1) | has_del(2) | miss(3)
_REC_FD = 1
_REC_TOK = 2
_REC_DEL = 4
_REC_MISS = 8


@dataclass
class DeviceVocab:
    """Device-resident arrays for the device tokenizer, built from a Vocab."""
    p1: jnp.ndarray          # flag | nwords<<8 | len1<<16 | len2<<24 (u32)
    index1: jnp.ndarray      # alt1 dict index (u32, DNE sentinel)
    index2: jnp.ndarray
    ids: jnp.ndarray         # id, id1, id2 packed as (n,3) u32
    begin_byte: jnp.ndarray  # (256,) i32
    main_dfa: jnp.ndarray
    main_out: jnp.ndarray
    space_dfa: jnp.ndarray | None
    space_out: jnp.ndarray | None
    has_delete: bool
    delete_token: int
    has_unk: bool
    unk_token: int
    max_token_length: int
    lil_off: int = 1  # lilbufOffset: 2 for UTF-16 (go/tokenmonster.go:1031-1033)

    @classmethod
    def build(cls, vocab) -> "DeviceVocab":
        p1 = (vocab.flag.astype(np.uint32)
              | (vocab.nwords.astype(np.uint32) << 8)
              | (vocab.len1.astype(np.uint32) << 16)
              | (vocab.len2.astype(np.uint32) << 24))
        ids = np.stack([vocab.id, vocab.id1, vocab.id2], axis=1).astype(np.uint32)
        lil_off = 2 if vocab.charset == 2 else 1
        max_len = int(vocab.max_token_length)
        main, space = build_match_automata(vocab)
        return cls(
            p1=jnp.asarray(p1),
            index1=jnp.asarray(vocab.index1),
            index2=jnp.asarray(vocab.index2),
            ids=jnp.asarray(ids),
            begin_byte=jnp.asarray(vocab.begin_byte.astype(np.int32)),
            main_dfa=jnp.asarray(main.dfa),
            main_out=jnp.asarray(main.out),
            space_dfa=jnp.asarray(space.dfa) if space is not None else None,
            space_out=jnp.asarray(space.out) if space is not None else None,
            has_delete=vocab.delete_token != DOES_NOT_EXIST,
            delete_token=int(vocab.delete_token),
            has_unk=vocab.unk_token != DOES_NOT_EXIST,
            unk_token=int(vocab.unk_token),
            max_token_length=max_len,
            lil_off=lil_off,
        )


def _max0(x):
    return jnp.maximum(x, 0)


def ungreedy_step(pos, fd, m_tab, mb_tab, bb, p1, index1_t, index2_t, ids3,
                  n, eval_end, has_delete: bool, has_unk: bool,
                  unk_token: int, lil_off: int = 1):
    """One 6-branch ungreedy decision for every element of ``pos`` given the
    carried forward-delete state ``fd`` (vector, same shape as pos).

    This is the exact transition function of the reference tokenize loop
    (go/tokenmonster.go:1048-1277): the automaton state at any emission point
    is precisely (position, forwardDelete), so this function fully determines
    both the sequential scan (ops/scan.py) and the position-parallel decision
    tables (ops/decision.py).

    Returns (new_pos, new_fd, has_tok, is_b, miss, tok):
      new_pos: next position; new_fd: next forward-delete state
      has_tok: emits ``tok``; is_b: additionally emits the delete token
      miss:    no dictionary match at pos (counted; emits unk iff has_unk)
    """
    safe_pos = jnp.minimum(pos, n)  # padded tables

    m_plain = jnp.take(m_tab, safe_pos)
    if has_delete:
        mb_here = jnp.take(mb_tab, safe_pos)
        m = jnp.where(fd == 1, mb_here, m_plain)
    else:
        m = m_plain
    cur_idx = (m >> 6).astype(jnp.int32)
    # carried b-match lengths have lilbufOffset already applied
    # (go/tokenmonster.go:1093, 1222)
    cur_len = (m & 63).astype(jnp.int32) - fd * lil_off
    found = m != 0

    L = pos.shape[0]
    NEGS = jnp.int32(NEG)

    # current-token metadata + alternative lengths (len==0 <=> no alt,
    # core/tokenmeta.py:159-175 — equivalent to the DOES_NOT_EXIST test)
    v = jnp.take(p1, cur_idx).astype(jnp.int32)
    of, onw = v & 0xFF, (v >> 8) & 0xFF
    olen1, olen2 = (v >> 16) & 0xFF, (v >> 24) & 0xFF
    # (L, 3) id, id1, id2 of the current token
    oids = jnp.take(ids3, cur_idx, axis=0)

    i1 = safe_pos + cur_len
    bb_i1 = jnp.take(bb, i1)
    do_eval = found & (i1 < eval_end) & (
        ((of & 32) == 0) | (bb_i1 != 12))
    nw_adj = onw - fd

    # ---- stacked branch layout: rows = [greedy, alt1, alt2] ----
    has_alt1 = do_eval & (olen1 > 0)
    has_alt2 = has_alt1 & (olen2 > 0)
    valid_first = jnp.stack([do_eval, has_alt1, has_alt2])        # (3,L)
    first_len = jnp.stack([cur_len, olen1 - fd, olen2 - fd])
    start3 = jnp.where(valid_first, safe_pos[None, :] + first_len,
                       i1[None, :])                               # (3,L)

    # batched lookahead matches at the three branch starts
    m3 = jnp.take(m_tab, start3.reshape(-1)).reshape(3, L)
    sec_idx = (m3 >> 6).astype(jnp.int32)
    sec_len = (m3 & 63).astype(jnp.int32)
    valid_nb = valid_first & (m3 != 0)
    if has_delete:
        mb3 = jnp.take(mb_tab, start3.reshape(-1)).reshape(3, L)
        secb_idx = (mb3 >> 6).astype(jnp.int32)
        secb_lenf = (mb3 & 63).astype(jnp.int32)  # incl. leading space
    else:
        secb_idx = sec_idx
        secb_lenf = jnp.zeros_like(sec_len)

    # metadata: first flags (3), second (3), second-b (3)
    oidx1 = jnp.take(index1_t, cur_idx)
    oidx2 = jnp.take(index2_t, cur_idx)
    alt1_idx = jnp.where(has_alt1, oidx1, 0).astype(jnp.int32)
    alt2_idx = jnp.where(has_alt2, oidx2, 0).astype(jnp.int32)
    first_idx = jnp.stack([cur_idx, alt1_idx, alt2_idx])          # (3,L)
    meta_idx = jnp.concatenate(
        [first_idx.reshape(-1), sec_idx.reshape(-1), secb_idx.reshape(-1)])
    mv = jnp.take(p1, meta_idx).astype(jnp.int32).reshape(9, L)
    ff, fsec, fsecb = mv[0:3], mv[3:6], mv[6:9]
    f_first = ff & 0xFF
    fnw = (ff >> 8) & 0xFF
    sf, snw = fsec & 0xFF, (fsec >> 8) & 0xFF
    sfb, snwb = fsecb & 0xFF, (fsecb >> 8) & 0xFF

    # batched next-byte classes at the six branch end positions
    end_nb = start3 + sec_len
    end_b = start3 + (secb_lenf - lil_off)
    nb_all = jnp.take(bb, jnp.concatenate(
        [end_nb.reshape(-1), end_b.reshape(-1)])).reshape(6, L)
    nb_nb, nb_b = nb_all[0:3], nb_all[3:6]

    nw1_adj = jnp.stack([nw_adj, fnw[1] - fd, fnw[2] - fd])       # (3,L)
    greedy_len = cur_len[None, :]
    is_alt = jnp.array([0, 1, 1], jnp.int32)[:, None]

    # ---- plain branches (go :1075-1084 exact formula) ----
    bl_nb = first_len + sec_len
    base = (bl_nb + (f_first >> 7) + (sf >> 7)
            + _max0(nw1_adj - 1) + _max0(snw - 1)
            + ((sf >> 2) & 1) + ((nb_nb >> 2) & 1)
            + (nw1_adj + snw + (nb_nb >> 3)) * 100)
    ded = ((f_first & 1 & (sf >> 1)) * 103
           + ((f_first >> 3) & 1 & (sf >> 4)) * 100
           + (sf & 1 & nb_nb) * 3
           + is_alt * (jnp.where(bl_nb < greedy_len, 100, 0)
                       + jnp.where(bl_nb == greedy_len, 10000, 0)))
    s_nb = jnp.where(valid_nb, base - ded, NEGS)                  # (3,L)

    # ---- forward-delete branches ----
    if has_delete:
        want_b = (valid_nb & ((sf & 2) != 0) & (nb_nb == 1) & (snw == 0)
                  & (secb_lenf > sec_len + 1))
        secb_len = secb_lenf - lil_off
        bl_b = first_len + secb_len
        base_b = (bl_b + (f_first >> 7) + (sfb >> 7)
                  + _max0(nw1_adj - 1) + _max0(snwb - 1)
                  + ((nb_b >> 2) & 1)
                  + (nw1_adj + snwb + (nb_b >> 3)) * 100)
        ded_b = ((f_first & 1) * 103
                 + ((f_first >> 3) & 1 & (sfb >> 4)) * 100
                 + (sfb & 1 & nb_b) * 3 + 1
                 + is_alt * (jnp.where(bl_b < greedy_len, 100, 0)
                             + jnp.where(bl_b == greedy_len, 10000, 0)))
        s_b = jnp.where(want_b, base_b - ded_b, NEGS)             # (3,L)
    else:
        secb_len = sec_len
        s_b = jnp.full_like(s_nb, NEG)

    # ---- winner, tie order s1 > s2 > s3 > s1b > s2b > s3b ----
    scores6 = jnp.concatenate([s_nb, s_b])                        # (6,L)
    mx = jnp.max(scores6, axis=0)
    any_branch = mx != NEGS
    winner = jnp.argmax((scores6 == mx[None, :]).astype(jnp.int32),
                        axis=0)                                   # first hit
    w3 = winner % 3
    is_b = any_branch & (winner >= 3)
    lane = jnp.arange(L)

    # emitted token id: id/id1/id2 of the current token by branch row
    emit_id = oids[lane, w3]
    adv = first_len[w3, lane]

    new_pos = safe_pos + jnp.where(
        found, jnp.where(any_branch, adv, cur_len), 1)
    new_fd = jnp.where(is_b, 1, 0)

    miss = ~found
    has_tok = found | (miss & has_unk)
    emit_skip = jnp.where(any_branch, emit_id, oids[:, 0])
    tok = jnp.where(miss, jnp.uint32(unk_token), emit_skip)
    return new_pos, new_fd, has_tok, is_b, miss, tok


def scan_lanes(m_tab, mb_tab, bb, p1, index1_t, index2_t, ids3,
               n, chunk: int, n_lanes: int,
               has_delete: bool, has_unk: bool,
               delete_token: int, unk_token: int,
               overlap: int = OVERLAP_SCAN, strip_mode: bool = False,
               lil_off: int = 1):
    """Pure function (composable under jit/shard_map): run the automaton on
    every lane.  Returns (rec, tok) of shape (T, L): packed step records and
    primary emitted token ids.  With strip_mode (trainer), every lane is an
    independent strip: it stops exactly at its chunk boundary and the
    lookahead evaluation window ends there too (overlap should be 0 and the
    match tables strip-local; see parallel/score.py).

    The six ungreedy branches (go/tokenmonster.go:1075-1210) are evaluated as
    stacked (3, L) arrays — [greedy, alt1, alt2] x [plain, forward-delete] —
    with batched gathers, so each step issues a handful of large table
    lookups instead of ~25 small ones."""
    L = n_lanes
    T = chunk + overlap
    starts = jnp.arange(L, dtype=jnp.int32) * chunk
    stops = jnp.minimum(starts + chunk + overlap, n)
    eval_end = stops if strip_mode else n

    def step(carry, _):
        pos, fd, done = carry
        new_pos, new_fd, has_tok, is_b, miss, tok = ungreedy_step(
            pos, fd, m_tab, mb_tab, bb, p1, index1_t, index2_t, ids3,
            n, eval_end, has_delete, has_unk, unk_token, lil_off)
        has_tok = has_tok & ~done
        rec = ((new_pos.astype(jnp.uint32) << 4)
               | (new_fd.astype(jnp.uint32) * _REC_FD)
               | (has_tok.astype(jnp.uint32) * _REC_TOK)
               | ((is_b & ~done).astype(jnp.uint32) * _REC_DEL)
               | ((miss & ~done).astype(jnp.uint32) * _REC_MISS))
        rec = jnp.where(done, 0, rec)

        new_done = done | (new_pos >= stops)
        new_pos = jnp.where(done, pos, new_pos)
        new_fd = jnp.where(done, fd, new_fd)
        return (new_pos, new_fd, new_done), (rec, tok)

    # while_loop with early exit: a lane finishes after ~1 step per emitted
    # token (avg ~3-4 bytes/step), far fewer than the worst-case T steps.
    recs0 = jnp.zeros((T, L), jnp.uint32)
    toks0 = jnp.zeros((T, L), jnp.uint32)

    def cond(state):
        t, pos, fd, done, recs, toks = state
        return (t < T) & ~jnp.all(done)

    def body(state):
        t, pos, fd, done, recs, toks = state
        (pos, fd, done), (rec, tok) = step((pos, fd, done), None)
        recs = jax.lax.dynamic_update_slice(recs, rec[None, :], (t, 0))
        toks = jax.lax.dynamic_update_slice(toks, tok[None, :], (t, 0))
        return (t + 1, pos, fd, done, recs, toks)

    init = (jnp.int32(0), starts, jnp.zeros(L, jnp.int32), starts >= stops,
            recs0, toks0)
    t_final, _, _, _, recs, toks = jax.lax.while_loop(cond, body, init)
    return recs, toks, t_final


MAX_LANES = 512   # lanes per dispatch; larger inputs run as a sequence of
                  # fixed-shape megachunk dispatches.  One 512-lane dispatch
                  # compiles in ~7 s cold, ~1 s from the persistent cache on
                  # an H100 (PERF.md, "Bring-up findings (H100)").
MARGIN = 512      # real-data lookahead past a dispatch's exact region: the
                  # last lane scans OVERLAP_SCAN bytes past its chunk end and
                  # its matches need up to 2*max_token_length more.


def device_pipeline(text, n, dfa, dout, sdfa, sout, bb_byte,
                    p1, i1t, i2t, ids3, *, chunk: int,
                    n_lanes: int, has_delete: bool, has_unk: bool,
                    unk_token: int, lil_off: int,
                    pack_follow: bool = False):
    """The full device tokenize pipeline for one dispatch (pure, jit/shard_map
    composable): phase-1 match tables for both automatons over the buffer
    (incl. margin), the position-parallel decision tables, then the
    per-lane chain follow over speculative chunk lanes.

    text: uint8[n_lanes*chunk + MARGIN]; n: valid byte count (traced).
    Returns (recs, toks, t_final) in the follow_lanes contract.
    """
    from .decision import decision_tables, follow_lanes
    from .match import OVERLAP, RESET, match_lanes
    total = n_lanes * chunk + MARGIN
    match_chunk = 512
    # total need not divide match_chunk: lanes are rounded up and the
    # reversed layout means the excess lands at the *front* of the flipped
    # output (sliced off below).
    m_lanes = -(-total // match_chunk)
    mt_total = m_lanes * match_chunk
    pad_n = mt_total - total
    with jax.named_scope("match"):
        rev = jnp.full(mt_total + OVERLAP, RESET, jnp.int32)
        body = jnp.flip(text.astype(jnp.int32))
        # positions >= n are padding: map to RESET
        posr = total - 1 - jnp.arange(total, dtype=jnp.int32)
        body = jnp.where(posr < n, body, RESET)
        rev = jax.lax.dynamic_update_slice(rev, body, (OVERLAP,))
        pad = jnp.zeros(64, jnp.uint32)
        m = jnp.flip(match_lanes(dfa, dout, rev, match_chunk, m_lanes))[pad_n:]
        m_tab = jnp.concatenate([m, pad])
        if has_delete:
            mb = jnp.flip(match_lanes(sdfa, sout, rev, match_chunk,
                                      m_lanes))[pad_n:]
            mb_tab = jnp.concatenate([mb, pad])
        else:
            mb_tab = m_tab
    with jax.named_scope("decide"):
        bb = jnp.concatenate([
            jnp.take(bb_byte, text.astype(jnp.int32)),
            jnp.full(64, bb_byte[0], jnp.int32)])
        ctl, tokt = decision_tables(
            m_tab, mb_tab, bb, p1, i1t, i2t, ids3, n,
            has_delete, has_unk, unk_token, lil_off=lil_off)
    with jax.named_scope("follow"):
        return follow_lanes(ctl, tokt, n, chunk, n_lanes, OVERLAP_SCAN,
                            packed=pack_follow)


class DeviceTokenizer:
    """End-to-end device tokenizer for a vocabulary: fixed-shape fused device
    dispatches (match tables + decision tables + lane follow + device
    stitch/compaction) over megachunks, chained through device scalars so
    the host never syncs mid-pipeline.  Dispatch joins reconcile exactly
    like lane joins via a one-lane overlap (ops/stitch.py); the host
    stitcher remains as the exact fallback for pathological junctions.

    ``last_mode`` records which path produced the last ``tokenize`` result:
    "fast"/"full" (device stitch, fast or full record window),
    "hoststitch" (device records, host stitcher) or "oracle" (the
    sequential host tokenizer, for a junction that never synced)."""

    def __init__(self, vocab, chunk: int = 2048):
        self.vocab = vocab
        self.chunk = chunk
        self.dv = DeviceVocab.build(vocab)
        # fold token ids into the follow-phase ctl words (1 gather/step
        # instead of 2) whenever every id fits in 22 bits
        self.pack_follow = len(vocab.reverse) < (1 << 22)
        self._bb_byte = jnp.asarray(vocab.begin_byte.astype(np.int32))
        self._fused = {}
        self._fused_stitch = {}
        self.last_mode = None
        self._finalize = {}
        self._chains = {}

    def tables(self):
        """The device table tuple every fused dispatch takes after its
        per-dispatch arguments."""
        dv = self.dv
        sdfa = dv.space_dfa if dv.space_dfa is not None else dv.main_dfa
        sout = dv.space_out if dv.space_out is not None else dv.main_out
        return (dv.main_dfa, dv.main_out, sdfa, sout, self._bb_byte,
                dv.p1, dv.index1, dv.index2, dv.ids)

    def _fused_fn(self, n_lanes: int):
        fn = self._fused.get(n_lanes)
        if fn is not None:
            return fn
        chunk = self.chunk
        dv = self.dv
        has_delete = dv.has_delete and dv.space_dfa is not None

        def device_tokenize(text, n, dfa, dout, sdfa, sout, bb_byte,
                            p1, i1t, i2t, ids3):
            return device_pipeline(
                text, n, dfa, dout, sdfa, sout, bb_byte, p1, i1t, i2t, ids3,
                chunk=chunk, n_lanes=n_lanes, has_delete=has_delete,
                has_unk=dv.has_unk, unk_token=dv.unk_token & 0xFFFFFF,
                lil_off=dv.lil_off, pack_follow=self.pack_follow)

        fn = jax.jit(device_tokenize)
        self._fused[n_lanes] = fn
        return fn

    def _t_rec(self, full: bool) -> int:
        """Record rows the device stitch reads per lane.  Typical text emits
        ~1 record per 3.5-4.3 bytes, so chunk//2 + overlap rows cover it
        with margin; denser streams (t_final past the bound) fail sync_ok
        and retry on the ``full`` window, sized for 1 byte per record."""
        chunk = self.chunk
        return (chunk + OVERLAP_SCAN + 64 if full
                else chunk // 2 + OVERLAP_SCAN + 64)

    def _out_cap(self, n_lanes: int, full: bool = False) -> int:
        """Output id-buffer capacity of the stitch fn for this geometry."""
        return 2 * self._t_rec(full) * n_lanes

    def _fused_stitch_fn(self, n_lanes: int, full: bool = False):
        """Fused pipeline + on-device stitch/compaction (ops/stitch.py).

        Returns a jitted fn(text, n, start0, last_lane, final, *tables) ->
        (out_ids, count, missing, start_next, sync_ok)."""
        fn = self._fused_stitch.get((n_lanes, full))
        if fn is not None:
            return fn
        from .stitch import device_stitch
        inner = self._fused_fn(n_lanes)
        dv = self.dv
        t_rec = self._t_rec(full)
        out_cap = self._out_cap(n_lanes, full)

        def run(text, n, start0, last_lane, final, dfa, dout, sdfa, sout,
                bb_byte, p1, i1t, i2t, ids3):
            recs, toks, t_final = inner(
                text, n, dfa, dout, sdfa, sout, bb_byte, p1, i1t, i2t, ids3)
            with jax.named_scope("stitch"):
                out, count, missing, start_next, sync_ok = device_stitch(
                    recs[:t_rec], toks[:t_rec], start0, last_lane, final,
                    dv.delete_token & 0xFFFFFF, out_cap)
            return out, count, missing, start_next, sync_ok & (t_final <= t_rec)

        fn = jax.jit(run)
        self._fused_stitch[(n_lanes, full)] = fn
        return fn

    def _dispatch(self, sl: np.ndarray, exact: int):
        """One fused device call over slice ``sl`` whose first ``exact``
        bytes are this dispatch's exact region (the rest is margin)."""
        from .match import _bucket
        chunk = self.chunk
        lanes = min(_bucket(-(-exact // chunk)), MAX_LANES)
        total = lanes * chunk + MARGIN
        buf = np.zeros(total, np.uint8)
        n_slice = min(len(sl), total)
        buf[:n_slice] = sl[:n_slice]
        recs, toks, t_final = self._fused_fn(lanes)(
            jnp.asarray(buf), n_slice, *self.tables())
        real_lanes = -(-exact // chunk)
        return recs, toks, t_final, real_lanes

    # ---- device-stitched fast path ----

    def _plan(self, n: int):
        """Dispatch plan for ``n`` bytes: (n_lanes, [(off, exact, last_lane)]).

        Single dispatch when the text fits; otherwise fixed-geometry
        dispatches owning (L-1)*chunk bytes each, the last lane of every
        dispatch being re-scanned as the next dispatch's lane 0 (bridge)."""
        from .match import _bucket
        chunk = self.chunk
        lanes_needed = -(-n // chunk)
        if lanes_needed <= MAX_LANES:
            return _bucket(lanes_needed), [(0, n, lanes_needed - 1)]
        L = MAX_LANES
        stride = (L - 1) * chunk
        plan = []
        off = 0
        while off < n:
            exact = min(stride, n - off)
            plan.append((off, exact, -(-exact // chunk) - 1))
            off += stride
        return L, plan

    def stage(self, data: bytes):
        """Pre-upload per-dispatch input buffers; returns an opaque staged
        object for tokenize_staged (used by benches and repeated runs)."""
        n = len(data)
        arr = np.frombuffer(bytes(data), np.uint8)
        L, plan = self._plan(n)
        total = L * self.chunk + MARGIN
        bufs = []
        for off, exact, lr in plan:
            buf = np.zeros(total, np.uint8)
            sl = arr[off:off + total]
            buf[:len(sl)] = sl
            bufs.append((jnp.asarray(buf), min(n - off, total), lr))
        return (n, L, bufs)

    MAX_FUSED_DISPATCHES = 16  # chain length folded into ONE jit call;
                               # longer texts enqueue dispatch by dispatch

    def _run_staged(self, staged, full: bool = False):
        """Enqueue the full chained pipeline; returns per-dispatch device
        outputs (no host sync).  Short chains run as a single fused jit
        call; longer texts fall back to per-dispatch enqueue.  ``full``
        selects the worst-case record-window variant (dense-text retry)."""
        n, L, bufs = staged
        fn = self._fused_stitch_fn(L, full)
        tables = self.tables()
        k = len(bufs)
        if 1 < k <= self.MAX_FUSED_DISPATCHES:
            runk = self._chain_fn(L, k, fn, full)
            flat = runk([b for b, _n, _l in bufs],
                        jnp.asarray([n_slice for _b, n_slice, _l in bufs],
                                    jnp.int32),
                        jnp.asarray([lr for _b, _n, lr in bufs], jnp.int32),
                        *tables)
            return [tuple(flat[4 * i:4 * i + 4]) for i in range(k)]
        start0 = jnp.int32(0)
        outs = []
        for i, (buf, n_slice, lr) in enumerate(bufs):
            final = jnp.bool_(i == k - 1)
            out, count, missing, start_next, sync_ok = fn(
                buf, jnp.int32(n_slice), start0, jnp.int32(lr), final,
                *tables)
            outs.append((out, count, missing, sync_ok))
            start0 = start_next
        return outs

    def _chain_fn(self, n_lanes: int, k: int, inner, full: bool = False):
        """Jitted k-dispatch chain: the bridge skip flows as a traced
        scalar, one device call for the whole text."""
        key = (n_lanes, k, full)
        fn = self._chains.get(key)
        if fn is not None:
            return fn

        def run_all(bufs, ns, lrs, *tables):
            start0 = jnp.int32(0)
            outs = []
            for i in range(k):
                final = jnp.bool_(i == k - 1)
                out, count, missing, start_next, sync_ok = inner(
                    bufs[i], ns[i], start0, lrs[i], final, *tables)
                outs += [out, count, missing, sync_ok]
                start0 = start_next
            return outs

        fn = jax.jit(run_all)
        self._chains[key] = fn
        return fn

    def _meta_concat_fns(self, k: int, out_cap: int = 0):
        """Jitted helpers per dispatch count: one (3k,) scalar-metadata
        fetch (counts|missing|sync in one transfer) and a device-side dense
        concat of the per-dispatch valid prefixes, downloaded at the
        narrowest width that fits (u16 when the id space allows, else
        24-bit packed u8)."""
        fns = self._finalize.get((k, out_cap))
        if fns is not None:
            return fns

        def meta(counts, missings, syncs):
            return jnp.concatenate([
                jnp.stack(counts).astype(jnp.int32),
                jnp.stack(missings).astype(jnp.int32),
                jnp.stack([s.astype(jnp.int32) for s in syncs])])

        narrow = len(self.vocab.reverse) <= 65536

        def concat(outs, counts):
            with jax.named_scope("concat"):
                total_cap = sum(o.shape[0] for o in outs)
                cat = jnp.zeros(total_cap, jnp.uint32)
                off = jnp.int32(0)
                # each dispatch's padded buffer lands at the running offset;
                # the next write starts at off+count, overwriting the pad
                for i in range(len(outs)):
                    cat = jax.lax.dynamic_update_slice(cat, outs[i], (off,))
                    off = off + counts[i]
                if narrow:
                    return cat.astype(jnp.uint16)
                p = jnp.stack([cat & 0xFF, (cat >> 8) & 0xFF,
                               (cat >> 16) & 0xFF], axis=1)
                return p.reshape(-1).astype(jnp.uint8)

        fns = (jax.jit(meta), jax.jit(concat))
        self._finalize[(k, out_cap)] = fns
        return fns

    def tokenize_staged(self, staged, full: bool = False):
        """Run the device pipeline on staged buffers and download the dense
        id stream.  Returns (ids, missing) or None if no device variant
        synced (caller falls back to the host stitcher).  A fast-window
        overflow (dense text) retries once on the full-window variant;
        ``self.last_mode`` records which variant produced the result."""
        outs = self._run_staged(staged, full)
        k = len(outs)
        meta_fn, concat_fn = self._meta_concat_fns(
            k, int(outs[0][0].shape[0]))
        meta = np.asarray(meta_fn([o[1] for o in outs],
                                  [o[2] for o in outs],
                                  [o[3] for o in outs]))
        counts, missings, syncs = meta[:k], meta[k:2 * k], meta[2 * k:]
        if not syncs.all():
            if not full:
                return self.tokenize_staged(staged, full=True)
            return None
        self.last_mode = "full" if full else "fast"
        missing = int(missings.sum())
        total = int(counts.sum())
        if total <= 0:
            return np.zeros(0, np.uint32), missing
        id_part = concat_fn([o[0] for o in outs], jnp.asarray(counts))
        narrow = len(self.vocab.reverse) <= 65536
        if narrow:
            b = min(-(-total // 65536) * 65536, id_part.shape[0])
            ids = np.asarray(id_part[:b])[:total].astype(np.uint32)
        else:
            b = min(-(-total // 65536) * 65536, id_part.shape[0] // 3)
            packed = np.asarray(id_part[:b * 3]).reshape(-1, 3) \
                .astype(np.uint32)
            ids = (packed[:, 0] | (packed[:, 1] << 8)
                   | (packed[:, 2] << 16))[:total]
        return ids, missing

    def tokenize(self, data: bytes):
        """Tokenize normalized+capcoded bytes; returns (ids u32, missing)."""
        n = len(data)
        if n == 0 or self.vocab.max_token_length == 0:
            return np.zeros(0, np.uint32), 0
        res = self.tokenize_staged(self.stage(data))
        if res is None:
            self.last_mode = "hoststitch"
            return self._tokenize_hoststitch(data)
        return res

    # ---- host-stitched path (exact fallback) ----

    def _tokenize_hoststitch(self, data: bytes):
        vocab = self.vocab
        n = len(data)
        if n == 0 or vocab.max_token_length == 0:
            return np.zeros(0, np.uint32), 0
        arr = np.frombuffer(bytes(data), np.uint8)
        chunk = self.chunk
        mega = MAX_LANES * chunk

        pending = []  # (device outputs, real_lanes, global offset)
        results = []  # (pos64, flags, toks, lane_starts) per dispatch
        offset = 0
        while offset < n:
            exact = min(mega, n - offset)
            out = self._dispatch(arr[offset:offset + mega + MARGIN], exact)
            pending.append((out, offset))
            if len(pending) > 1:
                results.append(self._materialize(*pending.pop(0)))
            offset += exact
        while pending:
            results.append(self._materialize(*pending.pop(0)))

        t_max = max(r[0].shape[1] for r in results)
        L_total = sum(r[0].shape[0] for r in results)

        def padded(i, dtype):
            out = np.zeros((L_total, t_max), dtype)
            row = 0
            for r in results:
                a = r[i]
                out[row:row + a.shape[0], :a.shape[1]] = a
                row += a.shape[0]
            return out

        pos = padded(0, np.int64)
        flags = padded(1, np.uint8)
        toks = padded(2, np.uint32)
        lane_starts = np.concatenate([r[3] for r in results])
        return self._stitch(arr, pos, flags, toks, n, lane_starts)

    def _materialize(self, out, offset: int):
        recs, toks, t_final, real_lanes = out
        t_final = int(t_final)
        recs = np.asarray(recs[:t_final]).T[:real_lanes]   # (L, T)
        toks = np.asarray(toks[:t_final]).T[:real_lanes]
        pos = (recs >> 4).astype(np.int64) + offset
        flags = (recs & 0xF).astype(np.uint8)
        pos[flags == 0] = 0
        lane_starts = (offset
                       + np.arange(real_lanes, dtype=np.int64) * self.chunk)
        return pos, flags, toks, lane_starts

    # ---- host stitcher ----

    def _stitch(self, data, pos, flags, toks, n, lane_starts):
        """pos/flags/toks: (L, T) with pos in GLOBAL byte coordinates
        (lanes from every dispatch concatenated).  Returns (ids, missing).

        Vectorised: junction syncs are found with one batched searchsorted
        (the first shared emission state is almost always within the first
        few records of the next lane); the token stream is materialised with
        global cumsum + scatter.  Junctions that do not sync within the
        probe window fall back to the exact per-lane two-pointer search."""
        L, T = pos.shape
        if L == 1:
            return self._stitch_slow(data, pos, flags, toks, n, lane_starts)
        valid = flags != 0
        state = (pos << 1) | (flags & _REC_FD)          # (L, T)
        lane_ids = np.arange(L, dtype=np.int64)
        # per-row valid records are a contiguous prefix (lanes stop emitting
        # once done), strictly increasing in pos — no compaction needed
        n_valid = valid.sum(axis=1)
        row_off = np.arange(L, dtype=np.int64) * T
        # replace invalid tail with +inf-like keys to keep rows ascending
        # (valid states are < 2^34, far below the 2^39 sentinel)
        inf_key = (lane_ids[:, None] << 40) | (np.int64(1) << 39)
        keyed_sorted = np.where(valid, (lane_ids[:, None] << 40) | state,
                                inf_key)
        flat_sorted = keyed_sorted.reshape(-1)

        K = 8
        b_first = keyed_sorted[1:, :K]                 # (L-1, K) queries
        qvalid = np.arange(K)[None, :] < n_valid[1:, None]
        # membership of lane l+1's first K states in lane l's records
        q = (b_first - (np.int64(1) << 40))            # shift to lane l keyspace
        idx = np.searchsorted(flat_sorted, q.reshape(-1)).reshape(L - 1, K)
        idx_c = np.minimum(idx, L * T - 1)
        hit = (flat_sorted[idx_c] == q) & qvalid
        # exclude hits pointing into the wrong lane row
        hit &= (idx_c // T) == np.arange(L - 1)[:, None]
        first_col = np.where(hit.any(axis=1), hit.argmax(axis=1), -1)

        if (first_col < 0).any():
            return self._stitch_slow(data, pos, flags, toks, n, lane_starts)

        ar = np.arange(L - 1)
        sync_idx_a = idx_c[ar, first_col] - row_off[:-1]   # index in lane l
        # keep ranges: lane 0: [0, sync_0]; lane l: (sync_{l-1 in b}, sync_l]
        end_rec = np.empty(L, np.int64)
        end_rec[:-1] = sync_idx_a
        end_rec[-1] = n_valid[-1] - 1
        start_rec = np.empty(L, np.int64)
        start_rec[0] = 0
        start_rec[1:] = first_col + 1

        t_idx = np.arange(T)[None, :]
        keep = ((t_idx >= start_rec[:, None]) & (t_idx <= end_rec[:, None])
                & (t_idx < n_valid[:, None]))
        has_tok = ((flags & _REC_TOK) != 0) & keep
        has_del = ((flags & _REC_DEL) != 0) & keep
        missing = int((((flags & _REC_MISS) != 0) & keep).sum())
        counts = has_tok.astype(np.int64) + has_del.astype(np.int64)
        flat_counts = counts.reshape(-1)
        ends = np.cumsum(flat_counts)
        total_out = int(ends[-1])
        starts_out = ends - flat_counts
        out = np.empty(total_out, np.uint32)
        ht = has_tok.reshape(-1)
        hd = has_del.reshape(-1)
        out[starts_out[ht]] = toks.reshape(-1)[ht]
        out[(ends - 1)[hd]] = np.uint32(self.dv.delete_token)
        return out, missing

    def _stitch_slow(self, data, pos, flags, toks, n, lane_starts):
        """Reference per-lane stitcher (exact two-pointer sync search)."""
        out_parts = []
        missing = 0
        delete_token = np.uint32(self.dv.delete_token)
        n_lanes = pos.shape[0]

        lane_recs = []
        for l in range(n_lanes):
            v = flags[l] != 0
            lane_recs.append((flags[l][v], toks[l][v], pos[l][v]))

        # sync_pos[l]: first common (pos, fd) state between lane l-1 and l
        prev_cut = 0  # index into lane 0's records from which output starts
        for l in range(n_lanes):
            f, t, p = lane_recs[l]
            if l + 1 < n_lanes:
                nf, nt, np_ = lane_recs[l + 1]
                j_next = lane_starts[l + 1]
                # states packed as pos*2+fd
                a = (p << 1) | (f & _REC_FD)
                b = (np_ << 1) | (nf & _REC_FD)
                common = np.intersect1d(a[p >= j_next], b)
                if len(common) == 0:
                    # pathological junction: fall back to host oracle from
                    # the end of this lane's exact region
                    return self._host_fallback(data)
                sync = common[0]
                end_idx = int(np.searchsorted(a, sync, side="right"))
                start_next = int(np.searchsorted(b, sync, side="right"))
            else:
                end_idx = len(f)
                start_next = 0
            seg_f = f[prev_cut:end_idx]
            seg_t = t[prev_cut:end_idx]
            has_tok = (seg_f & _REC_TOK) != 0
            has_del = (seg_f & _REC_DEL) != 0
            missing += int(((seg_f & _REC_MISS) != 0).sum())
            n_out = int(has_tok.sum() + has_del.sum())
            if n_out:
                buf = np.empty(n_out, np.uint32)
                # interleave: token, then delete marker where flagged
                idx = np.cumsum(has_tok.astype(np.int64) + has_del.astype(np.int64))
                tok_slots = idx - 1 - has_del.astype(np.int64)
                buf[tok_slots[has_tok]] = seg_t[has_tok]
                buf[idx[has_del] - 1] = delete_token
                out_parts.append(buf)
            prev_cut = start_next

        if out_parts:
            ids = np.concatenate(out_parts)
        else:
            ids = np.zeros(0, np.uint32)
        return ids, missing

    def _host_fallback(self, data):
        from ..core.tokenizer import tokenize as host_tokenize
        self.last_mode = "oracle"
        return host_tokenize(self.vocab, bytes(data))
