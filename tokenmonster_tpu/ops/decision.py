"""Decision-table tokenization: position-parallel ungreedy branch evaluation.

The reference tokenize loop (go/tokenmonster.go:1048-1277) is sequential —
one 6-branch evaluation per emitted token.  Its automaton state at every
emission is exactly ``(position, forwardDelete)`` (see ops/scan.py), so the
*transition function* can be precomputed for EVERY position and both fd
values as a fully parallel map over the text (phase A), after which
tokenization degenerates to following a pointer chain with one tiny gather
per emitted token (phase B).

Phase A trades ~4x redundant branch evaluations (every position instead of
every ~4.3-byte token step) for complete data-parallelism: all dictionary /
metadata lookups become large batched gathers instead of serializing into
the scan's per-step latency.
Phase B keeps the speculative chunk-lane + host-stitch structure of
ops/scan.py (lanes start at chunk boundaries with state (start, 0); the
first shared (pos, fd) state with the neighbouring lane is an exact sync
point), so outputs remain byte-exact vs the sequential oracle.

Decision-record packing (u32), one per (fd, position):
  ctl = delta(6 bits) | fd'<<6 | has_tok<<7 | has_del<<8 | miss<<9
  tok = emitted primary token id (u32; delete-token emission is has_del)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .scan import _REC_DEL, _REC_FD, _REC_MISS, _REC_TOK, ungreedy_step

CTL_FD = 1 << 6
CTL_TOK = 1 << 7
CTL_DEL = 1 << 8
CTL_MISS = 1 << 9


def decision_tables(m_tab, mb_tab, bb, p1, index1_t, index2_t, ids3,
                    n, has_delete: bool, has_unk: bool, unk_token: int,
                    lil_off: int = 1):
    """Compute the (2, P) decision tables over all positions.

    P = len(m_tab) (the match tables' padded length).  Row 0 is the fd=0
    transition, row 1 the fd=1 transition (identical to row 0 when the
    vocabulary has no delete token).  Returns (ctl, tok), both u32[2, P].
    Every table lookup is a batched gather (see scan.ungreedy_step).
    """
    P = m_tab.shape[0]
    pos = jnp.arange(P, dtype=jnp.int32)

    def one(fd_val: int):
        fd = jnp.full((P,), fd_val, jnp.int32)
        new_pos, new_fd, has_tok, is_b, miss, tok = ungreedy_step(
            pos, fd, m_tab, mb_tab, bb, p1, index1_t, index2_t, ids3,
            n, n, has_delete, has_unk, unk_token, lil_off)
        delta = jnp.clip(new_pos - jnp.minimum(pos, n), 1, 63)
        ctl = (delta.astype(jnp.uint32)
               | (new_fd.astype(jnp.uint32) << 6)
               | (has_tok.astype(jnp.uint32) << 7)
               | (is_b.astype(jnp.uint32) << 8)
               | (miss.astype(jnp.uint32) << 9))
        return ctl, tok

    ctl0, tok0 = one(0)
    if has_delete:
        ctl1, tok1 = one(1)
    else:
        ctl1, tok1 = ctl0, tok0
    return jnp.stack([ctl0, ctl1]), jnp.stack([tok0, tok1])


def follow_lanes(ctl, tok, n, chunk: int, n_lanes: int, overlap: int,
                 packed: bool = False):
    """Phase B: follow the decision chain per speculative chunk lane.

    Same output contract as ops/scan.py::scan_lanes — packed step records
    (rec) and emitted ids (tokens) of shape (T, L) plus the step count — so
    the host stitcher is shared.  Each step is two gathers of L elements,
    or ONE with ``packed`` (token id folded into ctl bits 10..31 — valid
    whenever every id < 2^22; decided statically by the caller)."""
    L = n_lanes
    T = chunk + overlap
    P = ctl.shape[1]
    if packed:
        ctl_f = (ctl | (tok << 10)).reshape(-1)
        tok_f = None
    else:
        ctl_f = ctl.reshape(-1)
        tok_f = tok.reshape(-1)
    starts = jnp.arange(L, dtype=jnp.int32) * chunk
    stops = jnp.minimum(starts + chunk + overlap, n)

    recs0 = jnp.zeros((T, L), jnp.uint32)
    toks0 = jnp.zeros((T, L), jnp.uint32)

    def cond(state):
        t, pos, fd, done, recs, toks = state
        return (t < T) & ~jnp.all(done)

    def body(state):
        t, pos, fd, done, recs, toks = state
        at = fd * P + jnp.minimum(pos, P - 1)
        w = jnp.take(ctl_f, at)
        tk = (w >> 10) if packed else jnp.take(tok_f, at)
        new_pos = jnp.minimum(pos, n) + (w & 63).astype(jnp.int32)
        new_fd = ((w >> 6) & 1).astype(jnp.int32)
        has_tok = ((w & CTL_TOK) != 0) & ~done
        has_del = ((w & CTL_DEL) != 0) & ~done
        miss = ((w & CTL_MISS) != 0) & ~done
        rec = ((new_pos.astype(jnp.uint32) << 4)
               | (new_fd.astype(jnp.uint32) * _REC_FD)
               | (has_tok.astype(jnp.uint32) * _REC_TOK)
               | (has_del.astype(jnp.uint32) * _REC_DEL)
               | (miss.astype(jnp.uint32) * _REC_MISS))
        rec = jnp.where(done, 0, rec)
        new_done = done | (new_pos >= stops)
        new_pos = jnp.where(done, pos, new_pos)
        new_fd = jnp.where(done, fd, new_fd)
        recs = jax.lax.dynamic_update_slice(recs, rec[None, :], (t, 0))
        toks = jax.lax.dynamic_update_slice(toks, tk[None, :], (t, 0))
        return (t + 1, new_pos, new_fd, new_done, recs, toks)

    init = (jnp.int32(0), starts, jnp.zeros(L, jnp.int32), starts >= stops,
            recs0, toks0)
    t_final, _, _, _, recs, toks = jax.lax.while_loop(cond, body, init)
    return recs, toks, t_final


def chain_follow_host(ctl, tok, n: int, delete_token: int):
    """Host reference: follow the chain from (0, 0); returns (ids, missing).

    Used by tests to validate decision tables directly against the oracle
    tokenizer without lanes or stitching.
    """
    import numpy as np

    ctl = np.asarray(ctl)
    tok = np.asarray(tok)
    out = []
    missing = 0
    pos, fd = 0, 0
    while pos < n:
        w = int(ctl[fd, pos])
        t = int(tok[fd, pos])
        if w & CTL_TOK:
            out.append(t)
        if w & CTL_DEL:
            out.append(delete_token)
        if w & CTL_MISS:
            missing += 1
        pos += w & 63
        fd = (w >> 6) & 1
    return np.asarray(out, np.uint32), missing
