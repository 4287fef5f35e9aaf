"""Distributed vocabulary-scoring step: the device mapping of trainvocab's
worker pool (training/trainvocab.go:505-1322, §2.3 of SURVEY).

The reference runs N CPU worker goroutines, each tokenizing its own corpus
strips with a candidate vocabulary and accumulating per-token "chars covered"
scores.  Here the corpus is sharded across the device mesh ("data" axis),
the candidate vocabulary tables are replicated, every device runs the
match + scan kernels over its shard (each lane chunk = an independent strip,
mirroring the reference's strip segmentation), and the per-token score
vector and token counts are reduced with jax.lax.psum across devices.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.match import match_strips
from ..ops.scan import _REC_DEL, _REC_MISS, _REC_TOK, scan_lanes


def _shard_score(text_shard, dfa, dout, sdfa, sout, bb_byte,
                 p1, index1_t, index2_t, ids3,
                 *, chunk: int, has_delete: bool, delete_token: int,
                 n_ids: int):
    """Score one corpus shard. text_shard: uint8[S] with S = lanes*chunk."""
    S = text_shard.shape[0]
    n_lanes = S // chunk

    # phase 1: strip-local match tables (no match crosses a strip boundary)
    text2d = text_shard.reshape(n_lanes, chunk)
    pad = jnp.zeros(64, jnp.uint32)
    m_tab = jnp.concatenate([match_strips(dfa, dout, text2d).reshape(-1), pad])
    if has_delete:
        mb_tab = jnp.concatenate(
            [match_strips(sdfa, sout, text2d).reshape(-1), pad])
    else:
        mb_tab = m_tab
    bb = jnp.concatenate([
        jnp.take(bb_byte, text_shard.astype(jnp.int32)),
        jnp.full(64, bb_byte[0], jnp.int32)])

    # phase 2: independent-strip scan (overlap=0: exact per-strip streams)
    recs, toks, _t_final = scan_lanes(
        m_tab, mb_tab, bb, p1, index1_t, index2_t, ids3,
        S, chunk, n_lanes, has_delete, False, delete_token, 0,
        overlap=0, strip_mode=True)

    # accumulate scores: chars covered per emitted token id
    # (trainvocab.go:1109-1157)
    pos = (recs >> 4).astype(jnp.int32)           # (T, L) pos_after
    starts = jnp.arange(n_lanes, dtype=jnp.int32) * chunk
    prev = jnp.concatenate([starts[None, :], pos[:-1]], axis=0)
    covered = jnp.where(recs != 0, pos - prev, 0)
    has_tok = (recs & _REC_TOK) != 0
    has_del = (recs & _REC_DEL) != 0
    miss = (recs & _REC_MISS) != 0

    flat_ids = jnp.where(has_tok & ~miss, toks, n_ids).reshape(-1)
    flat_cov = jnp.where(has_tok & ~miss, covered, 0).reshape(-1)
    scores = jnp.zeros(n_ids + 1, jnp.int32).at[flat_ids].add(flat_cov)
    scores = scores[:n_ids]
    n_tokens = (has_tok.astype(jnp.int32) + has_del.astype(jnp.int32)).sum()
    n_missing = miss.astype(jnp.int32).sum()
    return scores, n_tokens, n_missing


def make_distributed_score_step(mesh: Mesh, chunk: int, has_delete: bool,
                                delete_token: int, n_ids: int,
                                axis: str = "data"):
    """Build a jitted, mesh-sharded scoring step.

    Returns step(text, tables...) -> (scores[n_ids], tokens, missing), with
    `text` sharded over the mesh data axis and all tables replicated; the
    outputs are psum-reduced over the mesh, identical on every device.
    """
    kernel = functools.partial(
        _shard_score, chunk=chunk, has_delete=has_delete,
        delete_token=delete_token, n_ids=n_ids)

    def step(text, dfa, dout, sdfa, sout, bb_byte, p1, i1, i2, ids3):
        scores, n_tok, n_miss = kernel(
            text, dfa, dout, sdfa, sout, bb_byte, p1, i1, i2, ids3)
        return (jax.lax.psum(scores, axis),
                jax.lax.psum(n_tok, axis),
                jax.lax.psum(n_miss, axis))

    spec_data = P(axis)
    spec_rep = P()
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(spec_data,) + (spec_rep,) * 9,
        out_specs=(spec_rep, spec_rep, spec_rep),
        check_vma=False)
    return jax.jit(sharded)


def device_tables_for_scoring(vocab):
    """Replicated table tuple for make_distributed_score_step."""
    from ..ops.scan import DeviceVocab
    dv = DeviceVocab.build(vocab)
    sdfa = dv.space_dfa if dv.space_dfa is not None else dv.main_dfa
    sout = dv.space_out if dv.space_out is not None else dv.main_out
    return dv, (dv.main_dfa, dv.main_out, sdfa, sout,
                jnp.asarray(vocab.begin_byte.astype(np.int32)),
                dv.p1, dv.index1, dv.index2, dv.ids)


# ---- exact (decision-equivalent) strip scorer ----------------------------
#
# The lane-reset scorer above treats every 2048-byte lane as an independent
# strip; the reference worker tokenizes each corpus strip *contiguously*
# (trainvocab.go:924-1176), so votes can differ.  The exact scorer below
# runs the full chunk-parallel pipeline + device stitch per strip (byte-
# exact vs the sequential tokenizer) and accumulates chars-covered over the
# spliced stream — same deletions as the native backend, strip for strip.
# Distribution model: whole strips are data-parallel across the mesh
# (mirroring the reference's worker pool); scores/counts/missing-byte masks
# psum over the mesh.

def _pow2(x: int) -> int:
    b = 1
    while b < x:
        b <<= 1
    return b


def pad_tables_for_scoring(vocab, states_bucket=None, ids_bucket=None):
    """Device tables padded to pow2 buckets so the jitted scoring step's
    shapes — and hence its compilation — are stable across candidate
    vocabularies of similar size (the trainer builds a new candidate every
    round; an unpadded table shape would force a recompile each time)."""
    from ..ops.automaton import ALPHA
    from ..ops.scan import DeviceVocab
    dv = DeviceVocab.build(vocab)

    def pad_dfa(dfa, out):
        n_states = out.shape[0]
        cap = states_bucket or _pow2(n_states)
        cap = max(cap, n_states)
        dfa = jnp.concatenate(
            [dfa, jnp.zeros((cap - n_states) * ALPHA, dfa.dtype)])
        out = jnp.concatenate([out, jnp.zeros(cap - n_states, out.dtype)])
        return dfa, out

    mdfa, mout = pad_dfa(dv.main_dfa, dv.main_out)
    if dv.space_dfa is not None:
        sdfa, sout = pad_dfa(dv.space_dfa, dv.space_out)
    else:
        sdfa, sout = mdfa, mout

    n = dv.p1.shape[0]
    cap = max(ids_bucket or _pow2(n), n)

    def pad1(a):
        return jnp.concatenate([a, jnp.zeros(cap - n, a.dtype)])

    p1 = pad1(dv.p1)
    i1 = pad1(dv.index1)
    i2 = pad1(dv.index2)
    ids3 = jnp.concatenate(
        [dv.ids, jnp.zeros((cap - n, 3), dv.ids.dtype)], axis=0)
    bb = jnp.asarray(vocab.begin_byte.astype(np.int32))
    return dv, (mdfa, mout, sdfa, sout, bb, p1, i1, i2, ids3)


def exact_score_geometry(max_strip_len: int, chunk: int):
    """(lanes, dispatches, buffer) for strips up to max_strip_len bytes."""
    from ..ops.scan import MARGIN, MAX_LANES
    lanes = max(2, min(MAX_LANES, _pow2(-(-max_strip_len // chunk))))
    stride = (lanes - 1) * chunk
    dispatches = max(1, -(-max_strip_len // stride))
    buf = dispatches * stride + chunk + MARGIN
    return lanes, dispatches, buf


def make_exact_score_step(mesh: Mesh, chunk: int, lanes: int,
                          dispatches: int, n_ids_cap: int,
                          has_delete: bool, delete_token: int,
                          lil_off: int = 1, axis="data"):
    """Jitted mesh-sharded exact scorer: one whole strip per device per call.

    step(text (n_dev, B) u8, n (n_dev,) i32, *tables) ->
      (scores i32[n_ids_cap], n_tokens i32, miss_mask i32[256], sync_ok)
    all psum/all-reduced over the mesh.  ``axis`` may be a single mesh axis
    name or a tuple — e.g. ("hosts", "data") reduces over both axes of a
    two-level (process, device) mesh.
    """
    from ..ops.scan import MARGIN, device_pipeline
    from ..ops.stitch import device_stitch_score
    stride = (lanes - 1) * chunk
    total = lanes * chunk + MARGIN

    def one_strip(text, n, dfa, dout, sdfa, sout, bb, p1, i1, i2, ids3):
        scores = jnp.zeros(n_ids_cap, jnp.int32)
        n_tok = jnp.int32(0)
        miss_mask = jnp.zeros(256, jnp.int32)
        ok = jnp.bool_(True)
        start0 = jnp.int32(0)
        for d in range(dispatches):
            off = d * stride
            sl = jax.lax.dynamic_slice(text, (off,), (total,))
            rem = n - off
            n_slice = jnp.clip(rem, 0, total)
            exact = jnp.clip(rem, 0, stride)
            lr = jnp.clip(-(-exact // chunk) - 1, 0, lanes - 1)
            final_d = rem <= stride
            recs, toks, _t = device_pipeline(
                sl, n_slice, dfa, dout, sdfa, sout, bb, p1, i1, i2, ids3,
                chunk=chunk, n_lanes=lanes, has_delete=has_delete,
                has_unk=False, unk_token=0, lil_off=lil_off)
            s, nt, mm, start_next, sok = device_stitch_score(
                recs, toks, sl, start0, lr, final_d, n_ids_cap, chunk,
                delete_token=delete_token)
            live = rem > 0
            scores = scores + jnp.where(live, s, 0)
            n_tok = n_tok + jnp.where(live, nt, 0)
            miss_mask = miss_mask + jnp.where(live, mm, 0)
            ok = ok & (sok | ~live)
            start0 = start_next
        return scores, n_tok, miss_mask, ok

    def step(text, n, *tables):
        scores, n_tok, mm, ok = one_strip(text[0], n[0], *tables)
        # sync_ok across every device: count-of-ok == device count
        n_dev_total = jax.lax.psum(jnp.int32(1), axis)
        ok_all = jax.lax.psum(ok.astype(jnp.int32), axis) == n_dev_total
        return (jax.lax.psum(scores, axis),
                jax.lax.psum(n_tok, axis),
                jax.lax.psum(mm, axis),
                ok_all)

    spec_text = P(axis, None)
    spec_n = P(axis)
    spec_rep = P()
    sharded = jax.shard_map(
        step, mesh=mesh,
        in_specs=(spec_text, spec_n) + (spec_rep,) * 9,
        out_specs=(spec_rep, spec_rep, spec_rep, spec_rep),
        check_vma=False)
    return jax.jit(sharded)
