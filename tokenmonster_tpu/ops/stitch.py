"""Device-side stitching + compaction for the chunk-parallel tokenizer.

The host stitcher (ops/scan.py::DeviceTokenizer._stitch) downloads the full
(T, L) record/token grids per dispatch — ~9 MB per 1 MB of text — and
reconciles lane junctions on the host.  This module moves the whole
reconciliation on device: junction sync search, keep-range masking, token
stream compaction — so a dispatch returns a dense id buffer plus four
scalars, and the only download is the id stream itself.

Cross-dispatch junctions use a one-lane-overlap scheme: each dispatch owns
lanes 0..L-2 and re-scans its last chunk as the next dispatch's lane 0 (the
"bridge").  The junction between lanes L-2 and L-1 is resolved inside the
current dispatch; the number of bridge records to skip (``start_next``)
flows to the next dispatch as a device scalar, so the whole pipeline chains
with no host round-trips.

Junction semantics match the host stitcher exactly: the automaton state at
every emission is ``(position, forwardDelete)`` (see ops/scan.py); any state
shared by neighbouring lanes is an exact splice point because the transition
function is deterministic (go/tokenmonster.go:1048-1277).

``device_stitch_score`` is the trainer epilogue: instead of materialising
ids it accumulates per-token chars-covered scores over the *spliced* stream,
making the device scoring backend decision-equivalent to the native contiguous
tokenizer (trainvocab.go:1109-1157).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .scan import _REC_DEL, _REC_FD, _REC_MISS, _REC_TOK

# First K records of the right lane probed for a state shared with the left
# lane.  A typical-text bound, not a worst case: at ~4 bytes per record, 32
# records span about the OVERLAP_SCAN bytes the left lane scans past its
# chunk end, but a dense junction (up to one record per byte) can sync later.
# Such a junction reports sync_ok False and the dispatch is stitched by the
# exact host stitcher instead (DeviceTokenizer.last_mode == "hoststitch").
SYNC_PROBE = 32


def stitched_keep(recs, start0, last_lane, final, probe: int = SYNC_PROBE,
                  want_ranges: bool = False):
    """Junction sync search + keep-range masking over a lane record grid.

    Args:
      recs: (T, L) u32 step records (rows past t_final are zero = invalid).
      start0: i32 scalar — records to skip at the head of lane 0 (the
        bridge-lane skip exported by the previous dispatch; 0 for the first).
      last_lane: i32 scalar — index of the last *owned* lane (inclusive).
        Lanes past it contribute nothing.
      final: bool scalar — True for the last dispatch of a text, where the
        last owned lane keeps its full record tail (end of data).  In
        chained dispatches it instead ends at its junction with the bridge
        lane, whose record skip is exported as ``start_next``.

    Returns (flags, keep, start_next, sync_ok): flags u32 (T, L) low record
    bits; keep bool (T, L); start_next i32; sync_ok bool (False when an
    owned junction found no shared state within ``probe`` records).
    """
    T, L = recs.shape
    flags = recs & 0xF
    valid = flags != 0
    # state = (pos << 1) | fd — strictly increasing within a lane
    state = ((recs >> 4) << 1) | (recs & _REC_FD)
    n_valid = valid.sum(axis=0).astype(jnp.int32)            # (L,)
    lane_ids = jnp.arange(L, dtype=jnp.int32)

    if L > 1:
        sa = state[:, :-1]                                   # (T, L-1)
        va = valid[:, :-1]
        sb = state[:probe, 1:]                               # (K, L-1)
        vb = valid[:probe, 1:]
        hit = (sa[:, None, :] == sb[None, :, :]) \
            & va[:, None, :] & vb[None, :, :]                # (T, K, L-1)
        hit_k = hit.any(axis=0)                              # (K, L-1)
        sync_exists = hit_k.any(axis=0)                      # (L-1,)
        kstar = jnp.argmax(hit_k, axis=0).astype(jnp.int32)  # first k hit
        # hit row at kstar via masked any-reduce over the K axis (a
        # take_along_axis here lowers to ~T*L scalar gathers; the
        # select+reduce is pure vector work)
        k_iota = jnp.arange(probe, dtype=jnp.int32)[None, :, None]
        hit_at_k = jnp.any(hit & (k_iota == kstar[None, None, :]),
                           axis=1)                           # (T, L-1)
        tstar = jnp.argmax(hit_at_k, axis=0).astype(jnp.int32)

        end_rec = jnp.concatenate([tstar, jnp.zeros(1, jnp.int32)])
        start_rec = jnp.concatenate(
            [jnp.asarray(start0, jnp.int32).reshape(1), kstar + 1])
        # required junctions: l < last_lane, plus the bridge junction
        # (l == last_lane) when this dispatch chains into the next
        need = jnp.arange(L - 1) < jnp.where(final, last_lane,
                                             last_lane + 1)
        sync_ok = jnp.all(sync_exists | ~need)
        start_next = kstar[L - 2] + 1
    else:
        end_rec = jnp.zeros(1, jnp.int32)
        start_rec = jnp.asarray(start0, jnp.int32).reshape(1)
        sync_ok = jnp.bool_(True)
        start_next = jnp.int32(0)

    # in the final dispatch the last owned lane keeps everything it recorded
    end_rec = jnp.where(final & (lane_ids == last_lane), n_valid - 1,
                        end_rec)

    t_idx = jnp.arange(T, dtype=jnp.int32)[:, None]          # (T, 1)
    keep = (valid
            & (t_idx >= start_rec[None, :])
            & (t_idx <= end_rec[None, :])
            & (lane_ids[None, :] <= last_lane))
    if want_ranges:
        # per-lane kept ranges for the in-kernel compactor; excluded lanes
        # get an empty (end < start) window
        end_m = jnp.where(lane_ids <= last_lane, end_rec, -1)
        return flags, keep, start_next, sync_ok, start_rec, end_m
    return flags, keep, start_next, sync_ok


def device_stitch(recs, toks, start0, last_lane, final, delete_token: int,
                  out_cap: int, probe: int = SYNC_PROBE):
    """Stitch lane record grids into a dense token stream, on device.

    recs/toks: (T, L) u32 from follow_lanes/scan_lanes; see stitched_keep
    for start0/last_lane/final.  Returns (out, count, missing, start_next,
    sync_ok): out u32[out_cap] dense ids; count i32 valid prefix length;
    missing i32.  On sync_ok == False the caller must fall back to the exact
    host stitcher.
    """
    flags, keep, start_next, sync_ok = stitched_keep(
        recs, start0, last_lane, final, probe)
    has_tok = ((flags & _REC_TOK) != 0) & keep
    has_del = ((flags & _REC_DEL) != 0) & keep
    missing = (((flags & _REC_MISS) != 0) & keep).sum().astype(jnp.int32)

    # lane-major compaction: output order = lane 0 segment, lane 1, ...
    counts = (has_tok.astype(jnp.int32) + has_del.astype(jnp.int32)).T
    counts_f = counts.reshape(-1)                            # (L*T,)
    ends = jnp.cumsum(counts_f)
    total = ends[-1] if counts_f.size else jnp.int32(0)
    starts_f = ends - counts_f
    ht = has_tok.T.reshape(-1)
    hd = has_del.T.reshape(-1)
    toks_f = toks.T.reshape(-1)

    cap = jnp.int32(out_cap)
    out = jnp.zeros(out_cap, jnp.uint32)
    idx_tok = jnp.where(ht, starts_f, cap)
    idx_del = jnp.where(hd, ends - 1, cap)
    out = out.at[idx_tok].set(toks_f, mode="drop")
    out = out.at[idx_del].set(jnp.uint32(delete_token), mode="drop")
    return out, total.astype(jnp.int32), missing, start_next, sync_ok


def device_stitch_score(recs, toks, text, start0, last_lane, final,
                        n_ids: int, chunk: int, delete_token: int = 0,
                        probe: int = SYNC_PROBE):
    """Trainer epilogue: chars-covered score accumulation over the spliced
    stream — exact native-scorer semantics (tm_native.cpp tokenize_impl
    rec(): primary token += consumed bytes, the delete marker itself += 1,
    tokensInText counts missing bytes as 1; trainvocab.go:1105-1160).

    The kept records of all lanes form exactly the sequential tokenizer's
    record stream, and each record's predecessor position equals the same
    lane's previous record position (the skipped sync record shares its
    state with the left lane's splice record), so per-record covered chars
    are plain within-lane diffs.

    text: uint8 buffer the records index into (dispatch-local positions).
    Returns (scores i32[n_ids], n_tokens, miss_mask i32[256], start_next,
    sync_ok).
    """
    flags, keep, start_next, sync_ok = stitched_keep(
        recs, start0, last_lane, final, probe)
    T, L = recs.shape
    pos = (recs >> 4).astype(jnp.int32)                      # (T, L)
    starts = jnp.arange(L, dtype=jnp.int32) * chunk
    prev = jnp.concatenate([starts[None, :], pos[:-1]], axis=0)
    covered = pos - prev

    miss = ((flags & _REC_MISS) != 0) & keep
    has_tok = ((flags & _REC_TOK) != 0) & keep & ~miss
    has_del = ((flags & _REC_DEL) != 0) & keep
    n_tokens = (has_tok.sum() + has_del.sum() + miss.sum())

    flat_ids = jnp.where(has_tok, toks, jnp.uint32(n_ids)).reshape(-1)
    flat_cov = jnp.where(has_tok, covered, 0).reshape(-1)
    scores = jnp.zeros(n_ids + 1, jnp.int32).at[flat_ids].add(
        flat_cov, mode="drop")
    # the delete marker itself scores +1 per emission
    n_del = has_del.sum().astype(jnp.int32)
    scores = scores.at[jnp.int32(delete_token)].add(n_del, mode="drop")
    scores = scores[:n_ids]

    # missing byte values: the missed byte sits at the pre-advance position
    mb_pos = jnp.clip(prev, 0, text.shape[0] - 1)
    mb = jnp.take(text, mb_pos).astype(jnp.int32)
    mb_idx = jnp.where(miss, mb, 256).reshape(-1)
    miss_mask = jnp.zeros(257, jnp.int32).at[mb_idx].add(1, mode="drop")[:256]
    return (scores, n_tokens.astype(jnp.int32), miss_mask,
            start_next, sync_ok)
