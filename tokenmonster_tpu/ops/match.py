"""Phase 1 of device tokenization: longest-match tables for every position.

Runs the dense reversed-key AC DFA (ops/automaton.py) over the text in
lockstep chunk lanes.  Chunks carry a warm-up overlap of >= max key length
bytes, which makes every in-chunk state exact — M/Mb tables need no
reconciliation (unlike the phase-2 scan).

Output packing: M[p] = (dict_index << 6) | match_length, 0 = no match.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from .automaton import ALPHA, RESET

# Warm-up must cover the longest key (40) — round up for alignment.
OVERLAP = 64


def match_lanes(dfa, out, rev_padded, chunk: int, n_lanes: int,
                unroll: int = 4):
    """Pure function (composable under jit/shard_map): run the DFA over all
    lanes.  rev_padded: int32[(n_lanes * chunk) + OVERLAP] reversed text with
    OVERLAP leading RESET sentinels and RESET tail padding.

    The byte loop is unrolled (``unroll`` bytes per scan iteration) to
    amortise per-iteration loop overhead; the gathers stay serial (state
    dependency) but bookkeeping is batched."""
    # lane l consumes rev_padded[l*chunk : l*chunk + OVERLAP + chunk]
    starts = jnp.arange(n_lanes, dtype=jnp.int32) * chunk
    t_steps = OVERLAP + chunk
    while t_steps % unroll:
        unroll //= 2

    def step(state, t0):
        outs_u = []
        for u in range(unroll):
            c = rev_padded[starts + (t0 + u)]
            state = jnp.take(dfa, state * ALPHA + c).astype(jnp.int32)
            outs_u.append(jnp.take(out, state))
        return state, jnp.stack(outs_u)

    init = jnp.zeros(n_lanes, jnp.int32)
    _, outs = jax.lax.scan(
        step, init,
        jnp.arange(0, t_steps, unroll, dtype=jnp.int32))
    # outs: (T/unroll, unroll, L) -> (T, L); drop warmup, transpose, flatten
    outs = outs.reshape(t_steps, n_lanes)
    return outs[OVERLAP:].T.reshape(-1)


_match_kernel = jax.jit(match_lanes, static_argnames=("chunk", "n_lanes"))


def match_strips(dfa, out, text2d):
    """Strip-local matching: text2d (L, chunk) forward-order strips; returns
    packed matches (L, chunk) where no match crosses a strip boundary
    (automaton state resets at every strip end — used by the trainer, whose
    strips are independent segments like trainvocab.go:1668-1695)."""
    L, chunk = text2d.shape
    revd = jnp.flip(text2d.astype(jnp.int32), axis=1)  # (L, T)

    def step(state, t):
        c = revd[:, t]
        new_state = jnp.take(dfa, state * ALPHA + c).astype(jnp.int32)
        return new_state, jnp.take(out, new_state)

    init = jnp.zeros(L, jnp.int32)
    _, outs = jax.lax.scan(step, init, jnp.arange(chunk, dtype=jnp.int32))
    return jnp.flip(outs.T, axis=1)  # (L, chunk) forward order


def reverse_for_match(data, n: int, chunk: int, n_lanes: int):
    """Build the reversed+sentinel-padded input for match_lanes (jnp ops,
    composable under jit): data is uint8[>=n]."""
    total = n_lanes * chunk
    rev = jnp.full(total + OVERLAP, RESET, jnp.int32)
    body = jnp.flip(data[:n].astype(jnp.int32))
    return jax.lax.dynamic_update_slice(rev, body, (OVERLAP,))


def _bucket(n_lanes: int) -> int:
    """Round lane count up to a power of two (bounds jit recompilation)."""
    b = 1
    while b < n_lanes:
        b <<= 1
    return b


def compute_match_table(automaton, data: np.ndarray, chunk: int = 512,
                        device_tables=None):
    """Compute M[p] for all positions of ``data`` (uint8 array).

    Returns uint32[N] packed matches. ``device_tables`` may hold a
    pre-transferred (dfa, out) pair to avoid re-uploading per call.
    """
    n = len(data)
    if n == 0:
        return np.zeros(0, np.uint32)
    if device_tables is not None:
        dfa, out = device_tables
    else:
        dfa, out = jnp.asarray(automaton.dfa), jnp.asarray(automaton.out)
    n_lanes = _bucket(-(-n // chunk))
    rev = np.full(n_lanes * chunk + OVERLAP, RESET, np.int32)
    rev[OVERLAP:OVERLAP + n] = np.asarray(data, np.uint8)[::-1]
    out_rev = np.asarray(_match_kernel(dfa, out, jnp.asarray(rev), chunk, n_lanes))
    return out_rev[:n][::-1].copy()


def reference_match_table(vocab, data) -> np.ndarray:
    """Host oracle: M[p] via the dictionary, for testing."""
    out = np.zeros(len(data), np.uint32)
    max_len = vocab.max_token_length
    ls = vocab.dictionary.longest_substring
    for p in range(len(data)):
        idx, length, found = ls(data, p, min(len(data) - p, max_len))
        if found:
            out[p] = (idx << 6) | length
    return out


def reference_space_match_table(vocab, data) -> np.ndarray:
    """Host oracle for Mb[p]: longest key match of " "+data[p:] (the lilbuf
    probe, go/tokenmonster.go:1088-1091), keeping only matches of length >= 2
    (a length-1 " " match can never pass the ``length1b > length1+1`` gate)."""
    out = np.zeros(len(data), np.uint32)
    max_len = vocab.max_token_length
    data = bytes(data)
    ls = vocab.dictionary.longest_substring
    for p in range(len(data)):
        probe = b" " + data[p:p + max_len - 1]
        idx, length, found = ls(probe, 0, len(probe))
        if found and length >= 2:
            out[p] = (idx << 6) | length
    return out
