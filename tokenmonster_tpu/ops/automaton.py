"""Aho-Corasick DFA over reversed keys: the device longest-match engine.

The reference finds the longest dictionary key starting at each position with
a length-bucketed packed-key search (pansearch; C++ port at
tokenmonster-cpp/src/tokenmonster.cpp:491-877).  That structure is pointer-
chasing and branch-heavy — wrong shape for a data-parallel device.  Here we
restructure the problem: the longest key *starting* at position p in the
text equals the longest reversed key *ending* at the mirrored position of
the reversed text.
A dense Aho-Corasick DFA over reversed keys computes that for every position
in one lockstep pass: exactly one (next_state, output) table gather per byte,
no data-dependent branching — ideal for lockstep chunk lanes.

Each DFA transition entry carries the target state's "deepest terminal in the
suffix-link chain" (dictionary index + match length), so a single gather per
byte yields the full longest-match table M(p).

A second automaton over space-stripped keys ({x : " "+x in dict}) computes
Mb(p), the space-prefixed match used by the tokenizer's forward-delete
branches (the ``lilbuf`` probes, go/tokenmonster.go:1088-1108).

Alphabet is 257: byte value 256 is a reset sentinel used for padding so that
chunk warm-up regions outside the text behave as if the automaton started at
the text edge.
"""

from __future__ import annotations

from collections import deque

import numpy as np

ALPHA = 257
RESET = 256


class MatchAutomaton:
    """Dense reversed-key AC DFA with packed per-state outputs.

    Attributes:
      dfa: (n_states * ALPHA,) uint32 — next-state transition table.
      out: (n_states,) uint32 — packed deepest-terminal output per state:
           (dict_index << 6) | match_length, 0 when none.
      n_states: number of DFA states.
    """

    __slots__ = ("dfa", "out", "n_states")

    def __init__(self, dfa: np.ndarray, out: np.ndarray, n_states: int):
        self.dfa = dfa
        self.out = out
        self.n_states = n_states

    @classmethod
    def build(cls, keys, indices, lengths=None) -> "MatchAutomaton":
        """Build from keys (list[bytes]) with their output indices.

        ``lengths`` overrides the reported match length (defaults to
        len(key)); the space automaton uses full-match lengths including the
        stripped leading space.  Uses the native builder when available
        (tm_ac_build — identical tables, ~50x faster); the Python path below
        is the oracle.
        """
        n_keys = len(keys)
        if lengths is None:
            lengths = [len(k) for k in keys]

        try:
            from .. import native
            built = native.native_ac_build(list(keys), list(indices),
                                           list(lengths))
        except Exception as e:
            import logging
            logging.getLogger(__name__).warning(
                "native tm_ac_build unavailable (%s); falling back to the "
                "~50x slower Python automaton builder", e)
            built = None
        if built is not None:
            dfa, out, n_states = built
            return cls(dfa, out, n_states)

        # --- trie over reversed keys (flat arrays, child dicts) ---
        children: list[dict[int, int]] = [{}]
        term_idx = [0xFFFFFF]
        term_len = [0]
        depth = [0]
        for k, out_idx, out_len in zip(keys, indices, lengths):
            node = 0
            for c in reversed(k):
                nxt = children[node].get(c)
                if nxt is None:
                    nxt = len(children)
                    children[node][c] = nxt
                    children.append({})
                    term_idx.append(0xFFFFFF)
                    term_len.append(0)
                    depth.append(depth[node] + 1)
                node = nxt
            term_idx[node] = int(out_idx)
            term_len[node] = int(out_len)

        n_states = len(children)
        fail = np.zeros(n_states, np.int64)
        # packed deepest-terminal output per state
        out = np.zeros(n_states, np.uint32)
        if term_len[0] > 0:
            out[0] = (term_idx[0] << 6) | term_len[0]

        # Dense DFA rows built in BFS order; fail transitions collapse into
        # the rows as we go (fail[t] = dfa[fail[s]][c]).
        dfa = np.zeros((n_states, ALPHA), np.uint32)
        dq = deque()
        for c, s in children[0].items():
            dfa[0][c] = s
            fail[s] = 0
            dq.append(s)
        while dq:
            s = dq.popleft()
            f = fail[s]
            if term_len[s] > 0:
                out[s] = (term_idx[s] << 6) | term_len[s]
            else:
                out[s] = out[f]
            row = dfa[f].copy()
            for c, t in children[s].items():
                fail[t] = row[c]
                row[c] = t
                dq.append(t)
            row[RESET] = 0
            dfa[s] = row

        return cls(dfa.reshape(-1), out, n_states)

    def nbytes(self) -> int:
        return self.dfa.nbytes + self.out.nbytes


def build_match_automata(vocab):
    """Build (main, space) automatons from a Vocab.

    Returns (main_automaton, space_automaton_or_None).
    The space automaton outputs the dictionary index of the full " "+x key
    and the full match length (including the leading space byte).
    """
    keys = vocab.tokens
    main = MatchAutomaton.build(keys, list(range(len(keys))))
    # the lilbuf space prefix is " " (UTF-8) or " \x00" (UTF-16-LE),
    # go/tokenmonster.go:1029-1036
    pre = b" \x00" if vocab.charset == 2 else b" "
    space_keys = []
    space_idx = []
    space_len = []
    for i, k in enumerate(keys):
        if len(k) > len(pre) and k[:len(pre)] == pre:
            space_keys.append(k[len(pre):])
            space_idx.append(i)
            space_len.append(len(k))
    space = None
    if space_keys:
        space = MatchAutomaton.build(space_keys, space_idx, space_len)
    return main, space
