"""Device-assisted bounded suffix sort for getalltokens (SURVEY §8.6).

The candidate-generation counting engine orders every position of a
micro-chunk by its (max_token_length+1)-byte window; equal prefixes of any
length are then contiguous and the first-mismatch column between adjacent
sorted windows yields per-length run boundaries (getalltokens.go's
counting restructured, train/getalltokens.py::SortedWindows).  The host
suffix sort is the pipeline's second-largest cost; on the device the same
order is ONE lexicographic multi-operand sort (jax.lax.sort) plus a
vectorised first-diff pass.

Big-endian u32 word packing makes tuple-lexicographic order equal byte
order; ties (identical windows) may order differently than the host sort,
but the counting walk only consumes run structure — first_diff >= length
marks "same run" regardless of tie order — so counts and the final .tok
bytes are identical (tests/test_device_sort.py).
"""

from __future__ import annotations

import numpy as np

_fns: dict = {}


def _build(n: int, width: int):
    import jax
    import jax.numpy as jnp

    w32 = -(-width // 4)

    def fn(padded):
        # big-endian u32 words of each position's window
        words = []
        for j in range(w32):
            w = (padded[4 * j:4 * j + n].astype(jnp.uint32) << 24
                 | padded[4 * j + 1:4 * j + 1 + n].astype(jnp.uint32) << 16
                 | padded[4 * j + 2:4 * j + 2 + n].astype(jnp.uint32) << 8
                 | padded[4 * j + 3:4 * j + 3 + n].astype(jnp.uint32))
            words.append(w)
        # LSD radix over the words with STABLE single-key sorts: the
        # variadic lexicographic sort takes XLA's comparator path and its
        # compile explodes at tens of millions of rows (measured: killed
        # at 30 min for 21M x 11 operands).  Each pass is a stable
        # sort_key_val carrying the running permutation — stability is
        # exactly what LSD radix needs for lexicographic order.
        order = jnp.arange(n, dtype=jnp.uint32)
        for j in range(w32 - 1, -1, -1):
            wj = jnp.take(words[j], order.astype(jnp.int32))
            _, order = jax.lax.sort([wj, order], num_keys=1,
                                    is_stable=True)
        sw = [jnp.take(w, order.astype(jnp.int32)) for w in words]
        # first differing byte between adjacent sorted windows
        fw = jnp.full(n - 1, w32, jnp.int32)        # first differing word
        xw = jnp.zeros(n - 1, jnp.uint32)
        for j in range(w32 - 1, -1, -1):
            neq = sw[j][1:] != sw[j][:-1]
            fw = jnp.where(neq, j, fw)
            xw = jnp.where(neq, sw[j][1:] ^ sw[j][:-1], xw)
        inword = jnp.where(
            xw >= (1 << 24), 0,
            jnp.where(xw >= (1 << 16), 1, jnp.where(xw >= (1 << 8), 2, 3)))
        fd = jnp.minimum(4 * fw + inword, 255).astype(jnp.uint8)
        return order, fd

    return jax.jit(fn)


def device_sorted_windows(data: np.ndarray, n: int, width: int):
    """(order uint32[n], first_diff uint8[n-1]) — drop-in for
    native_sorted_windows, computed on the default jax device.  Returns
    None when jax is unavailable."""
    if n <= 1:
        return None
    try:
        import jax.numpy as jnp
    except Exception:
        return None
    w32 = -(-width // 4)
    pad = np.zeros(n + 4 * w32 + 4, np.uint8)
    m = min(len(data), n + width)
    pad[:m] = data[:m]
    key = (n, width)
    fn = _fns.get(key)
    if fn is None:
        fn = _fns[key] = _build(n, width)
    order, fd = fn(jnp.asarray(pad))
    return np.asarray(order), np.asarray(fd)
