"""Mask -> fixed-size index compaction, scatter-free.

The recurring pattern in this framework: a data-dependent subset (matched
candidates, BA edges, window mappoints, ...) is turned into a *fixed-capacity*
packed index list plus a validity mask, so every downstream kernel keeps
static shapes.  This is the structural replacement for the reference's
dynamically-sized ``std::vector`` / ``unordered_map`` collections (e.g.
``mptCandidates`` at ``src/frontend.cpp:171-184``).

Everything here is formulated WITHOUT scatters: ``compact_indices`` uses a
prefix-sum + binary search (``searchsorted``) and
``scatter_back``/``inverse_lookup`` use dense comparisons + gathers, all of
which vmap cleanly.  Whether XLA:GPU's native scatters would be faster is
an open measurement (PERF.md).
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp


def compact_indices(mask: jnp.ndarray, k: int):
    """Pack the indices where ``mask`` is True into ``k`` slots.

    Returns ``(indices int32 [k], valid bool [k])``.  The first
    ``min(count, k)`` slots hold the lowest True indices in ascending order;
    remaining slots point at index 0 with ``valid=False`` (safe to gather).
    If more than ``k`` entries are set, the excess is dropped (callers size
    ``k`` generously and may log the overflow).

    Scatter-free: ``indices[j]`` = position of the (j+1)-th True = the first
    index where the inclusive prefix sum reaches j+1, found by binary search.
    """
    csum = jnp.cumsum(mask.astype(jnp.int32))  # inclusive prefix sum
    idx = jnp.searchsorted(
        csum, jnp.arange(1, k + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    count = csum[-1]
    valid = jnp.arange(k) < count
    return jnp.where(valid, idx, 0), valid


def compact_best_indices(mask: jnp.ndarray, score: jnp.ndarray, k: int, n_bins: int = 258):
    """Pack up to ``k`` True indices, preferring LOW integer ``score``.

    Like :func:`compact_indices`, but when more than ``k`` entries are set
    the survivors are the best-scoring ones (e.g. smallest Hamming
    distances), not the lowest slot indices.  Slot order would
    systematically keep the OLDEST mappoints: pool slots are allocated in
    creation order, so once a frame matches more points than ``k`` the
    freshest landmarks - the ones actually visible in the current frustum -
    are exactly the ones dropped, and tracking quality decays as the map
    grows (measured on the 240-frame fr1-like scene as late-sequence drift:
    frames past ~170 match 2000+ mappoints against a 1024 cap).

    ``score`` must be small non-negative integers (< ``n_bins - 1``;
    Hamming distances are in [0, 256]).  The threshold bin's ties are
    broken by slot index.  Scatter-free and sort-free: a [n_bins, M]
    histogram + prefix sum finds the k-th smallest score, then
    :func:`compact_indices` packs the refined mask.
    """
    s = jnp.where(mask, jnp.clip(score, 0, n_bins - 1), n_bins - 1)
    counts = jnp.sum(
        (s[None, :] == jnp.arange(n_bins, dtype=s.dtype)[:, None]) & mask[None, :],
        axis=1,
        dtype=jnp.int32,
    )
    ccum = jnp.cumsum(counts)
    # smallest score bin whose cumulative count reaches k; every entry
    # scoring strictly below t survives, and the threshold bin fills the
    # remaining quota in slot order
    t = jnp.searchsorted(ccum, k, side="left").astype(s.dtype)
    below = mask & (s < t)
    quota_t = k - jnp.sum(below, dtype=jnp.int32)
    at_t = mask & (s == t)
    keep_t = at_t & (jnp.cumsum(at_t.astype(jnp.int32)) <= quota_t)
    return compact_indices(below | keep_t, k)


def scatter_back(mask_size: int, indices: jnp.ndarray, values: jnp.ndarray):
    """Expand packed boolean ``values [k]`` back to a full-size mask.

    Scatter-free: a dense (size x k) comparison reduced with ``any``.
    Invalid slots must carry ``values=False``.
    """
    eq = indices[None, :] == jnp.arange(mask_size, dtype=indices.dtype)[:, None]
    return jnp.any(eq & values[None, :], axis=1)


def inverse_lookup(size: int, indices: jnp.ndarray, valid: jnp.ndarray):
    """Invert a packed unique-index list: for each slot ``c`` of the full
    array, which packed row (if any) targets it.

    Returns ``(hit bool [size], inv int32 [size])`` with
    ``indices[inv[c]] == c`` wherever ``hit[c]``.  This is the gather-side
    dual of a scatter: ``full = where(hit[:, None], packed[inv], full)``
    replaces ``full.at[indices].set(packed)`` without emitting a scatter.
    ``indices`` must be unique where ``valid`` (compaction outputs are).
    """
    k = indices.shape[0]
    tgt = jnp.where(valid, indices, size)  # sentinel drops invalid rows
    # bit-plane one-hot matmul: the [size, k] equality matrix is built in
    # int8 and immediately contracted (int32 accumulation, exact) against
    # 1+ceil(log2(k)) binary weight columns - column 0 of ones recovers
    # `hit`, columns b recover bit b of the matching row index (rows are
    # unique, so each output is 0/1).
    nbits = max(1, (k - 1).bit_length())
    eq = (tgt[None, :] == jnp.arange(size, dtype=indices.dtype)[:, None]).astype(jnp.int8)
    j = np.arange(k)
    w = np.concatenate(
        [
            np.ones((k, 1), np.int8),
            ((j[:, None] >> np.arange(nbits)[None, :]) & 1).astype(np.int8),
        ],
        axis=1,
    )
    out = jax.lax.dot_general(
        eq, jnp.asarray(w),
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # [size, 1 + nbits]
    hit = out[:, 0] > 0
    inv = jnp.sum(out[:, 1:] << jnp.arange(nbits)[None, :], axis=1).astype(jnp.int32)
    return hit, inv
