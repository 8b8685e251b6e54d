"""Exact Hamming descriptor matching as an int8 matrix product.

Replaces ``cv::FlannBasedMatcher(LshIndexParams(5,10,2))`` (reference
``src/frontend.cpp:33,186-215``).  The LSH index is an *approximate*
nearest-neighbor structure; on an accelerator we can afford the exact
brute-force search: with descriptors stored as bipolar int8 vectors in
{-1,+1}^256, the Hamming distance is an affine function of the dot product,

    hamming(a, b) = (256 - <a_bip, b_bip>) / 2,

so the whole (candidates x keypoints) distance matrix is one int8 matmul
with int32 accumulation - exact, and exactness replaces approximation.

The distance filter keeps the reference's rule: a match survives iff
``dist <= max(min_dist * match_ratio, 30)`` (``src/frontend.cpp:190-211``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

BIG = jnp.int32(1 << 20)
BITS = 256  # descriptor bits = 8 packed uint32 words


def hamming_matrix(a_bip: jnp.ndarray, b_bip: jnp.ndarray) -> jnp.ndarray:
    """[M, 256] x [N, 256] bipolar int8 -> [M, N] int32 Hamming distances.

    Rows/columns whose descriptor is all-zero (invalid lanes) yield 128 -
    callers mask with validity flags.
    """
    dot = jax.lax.dot_general(
        a_bip,
        b_bip,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    nbits = a_bip.shape[-1]
    return (nbits - dot) // 2


class MatchResult(NamedTuple):
    """Per-candidate best match (the ``flannMatchedMptKptMap_`` analogue)."""

    matched: jnp.ndarray  # [M] bool - survives the distance filter
    kp_index: jnp.ndarray  # [M] int32 - best current-frame keypoint per candidate
    distance: jnp.ndarray  # [M] int32 - Hamming distance of that match
    min_distance: jnp.ndarray  # scalar int32 - best distance over all candidates


class NearestKeypoints(NamedTuple):
    """Pose-independent half of matching: best keypoint per map candidate."""

    kp_index: jnp.ndarray  # [M] int32
    distance: jnp.ndarray  # [M] int32 (BIG where no valid keypoint)


def nearest_keypoints(
    cand_bip: jnp.ndarray, kp_bip: jnp.ndarray, kp_mask: jnp.ndarray
) -> NearestKeypoints:
    """Exact Hamming nearest valid keypoint for every candidate row.

    Depends only on the descriptors, NOT on the pose - so the coarse and
    fine estimation rounds (``frontend.cpp:100-108``) can share one call:
    the reference re-runs FLANN because LSH lookups are stochastic, but
    exact matching is deterministic and the second round only changes the
    frustum candidate mask, never the distances.
    """
    d = hamming_matrix(cand_bip, kp_bip)
    d = jnp.where(kp_mask[None, :], d, BIG)
    best_kp = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_d = jnp.min(d, axis=1)
    return NearestKeypoints(kp_index=best_kp, distance=best_d)


def unpack_bipolar(desc: jnp.ndarray) -> jnp.ndarray:
    """[..., 8] uint32 -> [..., 256] int8 in {-1, +1} (bit order: word-major,
    LSB first - must match ops/orb.py's packing)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts[None, :]) & jnp.uint32(1)
    flat = bits.reshape(desc.shape[:-1] + (BITS,))
    return (flat.astype(jnp.int8) << 1) - 1


def hamming_matrix_packed_T(cand_descT: jnp.ndarray, kp_bip: jnp.ndarray) -> jnp.ndarray:
    """[8, C] uint32 packed pool x [N, 256] int8 bipolar -> [N, C] int32.

    Unpacks the C-minor pool to a ``[256, C]`` bipolar plane (row
    ``32*w + b`` is bit ``b`` of word ``w``, the order of
    :func:`unpack_bipolar`) and contracts it with one int8 matmul, so the
    distances equal :func:`hamming_matrix` on the unpacked descriptors."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (cand_descT[:, None, :] >> shifts[None, :, None]) & jnp.uint32(1)
    a = (bits.reshape(BITS, cand_descT.shape[1]).astype(jnp.int8) << 1) - 1
    dot = jax.lax.dot_general(
        kp_bip, a, dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return (BITS - dot) // 2


def nearest_keypoints_packed(
    cand_descT: jnp.ndarray,  # [8, C] uint32 packed pool (C-minor layout)
    kp_bip: jnp.ndarray,  # [N, 256] int8 bipolar keypoints
    kp_mask: jnp.ndarray,
) -> NearestKeypoints:
    """:func:`nearest_keypoints` computed straight from the PACKED pool,
    so the map state needs no persistent ``[C, 256]`` int8 copy (8x less
    map memory; ``VOConfig.packed_matching``).  The unpack runs inside the
    step on every call; which layout is faster on the GPU is an open
    measurement (``PERF.md``).

    Takes the C-minor ``mp_desc`` pool (``[8, C]``); the distance matrix
    comes back ``[N, C]`` and the per-candidate reductions run over axis 0.
    """
    d = hamming_matrix_packed_T(cand_descT, kp_bip)  # [N, C]
    d = jnp.where(kp_mask[:, None], d, BIG)
    best_kp = jnp.argmin(d, axis=0).astype(jnp.int32)
    best_d = jnp.min(d, axis=0)
    return NearestKeypoints(kp_index=best_kp, distance=best_d)


def gate_matches(
    nn: NearestKeypoints,
    cand_mask: jnp.ndarray,
    match_ratio: float = 2.0,
    min_match_distance: float = 30.0,
) -> MatchResult:
    """Apply the reference's adaptive distance gate
    (``max(min_dis * match_ratio, 30)``, ``src/frontend.cpp:190-211``) to a
    precomputed nearest-keypoint table under a candidate mask."""
    row_ok = cand_mask & (nn.distance < BIG)
    min_dis = jnp.min(jnp.where(row_ok, nn.distance, BIG))
    max_dis = jnp.maximum(
        min_dis.astype(jnp.float32) * match_ratio, min_match_distance
    )
    matched = row_ok & (nn.distance.astype(jnp.float32) <= max_dis)
    return MatchResult(
        matched=matched, kp_index=nn.kp_index, distance=nn.distance,
        min_distance=min_dis,
    )


def match_descriptors(
    cand_bip: jnp.ndarray,
    cand_mask: jnp.ndarray,
    kp_bip: jnp.ndarray,
    kp_mask: jnp.ndarray,
    match_ratio: float = 2.0,
    min_match_distance: float = 30.0,
) -> MatchResult:
    """For every valid candidate descriptor, find its nearest valid current
    keypoint and apply the reference's adaptive distance gate.

    Query/train orientation matches ``flannMatcher_.match(candidateDescs,
    currDescs)`` (``src/frontend.cpp:187``): candidates are rows, one best
    keypoint per candidate; several candidates may share a keypoint, exactly
    like the reference's map-of-sets.
    """
    return gate_matches(
        nearest_keypoints(cand_bip, kp_bip, kp_mask),
        cand_mask, match_ratio, min_match_distance,
    )
