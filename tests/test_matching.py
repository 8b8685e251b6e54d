"""Hamming matching tests: int8-matmul distances vs a numpy popcount oracle,
and the reference's adaptive distance filter (src/frontend.cpp:190-211)."""

import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_visualodometry_tpu.ops import matching, packing


def random_descs(rng, n):
    bits = rng.integers(0, 2, (n, 256)).astype(np.int8)
    bipolar = bits * 2 - 1
    return bits, bipolar


def numpy_hamming(bits_a, bits_b):
    return (bits_a[:, None, :] != bits_b[None, :, :]).sum(axis=2)


def test_hamming_matches_popcount_oracle():
    rng = np.random.default_rng(0)
    ba, pa = random_descs(rng, 37)
    bb, pb = random_descs(rng, 53)
    d = np.asarray(matching.hamming_matrix(jnp.asarray(pa), jnp.asarray(pb)))
    np.testing.assert_array_equal(d, numpy_hamming(ba, bb))


def test_match_filter_semantics():
    rng = np.random.default_rng(1)
    bits, bip = random_descs(rng, 10)
    # candidates: 0 and 1 perturbed by 5 and 40 bits, 2 unrelated
    cand_bits = bits[:3].copy()
    cand_bits[0, :5] ^= 1
    cand_bits[1, :40] ^= 1
    cand_bip = (cand_bits * 2 - 1).astype(np.int8)

    res = matching.match_descriptors(
        jnp.asarray(cand_bip),
        jnp.ones(3, bool),
        jnp.asarray(bip),
        jnp.ones(10, bool),
        match_ratio=2.0,
        min_match_distance=30.0,
    )
    # candidate 2 is exactly bits[2] -> min over candidates is 0
    assert int(res.min_distance) == 0
    # gate = max(0 * 2, 30) = 30: candidate 0 (d=5) passes, candidate 1
    # (d=40) fails, candidate 2 (d=0) passes
    assert bool(res.matched[0])
    assert int(res.kp_index[0]) == 0
    assert not bool(res.matched[1])
    assert bool(res.matched[2]) and int(res.distance[2]) == 0


def test_match_masks():
    rng = np.random.default_rng(2)
    _, bip = random_descs(rng, 8)
    cand_mask = jnp.asarray([True, False, True, True, True, True, True, True])
    kp_mask = jnp.zeros(8, bool).at[jnp.arange(4)].set(True)
    res = matching.match_descriptors(
        jnp.asarray(bip), cand_mask, jnp.asarray(bip), kp_mask
    )
    # masked-out candidate can never match
    assert not bool(res.matched[1])
    # all matches point at unmasked keypoints
    assert all(int(k) < 4 for k in np.asarray(res.kp_index)[np.asarray(res.matched)])
    # identity matches for the first 4 (distance 0)
    assert bool(res.matched[0]) and int(res.kp_index[0]) == 0


def test_compact_indices():
    mask = jnp.asarray([False, True, False, True, True, False, False, True])
    idx, valid = packing.compact_indices(mask, 3)
    np.testing.assert_array_equal(np.asarray(idx), [1, 3, 4])  # overflow drops 7
    assert all(np.asarray(valid))
    idx2, valid2 = packing.compact_indices(mask, 6)
    np.testing.assert_array_equal(np.asarray(idx2)[:4], [1, 3, 4, 7])
    np.testing.assert_array_equal(np.asarray(valid2), [1, 1, 1, 1, 0, 0])
    # scatter roundtrip
    back = packing.scatter_back(8, idx2, valid2)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(mask))


def test_compact_indices_empty():
    mask = jnp.zeros(16, bool)
    idx, valid = packing.compact_indices(mask, 4)
    assert not np.asarray(valid).any()
    assert (np.asarray(idx) == 0).all()


def test_compact_best_indices_prefers_low_scores():
    """Over-capacity packing must keep the best-scoring entries (smallest
    Hamming distance), not the lowest slot indices - slot order keeps the
    OLDEST mappoints and drops the fresh ones (late-sequence drift)."""
    mask = jnp.asarray([True, True, False, True, True, True, False, True])
    score = jnp.asarray([90, 40, 0, 10, 40, 5, 1, 200])
    idx, valid = packing.compact_best_indices(mask, score, 3)
    assert all(np.asarray(valid))
    # best three set entries are slots 5 (5), 3 (10), and one of the 40s
    # (tie at the threshold bin broken by slot index -> 1)
    assert set(np.asarray(idx).tolist()) == {5, 3, 1}
    # exact-capacity and under-capacity fall back to keep-everything
    idx2, valid2 = packing.compact_best_indices(mask, score, 6)
    assert set(np.asarray(idx2).tolist()) == {0, 1, 3, 4, 5, 7}
    idx3, valid3 = packing.compact_best_indices(mask, score, 8)
    assert np.asarray(valid3).sum() == 6
    np.testing.assert_array_equal(np.asarray(idx3)[:6], [0, 1, 3, 4, 5, 7])


def test_compact_best_indices_empty_and_uniform():
    idx, valid = packing.compact_best_indices(jnp.zeros(8, bool), jnp.zeros(8, jnp.int32), 4)
    assert not np.asarray(valid).any()
    # all-equal scores degrade to compact_indices order
    mask = jnp.asarray([True] * 6 + [False, False])
    idx2, valid2 = packing.compact_best_indices(mask, jnp.full(8, 7, jnp.int32), 4)
    np.testing.assert_array_equal(np.asarray(idx2), [0, 1, 2, 3])
    assert all(np.asarray(valid2))


def _random_packed(rng, n):
    """(packed [n, 8] uint32, bipolar [n, 256] int8) for random bits."""
    bits = rng.integers(0, 2, (n, 256)).astype(np.uint32)
    packed = (bits.reshape(n, 8, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=-1, dtype=np.uint32
    )
    return packed, (bits.astype(np.int8) * 2 - 1).astype(np.int8)


def test_hamming_packed_matches_bipolar_matmul():
    """Packed-pool oracle: unpacking inverts orb's packing, and the
    distance from packed uint32 words equals the bipolar-matmul distance
    for the same descriptors."""
    rng = np.random.default_rng(3)
    packed, bip = _random_packed(rng, 64)

    # unpack inverts the pack
    np.testing.assert_array_equal(
        np.asarray(matching.unpack_bipolar(jnp.asarray(packed))), bip
    )

    kp = (rng.integers(0, 2, (48, 256)).astype(np.int8) * 2 - 1).astype(np.int8)
    d_ref = np.asarray(matching.hamming_matrix(jnp.asarray(bip), jnp.asarray(kp)))
    d_new = np.asarray(
        matching.hamming_matrix_packed_T(jnp.asarray(packed.T.copy()), jnp.asarray(kp))
    )
    np.testing.assert_array_equal(d_ref, d_new.T)
    # brute-force spot check
    a0 = bip[0] > 0
    b0 = kp[0] > 0
    assert d_ref[0, 0] == int((a0 != b0).sum())


def test_hamming_packed_T_matches_bipolar_matmul():
    """nearest_keypoints_packed consumes the C-minor [8, C] pool directly
    and must agree with the dense bipolar path."""
    rng = np.random.default_rng(11)
    packed, bip = _random_packed(rng, 96)
    kp = (rng.integers(0, 2, (40, 256)).astype(np.int8) * 2 - 1).astype(np.int8)
    kp_mask = jnp.ones(40, bool).at[7].set(False)
    nn_dense = matching.nearest_keypoints(jnp.asarray(bip), jnp.asarray(kp), kp_mask)
    nn_packed = matching.nearest_keypoints_packed(
        jnp.asarray(packed.T.copy()), jnp.asarray(kp), kp_mask
    )
    np.testing.assert_array_equal(np.asarray(nn_dense.distance), np.asarray(nn_packed.distance))
    np.testing.assert_array_equal(np.asarray(nn_dense.kp_index), np.asarray(nn_packed.kp_index))


@pytest.mark.parametrize("C", [16384, 16384 - 333])
def test_hamming_packed_T_exact_at_bench_width(C):
    """At the bench matching shape (C=16384 pool, N=512 keypoints) the
    packed path equals the dense bipolar matmul exactly, including a pool
    width that is not a multiple of any tile size."""
    rng = np.random.default_rng(C)
    packed, bip = _random_packed(rng, C)
    _, kp = _random_packed(rng, 512)
    d_ref = np.asarray(matching.hamming_matrix(jnp.asarray(bip), jnp.asarray(kp)))
    d_new = np.asarray(
        matching.hamming_matrix_packed_T(jnp.asarray(packed.T.copy()), jnp.asarray(kp))
    )
    np.testing.assert_array_equal(d_ref.T, d_new)
