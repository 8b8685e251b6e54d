"""The world state: keyframes, mappoints, observations, covisibility.

This one fixed-capacity pytree replaces the reference's entire mutable object
graph - the ``MapManager`` singleton (``include/myslam/mapmanager.h:23-26``),
per-object mutexes, ``Frame``'s observation / covisibility bookkeeping
(``src/frame.cpp:93-171``) and ``Mappoint``'s observation map
(``include/myslam/mappoint.h:59-88``).  Because the state is immutable and
threaded through jitted step functions, the data races the reference guards
against with five mutexes are impossible by construction (SURVEY.md section 5).

Representation choices:

- **Keyframes**: pose array ``[K, 7]`` + validity mask; slots are allocated
  monotonically (the reference never deletes keyframes).
- **Mappoints**: struct-of-arrays over a capacity-``C`` pool, stored
  **C-minor** (capacity on the last axis - see below).  Slots of outlier
  points are recycled (an outlier has zero observations by construction -
  ``src/mappoint.cpp:39-49`` - so recycling is safe).
- **Observations**: fixed per-mappoint slots ``(kf, u, v, valid)`` in
  ``[M, C]`` / ``[2, M, C]`` planes - serving triangulation and bundle
  adjustment directly.
- **Covisibility** is *derived*, not stored: with the binary incidence
  matrix ``A[K, C]`` (keyframe observes mappoint), the covisibility weight
  matrix of ``Frame::allCovisibleKeyframeIdToWeight_`` (``frame.h:94``) is
  exactly ``A @ A^T`` - one exact int8 matmul replaces all of the
  reference's incremental two-sided weight bookkeeping
  (``src/frame.cpp:93-171``).

C-minor pool layout: every persistent mappoint pool keeps its capacity C
on the LAST axis (``mp_pos``/``mp_norm`` ``[3, C]``, ``mp_desc`` ``[8, C]``,
``obs_kf``/``obs_depth``/``obs_valid`` ``[M, C]``, ``obs_uv`` ``[2, M, C]``),
so per-frame masked rewrites stream along the long axis.  The layout stays
until a GPU measurement decides it (PERF.md, open questions).

Compact per-problem arrays (PnP rows, BA blocks, new-keypoint rows) stay
row-major - they are small and transposing at the gather boundary is cheap;
only the persistent, per-frame-rewritten pools need the C-minor layout.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.ops import packing, se3

# FSM codes (frontend.h:26-30)
INITIALIZING = 0
TRACKING = 1
LOST = 2


class VOState(NamedTuple):
    # --- keyframes -------------------------------------------------------
    kf_pose: jnp.ndarray  # [K, 7] T_c_w
    kf_valid: jnp.ndarray  # [K] bool
    kf_timestamp: jnp.ndarray  # [K] f32 seconds since the first staged frame
    # (hosts keep the absolute float64 origin - see VisualOdometry.time_base;
    # raw TUM epoch stamps would lose ~2 min of precision in f32)
    num_kf: jnp.ndarray  # scalar int32: next keyframe slot (monotonic)

    # --- mappoints (C-minor pools - see module docstring) -----------------
    mp_pos: jnp.ndarray  # [3, C]
    mp_desc: jnp.ndarray  # [8, C] uint32 packed 256-bit descriptor
    mp_bip: jnp.ndarray  # [C, 256] int8 bipolar descriptor (for matching);
    # [C, 0] under cfg.packed_matching (matching reads mp_desc instead)
    mp_norm: jnp.ndarray  # [3, C] mean viewing direction (mappoint.h:59-64)
    mp_valid: jnp.ndarray  # [C] bool: slot allocated
    mp_outlier: jnp.ndarray  # [C] bool (mappoint.h:32)
    mp_triangulated: jnp.ndarray  # [C] bool (mappoint.h:23)
    mp_optimized: jnp.ndarray  # [C] bool (mappoint.h:24)

    # --- observations (per-mappoint slots, C-minor planes) ----------------
    obs_kf: jnp.ndarray  # [M, C] int32 keyframe slot, -1 = empty
    obs_uv: jnp.ndarray  # [2, M, C] float32 pixel position (u plane, v plane)
    obs_depth: jnp.ndarray  # [M, C] float32 measured depth in meters (0 = none)
    obs_valid: jnp.ndarray  # [M, C] bool

    # --- derived-but-cached incidence (maintained incrementally) ----------
    # A_inc[K, C] int8: keyframe k observes mappoint c.  Kept in lock-step
    # with the observation table because rebuilding it is a 2M-element
    # scatter per frame while the incremental updates are one
    # row-write (add), a small scatter (create) and a masked scatter (BA
    # pruning).  tests/test_mapstate.py asserts consistency.
    A_inc: jnp.ndarray

    # --- tracking bookkeeping -------------------------------------------
    ref_kf: jnp.ndarray  # scalar int32: keyframeRef_ slot
    prev_pose: jnp.ndarray  # [7] framePrev_ pose
    fsm: jnp.ndarray  # scalar int32 INITIALIZING/TRACKING/LOST
    lost_count: jnp.ndarray  # scalar int32 accuLostFrameNums_
    frame_index: jnp.ndarray  # scalar int32
    rng: jax.Array  # PRNG key for RANSAC sampling

    @property
    def mp_alive(self) -> jnp.ndarray:
        """Allocated, non-outlier mappoints (the usable map)."""
        return self.mp_valid & ~self.mp_outlier

    @property
    def mp_obs_count(self) -> jnp.ndarray:
        return jnp.sum(self.obs_valid, axis=0).astype(jnp.int32)

    @property
    def obs_capacity(self) -> tuple[int, int]:
        """(C, M) pool capacities (obs planes are [M, C])."""
        M, C = self.obs_kf.shape
        return C, M


def init_state(cfg: VOConfig, seed: int = 0) -> VOState:
    K, C, M = cfg.max_keyframes, cfg.max_mappoints, cfg.max_obs_per_mappoint
    f32 = jnp.float32
    return VOState(
        kf_pose=jnp.tile(se3.identity(f32)[None], (K, 1)),
        kf_valid=jnp.zeros(K, bool),
        kf_timestamp=jnp.zeros(K, f32),
        num_kf=jnp.int32(0),
        mp_pos=jnp.zeros((3, C), f32),
        mp_desc=jnp.zeros((8, C), jnp.uint32),
        # packed_matching reclaims the pool's largest leaf (16 MB/stream at
        # C=65536): matching then runs off the packed mp_desc pool
        mp_bip=jnp.zeros((C, 0 if cfg.packed_matching else 256), jnp.int8),
        mp_norm=jnp.zeros((3, C), f32),
        mp_valid=jnp.zeros(C, bool),
        mp_outlier=jnp.zeros(C, bool),
        mp_triangulated=jnp.zeros(C, bool),
        mp_optimized=jnp.zeros(C, bool),
        obs_kf=jnp.full((M, C), -1, jnp.int32),
        obs_uv=jnp.zeros((2, M, C), f32),
        obs_depth=jnp.zeros((M, C), f32),
        obs_valid=jnp.zeros((M, C), bool),
        A_inc=jnp.zeros((K, C), jnp.int8),
        ref_kf=jnp.int32(0),
        prev_pose=se3.identity(f32),
        fsm=jnp.int32(INITIALIZING),
        lost_count=jnp.int32(0),
        frame_index=jnp.int32(0),
        rng=jax.random.PRNGKey(seed),
    )


# ---------------------------------------------------------------------------
# covisibility / tracking map (derived quantities)
# ---------------------------------------------------------------------------


def incidence(state: VOState) -> jnp.ndarray:
    """A[K, C] int8: keyframe k observes mappoint c (incrementally cached)."""
    return state.A_inc


def incidence_from_obs(state: VOState) -> jnp.ndarray:
    """Rebuild the incidence matrix from the observation table by scatter.

    Slow path (2M-element scatter) kept as the ground truth for consistency
    tests of the incremental ``A_inc``.
    """
    K = state.kf_pose.shape[0]
    M, C = state.obs_kf.shape
    cols = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (M, C))
    rows = jnp.clip(state.obs_kf, 0, K - 1)
    vals = state.obs_valid.astype(jnp.int8)
    A = jnp.zeros((K, C), jnp.int8)
    return A.at[rows.reshape(-1), cols.reshape(-1)].max(vals.reshape(-1))


def covisibility_weights(A: jnp.ndarray) -> jnp.ndarray:
    """W[K, K] int32 = A @ A^T: shared-observation counts - the weight map of
    ``Frame::allCovisibleKeyframeIdToWeight_`` (``src/frame.cpp:110-117``)."""
    return jax.lax.dot_general(
        A, A, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def active_covisible(state: VOState, A: jnp.ndarray, kf: jnp.ndarray, threshold: int) -> jnp.ndarray:
    """[K] bool: keyframes sharing >= threshold observations with ``kf``,
    *plus kf itself* (``mapmanager.cpp:17-19`` inserts the query keyframe).
    Computed as one row of A @ A^T."""
    K = A.shape[0]
    # int8 operands, int32 accumulation: casting the whole [K, C] incidence
    # to int32 would materialize a 4x copy per call (same int8 path as the
    # Hamming matmul)
    row = jax.lax.dot_general(
        A[kf], A,
        dimension_numbers=(((0,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    mask = (row >= threshold) | (jnp.arange(K) == kf)
    return mask & state.kf_valid


def tracking_map_mask(state: VOState, cfg: VOConfig) -> jnp.ndarray:
    """[C] bool: the tracking map of ``MatchKeyPointsInTrackingMap``
    (``src/frontend.cpp:156-166`` + ``src/mapmanager.cpp:14-38``):
    non-outlier mappoints observed by the reference keyframe or its active
    covisible keyframes; if fewer than ``tracking_map_min_points``, fall back
    to the whole map."""
    A = incidence(state)
    kfs = active_covisible(state, A, state.ref_kf, cfg.covisibility_weight_threshold)
    observed = (
        jax.lax.dot_general(
            kfs.astype(jnp.int8), A,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        > 0
    )
    local = observed & state.mp_alive
    enough = jnp.sum(local) >= cfg.tracking_map_min_points
    return jnp.where(enough, local, state.mp_alive)


# ---------------------------------------------------------------------------
# state updates (all pred-masked so they compose inside one jitted step)
# ---------------------------------------------------------------------------


def insert_keyframe(
    state: VOState,
    pose: jnp.ndarray,
    timestamp: jnp.ndarray,
    pred: jnp.ndarray,
    eviction: str = "ring",
):
    """Masked equivalent of ``MapManager::InsertKeyframe``
    (``mapmanager.h:28-33``).  Returns ``(state, slot, inserted)``.

    The reference's map is unbounded (it never deletes keyframes); this pool
    is fixed-capacity, so past capacity one of two policies applies:

    - ``eviction="ring"`` (default): recycle the oldest slot among 1..K-1
      (slot 0 - the initial keyframe and BA gauge anchor - is never evicted).
      The evicted keyframe's observations are cleared first; mappoints whose
      observation count drops to zero become outliers, exactly the lifecycle
      of ``Mappoint::RemoveObservedByKeyframe`` (``src/mappoint.cpp:39-49``).
    - ``eviction="refuse"``: the insert is dropped and ``inserted`` comes
      back False so the caller can skip every downstream keyframe update
      (observations, new mappoints, ref-keyframe advance) instead of
      attributing them to a stale slot.

    ``num_kf`` counts keyframes *ever inserted* (monotonic); the live count
    is ``min(num_kf, K)`` under ring eviction.
    """
    K = state.kf_pose.shape[0]
    full = state.num_kf >= K
    if eviction == "refuse":
        inserted = pred & ~full
        slot = jnp.clip(state.num_kf, 0, K - 1)
    elif eviction == "ring":
        inserted = pred
        # slots 1..K-1 recycle round-robin; slot 0 stays pinned
        ring = (state.num_kf - K) % (K - 1) + 1 if K > 1 else jnp.int32(0)
        slot = jnp.where(full, ring, state.num_kf).astype(jnp.int32)
        evict = inserted & full & state.kf_valid[jnp.clip(slot, 0, K - 1)]
        # clear the evicted keyframe's observations (dense compare, no scatter)
        hit_obs = evict & (state.obs_kf == slot) & state.obs_valid
        obs_valid = state.obs_valid & ~hit_obs
        count = jnp.sum(obs_valid, axis=0)
        mp_outlier = state.mp_outlier | (state.mp_valid & (count == 0))
        A_inc = jnp.where(
            ((jnp.arange(K) == slot) & evict)[:, None],
            jnp.zeros_like(state.A_inc),
            state.A_inc,
        )
        state = state._replace(obs_valid=obs_valid, mp_outlier=mp_outlier, A_inc=A_inc)
    else:
        raise ValueError(f"unknown keyframe eviction policy {eviction!r}")
    # dense one-hot writes instead of dynamic-index scatters: K is small
    # (the scatter-free formulation of ops/packing.py)
    hit = (jnp.arange(K) == slot) & inserted
    pose = jnp.asarray(pose, state.kf_pose.dtype)
    timestamp = jnp.asarray(timestamp, state.kf_timestamp.dtype)
    state = state._replace(
        kf_pose=jnp.where(hit[:, None], pose[None, :], state.kf_pose),
        kf_valid=state.kf_valid | hit,
        kf_timestamp=jnp.where(hit, timestamp, state.kf_timestamp),
        num_kf=jnp.where(inserted, state.num_kf + 1, state.num_kf),
    )
    return state, slot, inserted


def add_observations(
    state: VOState,
    kf_slot: jnp.ndarray,
    mp_mask: jnp.ndarray,  # [C] add an observation for these mappoints
    uvT: jnp.ndarray,  # [2, C] pixel position per mappoint (u row, v row)
    cam_center: jnp.ndarray,  # [3] observing camera center (for norm update)
    pred: jnp.ndarray,
    depth: jnp.ndarray | None = None,  # [C] measured depth at the pixel (m)
) -> VOState:
    """Vectorized ``Frame::AddObservedMappoint`` (``src/frame.cpp:93-121``) +
    ``Mappoint::AddObservedByKeyframe`` (``mappoint.h:59-64``) over the whole
    pool at once.  Each selected mappoint gets its first free observation
    slot; the viewing-direction normal is updated with the reference's
    normalized running sum.  Covisibility needs no update here - it is
    derived from the observation table (see :func:`covisibility_weights`).

    ``uvT`` is C-minor (``[2, C]``) to match the pool planes - callers with
    per-row ``[C, 2]`` data pass ``uv.T`` (the transpose fuses).
    """
    M, C = state.obs_kf.shape
    # explicit casts: float64 host inputs would otherwise hit JAX's
    # unsafe-scatter-cast FutureWarning (hard error in future releases)
    uvT = jnp.asarray(uvT, jnp.float32)
    cam_center = jnp.asarray(cam_center, jnp.float32)
    mp_mask = mp_mask & pred
    free = ~state.obs_valid  # [M, C]
    has_free = jnp.any(free, axis=0)
    first_free = jnp.argmax(free, axis=0)  # first True (0 if none - guarded)
    do = mp_mask & has_free
    one_hot = (jnp.arange(M)[:, None] == first_free[None, :]) & do[None, :]

    obs_kf = jnp.where(one_hot, kf_slot, state.obs_kf)
    obs_uv = jnp.where(one_hot[None, :, :], uvT[:, None, :], state.obs_uv)
    if depth is None:
        depth = jnp.zeros(C, jnp.float32)
    depth = jnp.asarray(depth, jnp.float32)
    obs_depth = jnp.where(one_hot, depth[None, :], state.obs_depth)
    obs_valid = state.obs_valid | one_hot

    # norm_ = normalize(norm_ + normalize(pos - camCenter))  (mappoint.h:63)
    d = state.mp_pos - cam_center[:, None]
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=0, keepdims=True), 1e-12)
    new_norm = state.mp_norm + d
    new_norm = new_norm / jnp.maximum(
        jnp.linalg.norm(new_norm, axis=0, keepdims=True), 1e-12
    )
    mp_norm = jnp.where(do[None, :], new_norm, state.mp_norm)

    # dense row update instead of a dynamic-row scatter (vmap-safe)
    K = state.A_inc.shape[0]
    rowsel = jnp.arange(K) == jnp.clip(kf_slot, 0, K - 1)
    A_inc = jnp.where(
        rowsel[:, None],
        jnp.maximum(state.A_inc, do.astype(jnp.int8)[None, :]),
        state.A_inc,
    )

    return state._replace(
        obs_kf=obs_kf, obs_uv=obs_uv, obs_depth=obs_depth, obs_valid=obs_valid,
        mp_norm=mp_norm, A_inc=A_inc,
    )


def create_mappoints(
    state: VOState,
    kf_slot: jnp.ndarray,
    positions: jnp.ndarray,  # [N, 3] world positions
    desc: jnp.ndarray,  # [N, 8] uint32
    bip: jnp.ndarray,  # [N, 256] int8
    uv: jnp.ndarray,  # [N, 2] observing pixel
    create_mask: jnp.ndarray,  # [N] bool
    cam_center: jnp.ndarray,  # [3]
    pred: jnp.ndarray,
    depth: jnp.ndarray | None = None,  # [N] measured depth at the pixel (m)
) -> VOState:
    """Vectorized ``FrontEnd::CreateNewMappoints`` (``src/frontend.cpp:372-406``):
    allocate pool slots (recycling outlier slots), write position/descriptor,
    and register the creating keyframe as first observer.

    Returns ``(state, n_created)`` where ``n_created`` counts the creates
    that actually landed - requests beyond the free-slot supply are dropped
    and surface in the caller's stats (pool-overflow observability).

    The per-row inputs stay row-major (``N`` is the small keypoint count);
    the write-back gathers their TRANSPOSES into the C-minor pools.
    """
    M, C = state.obs_kf.shape
    N = positions.shape[0]
    positions = jnp.asarray(positions, jnp.float32)
    uv = jnp.asarray(uv, jnp.float32)
    cam_center = jnp.asarray(cam_center, jnp.float32)
    create_mask = create_mask & pred

    free_mask = ~state.mp_valid | state.mp_outlier
    # rank of each new point among those being created
    rank = jnp.cumsum(create_mask.astype(jnp.int32)) - 1  # [N]
    # the rank-th free slot: compact free slots (ascending index)
    free_idx, free_ok = packing.compact_indices(free_mask, N)
    slot = jnp.take(free_idx, jnp.clip(rank, 0, N - 1))  # [N]
    ok = create_mask & jnp.take(free_ok, jnp.clip(rank, 0, N - 1))

    # first observation: viewing normal = normalize(pos - center) since the
    # stored norm starts at zero (mappoint.cpp:36-38 + mappoint.h:63)
    d = positions - cam_center[None, :]
    d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)

    if depth is None:
        depth = jnp.zeros(N, jnp.float32)
    depth = jnp.asarray(depth, jnp.float32)

    # scatter-free write-back: invert the (unique) target-slot list and
    # GATHER each new row into its pool slot (see ops/packing.py)
    hit, inv = packing.inverse_lookup(C, slot, ok)  # [C], [C]

    def put_cm(pool, rows):
        """C-minor pool [..., C] <- rows [N, ...] transposed + gathered."""
        rowsT = jnp.moveaxis(rows, 0, -1)  # [..., N]
        cond = hit.reshape((1,) * (pool.ndim - 1) + (C,))
        return jnp.where(cond, jnp.take(rowsT, inv, axis=-1), pool)

    first_col = jnp.arange(M) == 0  # new points start with one observation
    K = state.A_inc.shape[0]
    rowsel = jnp.arange(K) == jnp.clip(kf_slot, 0, K - 1)

    n_created = jnp.sum(ok).astype(jnp.int32)
    uvT_new = jnp.take(uv.T, inv, axis=1)  # [2, C]
    state = state._replace(
        mp_pos=put_cm(state.mp_pos, positions),
        mp_desc=put_cm(state.mp_desc, desc),
        mp_norm=put_cm(state.mp_norm, d),
        # mp_bip keeps its row-major [C, 256] layout (tile-exact already);
        # zero-width under packed_matching: slice the incoming rows to the
        # pool's (possibly empty) bit width
        mp_bip=jnp.where(
            hit[:, None],
            jnp.take(bip[:, : state.mp_bip.shape[1]], inv, axis=0),
            state.mp_bip,
        ),
        mp_valid=state.mp_valid | hit,
        mp_outlier=state.mp_outlier & ~hit,
        mp_triangulated=state.mp_triangulated & ~hit,
        mp_optimized=state.mp_optimized & ~hit,
        obs_kf=jnp.where(
            hit[None, :], jnp.where(first_col, kf_slot, -1)[:, None], state.obs_kf
        ),
        obs_uv=jnp.where(
            hit[None, None, :],
            first_col[None, :, None] * uvT_new[:, None, :],
            state.obs_uv,
        ),
        obs_depth=jnp.where(
            hit[None, :],
            first_col[:, None] * jnp.take(depth, inv)[None, :],
            state.obs_depth,
        ),
        obs_valid=jnp.where(hit[None, :], first_col[:, None], state.obs_valid),
        A_inc=jnp.where(
            rowsel[:, None],
            jnp.maximum(state.A_inc, hit.astype(jnp.int8)[None, :]),
            state.A_inc,
        ),
    )
    return state, n_created


def remove_observations(state: VOState, rm_mask: jnp.ndarray) -> VOState:
    """Vectorized ``Frame::RemoveObservedMappoint`` + outlier marking
    (``src/frame.cpp:123-154``, ``src/mappoint.cpp:39-49``): clear the given
    observation slots; mappoints whose observation count drops to zero become
    outliers (and their slot becomes recyclable).

    Full-pool form (rm_mask [M, C]); prefer
    :func:`remove_observations_rows` from compact per-point problems (BA) -
    it avoids a 2M-lane scatter on the incidence matrix.
    """
    K = state.A_inc.shape[0]
    M, C = state.obs_kf.shape
    obs_valid = state.obs_valid & ~rm_mask
    count = jnp.sum(obs_valid, axis=0)
    outlier = state.mp_outlier | (state.mp_valid & (count == 0))
    # clear incidence entries of removed observations ((kf, mp) pairs are
    # unique by construction, so a direct clear is safe)
    rows = jnp.where(rm_mask & state.obs_valid, jnp.clip(state.obs_kf, 0, K - 1), K)
    cols = jnp.broadcast_to(jnp.arange(C, dtype=jnp.int32)[None, :], (M, C))
    A_inc = state.A_inc.at[rows.reshape(-1), cols.reshape(-1)].set(0, mode="drop")
    return state._replace(obs_valid=obs_valid, mp_outlier=outlier, A_inc=A_inc)


def remove_observations_rows(
    state: VOState,
    pidx: jnp.ndarray,  # [B] mappoint slots
    pval: jnp.ndarray,  # [B] bool
    prune: jnp.ndarray,  # [B, M] slots to clear (row-major, BA's layout)
) -> VOState:
    """Compact form of :func:`remove_observations` for per-point problems:
    only B*M scatter lanes instead of C*M."""
    K = state.A_inc.shape[0]
    M, C = state.obs_kf.shape
    pruneT = prune.T & pval[None, :]  # [M, B]
    tgt = jnp.where(pval, pidx, C)
    old_cols = jnp.take(state.obs_valid, pidx, axis=1)  # [M, B]
    new_cols = old_cols & ~pruneT
    obs_valid = state.obs_valid.at[:, tgt].set(new_cols, mode="drop")

    new_count = jnp.sum(new_cols, axis=0)
    was_valid = jnp.take(state.mp_valid, pidx)
    newly_outlier = pval & was_valid & (new_count == 0)
    mp_outlier = state.mp_outlier.at[jnp.where(newly_outlier, pidx, C)].set(
        True, mode="drop"
    )

    okf = jnp.take(state.obs_kf, pidx, axis=1)  # [M, B]
    rows = jnp.where(pruneT & old_cols, jnp.clip(okf, 0, K - 1), K)
    cols = jnp.broadcast_to(pidx[None, :], pruneT.shape)
    A_inc = state.A_inc.at[rows.reshape(-1), cols.reshape(-1)].set(0, mode="drop")
    return state._replace(obs_valid=obs_valid, mp_outlier=mp_outlier, A_inc=A_inc)
