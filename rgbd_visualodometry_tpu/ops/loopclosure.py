"""Loop-closure pose-graph construction from the map's observation table.

Net-new capability beyond the reference (its backend only ever re-solves
the local covisible window, ``src/backend.cpp:19-195``; a revisit is never
used to undo accumulated drift).  Two complementary detectors:

1. **Co-observation** (:func:`build_coobservation_graph`): because
   tracking matches every frame against the PERSISTENT map (the
   reference's ``trackingMap_`` idea, ``src/mapmanager.cpp:14-38``), a
   camera revisiting a mapped area re-associates the OLD mappoints, and
   the new keyframe's observation rows link it directly to
   temporally-distant keyframes - the observation table already
   *contains* those loop closures.
2. **Appearance** (:func:`build_appearance_graph`): when the covisibility
   tracking window excluded the old landmarks during the revisit (long
   excursion), the frontend duplicates them instead of re-associating and
   no co-observation edge exists - a bag-of-bits screen + exact
   mutual-NN Hamming matching + trimmed Horn registration recovers the
   edge from descriptors alone.

Each observation stores the measured pixel + raw depth
(``mapstate.VOState.obs_uv/obs_depth``), so two keyframes observing the
same mappoint yield an INDEPENDENT 3D-3D correspondence between their
camera frames (back-projected measurements, not the shared map position).
For every keyframe pair this module accumulates weighted Kabsch moments
and solves Horn's closed form per pair, producing a relative-pose edge
``T_i^{-1} T_j`` ready for ``ops/posegraph.optimize_pose_graph``.

Shape of the computation:

- ONE pass over the ``[C, M]`` observation table, chunked with
  ``lax.scan`` (bounded memory), building all ``M x M`` within-row pairs
  and scatter-adding their moments into dense ``[K, K]`` accumulators
  (K = keyframe capacity, small: the whole accumulator set is ~3 MB at
  K=256).  No per-pair gathering, no data-dependent shapes.
- Per-pair rotation comes from the accumulated cross-covariance via the
  same Jacobi 4x4 eigensolver the PnP path uses
  (``ops/smalleig.horn_quat_from_crosscov``) - a batched closed form, no
  iteration.
- Edge compaction (dropping pairs below ``min_shared``) happens on the
  host: graph construction is offline post-processing, and a compacted
  edge list keeps the downstream Gauss-Newton dense-block assembly small.

Edge weights are the clamped co-observation counts: the pose-graph
solver's robust kernel needs weights bounded relative to the odometry
chain (measured requirement, see ``ops/posegraph.py`` module docstring),
so a 500-point pair must not get 50x the influence of a 10-point pair.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from rgbd_visualodometry_tpu import camera as camera_mod
from rgbd_visualodometry_tpu.ops import se3
from rgbd_visualodometry_tpu.ops.posegraph import PoseGraph
from rgbd_visualodometry_tpu.ops.smalleig import horn_quat_from_crosscov


@partial(jax.jit, static_argnames=("chunk_rows",))
def coobservation_moments(state, cam, chunk_rows: int = 2048):
    """Weighted Kabsch moments for every ordered keyframe pair (i < j).

    For each mappoint row, every pair of depth-valid observations
    ``(m1, m2)`` with ``obs_kf[m1] < obs_kf[m2]`` contributes one 3D-3D
    correspondence ``a = backproject(obs m1)`` in keyframe i's camera
    frame, ``b = backproject(obs m2)`` in keyframe j's:

    Returns ``(cnt[K, K], sa[K, K, 3], sb[K, K, 3], mba[K, K, 3, 3])``::

        cnt[i, j] = sum w        sa[i, j] = sum w * a
        sb[i, j]  = sum w * b    mba[i, j, α, β] = sum w * b_α * a_β

    (w = 1 per correspondence today; the layout supports any per-obs
    weighting.)  Chunked ``lax.scan`` over mappoint rows bounds the
    transient at ``chunk_rows * M^2`` pair items.
    """
    K = state.kf_pose.shape[0]
    M, C = state.obs_kf.shape  # C-minor pools (mapstate.py docstring)
    n_chunks = -(-C // chunk_rows)
    pad = n_chunks * chunk_rows - C

    # transpose the C-minor planes to row-major [C, M] once at entry: this
    # is offline post-processing (once per relax), so the one-off padded
    # copy is irrelevant next to keeping the scan body unchanged
    def padded(x, fill):
        if pad == 0:
            return x
        tail = jnp.full((pad,) + x.shape[1:], fill, x.dtype)
        return jnp.concatenate([x, tail])

    kf = padded(state.obs_kf.T, -1).reshape(n_chunks, chunk_rows, M)
    uv = padded(jnp.transpose(state.obs_uv, (2, 1, 0)), 0.0).reshape(
        n_chunks, chunk_rows, M, 2
    )
    dep = padded(state.obs_depth.T, 0.0).reshape(n_chunks, chunk_rows, M)
    val = padded(state.obs_valid.T, False).reshape(n_chunks, chunk_rows, M)

    def body(acc, inp):
        cnt, sa, sb, mba = acc
        kf_c, uv_c, dep_c, val_c = inp
        ok = val_c & (dep_c > 0.0) & (kf_c >= 0)
        p = camera_mod.pixel2camera(cam, uv_c, dep_c)  # [B, M, 3]
        i_id = kf_c[:, :, None]  # keyframe of slot m1 -> point 'a'
        j_id = kf_c[:, None, :]  # keyframe of slot m2 -> point 'b'
        # i < j canonicalizes each unordered pair exactly once (slot ids
        # within one row are distinct: one observation per keyframe)
        w = (ok[:, :, None] & ok[:, None, :] & (i_id < j_id)).astype(
            jnp.float32
        )  # [B, M, M]
        pshape = w.shape + (3,)
        a = jnp.broadcast_to(p[:, :, None, :], pshape)
        b = jnp.broadcast_to(p[:, None, :, :], pshape)
        idx_i = jnp.clip(jnp.broadcast_to(i_id, w.shape), 0, K - 1).reshape(-1)
        idx_j = jnp.clip(jnp.broadcast_to(j_id, w.shape), 0, K - 1).reshape(-1)
        wf = w.reshape(-1)
        af = a.reshape(-1, 3)
        bwf = (b * w[..., None]).reshape(-1, 3)  # weight folded in once
        cnt = cnt.at[idx_i, idx_j].add(wf)
        sa = sa.at[idx_i, idx_j].add(af * wf[:, None])
        sb = sb.at[idx_i, idx_j].add(bwf)
        mba = mba.at[idx_i, idx_j].add(
            jnp.einsum("na,nb->nab", bwf, af, precision=jax.lax.Precision.HIGHEST)
        )
        return (cnt, sa, sb, mba), None

    f32 = jnp.float32
    init = (
        jnp.zeros((K, K), f32),
        jnp.zeros((K, K, 3), f32),
        jnp.zeros((K, K, 3), f32),
        jnp.zeros((K, K, 3, 3), f32),
    )
    (cnt, sa, sb, mba), _ = jax.lax.scan(body, init, (kf, uv, dep, val))
    return cnt, sa, sb, mba


@jax.jit
def kabsch_from_moments(cnt, sa, sb, mba) -> jnp.ndarray:
    """Weighted Horn alignment from accumulated moments (batched).

    Solves ``a ~= R b + t`` - maps keyframe-j camera coordinates into
    keyframe i's - which in the package's T_w_c pose-graph convention IS
    the edge measurement ``T_i^{-1} T_j``
    (``ops/posegraph.relative_measurement``).
    """
    w = jnp.maximum(cnt, 1e-9)[..., None]
    abar = sa / w
    bbar = sb / w
    # centered cross-covariance with world = b, cam = a
    S = mba - cnt[..., None, None] * bbar[..., :, None] * abar[..., None, :]
    q = horn_quat_from_crosscov(S)
    t = abar - se3.quat_rotate(q, bbar)
    return se3.make(q, t)


def keyframe_feature_table(state, cam, max_features: int = 512):
    """Per-keyframe local feature sets from the observation table.

    Returns ``(desc [K, F, 8] u32, pts [K, F, 3] f32, valid [K, F])``:
    each keyframe's depth-valid observations of alive mappoints, carrying
    the landmark's 256-bit descriptor and the back-projected MEASURED
    pixel+depth (an independent local 3D measurement in that keyframe's
    camera frame - not the shared, possibly drifted, map position).

    Host-side packing: this feeds offline loop-closure detection, and the
    per-keyframe observation counts are data-dependent.
    """
    # host-side transposes of the C-minor planes back to row-major [C, M]
    obs_kf = np.asarray(state.obs_kf).T  # [C, M]
    obs_valid = np.asarray(state.obs_valid).T
    obs_depth = np.asarray(state.obs_depth).T
    obs_uv = np.transpose(np.asarray(state.obs_uv), (2, 1, 0))  # [C, M, 2]
    mp_desc = np.asarray(state.mp_desc).T  # [C, 8]
    alive = np.asarray(state.mp_valid) & ~np.asarray(state.mp_outlier)
    K = state.kf_pose.shape[0]

    ok = obs_valid & (obs_depth > 0.0) & (obs_kf >= 0) & alive[:, None]
    c_idx, m_idx = np.nonzero(ok)
    k_idx = obs_kf[c_idx, m_idx]
    order = np.argsort(k_idx, kind="stable")
    c_idx, m_idx, k_idx = c_idx[order], m_idx[order], k_idx[order]
    starts = np.searchsorted(k_idx, np.arange(K + 1))

    F = int(max_features)
    desc = np.zeros((K, F, 8), np.uint32)
    pts = np.zeros((K, F, 3), np.float32)
    val = np.zeros((K, F), bool)
    if c_idx.size:
        p_cam = np.asarray(
            camera_mod.pixel2camera(
                cam,
                jnp.asarray(obs_uv[c_idx, m_idx]),
                jnp.asarray(obs_depth[c_idx, m_idx]),
            )
        )
        for k in range(K):
            s, e = int(starts[k]), int(starts[k + 1])
            n = min(e - s, F)
            if n == 0:
                continue
            desc[k, :n] = mp_desc[c_idx[s : s + n]]
            pts[k, :n] = p_cam[s : s + n]
            val[k, :n] = True
    return desc, pts, val


def _bit_histogram(desc: np.ndarray, val: np.ndarray) -> np.ndarray:
    """[K, 256] mean-bit signature per keyframe (a tiny bag-of-bits global
    descriptor; enough to rank candidate pairs before exact matching).
    Word-at-a-time so the transient stays [K, F, 32], not [K, F, 256]
    float32 (~268 MB at K=F=512)."""
    K, F, W = desc.shape
    out = np.zeros((K, W * 32), np.float32)
    shifts = np.arange(32, dtype=np.uint32)
    vf = val.astype(np.float32)
    for w in range(W):
        bits = ((desc[:, :, w, None] >> shifts) & np.uint32(1)).astype(np.float32)
        out[:, w * 32 : (w + 1) * 32] = np.einsum("kf,kfb->kb", vf, bits)
    cnt = np.maximum(val.sum(axis=1, keepdims=True), 1).astype(np.float32)
    return out / cnt


def _register_pair(di, pi, vi, dj, pj, vj, match_ratio, min_match_distance, inlier_radius):
    """Mutual-NN Hamming matching + trimmed Horn registration of one
    keyframe pair's local features.  Returns ``(T_i^-1 T_j, inliers, rms)``.

    Matching keeps the reference's adaptive gate
    ``max(min_dis * ratio, 30)`` (``src/frontend.cpp:190-211``) plus a
    mutual-NN requirement (self-similar structure produces asymmetric
    matches; mutuality is the cheap symmetric filter).
    """
    F = di.shape[0]
    BIG = 1 << 14
    d = jnp.zeros((F, F), jnp.int32)
    for w in range(8):  # word-at-a-time keeps the transient at [F, F]
        d = d + jax.lax.population_count(di[:, None, w] ^ dj[None, :, w]).astype(jnp.int32)
    d = jnp.where(vi[:, None] & vj[None, :], d, BIG)
    nn_j = jnp.argmin(d, axis=1)
    dmin = jnp.min(d, axis=1)
    nn_i = jnp.argmin(d, axis=0)
    mutual = jnp.take(nn_i, nn_j) == jnp.arange(F)
    row_ok = vi & (dmin < BIG)
    min_dis = jnp.min(jnp.where(row_ok, dmin, BIG)).astype(jnp.float32)
    gate = dmin.astype(jnp.float32) <= jnp.maximum(
        min_dis * match_ratio, min_match_distance
    )
    m0 = (row_ok & mutual & gate).astype(jnp.float32)
    a = pi  # [F, 3] in keyframe i's camera frame
    b = jnp.take(pj, nn_j, axis=0)  # matched partner in keyframe j's frame

    def fit(w):
        cw = jnp.maximum(jnp.sum(w), 1e-9)
        abar = jnp.sum(a * w[:, None], axis=0) / cw
        bbar = jnp.sum(b * w[:, None], axis=0) / cw
        S = jnp.einsum("n,na,nb->ab", w, b - bbar, a - abar, precision=jax.lax.Precision.HIGHEST)
        q = horn_quat_from_crosscov(S)
        t = abar - se3.quat_rotate(q, bbar)
        return se3.make(q, t)

    # trimmed IRLS: refit on the survivors of a fixed inlier radius - the
    # descriptor-NN match set always carries aliased outliers
    w = m0
    pose = fit(w)
    for _ in range(4):
        r = jnp.linalg.norm(a - se3.apply(pose, b), axis=-1)
        w = m0 * (r < inlier_radius)
        pose = fit(w)
    r = jnp.linalg.norm(a - se3.apply(pose, b), axis=-1)
    w = m0 * (r < inlier_radius)
    inl = jnp.sum(w)
    rms = jnp.sqrt(jnp.sum(w * r * r) / jnp.maximum(inl, 1.0))
    return pose, inl.astype(jnp.int32), rms


_register_pairs = jax.jit(jax.vmap(_register_pair, in_axes=(0, 0, 0, 0, 0, 0, None, None, None)))


def build_appearance_graph(
    state,
    cam,
    *,
    max_features: int = 512,
    top_per_kf: int = 3,
    loop_gap_s: float = 5.0,
    min_features: int = 30,
    min_inliers: int = 12,
    inlier_radius: float = 0.10,
    match_ratio: float = 2.0,
    min_match_distance: float = 30.0,
    max_pair_weight: float = 30.0,
    exclude=(),
    chunk_pairs: int = 16,
) -> PoseGraph:
    """Appearance-based loop-closure edges: descriptor place recognition
    with no reliance on shared mappoint rows.

    :func:`build_coobservation_graph` only sees a revisit when tracking
    re-associated the OLD landmarks.  When the covisibility tracking
    window excluded them (long excursion: the window follows the reference
    keyframe), the frontend duplicates the landmarks instead and the
    co-observation graph has no loop edge - exactly the drifted case that
    needs one.  This detector closes that gap: keyframes are ranked by a
    bag-of-bits global descriptor, the best temporally-distant candidates
    are matched exactly (mutual-NN Hamming, reference distance gate), and
    each match set is registered by trimmed Horn on the two keyframes'
    INDEPENDENT back-projected measurements.  Aliased candidates die in
    the trim (``min_inliers``) or later in the pose-graph solver's
    redescending kernel.

    ``exclude`` takes ``(i, j)`` keyframe-slot pairs (i < j) that already
    have co-observation edges.
    """
    kf_valid = np.asarray(state.kf_valid)
    ts = np.asarray(state.kf_timestamp).astype(np.float64)
    desc, pts, val = keyframe_feature_table(state, cam, max_features)
    counts = val.sum(axis=1)
    usable = kf_valid & (counts >= int(min_features))
    if usable.sum() < 2:
        return empty_graph()

    hist = _bit_histogram(desc, val)
    hn = hist / np.maximum(np.linalg.norm(hist, axis=1, keepdims=True), 1e-9)
    sim = hn @ hn.T
    eligible = (
        usable[:, None]
        & usable[None, :]
        & (np.abs(ts[:, None] - ts[None, :]) > float(loop_gap_s))
    )
    sim = np.where(eligible, sim, -np.inf)
    excl = set(exclude)
    pairs = set()
    for k in np.nonzero(usable)[0]:
        for j in np.argsort(-sim[k])[: int(top_per_kf)]:
            if not np.isfinite(sim[k, j]):
                break
            p = (int(min(k, j)), int(max(k, j)))
            if p not in excl:
                pairs.add(p)
    if not pairs:
        return empty_graph()
    pairs = sorted(pairs)

    poses, inls, rmss = [], [], []
    for s in range(0, len(pairs), int(chunk_pairs)):
        chunk = pairs[s : s + int(chunk_pairs)]
        n = len(chunk)
        # pad short tails to the fixed chunk size (repeat pair 0, slice the
        # results) so one compiled _register_pairs serves every call
        chunk = chunk + [chunk[0]] * (int(chunk_pairs) - n)
        ii = np.asarray([p[0] for p in chunk])
        jj = np.asarray([p[1] for p in chunk])
        pose, inl, rms = _register_pairs(
            jnp.asarray(desc[ii]), jnp.asarray(pts[ii]), jnp.asarray(val[ii]),
            jnp.asarray(desc[jj]), jnp.asarray(pts[jj]), jnp.asarray(val[jj]),
            float(match_ratio), float(min_match_distance), float(inlier_radius),
        )
        poses.append(np.asarray(pose)[:n])
        inls.append(np.asarray(inl)[:n])
        rmss.append(np.asarray(rms)[:n])
    poses = np.concatenate(poses)
    inls = np.concatenate(inls)
    keep = inls >= int(min_inliers)
    if not keep.any():
        return empty_graph()
    ii = np.asarray([p[0] for p in pairs])[keep]
    jj = np.asarray([p[1] for p in pairs])[keep]
    return PoseGraph(
        edge_i=jnp.asarray(ii, jnp.int32),
        edge_j=jnp.asarray(jj, jnp.int32),
        edge_meas=jnp.asarray(poses[keep], jnp.float32),
        edge_weight=jnp.asarray(
            np.minimum(inls[keep], float(max_pair_weight)), jnp.float32
        ),
        edge_valid=jnp.ones((int(keep.sum()),), bool),
    )


def empty_graph() -> PoseGraph:
    return PoseGraph(
        edge_i=jnp.zeros((0,), jnp.int32),
        edge_j=jnp.zeros((0,), jnp.int32),
        edge_meas=jnp.zeros((0, 7), jnp.float32),
        edge_weight=jnp.zeros((0,), jnp.float32),
        edge_valid=jnp.zeros((0,), bool),
    )


def build_coobservation_graph(
    state,
    cam,
    *,
    min_shared: int = 8,
    max_pair_weight: float = 30.0,
    chunk_rows: int = 2048,
) -> PoseGraph:
    """Compact edge list over all keyframe pairs sharing >= ``min_shared``
    depth-valid observations.  Host-compacted (offline post-processing):
    only surviving pairs pay the per-edge Kabsch + downstream Jacobians.

    ``min_shared`` doubles as the geometric-degeneracy guard: Horn's
    rotation needs a non-collinear point spread, and a pair that genuinely
    co-observes 8+ well-distributed FAST corners is overwhelmingly
    non-degenerate; the solver's redescending kernel + chi2 prune
    (``ops/posegraph.optimize_pose_graph``) absorbs the rare bad edge.
    """
    from rgbd_visualodometry_tpu.ops.posegraph import edge_bucket

    cnt, sa, sb, mba = coobservation_moments(state, cam, chunk_rows=chunk_rows)
    cnt_h = np.asarray(cnt)
    ii, jj = np.nonzero(cnt_h >= float(min_shared))
    if ii.size == 0:
        return empty_graph()
    # bucket-pad the batched Horn solve so online (mid-run) callers reuse
    # one compiled program across growing edge counts (pad rows repeat pair
    # 0 and are sliced off below)
    cap = edge_bucket(ii.size)
    pi = np.concatenate([ii, np.full(cap - ii.size, ii[0])])
    pj = np.concatenate([jj, np.full(cap - jj.size, jj[0])])
    meas = kabsch_from_moments(cnt[pi, pj], sa[pi, pj], sb[pi, pj], mba[pi, pj])[
        : ii.size
    ]
    weight = np.minimum(cnt_h[ii, jj], float(max_pair_weight))
    return PoseGraph(
        edge_i=jnp.asarray(ii, jnp.int32),
        edge_j=jnp.asarray(jj, jnp.int32),
        edge_meas=meas,
        edge_weight=jnp.asarray(weight, jnp.float32),
        edge_valid=jnp.ones((ii.size,), bool),
    )
