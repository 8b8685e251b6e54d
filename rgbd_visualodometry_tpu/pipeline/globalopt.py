"""Offline global map refinement: loop-closure graph + SE(3) relaxation.

Net-new vs the reference, whose optimizer never revisits poses outside the
local covisible window (``src/backend.cpp:19-195``) - accumulated drift is
permanent there.  This module glues the two building blocks into one
user-facing operation on a live ``VOState``:

1. ``ops/loopclosure.build_coobservation_graph`` - relative-pose edges
   from every keyframe pair sharing depth-valid observations (revisits
   included, because tracking re-associates old mappoints from the
   persistent map);
2. ``ops/loopclosure.build_appearance_graph`` (``appearance=True``) -
   place-recognition edges for revisits that DUPLICATED landmarks
   instead of re-associating (no shared rows: invisible to 1.);
3. ``ops/posegraph.optimize_pose_graph`` - robust damped Gauss-Newton on
   the whole keyframe graph.

After relaxation the map deforms rigidly with its anchors: every mappoint
moves with the keyframe of its first observation, and the tracking
reference (``prev_pose``) moves with the current reference keyframe, so a
mid-run relaxation hands tracking a coherent world.

Typical use (also reachable as ``rgbd-vo --global-relax``)::

    vo.run(frames, trajectory_path="traj.txt")
    report = vo.global_relax()
    # report.kf_ts / old_T_w_k / new_T_w_k feed correct_trajectory()
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from rgbd_visualodometry_tpu.camera import Camera
from rgbd_visualodometry_tpu.ops import loopclosure, posegraph, se3


@dataclass
class RelaxReport:
    """What the relaxation did, plus the keyframe delta table needed to
    correct an already-written per-frame trajectory."""

    num_edges: int  # co-observation edges in the graph
    num_loop_edges: int  # of those, spanning > loop_gap_s (true closures)
    num_chain_edges: int  # odometry insurance edges added
    mean_correction_m: float  # camera-center shift over valid keyframes
    max_correction_m: float
    # valid keyframes sorted by timestamp (offsets from the first staged
    # frame, see VisualOdometry.time_base):
    kf_ts: np.ndarray  # [V]
    old_T_w_k: np.ndarray  # [V, 7]
    new_T_w_k: np.ndarray  # [V, 7]
    # appearance (place-recognition) loop edges for keyframe pairs without
    # co-observations - duplicated-landmark revisits:
    num_appearance_edges: int = 0
    # [E, 2, 3] post-relax world camera centers of the loop constraints
    # (co-obs pairs spanning > loop_gap_s + appearance pairs) - render with
    # MapViewer.export_html(edges=...)
    loop_pairs_w: np.ndarray = None


def _noop_report() -> RelaxReport:
    return RelaxReport(
        0, 0, 0, 0.0, 0.0,
        np.zeros((0,), np.float64),
        np.zeros((0, 7), np.float32),
        np.zeros((0, 7), np.float32),
        loop_pairs_w=np.zeros((0, 2, 3), np.float32),
    )


@dataclass
class Relaxation:
    """A computed (but not yet applied) relaxation: the per-keyframe-slot
    world-frame correction table plus the human-facing report.

    Decoupling computation from application is what makes ONLINE loop
    closure non-stalling: ``compute_relaxation`` runs on
    a SNAPSHOT of the state (on a worker thread - graph build, Horn edges
    and the pose-graph solve never block the frame loop), and
    ``apply_relaxation`` later deforms whatever the LIVE state has become -
    the reference backend's "latest wins" contract
    (``include/myslam/backend.h:33-37``) applied to loop closure.
    """

    report: RelaxReport
    delta_w: "jnp.ndarray"  # [K, 7] per-slot world delta (identity if invalid)
    snap_valid: "jnp.ndarray"  # [K] bool keyframe validity at snapshot time
    snap_ts: "jnp.ndarray"  # [K] f32 keyframe timestamps at snapshot time
    ref_delta_w: "jnp.ndarray"  # [7] delta of the newest snapshot keyframe


def _noop_relaxation(K: int) -> Relaxation:
    ident = jnp.tile(se3.identity(jnp.float32)[None], (K, 1))
    return Relaxation(
        report=_noop_report(),
        delta_w=ident,
        snap_valid=jnp.zeros((K,), bool),
        snap_ts=jnp.zeros((K,), jnp.float32),
        ref_delta_w=se3.identity(jnp.float32),
    )


def compute_relaxation(
    state,
    cfg,
    *,
    min_shared: int = 8,
    max_pair_weight: float = 30.0,
    odometry_weight: float = 30.0,
    num_iterations: int = 12,
    robust_delta: float = 0.05,
    loop_gap_s: float = 5.0,
    appearance: bool = True,
    appearance_min_inliers: int = 12,
    require_loop: bool = False,
) -> Relaxation:
    """Build the loop-closure graph and solve the relaxation WITHOUT
    touching the state.  Returns a :class:`Relaxation` (no-op one - empty
    ``report.kf_ts`` - when there is nothing to do).  Thread-safe with
    respect to a concurrently tracking system as long as ``state`` is a
    snapshot whose buffers the tracker will not donate.

    - The temporally-first valid keyframe is the gauge (fixed), matching
      the backend's KF-0 convention (``src/backend.cpp:60-63`` fixes the
      first frame of the window).
    - Consecutive-in-time keyframe pairs without a strong co-observation
      edge get an odometry edge holding the current relative estimate, so
      the graph always stays connected.
    - ``robust_delta`` drives the redescending kernel + chi2 prune in the
      solver; wrong loop edges (aliased geometry) die there rather than
      bending the trajectory.
    - ``require_loop=True`` makes the relaxation a NO-OP unless at least
      one loop edge (co-observation spanning > ``loop_gap_s``, or
      appearance) exists.  Without loop information the graph holds only
      short-gap co-observation + odometry edges, whose Kabsch measurements
      are strictly noisier than the BA-refined poses they would replace -
      measured on a 56-frame hard-scene circuit as ATE 0.25 -> 0.36 cm per
      loopless relax.  The online (mid-run) path always sets this.
    """
    kf_valid = np.asarray(state.kf_valid)
    slots = np.nonzero(kf_valid)[0]
    if slots.size < 2:
        return _noop_relaxation(kf_valid.shape[0])

    cam = Camera.from_config(cfg)
    graph = loopclosure.build_coobservation_graph(
        state, cam, min_shared=min_shared, max_pair_weight=max_pair_weight
    )
    poses_w = se3.inverse(state.kf_pose)  # [K, 7] T_w_c

    ts = np.asarray(state.kf_timestamp).astype(np.float64)
    order = slots[np.argsort(ts[slots], kind="stable")]

    num_coobs = int(graph.edge_i.shape[0])
    loop_ij: list = []
    if num_coobs:
        gi, gj = np.asarray(graph.edge_i), np.asarray(graph.edge_j)
        is_loop = np.abs(ts[gi] - ts[gj]) > loop_gap_s
        num_loop = int(np.sum(is_loop))
        loop_ij += list(zip(gi[is_loop].tolist(), gj[is_loop].tolist()))
        have = set(zip(gi.tolist(), gj.tolist()))
    else:
        num_loop = 0
        have = set()

    # appearance edges cover revisits that duplicated landmarks (no shared
    # observation rows -> invisible to the co-observation graph)
    num_app = 0
    if appearance:
        app = loopclosure.build_appearance_graph(
            state, cam,
            loop_gap_s=loop_gap_s,
            min_inliers=appearance_min_inliers,
            max_pair_weight=max_pair_weight,
            exclude=have,
        )
        num_app = int(app.edge_i.shape[0])
        if num_app:
            ai, aj = np.asarray(app.edge_i), np.asarray(app.edge_j)
            loop_ij += list(zip(ai.tolist(), aj.tolist()))
            have |= set(zip(ai.tolist(), aj.tolist()))
            graph = (
                posegraph.concat_graphs(graph, app) if num_coobs else app
            )

    if require_loop and num_loop + num_app == 0:
        # nothing to close: leave the BA-refined poses untouched (see the
        # docstring) but still report what was detected
        rlx = _noop_relaxation(kf_valid.shape[0])
        rlx.report.num_edges = num_coobs
        return rlx

    chain = []
    for a, b in zip(order[:-1], order[1:]):
        i, j = (int(a), int(b)) if a < b else (int(b), int(a))
        if (i, j) not in have:
            chain.append((i, j))
    if chain:
        ci = jnp.asarray([c[0] for c in chain], jnp.int32)
        cj = jnp.asarray([c[1] for c in chain], jnp.int32)
        chain_graph = posegraph.PoseGraph(
            edge_i=ci,
            edge_j=cj,
            edge_meas=posegraph.relative_measurement(poses_w[ci], poses_w[cj]),
            edge_weight=jnp.full((len(chain),), odometry_weight, jnp.float32),
            edge_valid=jnp.ones((len(chain),), bool),
        )
        graph = (
            posegraph.concat_graphs(graph, chain_graph)
            if (num_coobs or num_app)
            else chain_graph
        )
    if int(graph.edge_i.shape[0]) == 0:
        return _noop_relaxation(kf_valid.shape[0])

    # bucket-pad the edge list so the jitted solver compiles O(log E) times
    # over a whole run instead of once per relax - online relaxation
    # (relax_every_kf) calls this with a growing graph, and the per-call
    # recompile was the dominant mid-run stall
    graph = posegraph.pad_graph(
        graph, posegraph.edge_bucket(int(graph.edge_i.shape[0]))
    )

    fixed = ~kf_valid
    fixed[order[0]] = True  # earliest keyframe anchors the world (gauge)
    relaxed_w = posegraph.optimize_pose_graph(
        poses_w,
        graph,
        num_iterations=num_iterations,
        robust_delta=robust_delta,
        fixed=jnp.asarray(fixed),
    )
    valid_dev = jnp.asarray(kf_valid)
    relaxed_w = jnp.where(valid_dev[:, None], relaxed_w, poses_w)

    # the per-slot correction table (identity on invalid slots); the newest
    # snapshot keyframe's delta anchors everything created AFTER the
    # snapshot when the relaxation is applied asynchronously
    delta_w = se3.compose(relaxed_w, se3.inverse(poses_w))  # [K, 7]
    K = kf_valid.shape[0]
    delta_w = jnp.where(
        valid_dev[:, None], delta_w, se3.identity(jnp.float32)[None, :]
    )
    ref_delta_w = delta_w[int(order[-1])]

    old_w = np.asarray(poses_w)
    new_w = np.asarray(relaxed_w)
    shift = np.linalg.norm(new_w[slots, 4:7] - old_w[slots, 4:7], axis=1)
    if loop_ij:
        li = np.asarray([p[0] for p in loop_ij])
        lj = np.asarray([p[1] for p in loop_ij])
        loop_pairs = np.stack([new_w[li, 4:7], new_w[lj, 4:7]], axis=1)
    else:
        loop_pairs = np.zeros((0, 2, 3), np.float32)
    report = RelaxReport(
        num_edges=num_coobs,
        num_loop_edges=num_loop,
        num_chain_edges=len(chain),
        mean_correction_m=float(shift.mean()),
        max_correction_m=float(shift.max()),
        kf_ts=ts[order],
        old_T_w_k=old_w[order],
        new_T_w_k=new_w[order],
        num_appearance_edges=num_app,
        loop_pairs_w=loop_pairs,
    )
    return Relaxation(
        report=report,
        delta_w=delta_w,
        snap_valid=valid_dev,
        snap_ts=jnp.asarray(state.kf_timestamp),
        ref_delta_w=ref_delta_w,
    )


@jax.jit
def _apply_relaxation_arrays(
    kf_pose, kf_valid, kf_timestamp, obs_kf, obs_valid, mp_pos, mp_valid,
    ref_kf, prev_pose, delta_w, snap_valid, snap_ts, ref_delta_w,
):
    """Device program deforming the live pools by the per-slot deltas.

    Keyframe slots still holding the SAME keyframe as at snapshot time
    (valid then and now, identical timestamp - slots are written once per
    keyframe, so the timestamp identifies the occupant) get their own
    delta; slots created or recycled after the snapshot move rigidly with
    the snapshot's newest keyframe (they were tracked against a map that
    moves with it).  Mappoints move with their first-observation keyframe,
    the tracking prior with the reference keyframe - the same rigid
    deformation contract as the synchronous path.
    """
    K = kf_pose.shape[0]
    same = kf_valid & snap_valid & (kf_timestamp == snap_ts)
    slot_delta = jnp.where(same[:, None], delta_w, ref_delta_w[None, :])  # [K, 7]

    poses_w = se3.inverse(kf_pose)
    new_w = se3.compose(slot_delta, poses_w)
    kf_pose2 = jnp.where(kf_valid[:, None], se3.inverse(new_w), kf_pose)

    # mappoints follow their anchor keyframe (C-minor pools: [M, C]/[3, C])
    anchor_m = jnp.argmax(obs_valid, axis=0)  # first valid obs slot [C]
    has_obs = jnp.any(obs_valid, axis=0)
    anchor_kf = jnp.clip(
        jnp.take_along_axis(obs_kf, anchor_m[None, :], axis=0)[0, :], 0, K - 1
    )
    mp_pos2 = jnp.where(
        (has_obs & mp_valid)[None, :],
        se3.apply(slot_delta[anchor_kf], mp_pos.T).T,
        mp_pos,
    )
    ref_delta = slot_delta[jnp.clip(ref_kf, 0, K - 1)]
    prev_pose2 = se3.inverse(se3.compose(ref_delta, se3.inverse(prev_pose)))
    return kf_pose2, mp_pos2, prev_pose2


def apply_relaxation(state, rlx: Relaxation):
    """Deform a (possibly newer) live state by a computed relaxation."""
    if rlx.report.kf_ts.size == 0:
        return state
    kf_pose, mp_pos, prev_pose = _apply_relaxation_arrays(
        state.kf_pose, state.kf_valid, state.kf_timestamp,
        state.obs_kf, state.obs_valid, state.mp_pos, state.mp_valid,
        state.ref_kf, state.prev_pose,
        rlx.delta_w, rlx.snap_valid, rlx.snap_ts, rlx.ref_delta_w,
    )
    return state._replace(kf_pose=kf_pose, mp_pos=mp_pos, prev_pose=prev_pose)


def relax_map(state, cfg, **kwargs):
    """Synchronous relax-and-apply (the offline API): compute the
    relaxation from ``state`` and deform the same state.  Returns
    ``(new_state, RelaxReport)``.  When applied to the very state it was
    computed from, the timestamp-matching in :func:`apply_relaxation`
    matches every valid slot, so this is exactly the rigid deformation of
    rounds 3-4; ``VisualOdometry.run`` uses the split form asynchronously
    (``relax_async``) instead."""
    rlx = compute_relaxation(state, cfg, **kwargs)
    return apply_relaxation(state, rlx), rlx.report


def correct_trajectory(
    report: RelaxReport,
    frame_ts: np.ndarray,
    poses_w_c: np.ndarray,
) -> np.ndarray:
    """Apply a relaxation to a per-frame trajectory: each frame moves
    rigidly with its reference keyframe (the most recent keyframe at or
    before it; frames before the first keyframe use the first).

    ``frame_ts`` are offsets from the first staged frame (the same clock
    as ``RelaxReport.kf_ts``); ``poses_w_c`` are ``[N, 7]`` T_w_c rows.
    """
    if report.kf_ts.size == 0:
        return np.asarray(poses_w_c)
    idx = np.searchsorted(report.kf_ts, np.asarray(frame_ts) + 1e-6) - 1
    idx = np.clip(idx, 0, report.kf_ts.size - 1)
    old_w = jnp.asarray(report.old_T_w_k[idx])
    new_w = jnp.asarray(report.new_T_w_k[idx])
    delta = se3.compose(new_w, se3.inverse(old_w))
    return np.asarray(
        se3.compose(delta, jnp.asarray(poses_w_c, jnp.float32))
    )
