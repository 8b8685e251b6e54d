"""The per-frame tracking step - one jitted, statically-shaped program.

Statically-shaped redesign of ``FrontEnd::AddFrame`` and its handlers
(``src/frontend.cpp:45-144``).  The reference's 3-state FSM
(INITIALIZING / TRACKING / LOST, ``frontend.h:26-30``) lives as an integer
in the state carry; branchy decisions (keyframe insertion, map growth,
lost handling) become predicate-masked state updates so the whole step is a
single XLA program - compiled once, no shape- or branch-dependent recompiles.

Pipeline per frame (mirroring the call stack in SURVEY.md section 3.2):

1. ORB extraction (``ops.orb``) - replaces ``orb_->detectAndCompute``.
2. Depth lookup + back-projection for all keypoints.
3. Coarse round: tracking-map candidates -> frustum/angle filter -> Hamming
   match -> RANSAC + two-round LM  (``frontend.cpp:100-103``).
4. Fine round: same again with the updated pose (``frontend.cpp:105-108``).
5. Quality gate (``IsGoodEstimation``, ``frontend.cpp:334-351``) and lost
   bookkeeping.
6. Keyframe policy (``IsKeyframe``, ``frontend.cpp:353-364``); on keyframe:
   insert, add PnP-inlier observations, create new mappoints from depth,
   triangulate tracking-map points (``frontend.cpp:126-138``).
7. The local-BA request is returned as a flag (``needs_ba``); the host
   dispatches the backend step asynchronously, preserving the reference's
   "backend woken per keyframe" design (``backend.h:33-37``) without threads.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rgbd_visualodometry_tpu import camera as cam_mod
from rgbd_visualodometry_tpu import mapstate
from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.mapstate import INITIALIZING, LOST, TRACKING, VOState
from rgbd_visualodometry_tpu.ops import depth as depth_mod
from rgbd_visualodometry_tpu.ops import image as im
from rgbd_visualodometry_tpu.ops import lm, matching, orb, packing, pnp, se3, triangulate


class FrameInput(NamedTuple):
    rgb: jnp.ndarray  # [H, W, 3] uint8
    depth: jnp.ndarray  # [H, W] uint16 raw depth
    timestamp: jnp.ndarray  # scalar float32


class StepOutput(NamedTuple):
    """Per-frame result, stored as ONE packed f32 vector.

    A single leaf means materializing a frame result costs exactly one
    device->host transfer instead of one per scalar field.  All integer
    fields fit float32 exactly (< 2^24).
    Property accessors use ``[..., i]`` indexing so batched (vmapped)
    outputs keep working.
    """

    packed: jnp.ndarray  # [32] float32 (leading batch dims allowed)
    # live-viewer payload, only populated when cfg.enable_viewer (static):
    # [N, 3] float32 (x, y, matched-flag) per keypoint - feeds the host-side
    # per-frame overlay, the PlotFrameImage analogue (viewer.cpp:144-150)
    viewer: jnp.ndarray | None = None

    # layout
    _POSE_C_W = slice(0, 7)
    _POSE_W_C = slice(7, 14)
    _FIELDS = {
        "tracked": 14, "fsm": 15, "is_keyframe": 16, "needs_ba": 17,
        "kf_slot": 18, "num_candidates": 19, "num_matches": 20,
        "num_inliers": 21, "num_final_inliers": 22, "num_new_mappoints": 23,
        "num_triangulated": 24, "num_keyframes": 25, "num_mappoints": 26,
        "kf_overflow": 27, "num_dropped_mappoints": 28,
    }
    SIZE = 32

    @classmethod
    def pack(cls, pose_c_w, pose_w_c, viewer=None, **fields) -> "StepOutput":
        parts = [pose_c_w, pose_w_c]
        vals = jnp.stack(
            [jnp.asarray(fields[k], jnp.float32) for k in cls._FIELDS], axis=-1
        )
        pad = jnp.zeros(vals.shape[:-1] + (cls.SIZE - 14 - len(cls._FIELDS),), jnp.float32)
        return cls(packed=jnp.concatenate(parts + [vals, pad], axis=-1), viewer=viewer)

    # ---- accessors (device- and host-side, batched or not) ---------------
    @property
    def pose_c_w(self):
        return self.packed[..., self._POSE_C_W]

    @property
    def pose_w_c(self):
        return self.packed[..., self._POSE_W_C]

    def _field(self, name):
        return self.packed[..., self._FIELDS[name]]

    @property
    def tracked(self):
        return self._field("tracked") > 0.5

    @property
    def fsm(self):
        return self._field("fsm").astype(jnp.int32)

    @property
    def is_keyframe(self):
        return self._field("is_keyframe") > 0.5

    @property
    def needs_ba(self):
        return self._field("needs_ba") > 0.5

    @property
    def kf_slot(self):
        return self._field("kf_slot").astype(jnp.int32)

    @property
    def num_candidates(self):
        return self._field("num_candidates").astype(jnp.int32)

    @property
    def num_matches(self):
        return self._field("num_matches").astype(jnp.int32)

    @property
    def num_inliers(self):
        return self._field("num_inliers").astype(jnp.int32)

    @property
    def num_final_inliers(self):
        return self._field("num_final_inliers").astype(jnp.int32)

    @property
    def num_new_mappoints(self):
        return self._field("num_new_mappoints").astype(jnp.int32)

    @property
    def num_triangulated(self):
        return self._field("num_triangulated").astype(jnp.int32)

    @property
    def num_keyframes(self):
        return self._field("num_keyframes").astype(jnp.int32)

    @property
    def num_mappoints(self):
        return self._field("num_mappoints").astype(jnp.int32)

    @property
    def kf_overflow(self):
        """True when a keyframe insert was refused by a full pool (only
        possible under ``keyframe_eviction='refuse'``)."""
        return self._field("kf_overflow") > 0.5

    @property
    def num_dropped_mappoints(self):
        """Creates requested beyond the mappoint pool's free-slot supply."""
        return self._field("num_dropped_mappoints").astype(jnp.int32)


def _match_and_estimate(cfg: VOConfig, camera, state: VOState, nn, feats, kp_cam, dep, tmap, pose, key, is_lost, coarse=False):
    """One coarse-or-fine round: candidates -> match -> RANSAC -> LM.

    The reference runs this twice per frame (``frontend.cpp:100-108``); the
    second round benefits from the refreshed pose in the frustum filter.
    While LOST (relocalization), the frustum/angle filter is bypassed and
    the whole alive map is the candidate set - the stale pose means nothing.

    ``nn`` is the pose-independent nearest-keypoint table, computed once
    per frame and shared by both rounds (only the frustum mask and the
    adaptive gate differ - see :func:`matching.nearest_keypoints`).
    """
    # pools are C-minor ([3, C]); the transposes fuse into the elementwise
    # frustum math (no materialized [C, 3] copy - asserted by the r5 HLO scan)
    observable = cam_mod.in_frustum(
        camera, state.mp_pos.T, pose, state.mp_norm.T, cfg.max_observe_angle
    )
    cand = tmap & observable  # outliers already excluded from tmap
    if cfg.enable_relocalization:
        cand = jnp.where(is_lost, state.mp_alive, cand)
    mres = matching.gate_matches(
        nn, cand, cfg.match_ratio, cfg.min_match_distance
    )
    # over-capacity frames keep the BEST matches by descriptor distance
    # (slot order would keep the oldest mappoints and drop the freshest -
    # the reference has no cap at all, src/frontend.cpp:219-230, so quality
    # selection is the closest fixed-shape equivalent)
    midx, mval = packing.compact_best_indices(
        mres.matched, mres.distance, cfg.pnp_max_points
    )
    p_w = jnp.take(state.mp_pos, midx, axis=1).T  # [P, 3] from the [3, C] pool
    kpi = jnp.take(mres.kp_index, midx)
    uv = jnp.take(feats.xy, kpi, axis=0)
    p_cam = jnp.take(kp_cam, kpi, axis=0)
    d_ok = jnp.take(dep.valid, kpi) & mval

    # coarse-round lightening: the fine round re-runs the full search from
    # this round's pose, so the coarse round may use fewer lanes/iterations
    # (0 = inherit full strength - the reference runs both rounds full)
    n_hyp = (cfg.coarse_ransac_hypotheses or cfg.ransac_hypotheses) if coarse else cfg.ransac_hypotheses
    lm_iters = (cfg.coarse_pose_ba_iterations or cfg.pose_ba_iterations) if coarse else cfg.pose_ba_iterations
    rr = pnp.ransac_pnp(
        key, p_w, uv, p_cam, d_ok, mval, pose, camera,
        n_hyp, cfg.ransac_reproj_threshold,
        depth_free_fraction=cfg.ransac_depth_free_fraction,
    )
    ref = lm.refine_pose(
        rr.pose, p_w, uv, rr.inliers & mval, camera,
        lm_iters, cfg.huber_delta, cfg.pose_chi2_outlier,
    )
    info = dict(
        midx=midx, mval=mval, kpi=kpi, uv=uv, rr=rr, ref=ref,
        n_cand=jnp.sum(cand).astype(jnp.int32),
        n_match=jnp.sum(mres.matched).astype(jnp.int32),
    )
    return ref.pose, info


class TrackInter(NamedTuple):
    """Intermediates between the tracking-compute and state-update halves.

    The batched (vmapped) step runs as two chained device programs split
    at this seam, with no host round-trip between them; the split matches
    the reference's own frontend-compute / map-mutation phase boundary at
    frontend.cpp:110-126.  Whether the fused single program is faster on
    the GPU is an open measurement (PERF.md).  Everything here is
    statically shaped and small (~0.2 MB).
    """

    # keypoints (the subset of ORBFeatures the update half consumes)
    xy: jnp.ndarray  # [N, 2] f32
    desc: jnp.ndarray  # [N, 8] u32
    bip: jnp.ndarray  # [N, 256] i8
    kp_valid: jnp.ndarray  # [N] bool
    depth: jnp.ndarray  # [N] f32
    depth_valid: jnp.ndarray  # [N] bool
    # fine-round match/estimate results (packed P slots)
    midx: jnp.ndarray  # [P] i32 matched mappoint slots
    mval: jnp.ndarray  # [P] bool
    kpi: jnp.ndarray  # [P] i32 matched keypoint index
    uv: jnp.ndarray  # [P, 2] f32 matched pixel
    ref_inliers: jnp.ndarray  # [P] bool post-LM chi2 inliers
    # tracking map + pose + FSM decisions
    tmap: jnp.ndarray  # [C] bool
    pose_used: jnp.ndarray  # [7]
    is_init: jnp.ndarray
    is_kf: jnp.ndarray
    do_insert: jnp.ndarray
    good: jnp.ndarray
    fsm: jnp.ndarray
    lost_count: jnp.ndarray
    rng: jax.Array
    timestamp: jnp.ndarray
    # stats for StepOutput
    num_inliers: jnp.ndarray
    num_final_inliers: jnp.ndarray
    n_cand: jnp.ndarray
    n_match: jnp.ndarray
    viewer: jnp.ndarray | None


def track_compute(cfg: VOConfig, camera, state: VOState, frame: FrameInput) -> TrackInter:
    """Read-only tracking half: ORB -> match -> RANSAC/LM -> gates."""
    N = cfg.number_of_features

    gray = im.rgb_to_gray(frame.rgb)
    feats = orb.extract(
        gray,
        nfeatures=N,
        nlevels=cfg.level_pyramid,
        scale=cfg.scale_factor,
        threshold=float(cfg.fast_threshold),
        border=cfg.edge_threshold,
        angle_bins=cfg.orb_angle_bins,
        use_bf16=cfg.orb_bf16,
        brief_chunk=cfg.orb_brief_chunk,
        patch_bf16=cfg.orb_patch_bf16,
    )
    dep = depth_mod.lookup_depth(frame.depth, feats.xy, camera.depth_scale)
    kp_cam = cam_mod.pixel2camera(camera, feats.xy, dep.depth)

    is_init = state.fsm == INITIALIZING
    is_tracking = state.fsm == TRACKING
    is_lost = state.fsm == LOST

    rng, k1, k2 = jax.random.split(state.rng, 3)

    # ---- coarse + fine pose estimation (masked no-op while INITIALIZING:
    # the empty candidate set makes LM a fixed point of the seed pose) ------
    # localization-only: the covisibility window is keyed to ref_kf, which
    # never advances in this mode - candidates are the whole alive map (the
    # per-round frustum filter still trims them to what the pose can see)
    if cfg.localization_only:
        tmap = state.mp_alive
    else:
        tmap = mapstate.tracking_map_mask(state, cfg)
    if cfg.packed_matching:
        nn = matching.nearest_keypoints_packed(
            state.mp_desc, feats.desc_bipolar, feats.valid
        )
    else:
        nn = matching.nearest_keypoints(state.mp_bip, feats.desc_bipolar, feats.valid)
    pose_c, _ = _match_and_estimate(cfg, camera, state, nn, feats, kp_cam, dep, tmap, state.prev_pose, k1, is_lost, coarse=True)
    pose_f, info = _match_and_estimate(cfg, camera, state, nn, feats, kp_cam, dep, tmap, pose_c, k2, is_lost)

    # ---- quality gate (IsGoodEstimation, frontend.cpp:334-351) -----------
    rel = se3.log(se3.relative(state.prev_pose, pose_f))
    motion_ok = jnp.linalg.norm(rel) <= cfg.max_motion_norm
    enough_inliers = info["rr"].num_inliers >= cfg.min_inliers
    good_track = is_tracking & enough_inliers & motion_ok
    # relocalization gate: stricter, on the post-BA inlier set, no motion
    # check (the stale prev_pose means nothing while LOST)
    if cfg.enable_relocalization:
        reloc_good = is_lost & (info["ref"].num_final_inliers >= cfg.reloc_min_inliers)
    else:
        reloc_good = jnp.asarray(False)
    good = good_track | reloc_good

    lost_inc = 2 if cfg.compat_double_lost_increment else 1
    lost_count = jnp.where(
        good | is_init, 0, jnp.where(is_tracking, state.lost_count + lost_inc, state.lost_count)
    )
    fsm = jnp.where(
        is_init,
        TRACKING,
        jnp.where(is_tracking & ~good & (lost_count > cfg.max_num_lost), LOST, state.fsm),
    )
    fsm = jnp.where(reloc_good, TRACKING, fsm)

    # ---- keyframe policy (IsKeyframe, frontend.cpp:353-364) --------------
    trans_norm = jnp.linalg.norm(rel[:3])
    rot_norm = jnp.linalg.norm(rel[3:])
    is_kf = (
        good & ((rot_norm > cfg.keyframe_rotation) | (trans_norm > cfg.keyframe_translation))
    ) | reloc_good  # a relocalized frame re-anchors the map as a keyframe
    if cfg.localization_only:
        # frozen map: never insert (an INITIALIZING first frame still may -
        # that is the single-shot "map from one frame, then localize" case)
        is_kf = jnp.asarray(False)
        do_insert = is_init
    else:
        do_insert = is_init | is_kf

    pose_used = jnp.where(is_init, se3.identity(jnp.float32), pose_f)

    viewer_payload = None
    if cfg.enable_viewer:
        kp_matched = packing.scatter_back(
            N, jnp.where(info["mval"], info["kpi"], N), info["mval"]
        )
        viewer_payload = jnp.concatenate(
            [
                feats.xy.astype(jnp.float32),
                (kp_matched & feats.valid).astype(jnp.float32)[:, None],
            ],
            axis=-1,
        )

    return TrackInter(
        xy=feats.xy, desc=feats.desc, bip=feats.desc_bipolar,
        kp_valid=feats.valid, depth=dep.depth, depth_valid=dep.valid,
        midx=info["midx"], mval=info["mval"], kpi=info["kpi"], uv=info["uv"],
        ref_inliers=info["ref"].inliers,
        tmap=tmap, pose_used=pose_used,
        is_init=is_init, is_kf=is_kf, do_insert=do_insert, good=good,
        fsm=fsm, lost_count=lost_count, rng=rng, timestamp=frame.timestamp,
        num_inliers=info["rr"].num_inliers,
        num_final_inliers=info["ref"].num_final_inliers,
        n_cand=info["n_cand"], n_match=info["n_match"],
        viewer=viewer_payload,
    )


def apply_updates(cfg: VOConfig, camera, state: VOState, it: TrackInter):
    """State-update half: keyframe insert, observations, new mappoints,
    triangulation, bookkeeping.  ``track_step = apply_updates . track_compute``."""
    C = cfg.max_mappoints
    N = cfg.number_of_features
    pose_used = it.pose_used
    is_init, is_kf, do_insert = it.is_init, it.is_kf, it.do_insert
    fsm, lost_count = it.fsm, it.lost_count
    cam_center = cam_mod.camera_center(pose_used)

    state = state._replace(rng=it.rng)
    state, kf_slot, inserted = mapstate.insert_keyframe(
        state, pose_used, it.timestamp, do_insert, eviction=cfg.keyframe_eviction
    )
    # effective keyframe predicate: a refused insert (full pool under the
    # "refuse" policy) must gate every downstream keyframe update, or the
    # observations / mappoints / ref-kf advance get attributed to a stale slot
    is_kf_eff = is_kf & inserted
    kf_overflow = do_insert & ~inserted

    # ---- observations of PnP inliers (AddCurrentKeyframeObservations,
    # frontend.cpp:366-370: the post-BA chi2 inlier set with matched pixel) -
    # scatter-free: invert the packed match-index list and gather per slot
    inlier_packed = it.ref_inliers & it.mval
    inlier_mp, minv = packing.inverse_lookup(C, it.midx, inlier_packed)
    # C-minor gather: [2, P] rows taken along lanes -> [2, C] (pool layout)
    uvT_for_mp = jnp.take(it.uv.T, minv, axis=1) * inlier_mp[None, :]
    kp_depth = jnp.take(it.depth, it.kpi) * jnp.take(it.depth_valid, it.kpi)
    depth_for_mp = jnp.take(kp_depth, minv) * inlier_mp
    state = mapstate.add_observations(
        state, kf_slot, inlier_mp, uvT_for_mp, cam_center, is_kf_eff,
        depth=depth_for_mp,
    )

    # ---- new mappoints from depth (CreateNewMappoints,
    # frontend.cpp:372-406): unmatched keypoints with valid depth -----------
    matched_kp = packing.scatter_back(
        N, jnp.where(inlier_packed, it.kpi, N), inlier_packed
    )
    create_mask = it.kp_valid & it.depth_valid & ~(matched_kp & ~is_init)
    p_world_new = cam_mod.pixel2world(camera, it.xy, pose_used, it.depth)
    n_create_req = jnp.sum(create_mask & inserted).astype(jnp.int32)
    state, n_created = mapstate.create_mappoints(
        state, kf_slot, p_world_new, it.desc, it.bip, it.xy,
        create_mask, cam_center, inserted, depth=it.depth,
    )

    # ---- triangulation refinement (TriangulateMappointsInTrackingMap,
    # frontend.cpp:465-506) over tracking-map inliers not yet refined ------
    tri_cand = (
        it.tmap
        & inlier_mp
        & ~state.mp_triangulated
        & ~state.mp_optimized
        & ~state.mp_outlier
    )
    tidx, tval = packing.compact_indices(tri_cand, cfg.triangulation_batch)
    # C-minor pool gathers (lane takes), transposed to the compact row-major
    # problem layout (B is small - cfg.triangulation_batch)
    obs_kf = jnp.take(state.obs_kf, tidx, axis=1).T  # [B, M]
    obs_uv = jnp.transpose(jnp.take(state.obs_uv, tidx, axis=2), (2, 1, 0))  # [B, M, 2]
    obs_ok = jnp.take(state.obs_valid, tidx, axis=1).T & tval[:, None]
    poses_obs = jnp.take(state.kf_pose, jnp.clip(obs_kf, 0, None), axis=0)  # [B, M, 7]
    norm_xy = cam_mod.pixel2camera(camera, obs_uv, 1.0)[..., :2]
    tri = triangulate.triangulate(
        poses_obs, norm_xy, obs_ok, cfg.triangulation_sv_ratio,
        cfg.triangulation_min_obs, min_baseline=cfg.triangulation_min_baseline,
    )
    tri_ok = tval & tri.ok & (tri.points[:, 2] > 0) & is_kf_eff  # pworld[2]>0
    if cfg.compat_single_triangulation:
        # the reference `break`s after the first success (frontend.cpp:501)
        tri_ok = tri_ok & (jnp.cumsum(tri_ok.astype(jnp.int32)) == 1)
    thit, tinv = packing.inverse_lookup(C, tidx, tri_ok)
    state = state._replace(
        mp_pos=jnp.where(
            thit[None, :], jnp.take(tri.points.T, tinv, axis=1), state.mp_pos
        ),
        mp_triangulated=state.mp_triangulated | thit,
    )

    # ---- bookkeeping: framePrev_/keyframeRef_ only advance on keyframes
    # (frontend.cpp:140-141 runs after the IsKeyframe early-return); with a
    # frozen map there are no keyframes, so the motion prior advances on
    # every well-tracked frame instead
    advance = (inserted | it.good) if cfg.localization_only else inserted
    state = state._replace(
        prev_pose=jnp.where(advance, pose_used, state.prev_pose),
        ref_kf=jnp.where(inserted, kf_slot, state.ref_kf),
        fsm=fsm,
        lost_count=lost_count,
        frame_index=state.frame_index + 1,
    )

    out = StepOutput.pack(
        pose_used,
        se3.inverse(pose_used),
        viewer=it.viewer,
        tracked=it.good | is_init,
        fsm=fsm,
        is_keyframe=is_kf_eff,
        needs_ba=is_kf_eff & bool(cfg.enable_local_optimization),
        kf_slot=kf_slot,
        num_candidates=it.n_cand,
        num_matches=it.n_match,
        num_inliers=it.num_inliers,
        num_final_inliers=it.num_final_inliers,
        num_new_mappoints=n_created,
        num_triangulated=jnp.sum(tri_ok).astype(jnp.int32),
        num_keyframes=state.num_kf,
        num_mappoints=jnp.sum(state.mp_alive).astype(jnp.int32),
        kf_overflow=kf_overflow,
        num_dropped_mappoints=n_create_req - n_created,
    )
    return state, out


def track_step(cfg: VOConfig, camera, state: VOState, frame: FrameInput):
    """(state, frame) -> (state, StepOutput).  Pure; jit with cfg static.

    The fused single-program form (best for single-stream latency).  For
    batched multi-stream execution jit ``track_compute`` and ``apply_updates``
    separately - see :class:`TrackInter` for why.
    """
    return apply_updates(cfg, camera, state, track_compute(cfg, camera, state, frame))
