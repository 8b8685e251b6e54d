"""Local bundle adjustment over the covisible window - the backend.

Accelerator redesign of ``Backend::Optimize`` (``src/backend.cpp:19-195``),
which the reference runs on its own thread with g2o LM + CSparse Schur.
Here the whole solve is one jitted program over fixed-capacity arrays:

- **Window**: the current keyframe + its active covisible keyframes
  (``backend.cpp:36-38``), capped at ``ba_max_poses`` by covisibility weight.
  Keyframe slot 0 is held fixed (``backend.cpp:55``); keyframes outside the
  window that observe window mappoints act as fixed poses
  (``backend.cpp:108-120``) - instead of materializing extra vertices, their
  edges simply carry a zero pose-Jacobian.
- **Points**: non-outlier mappoints observed by window keyframes
  (``backend.cpp:62-81``), marginalized via the explicit Schur complement:
  per-point 3x3 blocks are inverted in closed form and the reduced (P*6)^2
  camera system is solved densely - P is small.
- **Edge layout is per-point**: observations stay in their native ``[MB, M]``
  slot structure (mappoint x observation-slot), so the per-point reductions
  (V, gl) are plain sums over the M axis and the per-pose reductions
  (U, gp, W) are one-hot matmuls - **no scatters in the LM loop**.  One-hot
  selections stay exact: their f32 operands run at ``Precision.HIGHEST``.
- **Robustification**: Huber delta = sqrt(7.815) (``backend.cpp:84``),
  two rounds of 10 LM iterations with chi2 > chi2_th pruning in between;
  pruned observations are *removed from the map* and zero-observation
  mappoints become outliers (``backend.cpp:139-172`` ->
  ``Frame::RemoveObservedMappoint`` -> ``Mappoint::RemoveObservedByKeyframe``).
- **Depth priors**: observations with measured sensor depth add a
  ``(d_meas - z_cam)`` residual weighted by the inverse Kinect axial-noise
  variance (sigma = k z^2 with a near-range floor) and Huber-robustified,
  anchoring the metric scale that pure reprojection BA leaves free (an
  improvement over the reference; disable with ``ba_use_depth_prior=False``).
- **Write-back**: window keyframe poses and non-outlier point positions
  (``backend.cpp:182-194``); touched points get ``optimized_ = true``.

The reference's "latest keyframe wins" condvar trigger (``backend.h:33-37``)
is preserved at the system level: the host dispatches this step after each
keyframe; XLA's async dispatch queue plays the role of the backend thread.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rgbd_visualodometry_tpu import camera as cam_mod
from rgbd_visualodometry_tpu import mapstate
from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.mapstate import VOState
from rgbd_visualodometry_tpu.ops import lm as lm_ops
from rgbd_visualodometry_tpu.ops import packing, se3
from rgbd_visualodometry_tpu.ops.smalleig import inv3x3


class _BAProblem(NamedTuple):
    # window poses
    widx: jnp.ndarray  # [P] keyframe slots in the window
    wval: jnp.ndarray  # [P] bool
    wfixed: jnp.ndarray  # [P] bool - held constant (slot 0)
    # points
    pidx: jnp.ndarray  # [MB] mappoint slots
    pval: jnp.ndarray  # [MB] bool
    # observations, per-point layout [MB, M]
    o_uv: jnp.ndarray  # [MB, M, 2] measured pixel
    o_depth: jnp.ndarray  # [MB, M] measured sensor depth (0 = none)
    o_valid: jnp.ndarray  # [MB, M] bool
    o_pose_free: jnp.ndarray  # [MB, M] bool - pose Jacobian active
    o_onehot: jnp.ndarray  # [MB, M, P] f32 one-hot window pose (0 if fixed)
    fixed_poses: jnp.ndarray  # [MB, M, 7] observer poses frozen from the map


def build_problem(cfg: VOConfig, state: VOState, kf: jnp.ndarray) -> _BAProblem:
    K = state.kf_pose.shape[0]
    M, C = state.obs_kf.shape  # pools are C-minor (mapstate.py docstring)
    # the covisible window can never exceed the keyframe pool
    P, MB = min(cfg.ba_max_poses, K), cfg.ba_max_points

    A = mapstate.incidence(state)
    row = jax.lax.dot_general(
        A[kf], A,  # int8 operands, int32 accumulation (no [K, C] int32 copy)
        dimension_numbers=(((0,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )  # [K] shared-observation counts with kf
    in_window = ((row >= cfg.covisibility_weight_threshold) | (jnp.arange(K) == kf)) & state.kf_valid
    # top-P by weight, with the current keyframe always included
    weight = jnp.where(in_window, row + 1, -1)
    weight = weight.at[kf].set(
        jnp.where(state.kf_valid[kf], jnp.iinfo(jnp.int32).max, -1)
    )
    wweight, widx = jax.lax.top_k(weight, P)
    wval = wweight > 0
    wfixed = (widx == 0) & wval  # KF id 0 fixed (backend.cpp:55)

    # window-membership lookup: kf slot -> window position (or -1)
    wpos = jnp.full(K, -1, jnp.int32).at[jnp.where(wval, widx, K)].set(
        jnp.arange(P, dtype=jnp.int32), mode="drop"
    )

    # points observed by the window
    win_kf_mask = jnp.zeros(K, bool).at[jnp.where(wval, widx, K)].set(True, mode="drop")
    observed = (
        jax.lax.dot_general(
            win_kf_mask.astype(jnp.int8), A,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        > 0
    )
    pmask = observed & state.mp_alive
    # over-capacity windows keep the BEST-constrained points: ones the
    # current keyframe observes first (they tie the new pose into the old
    # map), then by observation count.  Slot order would keep the oldest
    # points and starve fresh geometry exactly when the map is largest
    # (the reference's g2o window has no cap, backend.cpp:62-81).
    n_obs = jnp.sum(state.obs_valid, axis=0, dtype=jnp.int32)
    obs_by_cur = A[kf].astype(jnp.int32)
    score = (1 - obs_by_cur) * (M + 1) + (M - jnp.minimum(n_obs, M))
    pidx, pval = packing.compact_best_indices(pmask, score, MB)

    # observations gathered from the C-minor planes into the compact
    # row-major problem layout (MB is small: cfg.ba_max_points)
    o_kf = jnp.take(state.obs_kf, pidx, axis=1).T  # [MB, M]
    o_valid = jnp.take(state.obs_valid, pidx, axis=1).T & pval[:, None]
    o_uv = jnp.transpose(jnp.take(state.obs_uv, pidx, axis=2), (2, 1, 0))  # [MB, M, 2]
    o_depth = jnp.take(state.obs_depth, pidx, axis=1).T
    o_kf_safe = jnp.clip(o_kf, 0, K - 1)
    o_wpos = wpos[o_kf_safe]  # [MB, M]
    o_in_window = (o_wpos >= 0) & o_valid
    o_fixed_slot0 = jnp.take(wfixed, jnp.where(o_in_window, o_wpos, 0))
    o_pose_free = o_in_window & ~o_fixed_slot0
    o_onehot = jax.nn.one_hot(
        jnp.where(o_pose_free, o_wpos, P), P, dtype=jnp.float32
    )  # class P -> all-zeros row
    fixed_poses = jnp.take(state.kf_pose, o_kf_safe, axis=0)  # [MB, M, 7]

    return _BAProblem(
        widx=widx, wval=wval, wfixed=wfixed, pidx=pidx, pval=pval,
        o_uv=o_uv, o_depth=o_depth, o_valid=o_valid,
        o_pose_free=o_pose_free, o_onehot=o_onehot, fixed_poses=fixed_poses,
    )


def _obs_poses(prob: _BAProblem, poses_w: jnp.ndarray) -> jnp.ndarray:
    """Current observer pose per observation slot [MB, M, 7]: free edges read
    the evolving window estimates (via an exact one-hot matmul), fixed edges
    read the frozen map poses."""
    via = jnp.einsum("pmi,iq->pmq", prob.o_onehot, poses_w, precision=jax.lax.Precision.HIGHEST)
    return jnp.where(prob.o_pose_free[..., None], via, prob.fixed_poses)


def _residuals(prob: _BAProblem, poses_w, pts, camera):
    e_pose = _obs_poses(prob, poses_w)
    p_c = se3.apply(e_pose, pts[:, None, :])
    proj = cam_mod.camera2pixel(camera, p_c)
    return prob.o_uv - proj, p_c, e_pose


def _chi2(prob, poses_w, pts, camera):
    e, _, _ = _residuals(prob, poses_w, pts, camera)
    return jnp.sum(e * e, axis=-1)  # [MB, M]


class _IterState(NamedTuple):
    poses: jnp.ndarray  # [P, 7]
    pts: jnp.ndarray  # [MB, 3]
    lam: jnp.ndarray
    cost: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


def _lm_phase(cfg, camera, prob, poses0, pts0, obs_mask, iterations, huber_delta):
    """One LM phase (``optimizer.optimize(10)``) with adaptive damping.

    All reductions are sums over the M axis or one-hot matmuls over the P
    axis - scatter-free by construction.
    """
    P = poses0.shape[0]
    maskf = obs_mask.astype(jnp.float32)  # [MB, M]

    if cfg.ba_use_depth_prior:
        # Information weight from the Kinect axial-noise model sigma_z =
        # k z^2 (Khoshelham & Elberink 2012, k ~ 1.4e-3 / m): w = t / sigma^2.
        # The round-2 pixel-equivalent form t * (fx/z)^2 modeled a CONSTANT
        # depth sigma and scaled with image resolution - on fr1-like noisy
        # depth it over-trusted far-range measurements by z^2 and pulled
        # 4x harder at 640x480 than at 320x240 (measured: hard-scene ATE
        # 1.03 cm vs the twin's 0.76 at 640; the sigma model + noise floor
        # + robust depth loss below brought it to 0.69).
        z = jnp.maximum(prob.o_depth, 0.25)
        # noise floor: without it near-range weights grow as 1/z^4 and the
        # depth terms drown the reprojection terms entirely (measured: hard
        # scene ATE 18 cm with floorless weights vs ~1 cm with the floor)
        sigma = jnp.maximum(
            cfg.ba_depth_sigma_scale * z * z, cfg.ba_depth_sigma_floor
        )
        w_depth_info = (
            (prob.o_depth > 0).astype(jnp.float32)
            * cfg.ba_depth_weight
            / (sigma * sigma)
        )
    else:
        w_depth_info = jnp.zeros_like(prob.o_depth)

    # The depth term is ALWAYS Huber-robustified (both LM rounds, fixed
    # delta): unlike reprojection edges it has no chi2 pruning round, and a
    # single outlier depth reading (edge shadowing, hole boundary) with a
    # quadratic pull measurably destabilizes the whole window - observed on
    # the fr1-like hard scene as ATE jumping 1 -> 67 cm between depth-weight
    # settings before robustification.
    depth_delta = cfg.huber_delta

    def total_cost(poses, pts):
        e, p_c, _ = _residuals(prob, poses, pts, camera)
        c2 = jnp.sum(e * e, axis=-1)
        rd = prob.o_depth - p_c[..., 2]
        c2_d = w_depth_info * rd * rd  # sigma-normalized depth chi2
        return jnp.sum(
            maskf
            * (
                lm_ops._robust_cost(c2, huber_delta)
                + lm_ops._robust_cost(c2_d, depth_delta)
            )
        )

    free_pose = (~prob.wfixed) & prob.wval
    fm = free_pose.astype(jnp.float32)
    diag = jnp.arange(P)
    rtol = 1e-6

    def cond(st: _IterState):
        return (st.it < iterations) & ~st.done

    def body(st: _IterState) -> _IterState:
        # NOTE on formulation: every contraction below with a tiny inner
        # dimension (k=2 residual rows, 3x3 rotations) is written as explicit
        # broadcast multiply + sum, which XLA fuses into elementwise loops;
        # as einsums they lower to batched dot_generals with 6x3-ish tiles.
        e, p_c, e_pose = _residuals(prob, st.poses, st.pts, camera)  # [MB,M,*]
        Jp = lm_ops.pose_jacobian(p_c, camera)  # [MB, M, 2, 6]
        R = se3.quat_to_matrix(se3.quat(e_pose))  # [MB, M, 3, 3]
        # Jl[p,m,k,j] = sum_i Jp[p,m,k,i<3] R[p,m,i,j]  (g2o_types.h:172)
        Jl = jnp.sum(Jp[..., :3, None] * R[..., None, :, :], axis=-2)
        w = maskf * lm_ops._huber_weights(jnp.sum(e * e, axis=-1), huber_delta)
        wp = w * prob.o_pose_free.astype(jnp.float32)

        # depth-prior terms: r_d = d_meas - z_cam,
        # dz/ddelta = [0,0,1, y,-x, 0], dz/dp_w = R.row(2)
        X, Y = p_c[..., 0], p_c[..., 1]
        zeros = jnp.zeros_like(X)
        ones = jnp.ones_like(X)
        Jd_pose = -jnp.stack([zeros, zeros, ones, Y, -X, zeros], axis=-1)
        Jd_pt = -R[..., 2, :]
        r_d = prob.o_depth - p_c[..., 2]
        # IRLS Huber on the normalized depth chi2 (see depth_delta above)
        wd = (
            maskf
            * w_depth_info
            * lm_ops._huber_weights(w_depth_info * r_d * r_d, depth_delta)
        )
        wdp = wd * prob.o_pose_free.astype(jnp.float32)

        # The per-edge blocks stay f32.  Rounded to bf16 entry by entry they
        # are no longer positive semi-definite, and on real windows the
        # relative rounding (2^-9) exceeds the weakest direction of S: the
        # Schur complement comes out indefinite, Cholesky returns NaN and
        # LM rejects every step (PERF.md, bring-up findings).

        def outer_k(a, b):
            """sum_k a[..., k, :, None] * b[..., k, None, :] (k = 2 rows)."""
            return (
                a[..., 0, :, None] * b[..., 0, None, :]
                + a[..., 1, :, None] * b[..., 1, None, :]
            )

        # per-point blocks: plain sums over the M axis (f32 accumulate)
        V = jnp.sum(
            w[..., None, None] * outer_k(Jl, Jl)
            + wd[..., None, None] * (Jd_pt[..., :, None] * Jd_pt[..., None, :]),
            axis=1,
        )
        gl = jnp.sum(
            w[..., None] * jnp.sum(Jl * e[..., None], axis=-2)
            + wd[..., None] * Jd_pt * r_d[..., None],
            axis=1,
        )
        # per-(point,slot) blocks, then one-hot matmuls to pose space (the
        # only true matmuls here - [P, MB*M] @ [MB*M, ...])
        UJp = wp[..., None, None] * outer_k(Jp, Jp) + (
            wdp[..., None, None] * (Jd_pose[..., :, None] * Jd_pose[..., None, :])
        )
        MBn, Mn = UJp.shape[0], UJp.shape[1]
        oh_flat = prob.o_onehot.reshape(MBn * Mn, -1)  # [MB*M, P]
        U = jax.lax.dot_general(
            oh_flat, UJp.reshape(MBn * Mn, 36),
            dimension_numbers=(((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(-1, 6, 6)
        gpe = wp[..., None] * jnp.sum(Jp * e[..., None], axis=-2) + (
            wdp[..., None] * Jd_pose * r_d[..., None]
        )
        gp = jax.lax.dot_general(
            oh_flat, gpe.reshape(MBn * Mn, 6),
            dimension_numbers=(((0,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        WJ = wp[..., None, None] * outer_k(Jp, Jl) + (
            wdp[..., None, None] * (Jd_pose[..., :, None] * Jd_pt[..., None, :])
        )  # [MB, M, 6, 3]
        # Wt[p, i, :] = sum_m onehot[p, m, i] WJ[p, m, :]: batched
        # dot_general contracting M
        Wt = jax.lax.dot_general(
            prob.o_onehot, WJ.reshape(MBn, Mn, 18),
            dimension_numbers=(((1,), (1,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST,
        ).reshape(MBn, P, 6, 3)

        lam = st.lam
        Ud = U + lam * jnp.eye(6, dtype=jnp.float32)[None]
        Vd = V + lam * jnp.eye(3, dtype=jnp.float32)[None]
        Vinv = inv3x3(Vd)
        Y_ = jnp.einsum("pial,plk->piak", Wt, Vinv, precision=jax.lax.Precision.HIGHEST)  # [MB, P, 6, 3]

        S = -jnp.einsum("piak,pjbk->iajb", Y_, Wt, precision=jax.lax.Precision.HIGHEST)  # [P, 6, P, 6]
        S = S.at[diag, :, diag, :].add(Ud)
        rhs = -(gp - jnp.einsum("piak,pk->ia", Y_, gl, precision=jax.lax.Precision.HIGHEST))  # [P, 6]

        # freeze fixed / invalid poses: identity rows, zero rhs
        S = S * fm[:, None, None, None] * fm[None, None, :, None]
        S = S.at[diag, :, diag, :].add(
            jnp.eye(6, dtype=jnp.float32)[None] * (1.0 - fm)[:, None, None]
        )
        rhs = rhs * fm[:, None]

        # Cholesky instead of LU: S is SPD after damping (+ identity rows
        # for fixed poses), so the pivoting of LU buys nothing
        Sm = S.reshape(P * 6, P * 6)
        L = jnp.linalg.cholesky(Sm)
        y = jax.scipy.linalg.solve_triangular(L, rhs.reshape(P * 6), lower=True)
        dp = jax.scipy.linalg.solve_triangular(
            L, y, lower=True, trans=1
        ).reshape(P, 6)
        dl = jnp.einsum(
            "pij,pj->pi", Vinv,
            -gl - jnp.einsum("piak,ia->pk", Wt, dp, precision=jax.lax.Precision.HIGHEST),
            precision=jax.lax.Precision.HIGHEST,
        )

        cand_poses = se3.normalize(se3.compose(se3.exp(dp), st.poses))
        cand_poses = jnp.where(free_pose[:, None], cand_poses, st.poses)
        cand_pts = jnp.where(prob.pval[:, None], st.pts + dl, st.pts)
        new_cost = total_cost(cand_poses, cand_pts)
        accept = new_cost < st.cost
        converged = accept & (st.cost - new_cost <= rtol * (st.cost + 1e-20))
        return _IterState(
            poses=jnp.where(accept, cand_poses, st.poses),
            pts=jnp.where(accept, cand_pts, st.pts),
            lam=jnp.where(accept, lam * 0.33, lam * 5.0),
            cost=jnp.where(accept, new_cost, st.cost),
            it=st.it + 1,
            done=converged | (lam > 1e8),
        )

    init = _IterState(
        poses=poses0, pts=pts0, lam=jnp.asarray(1e-3, jnp.float32),
        cost=total_cost(poses0, pts0), it=jnp.int32(0), done=jnp.asarray(False),
    )
    st = jax.lax.while_loop(cond, body, init)
    return st.poses, st.pts


class BAOutput(NamedTuple):
    num_pruned: jnp.ndarray  # outlier observations removed (both passes)
    num_points: jnp.ndarray
    num_poses: jnp.ndarray


def ba_step(cfg: VOConfig, camera, state: VOState, kf: jnp.ndarray):
    """Full two-round local BA on keyframe ``kf``; returns (state, BAOutput).

    Masked no-op when the window/point sets are empty.
    """
    M, C = state.obs_kf.shape
    prob = build_problem(cfg, state, kf)

    poses0 = jnp.take(state.kf_pose, prob.widx, axis=0)
    pts0 = jnp.take(state.mp_pos, prob.pidx, axis=1).T  # [MB, 3]

    # round 1: robust kernel on all edges (backend.cpp:122-141)
    poses1, pts1 = _lm_phase(
        cfg, camera, prob, poses0, pts0, prob.o_valid,
        cfg.ba_iterations, cfg.huber_delta,
    )
    chi2_1 = _chi2(prob, poses1, pts1, camera)
    prune1 = prob.o_valid & (chi2_1 > cfg.chi2_th)

    # round 2: no robust kernel, pruned edges out (backend.cpp:143-159)
    mask2 = prob.o_valid & ~prune1
    poses2, pts2 = _lm_phase(
        cfg, camera, prob, poses1, pts1, mask2, cfg.ba_iterations, None
    )
    chi2_2 = _chi2(prob, poses2, pts2, camera)
    prune2 = mask2 & (chi2_2 > cfg.chi2_th)
    pruned = prune1 | prune2  # [MB, M]

    # ---- write back ------------------------------------------------------
    # poses of window keyframes (the fixed one is unchanged anyway)
    wtgt = jnp.where(prob.wval & ~prob.wfixed, prob.widx, state.kf_pose.shape[0])
    kf_pose = state.kf_pose.at[wtgt].set(poses2, mode="drop")

    # positions of selected, still-non-outlier points + optimized_ flag
    pt_ok = prob.pval & ~jnp.take(state.mp_outlier, prob.pidx)
    ptgt = jnp.where(pt_ok, prob.pidx, C)
    mp_pos = state.mp_pos.at[:, ptgt].set(pts2.T, mode="drop")
    mp_opt = state.mp_optimized.at[ptgt].set(True, mode="drop")

    state = state._replace(kf_pose=kf_pose, mp_pos=mp_pos, mp_optimized=mp_opt)

    # remove pruned observations from the map (backend.cpp:148-153, 164-168):
    # the per-point layout maps 1:1 onto the observation table rows
    state = mapstate.remove_observations_rows(state, prob.pidx, prob.pval, pruned)

    out = BAOutput(
        num_pruned=jnp.sum(pruned).astype(jnp.int32),
        num_points=jnp.sum(prob.pval).astype(jnp.int32),
        num_poses=jnp.sum(prob.wval).astype(jnp.int32),
    )
    return state, out
