"""Lane-parallel RANSAC pose estimation for RGB-D 3D-2D correspondences.

Lane-parallel replacement for ``cv::solvePnPRansac(..., 100 iters, 4.0 px,
0.99 conf, SOLVEPNP_P3P, useExtrinsicGuess=true)`` at
``src/frontend.cpp:233-242``.  Instead of OpenCV's sequential
hypothesize-and-test loop, all hypotheses are generated and scored at once:

- **Depth lanes** sample a 3-point minimal set and solve a closed-form
  **Kabsch 3D-3D alignment** between the matched mappoints (world frame) and
  the same keypoints back-projected through the current *depth image*
  (camera frame).  For an RGB-D sensor this minimal solver is available
  "for free" and is branch-free - a batched quaternion eigensolve - which
  suits a data-parallel device far better than P3P's quartic root-finding.
- **Depth-free lanes** (fraction ``depth_free_fraction``) sample 3 matches
  needing only a valid *match* and solve the 3-point 2D-3D problem with a
  few damped Gauss-Newton steps from the seed pose (6 residuals, 6 DOF - a
  generically exact system, i.e. P3P solved iteratively with the extrinsic
  guess).  This mirrors the reference's actual solver contract: its P3P
  never touches the depth channel (``src/frontend.cpp:238-241``), so a
  depth-starved frame (real Kinect frames lose 10-50% of depth to holes)
  must still produce pose hypotheses.  Without these lanes only the seed
  lane would survive total depth dropout.
- Lane 0 is always the previous pose, reproducing the reference's
  ``useExtrinsicGuess=true`` seeding.
- Scoring reproduces the reference contract: a correspondence is an inlier
  iff its **2D reprojection error** is below 4 px; the best lane maximizes
  the inlier count.

The polished pose then comes from the two-round Huber LM in
:mod:`rgbd_visualodometry_tpu.ops.lm`, mirroring the g2o motion-only BA.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rgbd_visualodometry_tpu import camera as cam_mod
from rgbd_visualodometry_tpu.ops import se3


class RansacResult(NamedTuple):
    pose: jnp.ndarray  # [7] best T_c_w
    inliers: jnp.ndarray  # [M] bool (reprojection < threshold under best pose)
    num_inliers: jnp.ndarray  # scalar int32 (the reference's numInliers_)


# Closed-form rigid alignment (Horn quaternion method, batched Jacobi
# eigensolver - no SVD, compiles to fused elementwise ops).
from rgbd_visualodometry_tpu.ops.smalleig import kabsch_quat as _kabsch  # noqa: E402


def _gn_three_point(pose0, p3, uv3, camera, iterations: int = 6, damping: float = 1e-4):
    """Solve one 3-point 2D-3D pose (6 residuals = 6 DOF) by damped
    Gauss-Newton from ``pose0``.  The branch-free replacement for one
    P3P evaluation: fixed iteration count, one 6x6 Cholesky per step.
    vmapped over RANSAC lanes."""
    from rgbd_visualodometry_tpu.ops import lm
    from rgbd_visualodometry_tpu.ops.smalleig import cholesky_solve

    def body(_, pose):
        e, p_c = lm.reprojection_residuals(pose, p3, uv3, camera)
        J = lm.pose_jacobian(p_c, camera)  # [3, 2, 6]
        H = jnp.einsum("mki,mkj->ij", J, J, precision=jax.lax.Precision.HIGHEST)
        g = jnp.einsum("mki,mk->i", J, e, precision=jax.lax.Precision.HIGHEST)
        Hd = H + damping * jnp.eye(6, dtype=H.dtype)
        delta = -cholesky_solve(Hd, g)
        # behind-camera / degenerate samples produce wild steps; clamping
        # keeps the lane finite so scoring can vote it out
        delta = jnp.clip(delta, -0.5, 0.5)
        return se3.normalize(se3.compose(se3.exp(delta), pose))

    return jax.lax.fori_loop(0, iterations, body, pose0)


def ransac_pnp(
    key: jax.Array,
    p_world: jnp.ndarray,  # [M, 3] matched mappoint positions (world)
    uv: jnp.ndarray,  # [M, 2] matched keypoint pixels
    p_cam_depth: jnp.ndarray,  # [M, 3] keypoints back-projected via depth
    depth_ok: jnp.ndarray,  # [M] bool - depth was valid at the keypoint
    match_valid: jnp.ndarray,  # [M] bool - slot holds a real match
    seed_pose: jnp.ndarray,  # [7] previous pose T_c_w (extrinsic guess)
    camera: cam_mod.Camera,
    n_hypotheses: int = 128,
    threshold: float = 4.0,
    depth_free_fraction: float = 0.25,
) -> RansacResult:
    """Vectorized RANSAC over ``n_hypotheses`` lanes (+1 seed lane).

    ``depth_free_fraction`` of the lanes need no depth at the sampled
    keypoints (see module docstring) - with heavy sensor dropout the depth
    lanes degenerate to repeats of the few depth-valid matches while the
    depth-free lanes keep full sample diversity.
    """
    m = p_world.shape[0]
    n_free = int(round(n_hypotheses * depth_free_fraction))
    n_depth = n_hypotheses - n_free
    sample_ok = match_valid & depth_ok

    # --- sample 3 distinct valid indices per lane -------------------------
    kd, kf = jax.random.split(key)
    noise = jax.random.uniform(kd, (n_depth, m))
    scores = jnp.where(sample_ok[None, :], noise, -1.0)
    _, sample_idx = jax.lax.top_k(scores, 3)  # [Hd, 3]

    # --- closed-form hypothesis per depth lane ----------------------------
    w3 = jnp.take(p_world, sample_idx, axis=0)  # [Hd, 3, 3]
    c3 = jnp.take(p_cam_depth, sample_idx, axis=0)
    hyp = _kabsch(w3, c3)  # [Hd, 7] (batched closed form)
    hyp = jnp.nan_to_num(hyp)

    parts = [seed_pose[None], hyp]
    if n_free:
        # --- depth-free lanes: 3-point GN from the seed pose --------------
        noise_f = jax.random.uniform(kf, (n_free, m))
        scores_f = jnp.where(match_valid[None, :], noise_f, -1.0)
        _, idx_f = jax.lax.top_k(scores_f, 3)  # [Hf, 3]
        wf = jnp.take(p_world, idx_f, axis=0)  # [Hf, 3, 3]
        uvf = jnp.take(uv, idx_f, axis=0)  # [Hf, 3, 2]
        hyp_f = jax.vmap(
            lambda p3, u3: _gn_three_point(seed_pose, p3, u3, camera)
        )(wf, uvf)
        parts.append(jnp.nan_to_num(hyp_f))
    hyp = jnp.concatenate(parts, axis=0)  # [H+1, 7]

    # --- score every lane against every correspondence --------------------
    proj = cam_mod.world2pixel(camera, p_world[None, :, :], hyp[:, None, :])
    z = cam_mod.world2camera(p_world[None, :, :], hyp[:, None, :])[..., 2]
    err2 = jnp.sum((proj - uv[None, :, :]) ** 2, axis=-1)  # [H+1, M]
    is_in = match_valid[None, :] & (z > 0) & (err2 < threshold * threshold)
    counts = jnp.sum(is_in, axis=1)  # [H+1]
    best = jnp.argmax(counts)

    return RansacResult(
        pose=se3.normalize(hyp[best]),
        inliers=is_in[best],
        num_inliers=counts[best].astype(jnp.int32),
    )
