"""Motion-only bundle adjustment: Levenberg-Marquardt on SE(3).

Batched replacement for the g2o pose-only BA in the tracking loop
(``src/frontend.cpp:256-312`` with ``VertexPose`` / ``UnaryEdgeProjection``
from ``include/myslam/g2o_types.h:47-108``):

- analytic 2x6 reprojection Jacobian w.r.t. the left-multiplicative update
  ``exp(delta) * T`` (same parameterization as ``g2o_types.h:59``),
- Huber robust kernel with delta = sqrt(7.815) (``src/frontend.cpp:282``)
  implemented as IRLS weights,
- the reference's two-round schedule: 10 robust iterations, drop edges with
  chi2 > 1, 10 non-robust iterations on the survivors, then re-collect the
  final inlier set over *all* edges (``src/frontend.cpp:291-329``).

Everything is batched over a fixed number of correspondence slots with a
validity mask; the "edge level" mechanism of g2o becomes a mask update.
The LM iteration count is static (`lax.fori_loop`), with classic adaptive
damping carried through the loop state.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rgbd_visualodometry_tpu import camera as cam_mod
from rgbd_visualodometry_tpu.ops import se3


def reprojection_residuals(pose, pts_w, uv, camera):
    """e = measured - projected (g2o computeError, g2o_types.h:81-85).

    Returns (e [M, 2], p_cam [M, 3])."""
    p_c = se3.apply(pose, pts_w)
    proj = cam_mod.camera2pixel(camera, p_c)
    return uv - proj, p_c


def pose_jacobian(p_cam: jnp.ndarray, camera) -> jnp.ndarray:
    """[M, 2, 6] analytic d(error)/d(delta) for the left-mult update.

    Equals ``-dproj/dp_c @ [I | -hat(p_c)]`` - the closed form written out
    at ``g2o_types.h:86-100`` (columns 0-2 translation, 3-5 rotation).
    """
    X, Y, Z = p_cam[..., 0], p_cam[..., 1], p_cam[..., 2]
    Zi = 1.0 / (Z + 1e-18)
    Zi2 = Zi * Zi
    fx, fy = camera.fx, camera.fy
    z = jnp.zeros_like(X)
    row0 = jnp.stack(
        [-fx * Zi, z, fx * X * Zi2, fx * X * Y * Zi2, -fx - fx * X * X * Zi2, fx * Y * Zi],
        axis=-1,
    )
    row1 = jnp.stack(
        [z, -fy * Zi, fy * Y * Zi2, fy + fy * Y * Y * Zi2, -fy * X * Y * Zi2, -fy * X * Zi],
        axis=-1,
    )
    return jnp.stack([row0, row1], axis=-2)


def _huber_weights(e_norm2: jnp.ndarray, delta: float | None) -> jnp.ndarray:
    """IRLS weight of the Huber kernel on squared residual norms."""
    if delta is None:
        return jnp.ones_like(e_norm2)
    e_norm = jnp.sqrt(jnp.maximum(e_norm2, 1e-18))
    return jnp.where(e_norm <= delta, 1.0, delta / e_norm)


def _robust_cost(e_norm2: jnp.ndarray, delta: float | None) -> jnp.ndarray:
    if delta is None:
        return e_norm2
    e_norm = jnp.sqrt(jnp.maximum(e_norm2, 1e-18))
    return jnp.where(e_norm <= delta, e_norm2, 2.0 * delta * e_norm - delta * delta)


class _LMState(NamedTuple):
    pose: jnp.ndarray
    lam: jnp.ndarray
    cost: jnp.ndarray
    it: jnp.ndarray
    done: jnp.ndarray


def lm_pose_round(
    pose0: jnp.ndarray,
    pts_w: jnp.ndarray,
    uv: jnp.ndarray,
    mask: jnp.ndarray,
    camera,
    iterations: int,
    huber_delta: float | None,
    rtol: float = 1e-6,
) -> jnp.ndarray:
    """One LM round over masked correspondences; returns the refined pose.

    Runs at most ``iterations`` damped steps (the reference's optimize(10))
    but exits early once the relative cost improvement of an accepted step
    drops below ``rtol`` - LM iterations execute serially on device, so
    converged iterations are pure latency.
    """
    from rgbd_visualodometry_tpu.ops.smalleig import cholesky_solve

    maskf = mask.astype(pts_w.dtype)

    def total_cost(pose):
        e, _ = reprojection_residuals(pose, pts_w, uv, camera)
        return jnp.sum(maskf * _robust_cost(jnp.sum(e * e, axis=-1), huber_delta))

    def cond(st: _LMState):
        return (st.it < iterations) & ~st.done

    def body(st: _LMState) -> _LMState:
        e, p_c = reprojection_residuals(st.pose, pts_w, uv, camera)
        J = pose_jacobian(p_c, camera)
        w = maskf * _huber_weights(jnp.sum(e * e, axis=-1), huber_delta)
        # normal equations: (sum w J^T J) delta = -(sum w J^T e)
        H = jnp.einsum("m,mki,mkj->ij", w, J, J, precision=jax.lax.Precision.HIGHEST)
        g = jnp.einsum("m,mki,mk->i", w, J, e, precision=jax.lax.Precision.HIGHEST)
        Hd = H + st.lam * jnp.eye(6, dtype=H.dtype)
        delta = -cholesky_solve(Hd, g)
        cand = se3.normalize(se3.compose(se3.exp(delta), st.pose))
        new_cost = total_cost(cand)
        accept = new_cost < st.cost
        converged = accept & (st.cost - new_cost <= rtol * (st.cost + 1e-20))
        return _LMState(
            pose=jnp.where(accept, cand, st.pose),
            lam=jnp.where(accept, st.lam * 0.33, st.lam * 5.0),
            cost=jnp.where(accept, new_cost, st.cost),
            it=st.it + 1,
            done=converged | (st.lam > 1e8),
        )

    init = _LMState(
        pose=pose0,
        lam=jnp.asarray(1e-3, pts_w.dtype),
        cost=total_cost(pose0),
        it=jnp.int32(0),
        done=jnp.asarray(False),
    )
    return jax.lax.while_loop(cond, body, init).pose


class PoseRefineResult(NamedTuple):
    pose: jnp.ndarray  # [7]
    inliers: jnp.ndarray  # [M] bool - final chi2 <= threshold set
    num_final_inliers: jnp.ndarray  # scalar int32


def refine_pose(
    pose0: jnp.ndarray,
    pts_w: jnp.ndarray,
    uv: jnp.ndarray,
    inlier_mask: jnp.ndarray,
    camera,
    iterations: int = 10,
    huber_delta: float = 7.815**0.5,
    chi2_outlier: float = 1.0,
) -> PoseRefineResult:
    """The reference's full two-round motion-only BA schedule
    (``src/frontend.cpp:256-329``)."""
    # round 1: robust, over RANSAC inliers
    pose1 = lm_pose_round(pose0, pts_w, uv, inlier_mask, camera, iterations, huber_delta)

    # drop chi2 > th edges (edge "level 1" trick becomes a mask update);
    # chi2 is the *unrobustified* squared error, like edge->chi2()
    e1, _ = reprojection_residuals(pose1, pts_w, uv, camera)
    chi2_1 = jnp.sum(e1 * e1, axis=-1)
    mask2 = inlier_mask & (chi2_1 <= chi2_outlier)

    # round 2: no robust kernel (setRobustKernel(0), frontend.cpp:305)
    pose2 = lm_pose_round(pose1, pts_w, uv, mask2, camera, iterations, None)

    # final inlier collection over ALL round-1 edges (frontend.cpp:314-329)
    e2, _ = reprojection_residuals(pose2, pts_w, uv, camera)
    chi2_2 = jnp.sum(e2 * e2, axis=-1)
    final = inlier_mask & (chi2_2 <= chi2_outlier)
    return PoseRefineResult(
        pose=pose2, inliers=final, num_final_inliers=jnp.sum(final).astype(jnp.int32)
    )
