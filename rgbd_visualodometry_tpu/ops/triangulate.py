"""Batched DLT triangulation with SVD quality gate.

Batched equivalent of ``myslam::Triangulation``
(``include/myslam/util.h:16-34``): for each landmark, stack two rows per
observation

    A[2i]   = x_i * P_i.row(2) - P_i.row(0)
    A[2i+1] = y_i * P_i.row(2) - P_i.row(1)

where ``P_i`` is the 3x4 pose matrix and ``(x_i, y_i)`` the normalized-plane
observation, then take the right singular vector of the smallest singular
value.  Success requires ``sigma_last / sigma_second_last < 1e-2`` (the gate
at ``util.h:30-33``).

Instead of one SVD per point in a loop, the whole mappoint batch is
triangulated at once: observations are padded to a fixed ``max_obs`` (padded
rows are zero, which leaves the normal equations untouched), giving one
batched SVD of shape ``[B, 2*max_obs, 4]``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from rgbd_visualodometry_tpu.ops import se3


class TriangulationResult(NamedTuple):
    points: jnp.ndarray  # [B, 3] world positions
    ok: jnp.ndarray  # [B] bool - gate passed and >= 2 observations


def triangulate(
    poses: jnp.ndarray,  # [B, K, 7] observing keyframe poses (T_c_w)
    norm_xy: jnp.ndarray,  # [B, K, 2] normalized-plane observations
    obs_mask: jnp.ndarray,  # [B, K] bool
    sv_ratio: float = 1e-2,
    min_obs: int = 2,
    min_baseline: float = 0.0,
) -> TriangulationResult:
    """``min_baseline`` > 0 additionally requires the observing camera
    centers to span at least that distance.  The reference's sigma-ratio
    gate only rejects ALGEBRAICALLY degenerate systems; a pair of keyframes
    one keyframe-threshold apart (0.05 m) at fr1 depths (~2 m) passes it
    easily yet triangulates with ~z^2*sigma_px/(f*b) ~ 8 cm depth noise -
    40x worse than the Kinect sensor noise model (sigma = 1.4e-3 z^2 ~
    6 mm) of the depth-derived position it would overwrite.  The break-even
    baseline is sigma_px/(f*k) ~ 0.7 m; the reference never faces this at
    scale because it `break`s after ONE success per keyframe
    (frontend.cpp:501) while this pipeline refines up to
    ``triangulation_batch`` landmarks per keyframe."""
    P = se3.to_matrix34(poses)  # [B, K, 3, 4]
    x = norm_xy[..., 0:1]
    y = norm_xy[..., 1:2]
    row0 = x * P[..., 2, :] - P[..., 0, :]  # [B, K, 4]
    row1 = y * P[..., 2, :] - P[..., 1, :]
    A = jnp.concatenate([row0, row1], axis=-2)  # [B, 2K, 4]
    A = A * jnp.concatenate([obs_mask, obs_mask], axis=-1)[..., None]

    # right singular vectors / values of A via the 4x4 Gram matrix: the
    # eigenvector of the smallest eigenvalue of A^T A is the DLT solution,
    # and eigenvalues are squared singular values.  A batched Jacobi sweep on
    # 4x4 symmetric matrices compiles far leaner than a [B, 2K, 4] SVD.
    from rgbd_visualodometry_tpu.ops.smalleig import jacobi_eigh_sym

    G = jnp.einsum("...ki,...kj->...ij", A, A, precision=jax.lax.Precision.HIGHEST)
    lam, V = jacobi_eigh_sym(G)  # ascending eigenvalues
    v_last = V[..., :, 0]  # null-space direction
    w = v_last[..., 3]
    pts = v_last[..., :3] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)[..., None]

    # sigma_last/sigma_second < ratio (util.h:30-33) on squared values, plus
    # a conditioning floor: a rank-<3 system (e.g. zero baseline) has BOTH
    # sigma_3 and sigma_4 at float-noise level, where the reference's ratio
    # is numerically meaningless garbage - require genuine rank 3
    lam = jnp.maximum(lam, 0.0)
    # floor at sigma_3 > 1e-2 * sigma_1 (squared: 1e-4): safely above the
    # float32 Gram-matrix noise floor (~1e-7 * lam_max)
    quality = (lam[..., 0] < sv_ratio**2 * lam[..., 1]) & (
        lam[..., 1] > 1e-4 * lam[..., 3]
    )
    enough = jnp.sum(obs_mask, axis=-1) >= min_obs
    ok = quality & enough
    if min_baseline > 0.0:
        # camera centers c = -R^T t from the T_c_w rows of P
        c = -jnp.einsum("...ij,...i->...j", P[..., :3, :3], P[..., :3, 3], precision=jax.lax.Precision.HIGHEST)
        d2 = jnp.sum((c[..., :, None, :] - c[..., None, :, :]) ** 2, axis=-1)
        pair_ok = obs_mask[..., :, None] & obs_mask[..., None, :]
        span2 = jnp.max(jnp.where(pair_ok, d2, 0.0), axis=(-2, -1))
        ok = ok & (span2 >= min_baseline * min_baseline)
    return TriangulationResult(points=pts, ok=ok)
