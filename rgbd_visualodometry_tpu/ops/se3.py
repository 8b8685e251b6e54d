"""SE(3) / SO(3) Lie group operations, fully vectorized and differentiable.

Batched replacement for ``Sophus::SE3d`` as used by the reference
(``include/myslam/common_include.h:36-41``, ``include/myslam/g2o_types.h:56-60``).

Conventions (matching Sophus so the reference's thresholds transfer 1:1):

- A pose is a flat array ``[..., 7] = (qw, qx, qy, qz, tx, ty, tz)`` acting as
  ``T * p = R(q) p + t``; in the pipeline poses are ``T_c_w`` (world->camera),
  like ``Frame::T_c_w_`` (``include/myslam/frame.h:89``).
- The tangent vector is ``(rho, phi)``: **translation first, rotation last**,
  exactly the ordering the reference's g2o vertices use
  (``g2o_types.h:44-45`` comment, ``g2o_types.h:61-66`` oplus).
- ``exp`` / ``log`` use the left-multiplicative convention: optimizer updates
  are ``exp(delta) * T`` (``g2o_types.h:59``).

Everything broadcasts over leading batch dimensions and is `vmap`/`jit`
friendly (no data-dependent branches - small-angle cases use Taylor series
selected with `jnp.where`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.array([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype)


def quat(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., :4]


def trans(T: jnp.ndarray) -> jnp.ndarray:
    return T[..., 4:7]


def make(q: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([q, t], axis=-1)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def normalize(T: jnp.ndarray) -> jnp.ndarray:
    """Re-normalize the quaternion part (cheap drift control under f32)."""
    return make(quat_normalize(quat(T)), trans(T))


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors ``v[..., 3]`` by unit quaternions ``q[..., 4]``."""
    qv = q[..., 1:4]
    w = q[..., 0:1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free.

    Uses the four-candidate construction (one per largest diagonal term),
    selected with `where`, so it is safe under `vmap`/`jit`.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _cand(a, b, c, d):
        return jnp.stack([a, b, c, d], axis=-1)

    # candidate 0: trace-dominant
    s0 = jnp.sqrt(jnp.maximum(tr + 1.0, _EPS)) * 2.0
    q0 = _cand(0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0)
    # candidate 1: m00 dominant
    s1 = jnp.sqrt(jnp.maximum(1.0 + m00 - m11 - m22, _EPS)) * 2.0
    q1 = _cand((m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1)
    # candidate 2: m11 dominant
    s2 = jnp.sqrt(jnp.maximum(1.0 + m11 - m00 - m22, _EPS)) * 2.0
    q2 = _cand((m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2)
    # candidate 3: m22 dominant
    s3 = jnp.sqrt(jnp.maximum(1.0 + m22 - m00 - m11, _EPS)) * 2.0
    q3 = _cand((m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3)

    c1 = (m00 > m11) & (m00 > m22)
    c2 = m11 > m22
    qd = jnp.where(c1[..., None], q1, jnp.where(c2[..., None], q2, q3))
    q = jnp.where((tr > 0.0)[..., None], q0, qd)
    return quat_normalize(q)


def _hat(w: jnp.ndarray) -> jnp.ndarray:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = jnp.zeros_like(wx)
    m = jnp.stack(
        [zero, -wz, wy, wz, zero, -wx, -wy, wx, zero], axis=-1
    )
    return m.reshape(w.shape[:-1] + (3, 3))


hat = _hat


def so3_exp_quat(phi: jnp.ndarray) -> jnp.ndarray:
    """Rotation-vector -> unit quaternion, Taylor-safe near zero."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < 1e-4
    half = 0.5 * theta
    # sin(theta/2)/theta with Taylor fallback
    k = jnp.where(small, 0.5 - theta2 / 48.0, jnp.sin(half) / jnp.maximum(theta, _EPS))
    w = jnp.where(small, 1.0 - theta2 / 8.0, jnp.cos(half))
    return quat_normalize(
        jnp.concatenate([w[..., None], k[..., None] * phi], axis=-1)
    )


def so3_log(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> rotation vector, Taylor-safe near zero."""
    q = jnp.where(q[..., 0:1] < 0, -q, q)  # canonical hemisphere
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:4]
    vn = jnp.linalg.norm(v, axis=-1)
    theta = 2.0 * jnp.arctan2(vn, w)
    small = vn < 1e-6
    scale = jnp.where(small, 2.0 / jnp.maximum(w, _EPS), theta / jnp.maximum(vn, _EPS))
    return scale[..., None] * v


def _so3_left_jacobian(phi: jnp.ndarray) -> jnp.ndarray:
    """V(phi): the SO(3) left Jacobian, so that exp_se3 t-part = V @ rho."""
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < 1e-4
    a = jnp.where(  # (1 - cos t)/t^2
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS)
    )
    b = jnp.where(  # (t - sin t)/t^3
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, _EPS),
    )
    W = _hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * jnp.matmul(W, W, precision=jax.lax.Precision.HIGHEST)


def _so3_left_jacobian_inv(phi: jnp.ndarray) -> jnp.ndarray:
    theta2 = jnp.sum(phi * phi, axis=-1)
    theta = jnp.sqrt(theta2)
    small = theta < 1e-4
    half = 0.5 * theta
    # 1/t^2 - (1 + cos t)/(2 t sin t)  ==  (1 - t/2 * cot(t/2)) / t^2
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), _EPS))
        / jnp.maximum(theta2, _EPS),
    )
    W = _hat(phi)
    I = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), W.shape)
    return I - 0.5 * W + cot_term[..., None, None] * jnp.matmul(W, W, precision=jax.lax.Precision.HIGHEST)


def exp(xi: jnp.ndarray) -> jnp.ndarray:
    """se(3) tangent ``(rho, phi)[..., 6]`` -> pose ``[..., 7]``.

    Matches ``Sophus::SE3d::exp`` with translation-first ordering
    (``g2o_types.h:44-45``).
    """
    rho, phi = xi[..., :3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    V = _so3_left_jacobian(phi)
    t = jnp.einsum("...ij,...j->...i", V, rho, precision=jax.lax.Precision.HIGHEST)
    return make(q, t)


def log(T: jnp.ndarray) -> jnp.ndarray:
    """Pose ``[..., 7]`` -> se(3) tangent ``(rho, phi)[..., 6]``."""
    phi = so3_log(quat(T))
    Vinv = _so3_left_jacobian_inv(phi)
    rho = jnp.einsum("...ij,...j->...i", Vinv, trans(T), precision=jax.lax.Precision.HIGHEST)
    return jnp.concatenate([rho, phi], axis=-1)


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a * b`` (apply b first, then a)."""
    q = quat_mul(quat(a), quat(b))
    t = quat_rotate(quat(a), trans(b)) + trans(a)
    return make(quat_normalize(q), t)


def inverse(T: jnp.ndarray) -> jnp.ndarray:
    qc = quat_conj(quat(T))
    return make(qc, -quat_rotate(qc, trans(T)))


def apply(T: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """``T * p``: transform points ``p[..., 3]``."""
    return quat_rotate(quat(T), p) + trans(T)


def to_matrix(T: jnp.ndarray) -> jnp.ndarray:
    """Pose -> homogeneous ``[..., 4, 4]`` matrix."""
    R = quat_to_matrix(quat(T))
    t = trans(T)[..., :, None]
    top = jnp.concatenate([R, t], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0, 0, 1.0], dtype=T.dtype), T.shape[:-1] + (4,)
    )[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def to_matrix34(T: jnp.ndarray) -> jnp.ndarray:
    """Pose -> ``[..., 3, 4]`` matrix (as ``SE3::matrix3x4`` in util.h:24)."""
    R = quat_to_matrix(quat(T))
    return jnp.concatenate([R, trans(T)[..., :, None]], axis=-1)


def from_matrix(M: jnp.ndarray) -> jnp.ndarray:
    """``[..., 3|4, 4]`` rigid matrix -> pose array."""
    return make(matrix_to_quat(M[..., :3, :3]), M[..., :3, 3])


def relative(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a * b^-1`` - the reference's relative-motion expression
    ``T_r_c = framePrev.pose * frameCurr.pose.inverse()``
    (``src/frontend.cpp:344,356``)."""
    return compose(a, inverse(b))
