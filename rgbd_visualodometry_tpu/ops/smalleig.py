"""Branch-free batched small linear algebra.

``jnp.linalg.svd`` / ``eigh`` lower to generic LAPACK-style loops that are
expensive for XLA to compile and poorly shaped for the device when the
matrices are tiny (3x3 / 4x4) but the batch is large - exactly this
framework's workload (RANSAC Kabsch lanes, per-point Schur blocks, DLT
normal matrices).  This module provides closed-form / fixed-iteration
alternatives that compile to a handful of fused elementwise ops:

- :func:`jacobi_eigh_sym`: cyclic Jacobi eigendecomposition for batched
  symmetric matrices (static sweep count, rotations applied with `where`
  masks - no data-dependent control flow).
- :func:`inv3x3`: adjugate closed-form inverse.
- :func:`kabsch_quat`: Horn's quaternion absolute-orientation method - the
  rigid alignment used by the RANSAC minimal solver - needing only the
  largest eigenvector of a symmetric 4x4, via Jacobi.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def jacobi_eigh_sym(A: jnp.ndarray, sweeps: int = 8):
    """Eigendecomposition of batched symmetric matrices ``A [..., n, n]``.

    Returns ``(eigenvalues [..., n] ascending, eigenvectors [..., n, n])``
    with ``A @ v[..., :, i] = w[..., i] * v[..., :, i]``.  Cyclic Jacobi
    with a static sweep count; for n <= 6 and float32, ``sweeps=8`` reaches
    machine precision.
    """
    import jax

    n = A.shape[-1]
    V = jnp.broadcast_to(jnp.eye(n, dtype=A.dtype), A.shape)

    def one_sweep(_, AV):
        A, V = AV
        for p in range(n - 1):
            for q in range(p + 1, n):
                app = A[..., p, p]
                aqq = A[..., q, q]
                apq = A[..., p, q]
                # rotation angle zeroing A[p, q]; atan2 handles apq == 0
                theta = 0.5 * jnp.arctan2(2.0 * apq, aqq - app)
                c = jnp.cos(theta)[..., None]
                s = jnp.sin(theta)[..., None]

                Ap = A[..., p, :]
                Aq = A[..., q, :]
                A = A.at[..., p, :].set(c * Ap - s * Aq)
                A = A.at[..., q, :].set(s * Ap + c * Aq)
                Ap = A[..., :, p]
                Aq = A[..., :, q]
                A = A.at[..., :, p].set(c * Ap - s * Aq)
                A = A.at[..., :, q].set(s * Ap + c * Aq)

                Vp = V[..., :, p]
                Vq = V[..., :, q]
                V = V.at[..., :, p].set(c * Vp - s * Vq)
                V = V.at[..., :, q].set(s * Vp + c * Vq)
        return A, V

    # sweeps in a fori_loop: traces one sweep instead of all of them
    A, V = jax.lax.fori_loop(0, sweeps, one_sweep, (A, V))

    w = jnp.diagonal(A, axis1=-2, axis2=-1)
    order = jnp.argsort(w, axis=-1)
    w_sorted = jnp.take_along_axis(w, order, axis=-1)
    V_sorted = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    return w_sorted, V_sorted


def inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form adjugate inverse of batched 3x3 matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < 1e-18, 1e-18, det)
    adj = jnp.stack(
        [A11, A12, A13, A21, A22, A23, A31, A32, A33], axis=-1
    ).reshape(A.shape)
    return adj / det[..., None, None]


def cholesky_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve SPD systems ``A x = b`` with a fully unrolled Cholesky.

    A: [..., n, n] (n static, intended n <= 8), b: [..., n].  Unrolled
    scalar recurrences compile to a handful of fused elementwise ops - much cheaper
    inside an LM iteration loop than a general LU ``jnp.linalg.solve``.
    """
    n = A.shape[-1]
    eps = jnp.asarray(1e-12, A.dtype)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = jnp.sqrt(jnp.maximum(s, eps))
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def horn_quat_from_crosscov(S: jnp.ndarray) -> jnp.ndarray:
    """Horn's rotation from a CENTERED cross-covariance ``[..., 3, 3]``,
    ``S[a, b] = sum_i w_i (world_i - wbar)_a (cam_i - cbar)_b`` -> unit
    quaternion ``[..., 4]`` (w, x, y, z) of the R with ``cam ~= R @ world``.

    Builds the symmetric 4x4 quaternion matrix and takes the top
    eigenvector via Jacobi - no SVD, no reflection-sign fixup needed (the
    quaternion parameterization can only produce proper rotations).
    Shared by ``kabsch_quat`` (raw point sets) and the moment-based
    weighted Kabsch in ``ops/loopclosure.py`` (per-keyframe-pair
    scatter-accumulated moments).
    """
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = jnp.stack(
        [
            Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx,
            Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz,
            Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy,
            Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz,
        ],
        axis=-1,
    ).reshape(S.shape[:-2] + (4, 4))
    w, V = jacobi_eigh_sym(N)
    q = V[..., :, -1]  # eigenvector of the largest eigenvalue, (w, x, y, z)
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def kabsch_quat(world: jnp.ndarray, cam: jnp.ndarray) -> jnp.ndarray:
    """Horn's closed-form absolute orientation: find pose [..., 7] with
    ``cam ~= R @ world + t`` from point sets ``[..., k, 3]``.
    """
    wc = world.mean(axis=-2, keepdims=True)
    cc = cam.mean(axis=-2, keepdims=True)
    # S[a, b] = sum_i (world_i - wbar)_a (cam_i - cbar)_b
    S = jnp.einsum("...ka,...kb->...ab", world - wc, cam - cc, precision=jax.lax.Precision.HIGHEST)
    q = horn_quat_from_crosscov(S)

    from rgbd_visualodometry_tpu.ops import se3

    t = cc[..., 0, :] - se3.quat_rotate(q, wc[..., 0, :])
    return se3.make(q, t)
