"""Pinhole RGB-D camera model.

Vectorized equivalent of the reference ``Camera`` class
(``include/myslam/camera.h:29-69``, ``src/camera.cpp:41-86``).  The full
transform family world <-> camera <-> pixel is reproduced; all functions
broadcast over leading batch dimensions of the point arrays, so one call
projects the whole mappoint pool at once instead of looping point by point.

Poses are ``T_c_w`` (world -> camera) arrays as defined in
:mod:`rgbd_visualodometry_tpu.ops.se3`.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from rgbd_visualodometry_tpu.ops import se3


class Camera(NamedTuple):
    """Intrinsics bundle (reference ``camera.h:64-66``).

    Carried as a pytree of scalars so it can be closed over by jitted
    functions or passed as a runtime argument interchangeably.
    """

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    depth_scale: jnp.ndarray
    width: int = 640
    height: int = 480

    @classmethod
    def from_config(cls, cfg) -> "Camera":
        """Reads intrinsics from config like ``Camera::Camera``
        (``src/camera.cpp:27-39``)."""
        f32 = jnp.float32
        return cls(
            fx=f32(cfg.camera_fx),
            fy=f32(cfg.camera_fy),
            cx=f32(cfg.camera_cx),
            cy=f32(cfg.camera_cy),
            depth_scale=f32(cfg.camera_depth_scale),
            width=cfg.image_width,
            height=cfg.image_height,
        )

    @property
    def matrix(self) -> jnp.ndarray:
        """3x3 intrinsics K (``camera.h:48-50``)."""
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [self.fx, z, self.cx, z, self.fy, self.cy, z, z, o]
        ).reshape(3, 3)


def world2camera(p_w: jnp.ndarray, T_c_w: jnp.ndarray) -> jnp.ndarray:
    """``src/camera.cpp:41-44``."""
    return se3.apply(T_c_w, p_w)


def camera2world(p_c: jnp.ndarray, T_c_w: jnp.ndarray) -> jnp.ndarray:
    """``src/camera.cpp:46-49``."""
    return se3.apply(se3.inverse(T_c_w), p_c)


def camera2pixel(cam: Camera, p_c: jnp.ndarray) -> jnp.ndarray:
    """Perspective projection (``src/camera.cpp:51-57``).

    A tiny epsilon guards the division; callers mask out points with
    non-positive depth themselves (as the reference does via its frustum
    check, ``src/frame.cpp:72-75``).
    """
    z = p_c[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    u = cam.fx * p_c[..., 0] / zs + cam.cx
    v = cam.fy * p_c[..., 1] / zs + cam.cy
    return jnp.stack([u, v], axis=-1)


def pixel2camera(cam: Camera, p_p: jnp.ndarray, depth=1.0) -> jnp.ndarray:
    """Back-projection to the camera frame (``src/camera.cpp:59-66``)."""
    depth = jnp.asarray(depth)
    x = (p_p[..., 0] - cam.cx) * depth / cam.fx
    y = (p_p[..., 1] - cam.cy) * depth / cam.fy
    return jnp.stack([x, y, jnp.broadcast_to(depth, x.shape)], axis=-1)


def world2pixel(cam: Camera, p_w: jnp.ndarray, T_c_w: jnp.ndarray) -> jnp.ndarray:
    """``src/camera.cpp:72-75``."""
    return camera2pixel(cam, world2camera(p_w, T_c_w))


def pixel2world(cam: Camera, p_p: jnp.ndarray, T_c_w: jnp.ndarray, depth=1.0) -> jnp.ndarray:
    """``src/camera.cpp:77-80``."""
    return camera2world(pixel2camera(cam, p_p, depth), T_c_w)


def camera_center(T_c_w: jnp.ndarray) -> jnp.ndarray:
    """Optical center in world coordinates: translation of ``T_c_w^-1``
    (``include/myslam/frame.h:54-56``)."""
    return se3.trans(se3.inverse(T_c_w))


def in_frustum(
    cam: Camera,
    p_w: jnp.ndarray,
    T_c_w: jnp.ndarray,
    mp_norm: jnp.ndarray | None = None,
    max_angle: float = jnp.pi / 6,
) -> jnp.ndarray:
    """Vectorized ``Frame::IsCouldObserveMappoint`` (``src/frame.cpp:70-91``).

    A point is observable iff (a) it is in front of the camera, (b) it
    projects inside the image, and (c) the angle between the current viewing
    ray and the point's mean viewing direction is below ``max_angle``.
    Returns a boolean mask over the leading batch dims.
    """
    p_c = world2camera(p_w, T_c_w)
    in_front = p_c[..., 2] > 0
    uv = camera2pixel(cam, p_c)
    in_img = (
        (uv[..., 0] >= 0)
        & (uv[..., 0] < cam.width)
        & (uv[..., 1] >= 0)
        & (uv[..., 1] < cam.height)
    )
    ok = in_front & in_img
    if mp_norm is not None:
        center = camera_center(T_c_w)
        d = p_w - center
        d = d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        cosang = jnp.sum(d * mp_norm, axis=-1)
        # angle < max_angle  <=>  cos(angle) > cos(max_angle)
        ok = ok & (cosang > jnp.cos(max_angle))
    return ok
