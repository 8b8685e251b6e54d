"""Synthetic RGB-D sequence generator with exact ground truth.

The reference has no test fixtures at all (SURVEY.md section 4); its only
"integration test" is running on a downloaded TUM sequence.  This module
renders an analytic world - every pixel's color and depth and every camera
pose are exact - giving hermetic golden-trajectory tests, benchmarks that
need no dataset download, and the CLI demo mode.

World model: a base plane ``z = plane_z`` (world frame) textured with a
random blocky pattern (sharp cell edges -> dense FAST corners at every cell
junction), optionally populated with ``n_boxes`` axis-aligned textured boxes
floating in front of it (non-coplanar structure, occlusion, real parallax).
Rendering intersects each pixel ray with every surface and keeps the nearest
hit; depth is the camera-frame z, encoded TUM-style as
``uint16 = meters * 5000``.

Sensor degradations (all off by default; the ``hard_scene`` preset turns
them on at Kinect-like rates) reproduce what the reference's robustness
machinery exists for:

- ``depth_dropout``: blobby per-frame holes in the depth map (TUM fr1 depth
  has large missing regions; this is why ``Frame::GetDepth`` probes 4
  neighbors, ``src/frame.cpp:54-67``),
- ``edge_dropout``: depth killed along strong depth discontinuities (Kinect
  edge shadowing - exactly where FAST corners concentrate),
- ``depth_noise``: Gaussian axial noise with the Kinect's sigma ~ z^2 growth
  (Khoshelham & Elberink 2012: sigma_z ~ 1.4e-3 * z^2 m) plus the uint16
  encoding's own quantization,
- ``exposure_jitter``: per-frame global gain/offset on the RGB (TUM fr1 has
  auto-exposure flicker; stresses the fixed FAST threshold).

Degradations are deterministic per (scene seed, timestamp) so sequences are
reproducible and the cv2 baseline twin sees bit-identical frames.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SyntheticFrame(NamedTuple):
    rgb: np.ndarray  # [H, W, 3] uint8
    depth: np.ndarray  # [H, W] uint16
    timestamp: float
    T_c_w: np.ndarray  # [7] ground-truth pose (qw qx qy qz tx ty tz)


def _quat_rotate(q, v):
    w, x, y, z = q[0], q[1:2], q[2:3], q[3:4]
    qv = q[1:4]
    t = 2.0 * np.cross(qv, v)
    return v + w * t + np.cross(qv, t)


def _pose_inverse(T):
    q = T[:4] * np.array([1.0, -1, -1, -1])
    return np.concatenate([q, -_quat_rotate(q, T[4:7][None])[0]])


def _rotvec_to_quat(rv):
    theta = np.linalg.norm(rv)
    if theta < 1e-12:
        return np.array([1.0, 0, 0, 0])
    axis = rv / theta
    return np.concatenate([[np.cos(theta / 2)], np.sin(theta / 2) * axis])


def _quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ]
    )


def make_pose(rotvec, trans) -> np.ndarray:
    return np.concatenate([_rotvec_to_quat(np.asarray(rotvec, float)), np.asarray(trans, float)])


class SyntheticScene:
    """Textured plane at ``z = plane_z``, optional boxes, optional sensor
    degradations (see module docstring).  Defaults reproduce the easy
    round-1/2 world exactly (no boxes, exact noise-free depth)."""

    def __init__(
        self,
        width: int = 640,
        height: int = 480,
        fx: float = 517.3,
        fy: float = 516.5,
        cx: float = 318.6,
        cy: float = 255.3,
        depth_scale: float = 5000.0,
        plane_z: float = 2.5,
        cell_size: float = 0.06,
        texture_cells: int = 1024,
        seed: int = 0,
        n_boxes: int = 0,
        # world-x/y span of the box field; defaults cover the region a
        # default ``orbit_trajectory`` camera actually sweeps (it drifts
        # toward -x with yaw, viewing x in ~[-4.5, 1.6] over 240 frames)
        box_span_x: tuple = (-5.0, 2.0),
        box_span_y: tuple = (-1.6, 1.6),
        depth_dropout: float = 0.0,  # fraction of pixels lost to blobby holes
        edge_dropout: bool = False,  # kill depth on strong discontinuities
        depth_noise: float = 0.0,  # sigma_z = depth_noise * z^2 (m); Kinect ~1.4e-3
        exposure_jitter: float = 0.0,  # per-frame gain in [1 +- j], offset ~ 25*j
    ):
        self.w, self.h = width, height
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy
        self.depth_scale = depth_scale
        self.plane_z = plane_z
        self.cell = cell_size
        self.seed = seed
        self.depth_dropout = float(depth_dropout)
        self.edge_dropout = bool(edge_dropout)
        self.depth_noise = float(depth_noise)
        self.exposure_jitter = float(exposure_jitter)
        rng = np.random.default_rng(seed)
        # RGB blocky texture with strong luma contrast
        self.tex = rng.integers(20, 236, (texture_cells, texture_cells, 3)).astype(np.uint8)
        # axis-aligned boxes in front of the plane, spread over the volume a
        # default orbit_trajectory sweeps (camera drifts +x over time)
        self.boxes = np.zeros((0, 6), float)  # rows: x0 x1 y0 y1 z0 z1
        if n_boxes:
            bc = np.stack(
                [
                    rng.uniform(*box_span_x, n_boxes),  # x centers
                    rng.uniform(*box_span_y, n_boxes),  # y centers
                    rng.uniform(plane_z - 1.4, plane_z - 0.35, n_boxes),  # z centers
                ],
                axis=1,
            )
            bs = rng.uniform(0.12, 0.45, (n_boxes, 3))  # half-sizes
            self.boxes = np.stack(
                [
                    bc[:, 0] - bs[:, 0], bc[:, 0] + bs[:, 0],
                    bc[:, 1] - bs[:, 1], bc[:, 1] + bs[:, 1],
                    bc[:, 2] - bs[:, 2], bc[:, 2] + bs[:, 2],
                ],
                axis=1,
            )
        u, v = np.meshgrid(np.arange(width), np.arange(height))
        self._dirs = np.stack(
            [(u - cx) / fx, (v - cy) / fy, np.ones_like(u, float)], axis=-1
        )  # camera-frame ray dirs, z=1

    def _frame_rng(self, timestamp: float) -> np.random.Generator:
        """Deterministic per-frame RNG: same (seed, timestamp) -> same frame."""
        key = int(np.float64(timestamp).view(np.int64)) & 0x7FFFFFFF
        return np.random.default_rng((self.seed, key))

    def render(self, T_c_w: np.ndarray, timestamp: float = 0.0) -> SyntheticFrame:
        """Render RGB + depth from pose T_c_w (world->camera)."""
        T_w_c = _pose_inverse(np.asarray(T_c_w, float))
        q_wc, center = T_w_c[:4], T_w_c[4:7]
        d_w = _quat_rotate(q_wc, self._dirs.reshape(-1, 3)).reshape(self.h, self.w, 3)
        dz = d_w[..., 2]
        dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)
        t_plane = (self.plane_z - center[2]) / dz  # camera depth (dirs have z=1)
        t_hit = np.where(t_plane > 0.05, t_plane, np.inf)
        # nearest box hit via the slab method, vectorized over pixels per box
        d_safe = np.where(np.abs(d_w) < 1e-12, 1e-12, d_w)
        for x0, x1, y0, y1, z0, z1 in self.boxes:
            lo = np.array([x0, y0, z0])
            hi = np.array([x1, y1, z1])
            ta = (lo[None, None, :] - center[None, None, :]) / d_safe
            tb = (hi[None, None, :] - center[None, None, :]) / d_safe
            t_near = np.minimum(ta, tb).max(axis=-1)
            t_far = np.maximum(ta, tb).min(axis=-1)
            ok = (t_near <= t_far) & (t_near > 0.05)
            t_hit = np.minimum(t_hit, np.where(ok, t_near, np.inf))
        hit = np.isfinite(t_hit)
        t = np.where(hit, t_hit, 0.0)
        p_w = center[None, None, :] + t[..., None] * d_w
        # world-stable texture coordinates that vary on every box face (pure
        # x/y indexing would leave z-normal faces constant-colored): shear
        # the lookup by z so all three face orientations get the pattern
        tu = p_w[..., 0] + 0.731 * p_w[..., 2]
        tv = p_w[..., 1] + 0.413 * p_w[..., 2]
        ui = np.floor(tu / self.cell).astype(np.int64) % self.tex.shape[0]
        vi = np.floor(tv / self.cell).astype(np.int64) % self.tex.shape[1]
        rgb = self.tex[vi, ui]
        rgb = np.where(hit[..., None], rgb, 0)

        rng = self._frame_rng(timestamp)
        if self.exposure_jitter:
            gain = 1.0 + self.exposure_jitter * rng.uniform(-1.0, 1.0)
            offset = 25.0 * self.exposure_jitter * rng.uniform(-1.0, 1.0)
            rgb = rgb.astype(np.float64) * gain + offset
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)

        t_meas = t
        if self.depth_noise:
            t_meas = t + rng.normal(0.0, 1.0, t.shape) * self.depth_noise * t * t
        keep = hit
        if self.edge_dropout:
            # Kinect-style shadowing: depth invalid along discontinuities
            jump = np.zeros_like(t)
            for ax in (0, 1):
                d = np.abs(np.diff(t, axis=ax))
                pad = [(0, 0), (0, 0)]
                pad[ax] = (0, 1)
                jump = np.maximum(jump, np.pad(d, pad))
                pad[ax] = (1, 0)
                jump = np.maximum(jump, np.pad(d, pad))
            keep = keep & (jump < 0.04)
        if self.depth_dropout:
            # blobby holes: threshold smooth low-res noise at the requested
            # dropout quantile (large contiguous missing regions, like fr1)
            bh, bw = max(self.h // 16, 2), max(self.w // 16, 2)
            blob = rng.uniform(0.0, 1.0, (bh, bw))
            blob = np.kron(blob, np.ones((self.h // bh + 1, self.w // bw + 1)))
            blob = blob[: self.h, : self.w]
            keep = keep & (blob > np.quantile(blob, self.depth_dropout))
        depth_raw = np.where(keep, t_meas * self.depth_scale, 0.0)
        depth = np.clip(np.round(depth_raw), 0, 65535).astype(np.uint16)
        return SyntheticFrame(rgb=rgb, depth=depth, timestamp=float(timestamp), T_c_w=np.asarray(T_c_w, float))


def hard_scene(width: int = 640, height: int = 480, **kw) -> SyntheticScene:
    """fr1-like difficulty preset: non-planar boxes,
    10% blobby depth holes + edge shadowing, Kinect z^2 axial noise, mild
    auto-exposure flicker.  Keyword overrides pass through to the scene."""
    params = dict(
        n_boxes=48,
        depth_dropout=0.10,
        edge_dropout=True,
        depth_noise=1.4e-3,
        exposure_jitter=0.06,
    )
    params.update(kw)
    return SyntheticScene(width=width, height=height, **params)


def orbit_trajectory(n_frames: int, step_t=(0.02, 0.004, 0.0), step_r=(0.0, 0.0, 0.004)):
    """Ground-truth T_c_w sequence: constant-velocity lateral drift + yaw.

    Defaults move ~2 cm/frame so every few frames crosses the reference's
    keyframe threshold (0.05 m / 0.05 rad, config/default.yaml:24-25).
    """
    poses = [make_pose([0.0, 0, 0], [0.0, 0, 0])]
    dq = _rotvec_to_quat(np.asarray(step_r, float))
    dt = np.asarray(step_t, float)
    for _ in range(n_frames - 1):
        prev = poses[-1]
        q = _quat_mul(dq, prev[:4])
        q /= np.linalg.norm(q)
        t = _quat_rotate(dq, prev[4:7][None])[0] + dt
        poses.append(np.concatenate([q, t]))
    return poses


def loop_trajectory(n_frames: int, step: float = 0.02):
    """Ground-truth T_c_w sequence on a CLOSED rectangular circuit parallel
    to the plane (constant orientation): +x, +y, -x, -y back to the start.
    The final quarter revisits the first quarter's mapped area - the
    guaranteed-revisit input for loop-closure tests (the reference has no
    loop handling at all; ``src/backend.cpp:19-195`` never leaves the local
    window)."""
    per = max(n_frames // 4, 1)
    dirs = [(step, 0.0), (0.0, step), (-step, 0.0), (0.0, -step)]
    poses, x, y = [], 0.0, 0.0
    for i in range(n_frames):
        poses.append(make_pose([0.0, 0.0, 0.0], [x, y, 0.0]))
        dx, dy = dirs[min(i // per, 3)]
        x += dx
        y += dy
    return poses


def generate_sequence(n_frames: int, fps: float = 30.0, scene: SyntheticScene | None = None, **traj_kw):
    scene = scene or SyntheticScene()
    frames = []
    for i, T in enumerate(orbit_trajectory(n_frames, **traj_kw)):
        frames.append(scene.render(T, timestamp=i / fps))
    return frames
