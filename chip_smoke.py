"""Smoke run of the VO pipeline on an NVIDIA GPU, through its public entry
points, at full fr1 width (640x480, 500 ORB features, 8 levels, local BA).

    python chip_smoke.py               # phases 1-5 on one GPU
    python chip_smoke.py --four-cards  # the multi-device phase only, 4 GPUs

Phases (each prints its checks, tolerances and wall time, compile included):

1. device  - the default backend is a GPU (there is no CPU fallback);
2. cli     - ``cli.main`` on ``configs/default.yaml --synthetic 60``;
3. single  - ``VisualOdometry`` at ``bench.single_stream_cfg`` on the
             bench's 120 frames; ATE bound; first 20 poses, GPU vs CPU
             on the f32 path and bf16 vs f32 on the GPU;
4. multi   - ``MultiStreamVO`` at ``bench.multistream_cfg(full_vo=True)``,
             72 streams x 30 steps;
5. kernels - each int8 / bf16 / one-hot path on the GPU against its plain
             reference (numpy or the same code on the CPU device);
6. four    - (``--four-cards`` only) the sharded paths over a 4-GPU mesh
             against the same work on one GPU.

Any failed check raises, so the process exits non-zero and prints no
result.  The last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Everything runs in this one process: the CPU references use JAX's CPU
device in-process, because a second process could not open the GPU while
this one holds it.  The CPU references run the f32 path (``orb_bf16`` and
``orb_patch_bf16`` off): XLA:CPU's dot thunk refuses the BRIEF matmul's
bf16 x bf16 -> f32 shape ("Unsupported element type for DotThunk"), and
f32 is the reference numerics anyway.  So a device difference is read
GPU f32 vs CPU f32, and the bf16-by-design difference GPU bf16 vs GPU f32.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# ATE of the single-stream phase (bench.single_stream_cfg, the bench's 120
# frames) measured with the CPU backend: 0.270 cm, 120/120 tracked, 25 BA
# solves.  The cv2 twin of the reference (baseline/opencv_vo.py) gets
# 0.750 cm on the same frames; the bound (2.5x the CPU figure) stays under it.
SINGLE_ATE_CPU_M = 0.002698
SINGLE_ATE_BOUND_M = 2.5 * SINGLE_ATE_CPU_M
# the same for the CLI phase (configs/default.yaml, 60 synthetic frames)
CLI_ATE_CPU_M = 0.003027
CLI_ATE_BOUND_M = 2.5 * CLI_ATE_CPU_M
# per-frame poses of the first 20 single-stream frames.  Device: GPU vs
# CPU, both on the f32 path.  Harris responses differ in their last bits
# with summation order, so near-tied corners of the rendered frames swap
# in and out of the top 500 (4.2% of the bench frame's keypoints, below),
# RANSAC sees other matches, and the poses differ by up to 3.681 mm /
# 1.41e-3 rad (H100, 700 W).  bf16: the production path (bf16 BRIEF) vs the
# f32 path, both on the GPU: up to 2.774 mm / 1.02e-3 rad (same run).  Each
# bound is twice its reading, under the 12 mm the camera moves per frame,
# so a pose one frame stale fails.  4 devices vs 1 (MultiStreamVO,
# ShardedMapVO) differ by summation order at most, so they share the
# device bound.
DEVICE_POSE_TOL_M = 7.5e-3
DEVICE_POSE_TOL_RAD = 3e-3
BF16_POSE_TOL_M = 5.5e-3
BF16_POSE_TOL_RAD = 2e-3
FOUR_CARD_POSE_TOL_M = DEVICE_POSE_TOL_M
FOUR_CARD_POSE_TOL_RAD = DEVICE_POSE_TOL_RAD
# one local BA solve of the production config, GPU vs CPU device, from the
# same state: the converged single-stream window with its keyframe poses
# (all but the fixed slot 0) knocked off by BA_KICK_M / BA_KICK_RAD
# (per-axis sigma) so that the solve has work to do.  Measured: 18.9 mm
# kicked, CPU ends 0.0003 mm and GPU 0.0032 mm from the converged window
# (H100, 700 W).
BA_KICK_M = 5e-3
BA_KICK_RAD = 5e-3
BA_TOL_M = 1e-4
BA_TOL_RAD = 1e-4
# orb.extract at 640x480, GPU (bf16 BRIEF) vs CPU device (f32): keypoints
# do not depend on the BRIEF precision, but Harris responses differ in the
# last bits (summation order), so near-equal keypoints may swap rank: the
# check compares keypoint SETS, and descriptors of the common keypoints
# (bits may flip within the orb_bf16 contract).  The noisy parity image
# has well-separated responses (100% common); the bench's rendered frame has
# many near-ties (95.8% common, 63% identical slot by slot; H100, 700 W).
ORB_XY_SAME_MIN = 0.99
ORB_BENCH_XY_SAME_MIN = 0.9
ORB_BITS_FLIPPED_MAX = 0.01
# bf16 vs f32 on the GPU (orb_bf16 and orb_patch_bf16 parity contracts)
BF16_BITS_FLIPPED_MAX = 0.01
PATCH_BF16_BITS_FLIPPED_MAX = 0.015
PATCH_BF16_ANGLE_P95_MAX = 0.1  # rad
N_SINGLE_FRAMES = 120
N_CPU_FRAMES = 20
N_MULTI_STEPS = 30
N_MULTI_SCENES = 8  # distinct rendered sequences, tiled over the streams
FOUR_CARD_STREAMS = 8
FOUR_CARD_STEPS = 20
SHARDED_MAP_FRAMES = 10


_failed: list[str] = []  # checks failed in the running phase


def _check(ok: bool, what: str) -> None:
    """Print one check; a failure fails its phase once the phase has
    printed all of its checks."""
    print(f"  {'ok' if ok else 'FAILED'}: {what}", flush=True)
    if not ok:
        _failed.append(what)


def _phase(name):
    def deco(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            print(f"[{name}]", flush=True)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if _failed:
                raise AssertionError(f"phase {name} failed: " + "; ".join(_failed))
            print(f"[{name}] passed in {time.perf_counter() - t0:.1f} s", flush=True)
            return out

        return run

    return deco


def _cpu_device():
    import jax

    return jax.devices("cpu")[0]


def _f32(cfg):
    """The config's f32 path (the CPU references run it; see docstring)."""
    return cfg.replace(orb_bf16=False, orb_patch_bf16=False)


def _ate(est_ts, est_xyz, gt_ts, gt_xyz) -> float:
    from rgbd_visualodometry_tpu.evaltools import absolute_trajectory_error

    return absolute_trajectory_error(
        np.asarray(est_ts), np.asarray(est_xyz), np.asarray(gt_ts), np.asarray(gt_xyz)
    ).rmse


def _pose_diff(a, b):
    """(translation m, rotation rad) between [..., 7] (qw qx qy qz t) poses."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dt = np.linalg.norm(a[..., 4:7] - b[..., 4:7], axis=-1)
    dot = np.abs(np.sum(a[..., :4] * b[..., :4], axis=-1))
    dot /= np.linalg.norm(a[..., :4], axis=-1) * np.linalg.norm(b[..., :4], axis=-1)
    return dt, 2.0 * np.arccos(np.clip(dot, 0.0, 1.0))


def _poses(results):
    return [r.pose_w_c for r in results]


def _check_poses(a, b, tol_m, tol_rad, what) -> None:
    """Per-frame pose agreement of two runs, printed frame by frame."""
    dt, dr = _pose_diff(a, b)
    print(f"  {what}, per-frame translation (mm): {np.round(dt * 1e3, 3).tolist()}")
    _check(
        dt.max() <= tol_m and dr.max() <= tol_rad,
        f"{what}: max {dt.max() * 1e3:.3f} mm <= {tol_m * 1e3:.3f} mm, "
        f"max {dr.max():.2e} rad <= {tol_rad:.1e} rad",
    )


def _bit_flip_fraction(a, b, valid) -> float:
    a, b = np.asarray(a)[valid], np.asarray(b)[valid]
    flips = np.unpackbits((a ^ b).view(np.uint8), axis=-1).sum()
    return flips / max(valid.sum() * 256.0, 1.0)


@_phase("1 device")
def phase_device() -> dict:
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX default backend is {backend!r})")
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    for line in smi.stdout.strip().splitlines():
        print(line.strip())  # the card's name and power limit, verbatim
    print(f"  jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}")
    print(f"  default matmul precision: {jax.config.jax_default_matmul_precision}")
    return {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())}


@_phase("2 cli")
def phase_cli() -> None:
    from rgbd_visualodometry_tpu import cli
    from rgbd_visualodometry_tpu.io import synthetic
    from rgbd_visualodometry_tpu.io.trajectory import read_trajectory

    n = 60
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "trajectory.txt")
        rc = cli.main(["configs/default.yaml", "--synthetic", str(n), "--quiet", "--output", out])
        _check(rc == 0, f"cli.main exit code {rc} == 0")
        _check(os.path.exists(out), "trajectory file written")
        ts, poses = read_trajectory(out)
    _check(len(ts) == n, f"{len(ts)}/{n} frames tracked and written")
    # the CLI's synthetic mode renders synthetic.orbit_trajectory at 30 fps
    gt = synthetic.orbit_trajectory(n)
    gt_xyz = [synthetic._pose_inverse(T)[4:7] for T in gt]
    gt_ts = np.arange(n) / 30.0
    ate = _ate(ts, poses[:, 4:7], gt_ts, gt_xyz)
    _check(
        ate <= CLI_ATE_BOUND_M,
        f"ATE {ate * 100:.3f} cm <= {CLI_ATE_BOUND_M * 100:.3f} cm "
        f"(2.5 x the CPU backend's {CLI_ATE_CPU_M * 100:.3f} cm)",
    )


@_phase("3 single")
def phase_single():
    """Returns (cfg, CPU state after N_CPU_FRAMES) for the BA kernel check."""
    import jax

    import bench
    from rgbd_visualodometry_tpu.config import VOConfig
    from rgbd_visualodometry_tpu.io import synthetic
    from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry

    cfg = bench.single_stream_cfg(VOConfig())
    seq = bench._make_frames(cfg, N_SINGLE_FRAMES)
    frames = [(f.rgb, f.depth, f.timestamp) for f in seq]
    vo = VisualOdometry(cfg)
    res = vo.run(iter(frames))
    n_tracked = sum(r.tracked for r in res)
    _check(n_tracked == len(seq), f"{n_tracked}/{len(seq)} frames tracked")
    _check(vo.ba_dispatches >= 1, f"{vo.ba_dispatches} local BA solves >= 1")
    ate = _ate(
        [r.timestamp for r in res], [r.pose_w_c[4:7] for r in res],
        [f.timestamp for f in seq], [synthetic._pose_inverse(f.T_c_w)[4:7] for f in seq],
    )
    _check(
        ate <= SINGLE_ATE_BOUND_M,
        f"ATE {ate * 100:.3f} cm <= {SINGLE_ATE_BOUND_M * 100:.3f} cm "
        f"(2.5 x the CPU backend's {SINGLE_ATE_CPU_M * 100:.3f} cm)",
    )

    head = frames[:N_CPU_FRAMES]
    res_32 = VisualOdometry(_f32(cfg)).run(iter(head))
    cpu = _cpu_device()
    t0 = time.perf_counter()
    with jax.default_device(cpu):
        vo_cpu = VisualOdometry(_f32(cfg), device=cpu)
        res_cpu = vo_cpu.run(iter(head))
    print(f"  CPU device run of {N_CPU_FRAMES} frames: {time.perf_counter() - t0:.1f} s")
    _check(
        all(r.tracked for r in res_32) and all(r.tracked for r in res_cpu),
        f"f32 path tracked {len(res_32)} frames on the GPU and {len(res_cpu)} on the CPU",
    )
    _check_poses(
        _poses(res_32), _poses(res_cpu), DEVICE_POSE_TOL_M, DEVICE_POSE_TOL_RAD,
        f"f32 path, GPU vs CPU, first {N_CPU_FRAMES} frames",
    )
    _check_poses(
        _poses(res[:N_CPU_FRAMES]), _poses(res_32), BF16_POSE_TOL_M, BF16_POSE_TOL_RAD,
        f"GPU, production (bf16 BRIEF) vs f32 path, first {N_CPU_FRAMES} frames",
    )
    return cfg, vo_cpu.state


@_phase("4 multi")
def phase_multi() -> None:
    import jax

    import bench
    from rgbd_visualodometry_tpu.config import VOConfig
    from rgbd_visualodometry_tpu.parallel import MultiStreamVO, make_mesh

    n = bench.FULL_VO_STREAMS
    mcfg = bench.multistream_cfg(VOConfig(), full_vo=True)
    scenes = [bench._make_frames(mcfg, N_MULTI_STEPS, seed=s) for s in range(N_MULTI_SCENES)]
    streams = [scenes[s % N_MULTI_SCENES] for s in range(n)]
    print(f"  {n} streams ({N_MULTI_SCENES} distinct scenes), {N_MULTI_STEPS} steps")
    vo = MultiStreamVO(mcfg, n_streams=n, mesh=make_mesh(1))
    tracked = []
    for i in range(N_MULTI_STEPS):
        out = vo.step(
            np.stack([s[i].rgb for s in streams]),
            np.stack([s[i].depth for s in streams]),
            np.asarray([s[i].timestamp for s in streams]),
        )
        tracked.append(out.tracked)
    vo.finish()
    tracked = np.asarray(jax.device_get(tracked))
    _check(bool(tracked.all()), f"all {n} streams tracked at all {N_MULTI_STEPS} steps")
    _check(vo.ba_dispatches >= 1, f"{vo.ba_dispatches} batched BA dispatches >= 1")
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    print(f"  peak device memory: {peak / 2**30:.2f} GiB" if peak else "  peak device memory: n/a")


@_phase("5 kernels")
def phase_kernels(cfg, cpu_state) -> None:
    import jax
    import jax.numpy as jnp

    from rgbd_visualodometry_tpu import mapstate
    from rgbd_visualodometry_tpu.camera import Camera
    from rgbd_visualodometry_tpu.ops import matching, orb, packing
    from rgbd_visualodometry_tpu.pipeline import backend, frontend
    from rgbd_visualodometry_tpu.utils.precision import dot_census, implicit_float_dots

    gpu, cpu = jax.devices()[0], _cpu_device()
    rng = np.random.default_rng(0)

    # matmul precision in force on the main path (traced for this backend)
    camera = Camera.from_config(cfg)
    state = mapstate.init_state(cfg)
    frame = frontend.FrameInput(
        rgb=jnp.zeros((cfg.image_height, cfg.image_width, 3), jnp.uint8),
        depth=jnp.zeros((cfg.image_height, cfg.image_width), jnp.uint16),
        timestamp=jnp.float32(0.0),
    )
    for name, fn, args in (
        ("track_step", functools.partial(frontend.track_step, cfg, camera), (state, frame)),
        ("ba_step", functools.partial(backend.ba_step, cfg, camera), (state, jnp.int32(0))),
    ):
        census = dot_census(fn, *args)
        print(f"  {name} dot_general census (dtype, precision): {dict(census)}")
        bad = implicit_float_dots(census)
        _check(not bad, f"{name}: no f32 matmul at default (TF32-eligible) precision")

    # packed Hamming vs the dense bipolar matmul at the bench width
    C, N = 16384, 512
    bits = rng.integers(0, 2, (C, 256)).astype(np.uint32)
    packed = (bits.reshape(C, 8, 32) << np.arange(32, dtype=np.uint32)).sum(
        axis=-1, dtype=np.uint32
    )
    bip = (bits.astype(np.int8) * 2 - 1).astype(np.int8)
    kp = bip[rng.permutation(C)[:N]].copy()
    kp[:, :7] *= -1  # distances away from 0
    ham_T = jax.jit(matching.hamming_matrix_packed_T)
    d_packed = np.asarray(ham_T(jnp.asarray(packed.T.copy()), jnp.asarray(kp)))
    d_dense = np.asarray(jax.jit(matching.hamming_matrix)(jnp.asarray(bip), jnp.asarray(kp)))
    d_np = (256 - bip.astype(np.int32) @ kp.astype(np.int32).T) // 2
    hlo = ham_T.lower(jnp.asarray(packed.T.copy()), jnp.asarray(kp)).compile().as_text()
    gemm = [t for t in ("cublas", "triton_gemm", "__triton", "cudnn") if t in hlo]
    print(f"  int8 Hamming GEMM lowers via: {gemm or 'no library GEMM (XLA loop fusion)'}")
    _check(
        np.array_equal(d_packed, d_np.T) and np.array_equal(d_dense, d_np),
        f"packed and dense Hamming == numpy at C={C}, N={N} (bit-exact)",
    )

    # covisibility A @ A^T at production capacity vs numpy (int exact in f64)
    K, Cm = 512, 65536
    A = (rng.random((K, Cm)) < 0.02).astype(np.int8)
    w_gpu = np.asarray(jax.jit(mapstate.covisibility_weights)(jnp.asarray(A)))
    Af = A.astype(np.float64)
    _check(
        np.array_equal(w_gpu, (Af @ Af.T).astype(np.int64)),
        f"covisibility A @ A^T == numpy at K={K}, C={Cm} (bit-exact)",
    )

    # inverse_lookup at production capacity vs numpy
    size, k = 65536, 1024
    idx = rng.choice(size, k, replace=False).astype(np.int32)
    valid = rng.random(k) < 0.8
    hit, inv = jax.jit(packing.inverse_lookup, static_argnums=0)(
        size, jnp.asarray(idx), jnp.asarray(valid)
    )
    hit_np = np.zeros(size, bool)
    hit_np[idx[valid]] = True
    inv_np = np.zeros(size, np.int32)
    inv_np[idx[valid]] = np.nonzero(valid)[0]
    hit, inv = np.asarray(hit), np.asarray(inv)
    _check(
        np.array_equal(hit, hit_np) and np.array_equal(inv[hit_np], inv_np[hit_np]),
        f"inverse_lookup == numpy at size={size}, k={k} (bit-exact)",
    )

    # orb.extract at 640x480: GPU (production bf16) vs CPU device (f32), on
    # the noisy parity image and on the bench's first rendered frame (with
    # the frontend's own arguments)
    import bench
    from rgbd_visualodometry_tpu.ops import image

    bench_rgb = bench._make_frames(cfg, 1)[0].rgb
    for what, img, kw, same_min in (
        ("noisy image", _parity_image(11, (cfg.image_height, cfg.image_width)),
         dict(nfeatures=cfg.number_of_features, nlevels=cfg.level_pyramid,
              scale=cfg.scale_factor, angle_bins=cfg.orb_angle_bins),
         ORB_XY_SAME_MIN),
        ("bench frame", np.asarray(image.rgb_to_gray(jax.device_put(bench_rgb, cpu))),
         dict(nfeatures=cfg.number_of_features, nlevels=cfg.level_pyramid,
              scale=cfg.scale_factor, threshold=float(cfg.fast_threshold),
              border=cfg.edge_threshold, angle_bins=cfg.orb_angle_bins),
         ORB_BENCH_XY_SAME_MIN),
    ):
        f_gpu = orb.extract(jax.device_put(img, gpu), **kw)
        f_cpu = orb.extract(jax.device_put(img, cpu), use_bf16=False, **kw)
        same, slot_same, flips, n_gpu, n_cpu = _orb_agreement(f_gpu, f_cpu)
        print(f"  orb.extract, {what}: {n_gpu} GPU / {n_cpu} CPU keypoints, "
              f"{slot_same:.2%} identical slot by slot")
        _check(
            same >= same_min and flips < ORB_BITS_FLIPPED_MAX,
            f"orb.extract GPU (bf16 BRIEF) vs CPU (f32), {what} at 640x480: {same:.2%} "
            f"of keypoints in both sets >= {same_min:.0%}, {flips:.3%} descriptor bits "
            f"of the common keypoints flipped < {ORB_BITS_FLIPPED_MAX:.0%}",
        )

    brief_bf16_parity()
    patch_bf16_parity()

    # one local BA solve of the production config from the kicked window,
    # GPU vs CPU device; both must pull the poses back to where the
    # pipeline's own BA left them
    from rgbd_visualodometry_tpu.ops import se3

    kf = int(cpu_state.num_kf) - 1
    live = np.asarray(cpu_state.kf_valid)
    kick = np.zeros((live.size, 6), np.float32)
    kick[1:] = rng.normal(0.0, 1.0, (live.size - 1, 6)) * np.repeat(
        [[BA_KICK_M, BA_KICK_RAD]], 3, axis=1
    )
    with jax.default_device(cpu):
        kicked = cpu_state._replace(
            kf_pose=se3.compose(se3.exp(jnp.asarray(kick)), cpu_state.kf_pose)
        )
    start = np.asarray(kicked.kf_pose)[live]
    converged = np.asarray(cpu_state.kf_pose)[live]

    def solve(c, dev):
        st, out = jax.jit(functools.partial(backend.ba_step, c, camera))(
            jax.device_put(kicked, dev), jax.device_put(jnp.int32(kf), dev)
        )
        poses = np.asarray(st.kf_pose)[live]
        print(
            f"  ba_step on keyframe {kf} ({dev.platform}): {int(out.num_poses)} poses, "
            f"{int(out.num_points)} points, {int(out.num_pruned)} observations pruned; "
            f"kicked {_pose_diff(start, converged)[0].max() * 1e3:.3f} mm off, "
            f"ends {_pose_diff(poses, converged)[0].max() * 1e3:.4f} mm off"
        )
        return poses

    ref = solve(cfg, cpu)
    got = solve(cfg, gpu)
    dt, dr = _pose_diff(ref, converged)
    _check(
        dt.max() <= BA_TOL_M and dr.max() <= BA_TOL_RAD,
        f"ba_step on the CPU brings the kicked poses back: max {dt.max() * 1e3:.4f} mm "
        f"<= {BA_TOL_M * 1e3:.1f} mm, max {dr.max():.2e} rad <= {BA_TOL_RAD:.0e} rad",
    )
    dt, dr = _pose_diff(got, ref)
    _check(
        dt.max() <= BA_TOL_M and dr.max() <= BA_TOL_RAD,
        f"ba_step from the kicked window, GPU vs CPU keyframe poses: max "
        f"{dt.max() * 1e3:.4f} mm <= {BA_TOL_M * 1e3:.1f} mm, max {dr.max():.2e} rad "
        f"<= {BA_TOL_RAD:.0e} rad",
    )


def _orb_agreement(f_a, f_b):
    """Keypoint-set overlap of two ``orb.extract`` results (share of ``f_a``'s
    keypoints, by position and octave, found in ``f_b``), the share of
    identical slots, the descriptor-bit flip fraction over the common
    keypoints, and both keypoint counts."""

    def keyed(f):
        v = np.asarray(f.valid)
        xy, octv, desc = np.asarray(f.xy)[v], np.asarray(f.octave)[v], np.asarray(f.desc)[v]
        return {(float(x), float(y), int(o)): d for (x, y), o, d in zip(xy, octv, desc)}

    k_a, k_b = keyed(f_a), keyed(f_b)
    common = sorted(k_a.keys() & k_b.keys())
    slot_same = np.mean(np.all(np.asarray(f_a.xy) == np.asarray(f_b.xy), axis=-1))
    flips = _bit_flip_fraction(
        np.stack([k_a[k] for k in common]), np.stack([k_b[k] for k in common]),
        np.ones(len(common), bool),
    ) if common else 1.0
    return len(common) / max(len(k_a), 1), slot_same, flips, len(k_a), len(k_b)


def _parity_image(seed, shape=(240, 320)):
    """Overlapping bright rectangles plus sensor noise (corners everywhere)."""
    rng = np.random.default_rng(seed)
    H, W = shape
    img = np.zeros(shape, np.float32)
    for _ in range(80 * (H * W) // (240 * 320)):
        y, x = rng.integers(10, H - 20), rng.integers(10, W - 20)
        h, w = rng.integers(8, 30, 2)
        img[y : y + h, x : x + w] += rng.uniform(30, 120)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.float32)


def brief_bf16_parity() -> None:
    """``orb_bf16``: the bf16 BRIEF matmul vs the f32 one on the GPU -
    identical keypoints, < 1% of descriptor bits flipped."""
    import jax.numpy as jnp

    from rgbd_visualodometry_tpu.ops import orb

    img = jnp.asarray(_parity_image(3))
    f_bf = orb.extract(img, nfeatures=200, nlevels=4, use_bf16=True)
    f_32 = orb.extract(img, nfeatures=200, nlevels=4, use_bf16=False)
    _check(
        np.array_equal(np.asarray(f_bf.xy), np.asarray(f_32.xy)),
        "orb_bf16: keypoints identical to the f32 path",
    )
    v = np.asarray(f_bf.valid) & np.asarray(f_32.valid)
    frac = _bit_flip_fraction(f_bf.desc, f_32.desc, v)
    _check(
        frac < BF16_BITS_FLIPPED_MAX,
        f"orb_bf16: {frac:.3%} descriptor bits flipped < {BF16_BITS_FLIPPED_MAX:.0%}",
    )


def patch_bf16_parity() -> None:
    """``orb_patch_bf16``: the bf16 patch canvas vs the f32 one on the GPU -
    identical keypoints, small angle deltas, < 1.5% bits flipped."""
    import jax.numpy as jnp

    from rgbd_visualodometry_tpu.ops import orb

    img = jnp.asarray(_parity_image(7))
    f_bf = orb.extract(img, nfeatures=200, nlevels=4, patch_bf16=True)
    f_32 = orb.extract(img, nfeatures=200, nlevels=4, patch_bf16=False)
    _check(
        np.array_equal(np.asarray(f_bf.xy), np.asarray(f_32.xy)),
        "orb_patch_bf16: keypoints identical to the f32 path",
    )
    v = np.asarray(f_bf.valid) & np.asarray(f_32.valid)
    da = np.abs(np.asarray(f_bf.angle)[v] - np.asarray(f_32.angle)[v])
    p95 = np.percentile(np.minimum(da, 2 * np.pi - da), 95)
    frac = _bit_flip_fraction(f_bf.desc, f_32.desc, v)
    _check(
        p95 < PATCH_BF16_ANGLE_P95_MAX and frac < PATCH_BF16_BITS_FLIPPED_MAX,
        f"orb_patch_bf16: angle p95 delta {p95:.4f} rad < {PATCH_BF16_ANGLE_P95_MAX} rad, "
        f"{frac:.3%} bits flipped < {PATCH_BF16_BITS_FLIPPED_MAX:.1%}",
    )


@_phase("6 four cards")
def phase_four_cards(n_devices: int = 4) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import bench
    from rgbd_visualodometry_tpu.config import VOConfig
    from rgbd_visualodometry_tpu.io import synthetic
    from rgbd_visualodometry_tpu.ops import matching
    from rgbd_visualodometry_tpu.parallel import (
        MultiStreamVO, ShardedMapVO, make_mesh, sharded_match_descriptors,
    )
    from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry

    devs = jax.devices()
    _check(len(devs) >= n_devices, f"{len(devs)} devices >= {n_devices}")

    # MultiStreamVO: 8 streams over a flat 4-device mesh vs one device
    n_streams, n_steps = FOUR_CARD_STREAMS, FOUR_CARD_STEPS
    mcfg = bench.multistream_cfg(VOConfig(), full_vo=True)
    seqs = [bench._make_frames(mcfg, n_steps, seed=s) for s in range(n_streams)]

    def run_streams(mesh):
        vo = MultiStreamVO(mcfg, n_streams=n_streams, mesh=mesh)
        poses, tracked = [], []
        for i in range(n_steps):
            out = vo.step(
                np.stack([s[i].rgb for s in seqs]),
                np.stack([s[i].depth for s in seqs]),
                np.asarray([s[i].timestamp for s in seqs]),
            )
            poses.append(out.pose_w_c)
            tracked.append(out.tracked)
        vo.finish()
        return np.asarray(jax.device_get(poses)), np.asarray(jax.device_get(tracked)), vo

    p4, t4, vo4 = run_streams(make_mesh(n_devices))
    p1, t1, _ = run_streams(make_mesh(1))
    _check(
        "stream" in str(vo4.states.mp_pos.sharding.spec) and t4.all() and t1.all(),
        f"MultiStreamVO: state sharded over {n_devices} devices, all streams tracked "
        f"on both meshes ({vo4.ba_dispatches} BA dispatches)",
    )
    dt, dr = _pose_diff(p4, p1)
    _check(
        dt.max() <= FOUR_CARD_POSE_TOL_M and dr.max() <= FOUR_CARD_POSE_TOL_RAD,
        f"MultiStreamVO {n_devices} devices vs 1: max {dt.max() * 1e3:.3f} mm "
        f"<= {FOUR_CARD_POSE_TOL_M * 1e3:.3f} mm, max {dr.max():.2e} rad "
        f"<= {FOUR_CARD_POSE_TOL_RAD:.1e} rad",
    )

    # ShardedMapVO at production capacity (C=65536 over 4) vs VisualOdometry
    cfg = VOConfig()
    scene = synthetic.SyntheticScene(
        width=cfg.image_width, height=cfg.image_height,
        fx=cfg.camera_fx, fy=cfg.camera_fy, cx=cfg.camera_cx, cy=cfg.camera_cy,
    )
    seq = synthetic.generate_sequence(SHARDED_MAP_FRAMES, scene=scene, step_t=(0.06, 0.01, 0.0))
    frames = [(f.rgb, f.depth, f.timestamp) for f in seq]
    tp = ShardedMapVO(cfg, make_mesh(n_devices, axis="map"))
    res_tp = tp.run(iter(frames))
    res_1 = VisualOdometry(cfg).run(iter(frames))
    _check(
        "map" in str(tp.state.mp_bip.sharding.spec)
        and all(r.tracked for r in res_tp) and all(r.tracked for r in res_1),
        f"ShardedMapVO: C={cfg.max_mappoints} pool sharded {n_devices} ways, "
        f"{len(res_tp)} frames tracked on both",
    )
    _check_poses(
        _poses(res_tp), _poses(res_1), FOUR_CARD_POSE_TOL_M, FOUR_CARD_POSE_TOL_RAD,
        "ShardedMapVO vs VisualOdometry",
    )

    # sharded_match_descriptors vs the single-device matcher
    rng = np.random.default_rng(1)
    C, N = cfg.max_mappoints, 512
    bip = (rng.integers(0, 2, (C, 256)) * 2 - 1).astype(np.int8)
    kp = bip[rng.permutation(C)[:N]].copy()
    kp[:, :9] *= -1
    cand_mask = rng.random(C) < 0.7
    kp_mask = rng.random(N) < 0.9
    mesh = make_mesh(n_devices)
    shard = NamedSharding(mesh, P("stream"))
    got = sharded_match_descriptors(
        mesh,
        jax.device_put(jnp.asarray(bip), shard),
        jax.device_put(jnp.asarray(cand_mask), shard),
        jnp.asarray(kp),
        jnp.asarray(kp_mask),
    )
    want = matching.match_descriptors(
        jax.device_put(bip, devs[0]), jnp.asarray(cand_mask), jnp.asarray(kp), jnp.asarray(kp_mask)
    )
    same = all(
        np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want)
    )
    _check(same, f"sharded_match_descriptors == match_descriptors at C={C}, N={N} (bit-exact)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the multi-device phase, on a 4-GPU mesh",
    )
    args = ap.parse_args(argv)
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    device = phase_device()
    if args.four_cards:
        phase_four_cards()
    else:
        phase_cli()
        cfg, cpu_state = phase_single()
        phase_multi()
        phase_kernels(cfg, cpu_state)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
