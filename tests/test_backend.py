"""Local BA backend tests on hand-built, well-posed problems.

Mirrors the Backend::Optimize contract (src/backend.cpp:19-195): window of
covisible keyframes (slot 0 fixed), marginalized points, Huber two-round
schedule with observation pruning that feeds back into the map.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_visualodometry_tpu import camera as cam_mod
from rgbd_visualodometry_tpu import mapstate
from rgbd_visualodometry_tpu.camera import Camera
from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.io import synthetic
from rgbd_visualodometry_tpu.ops import se3
from rgbd_visualodometry_tpu.pipeline import backend
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry


def small_cfg(**kw):
    base = dict(
        image_width=320, image_height=240,
        camera_fx=258.6, camera_fy=258.2, camera_cx=159.3, camera_cy=127.6,
        max_keyframes=8, max_mappoints=256, max_obs_per_mappoint=8,
        ba_max_poses=6, ba_max_points=256,
        covisibility_weight_threshold=15,
    )
    base.update(kw)
    return VOConfig(**base)


def build_scene_state(cfg, n_kf=4, n_pts=120, noise_px=0.0, seed=0, with_depth=True):
    """A state whose every keyframe observes every point (dense covis).

    ``with_depth`` stores the true camera-frame z as the measured sensor
    depth of each observation (what the frontend records from the depth map).
    """
    rng = np.random.default_rng(seed)
    cam = Camera.from_config(cfg)
    state = mapstate.init_state(cfg)

    poses_true = [se3.identity()]
    for k in range(1, n_kf):
        poses_true.append(
            se3.exp(jnp.asarray(rng.uniform(-1, 1, 6) * np.array([0.2, 0.2, 0.1, 0.03, 0.03, 0.03])))
        )
    poses_true = jnp.stack(poses_true)

    pts_true = jnp.asarray(rng.uniform([-1.5, -1.2, 2.0], [1.5, 1.2, 4.5], (n_pts, 3)), jnp.float32)

    for k in range(n_kf):
        state, slot, _ = mapstate.insert_keyframe(
            state, poses_true[k], jnp.float32(k), jnp.asarray(True)
        )
    # allocate points
    C = cfg.max_mappoints
    zero_desc = jnp.zeros((n_pts, 8), jnp.uint32)
    zero_bip = jnp.zeros((n_pts, 256), jnp.int8)
    z0 = cam_mod.world2camera(pts_true, poses_true[0])[:, 2]
    state, _ = mapstate.create_mappoints(
        state, jnp.int32(0), pts_true, zero_desc, zero_bip,
        np.asarray(cam_mod.world2pixel(cam, pts_true, poses_true[0])),
        jnp.ones(n_pts, bool), cam_mod.camera_center(poses_true[0]), jnp.asarray(True),
        depth=z0 if with_depth else None,
    )
    # add observations from the other keyframes
    for k in range(1, n_kf):
        uv = cam_mod.world2pixel(cam, pts_true, poses_true[k])
        uv = uv + rng.normal(0, noise_px, uv.shape) if noise_px else uv
        uv_full = (
            jnp.zeros((C, 2), jnp.float32)
            .at[jnp.arange(n_pts)]
            .set(jnp.asarray(uv, jnp.float32))
        )
        mask = jnp.zeros(C, bool).at[jnp.arange(n_pts)].set(True)
        zk = jnp.asarray(cam_mod.world2camera(pts_true, poses_true[k])[:, 2], jnp.float32)
        depth_full = (
            jnp.zeros(C, jnp.float32).at[jnp.arange(n_pts)].set(zk) if with_depth else None
        )
        state = mapstate.add_observations(
            state, jnp.int32(k), mask, uv_full.T, cam_mod.camera_center(poses_true[k]),
            jnp.asarray(True), depth=depth_full,
        )
    return cam, state, poses_true, pts_true


def perturb_state(state, rng, pose_mag=0.02, pt_mag=0.05, n_kf=4, n_pts=120):
    dp = jnp.asarray(rng.uniform(-pose_mag, pose_mag, (n_kf, 6)), jnp.float32)
    dp = dp.at[0].set(0.0)  # keyframe 0 stays at truth (it is fixed in BA)
    kf_pose = state.kf_pose.at[:n_kf].set(
        se3.compose(se3.exp(dp), state.kf_pose[:n_kf])
    )
    dpt = jnp.asarray(rng.uniform(-pt_mag, pt_mag, (n_pts, 3)), jnp.float32)
    mp_pos = state.mp_pos.at[:, :n_pts].set(state.mp_pos[:, :n_pts] + dpt.T)
    return state._replace(kf_pose=kf_pose, mp_pos=mp_pos)


def pose_errors(state, poses_true, n_kf):
    d = se3.log(se3.compose(state.kf_pose[:n_kf], se3.inverse(poses_true)))
    return np.linalg.norm(np.asarray(d), axis=1)


def test_build_problem_structure():
    cfg = small_cfg()
    cam, state, poses_true, pts_true = build_scene_state(cfg)
    prob = backend.build_problem(cfg, state, jnp.int32(3))
    # all 4 keyframes share 120 >= 15 observations -> all in window
    assert int(prob.wval.sum()) == 4
    widx = set(np.asarray(prob.widx)[np.asarray(prob.wval)].tolist())
    assert widx == {0, 1, 2, 3}
    # slot 0 fixed
    fixed = np.asarray(prob.wfixed)[np.asarray(prob.widx) == 0]
    assert fixed.all()
    assert int(prob.pval.sum()) == 120
    assert int(prob.o_valid.sum()) == 480  # 4 kf x 120 pts
    # every valid observation's pose is free except keyframe 0's
    assert int(prob.o_pose_free.sum()) == 360
    # one-hot rows sum to 1 exactly for free-pose observations
    assert int(prob.o_onehot.sum()) == 360


def test_ba_converges_to_ground_truth():
    cfg = small_cfg()
    cam, state, poses_true, pts_true = build_scene_state(cfg)
    rng = np.random.default_rng(1)
    state = perturb_state(state, rng)

    before = pose_errors(state, poses_true, 4)
    assert before[1:].max() > 5e-3

    step = jax.jit(functools.partial(backend.ba_step, cfg, cam))
    state2, out = step(state, jnp.int32(3))
    after = pose_errors(state2, poses_true, 4)
    assert int(out.num_poses) == 4 and int(out.num_points) == 120
    assert after[1:].max() < 1e-3, f"pose errors after BA: {after}"
    # points recovered too
    pt_err = np.linalg.norm(np.asarray(state2.mp_pos[:, :120].T) - np.asarray(pts_true), axis=1)
    assert np.median(pt_err) < 5e-3
    # fixed keyframe untouched
    np.testing.assert_allclose(np.asarray(state2.kf_pose[0]), np.asarray(poses_true[0]), atol=1e-7)
    assert int(out.num_pruned) == 0
    # optimized flags set (backend.cpp:170)
    assert bool(state2.mp_optimized[:120].all())


def test_ba_prunes_bad_observations_and_marks_outliers():
    cfg = small_cfg()
    cam, state, poses_true, pts_true = build_scene_state(cfg)
    # corrupt ALL observations of point 0 beyond repair (inconsistent
    # directions so no 3D point can re-fit them) and a single observation
    # of point 1
    bad = jnp.asarray(
        [[80.0, -60.0], [-75.0, 90.0], [65.0, 70.0], [-80.0, -85.0]], jnp.float32
    )
    state = state._replace(
        obs_uv=state.obs_uv.at[:, :4, 0].add(bad.T).at[:, 2, 1].add(60.0)
    )
    step = jax.jit(functools.partial(backend.ba_step, cfg, cam))
    state2, out = step(state, jnp.int32(3))
    assert int(out.num_pruned) >= 5
    # point 0 lost all observations -> outlier (mappoint.cpp:44-48)
    assert bool(state2.mp_outlier[0])
    # point 1 lost only one -> still alive
    assert not bool(state2.mp_outlier[1])
    assert int(state2.obs_valid[:, 1].sum()) == 3
    # remaining poses still at truth
    after = pose_errors(state2, poses_true, 4)
    assert after[1:].max() < 1e-3


def test_ba_without_depth_prior_still_reduces_pose_error():
    """Pure-reprojection BA (the reference's exact formulation) has a global
    scale gauge about the fixed camera; poses still land close to truth, but
    structure can slide ~1% in scale - assert the looser contract."""
    cfg = small_cfg(ba_use_depth_prior=False)
    cam, state, poses_true, pts_true = build_scene_state(cfg, with_depth=False)
    rng = np.random.default_rng(1)
    state = perturb_state(state, rng)
    before = pose_errors(state, poses_true, 4)
    step = jax.jit(functools.partial(backend.ba_step, cfg, cam))
    state2, out = step(state, jnp.int32(3))
    after = pose_errors(state2, poses_true, 4)
    assert after[1:].max() < before[1:].max()
    pt_err = np.linalg.norm(np.asarray(state2.mp_pos[:, :120].T) - np.asarray(pts_true), axis=1)
    assert np.median(pt_err) < 0.05


def test_ba_noop_on_empty_window():
    cfg = small_cfg()
    cam = Camera.from_config(cfg)
    state = mapstate.init_state(cfg)
    step = jax.jit(functools.partial(backend.ba_step, cfg, cam))
    state2, out = step(state, jnp.int32(0))
    assert int(out.num_poses) == 0
    assert not bool(jnp.any(jnp.isnan(state2.mp_pos)))
    assert not bool(jnp.any(jnp.isnan(state2.kf_pose)))


def test_ba_robust_to_outlier_depth_measurements():
    """Depth-prior edges are Huber-robustified with sigma(z)-normalized
    weights (pipeline/backend._lm_phase): a handful of wildly wrong sensor
    depths (edge shadowing / hole boundaries on real Kinect data) must not
    destabilize the window.  Regression for the fr1-like hard-scene blowups
    (ATE 1 -> 67 cm) observed before robustification."""
    cfg = small_cfg()
    cam, state, poses_true, pts_true = build_scene_state(cfg)
    rng = np.random.default_rng(7)
    state = perturb_state(state, rng)
    # corrupt the measured depth of 6 observations: gross outliers of the
    # kind edge shadowing produces (far-background depth behind a box edge)
    bad_pts = jnp.asarray([2, 5, 11, 17, 23, 31])
    state = state._replace(
        obs_depth=state.obs_depth.at[1, bad_pts].multiply(3.0)
    )
    step = jax.jit(functools.partial(backend.ba_step, cfg, cam))
    state2, _ = step(state, jnp.int32(3))
    after = pose_errors(state2, poses_true, 4)
    assert after[1:].max() < 2e-3, f"outlier depths destabilized BA: {after}"
    pt_err = np.linalg.norm(
        np.asarray(state2.mp_pos[:, :120].T) - np.asarray(pts_true), axis=1
    )
    assert np.median(pt_err) < 5e-3
    # even the points with a corrupted depth edge stay near truth: the
    # robust loss caps the pull
    assert pt_err[np.asarray(bad_pts)].max() < 0.05


@pytest.fixture(scope="module")
def tracked_window():
    """The state after 15 tracked synthetic frames: a real covisible window
    (5 keyframes, the pipeline's own map) that local BA has converged."""
    cfg = small_cfg(
        number_of_features=300, level_pyramid=4,
        max_keyframes=32, max_mappoints=4096, max_obs_per_mappoint=8,
        pnp_max_points=512, triangulation_batch=256, ransac_hypotheses=64,
        ba_max_poses=8, ba_max_points=2048,
    )
    scene = synthetic.SyntheticScene(
        width=320, height=240, fx=258.6, fy=258.2, cx=159.3, cy=127.6
    )
    vo = VisualOdometry(cfg)
    vo.run((f.rgb, f.depth, f.timestamp) for f in synthetic.generate_sequence(15, scene=scene))
    assert vo.ba_dispatches >= 1
    return cfg, vo.state


@pytest.mark.parametrize("sigma", [5e-3, 2e-3])
def test_ba_recovers_kicked_pipeline_window(tracked_window, sigma):
    """Knock the converged window's free poses off by ``sigma`` (m and rad
    per axis) and re-solve: BA must bring them back.  Regression for bf16
    normal-equation blocks, whose indefinite Schur complement made Cholesky
    return NaN so LM rejected every step and left the poses 1.7-4 mm off."""
    cfg, state = tracked_window
    live = np.asarray(state.kf_valid)
    kf = int(state.num_kf) - 1
    kick = np.zeros((live.size, 6), np.float32)
    kick[1:] = np.random.default_rng(0).normal(0.0, sigma, (live.size - 1, 6))
    kicked = state._replace(kf_pose=se3.compose(se3.exp(jnp.asarray(kick)), state.kf_pose))
    step = jax.jit(functools.partial(backend.ba_step, cfg, Camera.from_config(cfg)))
    out_state, out = step(kicked, jnp.int32(kf))

    def dist(a):
        d = se3.log(se3.compose(a.kf_pose, se3.inverse(state.kf_pose)))
        return np.linalg.norm(np.asarray(d)[live], axis=1).max()

    assert dist(kicked) > 1e-3
    assert int(out.num_pruned) == 0
    assert dist(out_state) < 2e-5, f"kicked {dist(kicked):.2e} -> {dist(out_state):.2e}"
