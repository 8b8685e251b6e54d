"""Accuracy-parity contract vs the measured reference baseline.

BASELINE.json's north star requires ATE RMSE within 5% of the OpenCV/g2o
reference.  `baseline/opencv_vo.py` is the measured stand-in for that
reference (same OpenCV kernels + numpy twins of its g2o solvers — see its
module docstring); this test runs the twin and the JAX pipeline on the SAME
synthetic sequence and asserts the contract, plus order-of-magnitude parity
of the reference's own diagnostic stage counters (frontend.cpp:212-214,243).
"""

import importlib.util
import os

import numpy as np
import pytest

from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.evaltools import absolute_trajectory_error
from rgbd_visualodometry_tpu.io import synthetic
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry

FX, FY, CX, CY = 258.6, 258.2, 159.3, 127.6
W, H = 320, 240
N_FRAMES = 60
TRAJ = dict(step_t=(0.012, 0.002, 0.0), step_r=(0.0, 0.0, 0.003))


def _load_twin():
    path = os.path.join(os.path.dirname(__file__), "..", "baseline", "opencv_vo.py")
    spec = importlib.util.spec_from_file_location("opencv_vo", os.path.abspath(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sequence():
    scene = synthetic.SyntheticScene(width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY)
    return synthetic.generate_sequence(N_FRAMES, scene=scene, **TRAJ)


@pytest.fixture(scope="module")
def twin_result(sequence):
    B = _load_twin()
    cfg = dict(B.DEFAULT_CFG)
    cfg.update(camera_fx=FX, camera_fy=FY, camera_cx=CX, camera_cy=CY,
               number_of_features=300)
    vo_map = B.Map()
    K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]])
    backend = B.Backend(cfg, vo_map, K, threaded=False)
    fe = B.FrontEnd(cfg, vo_map, backend)
    est_ts, est_xyz = [], []
    for f in sequence:
        fe.add_frame(f.rgb, f.depth, f.timestamp)
        if fe.state == B.LOST:
            break
        R, t = fe.pose
        est_ts.append(f.timestamp)
        est_xyz.append(-R.T @ t)
    return fe, np.asarray(est_ts), np.asarray(est_xyz)


@pytest.fixture(scope="module")
def ours_result(sequence):
    cfg = VOConfig(
        image_width=W, image_height=H,
        camera_fx=FX, camera_fy=FY, camera_cx=CX, camera_cy=CY,
        number_of_features=300, level_pyramid=4,
        max_keyframes=32, max_mappoints=8192, max_obs_per_mappoint=8,
        pnp_max_points=512, triangulation_batch=256, ransac_hypotheses=64,
        ba_max_poses=8, ba_max_points=2048,
    )
    vo = VisualOdometry(cfg)
    results = vo.run(((f.rgb, f.depth, f.timestamp) for f in sequence))
    est_ts = np.asarray([r.timestamp for r in results if r.tracked])
    est_xyz = np.asarray([r.pose_w_c[4:7] for r in results if r.tracked])
    return vo, results, est_ts, est_xyz


def _gt(sequence):
    ts = np.asarray([f.timestamp for f in sequence])
    xyz = np.asarray([synthetic._pose_inverse(f.T_c_w)[4:7] for f in sequence])
    return ts, xyz


def test_ate_within_contract(sequence, twin_result, ours_result):
    """North star: our ATE RMSE <= baseline's * 1.05."""
    gt_ts, gt_xyz = _gt(sequence)
    _, twin_ts, twin_xyz = twin_result
    _, _, our_ts, our_xyz = ours_result
    assert len(twin_ts) == N_FRAMES, "baseline twin lost tracking"
    twin_ate = absolute_trajectory_error(twin_ts, twin_xyz, gt_ts, gt_xyz).rmse
    our_ate = absolute_trajectory_error(our_ts, our_xyz, gt_ts, gt_xyz).rmse
    assert our_ate <= twin_ate * 1.05, (
        f"ATE parity violated: ours {our_ate * 100:.2f} cm vs "
        f"baseline {twin_ate * 100:.2f} cm"
    )


def test_stage_counters_same_regime(sequence, twin_result, ours_result):
    """Diagnostic parity: the pipelines see comparable match/inlier/keyframe
    volume on the same input (not bit parity - RANSAC and matching are
    algorithmically different by design, SURVEY.md section 7 'hard part 4')."""
    fe, _, _ = twin_result
    vo, results, _, _ = ours_result
    our_kf = sum(int(r.is_keyframe) for r in results)
    twin_kf = fe.stats["keyframes"]
    assert our_kf >= 2 and twin_kf >= 2
    assert 0.3 <= our_kf / twin_kf <= 3.0, (our_kf, twin_kf)
    our_inliers = float(
        np.mean([r.stats["num_inliers"] for r in results[1:] if r.tracked])
    )
    twin_inliers = fe.stats["inliers"] / max(2 * (fe.stats["frames"] - 1), 1)
    assert 0.3 <= our_inliers / max(twin_inliers, 1e-9) <= 3.0, (
        our_inliers, twin_inliers
    )


def test_tracking_not_lost(ours_result):
    _, results, est_ts, _ = ours_result
    assert len(est_ts) == N_FRAMES
