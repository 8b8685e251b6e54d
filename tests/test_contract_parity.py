"""Contract-scale accuracy parity (VERDICT r2 tasks 1b + 3).

BASELINE.json's contract is fr1-class: 640x480, fr1 intrinsics, 500 ORB
features, whole sequences - not the 320x240/300-feature toy scale the round-2
parity test used.  This module asserts ATE RMSE <= baseline x 1.05 at full
contract scale on

1. the easy textured-plane world (the bench workload, identical scene +
   trajectory + seed to ``bench.py::_make_frames``),
2. the fr1-like HARD world (boxes, depth holes/noise, exposure flicker -
   ``synthetic.hard_scene``),
3. the easy world run through ``MultiStreamVO`` at the EXACT bench
   throughput config (``bench.multistream_cfg(full_vo=True)``) - so the
   headline FPS configuration is the accuracy-verified configuration.

The cv2/numpy baseline twin and the JAX pipeline consume the SAME rendered
frames.  These are the slowest tests in the suite (marked ``slow``); frame
counts are chosen to keep them tractable on the CPU-forced CI while still
covering several keyframe-window generations and BA cycles.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest

from rgbd_visualodometry_tpu.config import VOConfig
from rgbd_visualodometry_tpu.evaltools import absolute_trajectory_error
from rgbd_visualodometry_tpu.io import synthetic
from rgbd_visualodometry_tpu.pipeline.system import VisualOdometry

pytestmark = pytest.mark.slow

W, H = 640, 480
N_FRAMES = 240
TRAJ = dict(step_t=(0.012, 0.002, 0.0), step_r=(0.0, 0.0, 0.003))  # bench traj


def _load_module(name, relpath):
    path = os.path.join(os.path.dirname(__file__), "..", relpath)
    spec = importlib.util.spec_from_file_location(name, os.path.abspath(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _twin():
    return _load_module("opencv_vo_contract", os.path.join("baseline", "opencv_vo.py"))


def _bench():
    return _load_module("bench_contract", "bench.py")


@pytest.fixture(scope="module")
def easy_sequence():
    scene = synthetic.SyntheticScene(width=W, height=H)  # fr1 intrinsics default
    return synthetic.generate_sequence(N_FRAMES, scene=scene, **TRAJ)


@pytest.fixture(scope="module")
def hard_sequence():
    scene = synthetic.hard_scene(width=W, height=H)
    return synthetic.generate_sequence(N_FRAMES, scene=scene, **TRAJ)


def _gt_xyz(seq):
    ts = np.asarray([f.timestamp for f in seq])
    xyz = np.asarray([synthetic._pose_inverse(f.T_c_w)[4:7] for f in seq])
    return ts, xyz


def _ours_ate(seq, cfg, multistream=False):
    gt_ts, gt_xyz = _gt_xyz(seq)
    if multistream:
        from rgbd_visualodometry_tpu.parallel import MultiStreamVO, make_mesh

        vo = MultiStreamVO(cfg, n_streams=1, mesh=make_mesh(1))
        est_ts, est_xyz, tracked = [], [], 0
        for f in seq:
            out = vo.step(f.rgb[None], f.depth[None], np.asarray([f.timestamp]))
            if bool(out.tracked[0]):
                tracked += 1
                est_ts.append(f.timestamp)
                est_xyz.append(np.asarray(out.pose_w_c[0][4:7]))
        vo.finish()
    else:
        vo = VisualOdometry(cfg)
        results = vo.run(((f.rgb, f.depth, f.timestamp) for f in seq))
        tracked = sum(r.tracked for r in results)
        est_ts = [r.timestamp for r in results if r.tracked]
        est_xyz = [r.pose_w_c[4:7] for r in results if r.tracked]
    assert tracked >= len(seq) - 2, f"tracked only {tracked}/{len(seq)}"
    return absolute_trajectory_error(
        np.asarray(est_ts), np.asarray(est_xyz), gt_ts, gt_xyz
    ).rmse


def _twin_ate(seq):
    res = _twin().run(frames=seq)
    assert res["frames_tracked"] >= len(seq) - 2, res
    return res["ate_rmse_m"]


@pytest.fixture(scope="module")
def easy_twin_ate(easy_sequence):
    return _twin_ate(easy_sequence)


def test_contract_parity_easy(easy_sequence, easy_twin_ate):
    """Full contract scale, default config, bench scene: ours within 5%."""
    twin_ate = easy_twin_ate
    our_ate = _ours_ate(easy_sequence, VOConfig())
    assert our_ate <= twin_ate * 1.05, (
        f"contract ATE parity violated (easy): ours {our_ate * 100:.2f} cm "
        f"vs baseline {twin_ate * 100:.2f} cm"
    )


def test_contract_parity_hard(hard_sequence):
    """Full contract scale on the fr1-like hard world: ours within 5%."""
    twin_ate = _twin_ate(hard_sequence)
    our_ate = _ours_ate(hard_sequence, VOConfig())
    assert our_ate <= twin_ate * 1.05, (
        f"contract ATE parity violated (hard): ours {our_ate * 100:.2f} cm "
        f"vs baseline {twin_ate * 100:.2f} cm"
    )


def test_single_stream_config_parity(easy_sequence, easy_twin_ate):
    """The EXACT bench single-stream config (single_stream_cfg: fr1-sized
    pools, 1024-point BA window, 128-slot triangulation, 64 RANSAC lanes)
    must still satisfy the 5% ATE contract - the round-4 single-stream FPS
    number may not be bought with accuracy (VERDICT r3 task 1)."""
    scfg = _bench().single_stream_cfg(VOConfig())
    our_ate = _ours_ate(easy_sequence, scfg)
    assert our_ate <= easy_twin_ate * 1.05, (
        f"single-stream-config ATE parity violated: ours {our_ate * 100:.2f} "
        f"cm vs baseline {easy_twin_ate * 100:.2f} cm"
    )


def test_throughput_config_parity(easy_sequence, easy_twin_ate):
    """The EXACT bench throughput config (multistream_cfg full_vo: shrunken
    map, gap-9 BA coalescing, 512 PnP slots) must still satisfy the 5% ATE
    contract - the headline FPS number may not be bought with accuracy
    (VERDICT r2 weak #2 / ADVICE r2 medium)."""
    twin_ate = easy_twin_ate
    mcfg = _bench().multistream_cfg(VOConfig(), full_vo=True)
    our_ate = _ours_ate(easy_sequence, mcfg, multistream=True)
    assert our_ate <= twin_ate * 1.05, (
        f"throughput-config ATE parity violated: ours {our_ate * 100:.2f} cm "
        f"vs baseline {twin_ate * 100:.2f} cm"
    )
