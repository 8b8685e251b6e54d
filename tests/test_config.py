"""Config loading tests: reference OpenCV-YAML files must load unmodified
(key set of ``config/default.yaml:1-31``)."""

import math

import pytest

from rgbd_visualodometry_tpu.config import VOConfig, load_config

REFERENCE_YAML = """%YAML:1.0
dataset_dir: /data/rgbd_dataset_freiburg1_room

output_file: ./output/output.txt

camera.fx: 517.3
camera.fy: 516.5
camera.cx: 318.6
camera.cy: 255.3

camera.depth_scale: 5000

number_of_features: 500
scale_factor: 1.2
level_pyramid: 8
match_ratio: 2.0
max_num_lost: 10
min_inliers: 10
keyframe_rotation: 0.05
keyframe_translation: 0.05

enable_local_optimization: 1
chi2_th: 1

enable_viewer: 0
"""


def test_load_reference_yaml(tmp_path):
    p = tmp_path / "default.yaml"
    p.write_text(REFERENCE_YAML)
    cfg = load_config(str(p))
    assert cfg.camera_fx == pytest.approx(517.3)
    assert cfg.camera_fy == pytest.approx(516.5)
    assert cfg.camera_cx == pytest.approx(318.6)
    assert cfg.camera_cy == pytest.approx(255.3)
    assert cfg.camera_depth_scale == 5000
    assert cfg.number_of_features == 500
    assert cfg.scale_factor == pytest.approx(1.2)
    assert cfg.level_pyramid == 8
    assert cfg.match_ratio == pytest.approx(2.0)
    assert cfg.max_num_lost == 10
    assert cfg.min_inliers == 10
    assert cfg.keyframe_rotation == pytest.approx(0.05)
    assert cfg.keyframe_translation == pytest.approx(0.05)
    assert cfg.enable_local_optimization is True
    assert cfg.chi2_th == pytest.approx(1.0)
    assert cfg.enable_viewer is False
    assert cfg.dataset_dir.endswith("freiburg1_room")


def test_defaults_match_reference():
    cfg = VOConfig()
    assert cfg.huber_delta == pytest.approx(math.sqrt(7.815))
    assert cfg.ransac_reproj_threshold == 4.0
    assert cfg.covisibility_weight_threshold == 15
    assert cfg.tracking_map_min_points == 100
    assert cfg.max_motion_norm == 5.0


def test_config_is_hashable_static_arg():
    cfg = VOConfig()
    assert hash(cfg) == hash(VOConfig())
    assert cfg.replace(fast_threshold=25).fast_threshold == 25
    assert cfg.fast_threshold == 20


def test_unknown_keys_ignored():
    cfg = VOConfig.from_dict({"nonexistent_key": 1, "min_inliers": 12})
    assert cfg.min_inliers == 12


def test_validation():
    with pytest.raises(ValueError):
        VOConfig(scale_factor=0.9)


def test_strict_parity_preset_flips_divergent_defaults():
    from rgbd_visualodometry_tpu.config import VOConfig

    cfg = VOConfig(strict_parity=True)
    assert cfg.enable_relocalization is False
    assert cfg.ba_use_depth_prior is False
    assert cfg.compat_single_triangulation is True
    assert cfg.compat_double_lost_increment is True
    assert cfg.compat_write_untracked_poses is True
    assert cfg.keyframe_eviction == "refuse"
    # defaults stay improved without the switch
    dflt = VOConfig()
    assert dflt.enable_relocalization is True
    assert dflt.keyframe_eviction == "ring"
    # hashable (jit static arg requirement)
    hash(cfg)


def test_strict_parity_from_yaml_key():
    from rgbd_visualodometry_tpu.config import VOConfig

    cfg = VOConfig.from_dict({"strict_parity": 1, "camera.fx": 500.0})
    assert cfg.strict_parity is True and cfg.compat_single_triangulation is True
    assert cfg.camera_fx == 500.0


def test_parser_reads_shipped_default_yaml_to_defaults():
    """configs/default.yaml (OpenCV %YAML:1.0, comments, quoted empty
    string) parses to exactly the default VOConfig."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs", "default.yaml")
    assert load_config(path) == VOConfig()


def test_parser_reads_reference_yaml_to_expected_config(tmp_path):
    p = tmp_path / "ref.yaml"
    p.write_text(REFERENCE_YAML)
    assert load_config(str(p)) == VOConfig(
        dataset_dir="/data/rgbd_dataset_freiburg1_room",
        output_file="./output/output.txt",
    )


@pytest.mark.parametrize(
    "text,value",
    [
        ("a: 'x # y'  # trailing comment", "x # y"),
        ('a: "./out dir/t.txt"', "./out dir/t.txt"),
        ("a: 1e-3", 1e-3),
        ("a: -7", -7),
        ("a: true", True),
        ("a: some/path", "some/path"),
    ],
)
def test_parser_scalars(text, value):
    from rgbd_visualodometry_tpu.config import _parse_opencv_yaml

    assert _parse_opencv_yaml("%YAML:1.0\n---\n" + text + "\n") == {"a": value}


@pytest.mark.parametrize("text", ["camera:\n  fx: 500", "a: [1, 2]", "just a line", "a:"])
def test_parser_rejects_non_flat_yaml(text):
    from rgbd_visualodometry_tpu.config import _parse_opencv_yaml

    with pytest.raises(ValueError):
        _parse_opencv_yaml(text)
