"""ORB frontend tests: FAST against a pure-numpy oracle and OpenCV,
orientation against the intensity-centroid definition, descriptor
self-consistency under rotation."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgbd_visualodometry_tpu.ops import fast, image as im, orb

jax.config.update("jax_platform_name", "cpu")

_CIRCLE = fast._CIRCLE


def numpy_fast_score(gray: np.ndarray) -> np.ndarray:
    """Naive reference implementation of the FAST-9 score."""
    h, w = gray.shape
    p = np.pad(gray, 3, mode="edge")
    diffs = np.stack(
        [p[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - gray for dy, dx in _CIRCLE]
    )
    doubled = np.concatenate([diffs, diffs[:8]], axis=0)
    bright = np.full((h, w), -np.inf)
    dark = np.full((h, w), -np.inf)
    for s in range(16):
        arc = doubled[s : s + 9]
        bright = np.maximum(bright, arc.min(axis=0))
        dark = np.maximum(dark, (-arc).min(axis=0))
    return np.maximum(np.maximum(bright, dark), 0.0)


@pytest.fixture(scope="module")
def test_image():
    rng = np.random.default_rng(7)
    img = np.zeros((120, 160), np.float32)
    # blocky structure -> strong corners, plus noise texture
    for _ in range(40):
        y, x = rng.integers(10, 100), rng.integers(10, 140)
        h, w = rng.integers(8, 30, 2)
        img[y : y + h, x : x + w] += rng.uniform(30, 120)
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def test_fast_score_matches_numpy_oracle(test_image):
    ours = np.asarray(fast.fast_score(jnp.asarray(test_image)))
    oracle = numpy_fast_score(test_image)
    np.testing.assert_allclose(ours, oracle, atol=1e-4)


def test_fast_corners_match_opencv(test_image):
    """Our corner decision (score > t) must agree with cv2.FAST_9_16
    away from the image border (padding differs at the border)."""
    t = 20
    img8 = test_image.astype(np.uint8)
    score = np.asarray(fast.fast_score(jnp.asarray(img8.astype(np.float32))))
    ours = score > t

    det = cv2.FastFeatureDetector_create(
        threshold=t, nonmaxSuppression=False, type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16
    )
    kps = det.detect(img8, None)
    theirs = np.zeros_like(ours)
    for kp in kps:
        x, y = int(round(kp.pt[0])), int(round(kp.pt[1]))
        theirs[y, x] = True

    interior = np.zeros_like(ours)
    interior[4:-4, 4:-4] = True
    agree = (ours == theirs) | ~interior
    assert agree.mean() > 0.999, f"disagreement {1 - agree.mean():.4f}"
    # and substantial overlap on the positives themselves
    inter = (ours & theirs & interior).sum()
    union = ((ours | theirs) & interior).sum()
    assert union > 50  # enough corners in the synthetic image to be meaningful
    assert inter / union > 0.95


def test_detect_level_static_shapes(test_image):
    xy, resp, valid = fast.detect_level(jnp.asarray(test_image), 20.0, 10, 64)
    assert xy.shape == (64, 2) and resp.shape == (64,) and valid.shape == (64,)
    n = int(valid.sum())
    assert 5 < n <= 64
    # valid keypoints respect the border
    xyv = np.asarray(xy[np.asarray(valid)])
    assert (xyv[:, 0] >= 10).all() and (xyv[:, 0] < 160 - 10).all()
    assert (xyv[:, 1] >= 10).all() and (xyv[:, 1] < 120 - 10).all()
    # detections are true FAST corners
    score = np.asarray(fast.fast_score(jnp.asarray(test_image)))
    for x, y in xyv[:10]:
        assert score[y, x] > 20


def test_orientation_matches_centroid_definition():
    """A patch with a bright blob to the right must yield angle ~0; blob
    below (y+) must yield ~pi/2 (atan2(m01, m10) like cv::ORB IC_Angle)."""
    patch = np.zeros((1, orb.PATCH, orb.PATCH), np.float32)
    patch[0, orb.PATCH_R, orb.PATCH_R + 10] = 100.0
    ang = float(orb._orientations(jnp.asarray(patch))[0])
    assert abs(ang) < 1e-5
    patch2 = np.zeros_like(patch)
    patch2[0, orb.PATCH_R + 10, orb.PATCH_R] = 100.0
    ang2 = float(orb._orientations(jnp.asarray(patch2))[0])
    assert abs(ang2 - np.pi / 2) < 1e-5


def test_descriptor_rotation_invariance(test_image):
    """Steered BRIEF: descriptors of the same keypoint under a 90-degree
    image rotation should be much closer in Hamming distance than random
    descriptor pairs (~128)."""
    img = test_image
    feats = orb.extract(jnp.asarray(img), nfeatures=128, nlevels=1, border=20)
    rot = np.rot90(img, k=-1).copy()  # (x, y) -> (H-1-y, x)
    feats_r = orb.extract(jnp.asarray(rot), nfeatures=128, nlevels=1, border=20)

    v = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)[v]
    d0 = np.asarray(feats.desc)[v]
    h = img.shape[0]
    xy_rot_expected = np.stack([h - 1 - xy[:, 1], xy[:, 0]], axis=1)

    vr = np.asarray(feats_r.valid)
    xyr = np.asarray(feats_r.xy)[vr]
    dr = np.asarray(feats_r.desc)[vr]

    def hamming(a, b):
        return bin(int.from_bytes(a.tobytes(), "little") ^ int.from_bytes(b.tobytes(), "little")).count("1")

    dists = []
    for i, pt in enumerate(xy_rot_expected):
        j = np.argmin(np.abs(xyr - pt).sum(axis=1))
        if np.abs(xyr[j] - pt).sum() <= 1.0:
            dists.append(hamming(d0[i], dr[j]))
    assert len(dists) >= 10
    assert np.mean(dists) < 45, f"mean rotated Hamming {np.mean(dists)}"


def test_extract_full_pipeline_shapes(test_image):
    feats = orb.extract(jnp.asarray(test_image), nfeatures=200, nlevels=4)
    assert feats.xy.shape == (200, 2)
    assert feats.desc.shape == (200, 8) and feats.desc.dtype == jnp.uint32
    assert feats.desc_bipolar.shape == (200, 256) and feats.desc_bipolar.dtype == jnp.int8
    assert int(feats.valid.sum()) > 20
    # bipolar and packed descriptors encode the same bits
    v = np.asarray(feats.valid)
    packed = np.asarray(feats.desc)[v]
    bip = np.asarray(feats.desc_bipolar)[v]
    bits = np.unpackbits(packed.view(np.uint8), bitorder="little", axis=1)
    np.testing.assert_array_equal(bits[:, :256], (bip > 0).astype(np.uint8))
    # octaves present beyond level 0
    assert set(np.asarray(feats.octave)[v]) >= {0, 1}


def test_feature_quota_distribution():
    q = im.features_per_level(500, 8, 1.2)
    assert sum(q) == 500
    assert q[0] > q[1] > q[-1] > 0


def test_pyramid_shapes():
    shapes = im.pyramid_shapes(480, 640, 8, 1.2)
    assert shapes[0] == (480, 640)
    assert shapes[1] == (400, 533)
    assert all(shapes[i][0] > shapes[i + 1][0] for i in range(7))


def test_diff_table_matches_continuous_sampler_at_bin_centers(test_image):
    """The matmul descriptor path (diff-table over quantized angle bins)
    must reproduce the per-keypoint continuous sampler exactly when the
    keypoint angle sits on a bin center."""
    import jax.numpy as jnp

    from rgbd_visualodometry_tpu.ops import image as im
    from rgbd_visualodometry_tpu.ops.orb import (
        PATCH_R,
        _brief_diff_table,
        _descriptors_from_image,
        _pack_bits,
        N_BITS,
    )

    img = jnp.asarray(test_image)
    blurred = im.gaussian_blur(img, 7, 2.0)
    Q = 30
    table = _brief_diff_table(Q)
    h, w = test_image.shape
    xy = jnp.asarray([[40, 40], [w - 45, h - 45], [60, 33]], jnp.int32)

    padded = jnp.pad(blurred, PATCH_R, mode="edge")
    for q in [0, 7, 15, 29]:
        ang = jnp.full(xy.shape[0], 2.0 * np.pi * q / Q, jnp.float32)
        ref_packed, _ = _descriptors_from_image(blurred, xy, ang)
        # table path: extract the blurred patch and apply bin q's columns
        patches = np.stack([
            np.asarray(padded)[y : y + 2 * PATCH_R + 1, x : x + 2 * PATCH_R + 1]
            for x, y in np.asarray(xy)
        ])
        flat = patches.reshape(len(patches), -1)
        d = flat @ table[:, q * N_BITS : (q + 1) * N_BITS].astype(np.float64)
        bits = (d > 0).astype(np.uint32)
        got_packed, _ = _pack_bits(jnp.asarray(bits))
        np.testing.assert_array_equal(np.asarray(ref_packed), np.asarray(got_packed))


def _run_chip_smoke_check(name):
    """Run one of ``chip_smoke.py``'s parity checks and fail on any of its
    failed checks (chip_smoke records them instead of raising)."""
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(repo, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    getattr(mod, name)()
    assert not mod._failed, mod._failed


@pytest.mark.gpu
def test_brief_bf16_parity_on_gpu():
    """The production descriptor path narrows BRIEF matmul operands to bf16
    on the GPU (config ``orb_bf16``); the CPU suite only ever runs the f32
    path.  On a GPU: identical keypoints, < 1% of descriptor bits flipped
    (``chip_smoke.py`` runs the same check in its kernel phase)."""
    _run_chip_smoke_check("brief_bf16_parity")


@pytest.mark.gpu
def test_patch_bf16_parity_on_gpu():
    """Same contract for ``orb_patch_bf16`` (bf16 patch-canvas row-take +
    column-select): identical keypoint coordinates, small angle deltas, and
    < 1.5% descriptor-bit flips vs the f32 canvas, on a GPU."""
    _run_chip_smoke_check("patch_bf16_parity")
